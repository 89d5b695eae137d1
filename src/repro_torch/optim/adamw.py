"""AdamW with decoupled weight decay, global-norm clipping and a warmup +
cosine schedule (port of ``repro/optim/adamw.py``).

Parameters, gradients and moments are dicts keyed by parameter name (a
model's ``named_parameters()``, see :func:`trainable_parameters`); the
update writes parameters and moments in place under ``torch.no_grad``.
The order of operations is the reference's: gradients clipped in f32,
moments in ``moment_dtype``, weight decay on every leaf, and ``p_new =
(p.f32 - lr * delta).to(p.dtype)``. The step, the learning rate and the
bias corrections stay 0-d tensors on the device: an update reads nothing
on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import torch_dtype


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def trainable_parameters(model: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    """The parameters an optimizer updates: every parameter of ``model``
    that takes a gradient, by name."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def lr_at_step(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr`` (an f32
    0-d tensor on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio
                    + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict[str, torch.Tensor], cfg: OptimizerConfig) -> dict:
    """Zero first and second moments in ``moment_dtype`` beside each
    parameter, and the step, a 0-d int32 tensor."""
    dt = torch_dtype(cfg.moment_dtype)
    device = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: dict[str, torch.Tensor], shards=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together. ``shards`` = (mesh,
    {name: spec}): each leaf is this rank's block under its spec, and its
    sum of squares is summed over the axes it is sharded on (one all-reduce
    for the leaves sharded alike), so a replicated leaf counts once and
    every rank gets the norm of the whole tree."""
    sq = {n: torch.sum(torch.square(x.to(torch.float32))) for n, x in tree.items()}
    if shards is not None:
        from repro_torch.runtime.collectives import all_reduce_sum
        from repro_torch.runtime.sharding import spec_axes

        mesh, specs = shards
        alike: dict[tuple, list[str]] = {}
        for n in tree:
            axes = tuple(a for e in specs[n] for a in spec_axes(e) if mesh.shape[a] > 1)
            alike.setdefault(axes, []).append(n)
        for axes, names in alike.items():
            if axes:
                total = all_reduce_sum(torch.stack([sq[n] for n in names]), mesh, axes)
                sq.update(zip(names, total))
    return torch.sqrt(sum(sq[n] for n in tree))


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 state: dict, cfg: OptimizerConfig, shards=None):
    """One AdamW step, in place on ``params`` and ``state``. Returns
    (params, state, {"lr", "grad_norm"}). ``shards`` = (mesh, specs): the
    leaves are this rank's blocks (the clip takes the whole tree's norm,
    :func:`global_norm`; the rest is elementwise). The clip and the update
    run a parameter at a time, the moments updated in place, so the step
    holds one parameter's temporaries beside the gradients (the arithmetic
    of the reference's ``clip_by_global_norm`` and closed form, op for op)."""
    gnorm = global_norm(grads, shards)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state["step"] + 1
    lr = lr_at_step(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    for name, p in params.items():
        m, v, g = state["m"][name], state["v"][name], grads[name]
        gf = (g.to(torch.float32) * scale).to(g.dtype).to(m.dtype)
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        del gf
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.to(m.dtype))
        p.copy_((p.to(torch.float32) - lr * delta.to(torch.float32)).to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
