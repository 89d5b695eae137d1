"""The train step on one device (port of ``repro/runtime/steps.py``):
``TrainRunConfig``, ``init_train_state`` and ``make_train_step``.

Gradients come from autograd on the float model (the reference
differentiates the same forward with ``jax.value_and_grad``; no kernel of
the port has a backward, and none is needed: training runs on float
weights). Microbatches accumulate their gradients in ``accum_dtype`` and
their metrics in f32, then take the mean, in the reference's order. The
reference's ``lower_*`` functions lower for XLA and its serve-step
builders wrap the model's ``prefill``/``decode_step``; they have no
counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import Transformer, init_model, loss_fn
from repro_torch.optim import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    trainable_parameters,
)

#: the metrics a microbatch contributes to the mean
_METRICS = ("loss", "ce", "aux", "ppl")


@dataclass(frozen=True)
class TrainRunConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    num_microbatches: int = 1
    grad_compression: str = "none"  # none | int8-pod (multi-device, not ported)
    accum_dtype: str = "float32"  # gradient accumulation dtype


def init_train_state(cfg: ModelConfig, run: TrainRunConfig, seed: int = 0, *,
                     device="cuda", model: Transformer | None = None) -> dict:
    """{"params": the model with its float leaves' gradients on, "opt":
    AdamW state}. ``model`` (e.g. carried from the reference with
    ``interop.params_from_numpy``) replaces the seeded init; it is trained
    in place."""
    if model is None:
        model = init_model(cfg, seed, device=resolve_device(device))
    elif model.cfg != cfg:
        raise ValueError(f"config {cfg.name} does not describe the model ({model.cfg.name})")
    model.requires_grad_(True)
    return {"params": model, "opt": init_opt_state(trainable_parameters(model), run.optimizer)}


def _split_microbatches(batch: dict, n_mb: int) -> list[dict]:
    b = batch["tokens"].shape[0]
    if b % n_mb:
        raise ValueError(f"global batch {b} not divisible by microbatches {n_mb}")
    size = b // n_mb
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n_mb)]


def make_train_step(cfg: ModelConfig, run: TrainRunConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradients (accumulated over ``run.num_microbatches``), then
    one AdamW update of the parameters and moments in place. ``batch``
    holds tensors on the model's device; the metrics are 0-d tensors there
    ("loss", "ce", "aux", "ppl", "lr", "grad_norm"), read by nobody until
    the caller reads them."""
    if run.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={run.grad_compression!r} compresses gradients across a "
            f"pod mesh: multi-device training is not ported")
    acc_dt = torch_dtype(run.accum_dtype)

    def grad_fn(model, params, mb):
        total, metrics = loss_fn(model, mb)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        return {"loss": total.detach(), **{k: v.detach() for k, v in metrics.items()}}, grads

    def accumulate(model, params, batch):
        if run.num_microbatches <= 1:
            return grad_fn(model, params, batch)
        dev = batch["tokens"].device
        g_acc = {n: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                 for n, p in params.items()}
        m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in _METRICS}
        for mb in _split_microbatches(batch, run.num_microbatches):
            metrics, grads = grad_fn(model, params, mb)
            g_acc = {n: a + grads[n].to(acc_dt) for n, a in g_acc.items()}
            m_acc = {k: a + metrics[k] for k, a in m_acc.items()}
        inv = 1.0 / run.num_microbatches
        grads = {n: (g * inv).to(params[n].dtype) for n, g in g_acc.items()}
        return {k: m * inv for k, m in m_acc.items()}, grads

    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = trainable_parameters(model)
        metrics, grads = accumulate(model, params, batch)
        _, _, opt_metrics = adamw_update(params, grads, state["opt"], run.optimizer)
        metrics.update(opt_metrics)
        return state, metrics

    return train_step
