"""The train step (port of ``repro/runtime/steps.py``): ``TrainRunConfig``,
``init_train_state``, ``train_state_shardings`` and ``make_train_step``, on
one device or on a mesh, and the placement of a train state on a mesh
(``place_train_state``, ``gather_train_state``).

Gradients come from autograd on the float model (the reference
differentiates the same forward with ``jax.value_and_grad``; no kernel of
the port has a backward, and none is needed: training runs on float
weights). Microbatches accumulate their gradients in ``accum_dtype`` and
their metrics in f32, then take the mean, in the reference's order.

On a mesh the step computes what the reference's jitted step computes
under GSPMD: the one-device step on the global batch, the state placed by
:func:`train_state_shardings`. A rank holds its slice of the parameters
and both moments between steps. A step gathers the full parameters (no
autograd through the gather), runs the one-device forward and backward on
the rank's rows of the batch with the whole batch's loss
(:class:`~repro_torch.models.transformer.BatchSplit`: the rank's share of
it, so the shares' gradients sum to the whole batch's), sums the gradients
over the batch axes, keeps its slice and runs AdamW on the slices, the
clip taking the norm of the whole tree. Ranks that differ only on
``model`` repeat the same rows. Under ``grad_compression="int8-pod"`` on a
mesh with a ``pod`` axis each pod takes the loss of its own rows and the
gradients cross the pods through
:func:`~repro_torch.runtime.compression.int8_psum`, as in the reference;
elsewhere the option changes nothing, as in the reference.

The reference's ``lower_*`` functions lower for XLA and its serve-step
builders wrap the model's ``prefill``/``decode_step``; they have no
counterpart here.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (
    BatchSplit,
    Transformer,
    init_model,
    loss_fn,
    split_stats_size,
)
from repro_torch.optim import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    trainable_parameters,
)
from repro_torch.runtime.collectives import all_reduce_sum, gather_dim
from repro_torch.runtime.compression import compressed_grad_fn
from repro_torch.runtime.sharding import local_slice, param_shardings, spec_axes

#: the metrics a microbatch contributes to the mean
_METRICS = ("loss", "ce", "aux", "ppl")


@dataclass(frozen=True)
class TrainRunConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    num_microbatches: int = 1
    grad_compression: str = "none"  # none | int8-pod
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


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def train_state_shardings(state: dict, mesh) -> dict:
    """The spec of every leaf of a train state (a one-device or abstract
    one, or one placed on ``mesh``): ``params``, ``opt.m`` and ``opt.v``
    by :func:`~repro_torch.runtime.sharding.param_shardings` under the
    default rules, keyed by parameter name (each matched by its reference
    leaf name), ``opt.step`` replicated."""
    model = state["params"]
    specs = getattr(model, "_train_specs", None)
    if specs is None:
        every = param_shardings(model, mesh)
        specs = {n: every[n] for n in trainable_parameters(model)}
    return {"params": specs, "opt": {"m": dict(specs), "v": dict(specs), "step": ()}}


def _live(spec, mesh) -> list[tuple[int, tuple]]:
    """(dim, axes of more than one rank) of every sharded dim of ``spec``."""
    out = []
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in spec_axes(entry) if mesh.shape[a] > 1)
        if axes:
            out.append((dim, axes))
    return out


def full_shape(x: torch.Tensor, spec, mesh) -> tuple[int, ...]:
    """The shape of the full tensor of this rank's block ``x`` under ``spec``."""
    shape = list(x.shape)
    for dim, axes in _live(spec, mesh):
        shape[dim] *= mesh.axes_size(axes)
    return tuple(shape)


def _gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor of this rank's block ``x`` under ``spec``."""
    for dim, axes in _live(spec, mesh):
        x = gather_dim(x, dim, mesh, axes)
    return x


def place_train_state(state: dict, mesh) -> dict:
    """A one-device train state (every rank holding the same one) placed on
    ``mesh``: a copy of the model holding this rank's slice of each
    parameter, this rank's slices of both moments, the step. The model
    carries the mesh and the specs (``_mesh``, ``_train_specs``)."""
    model, opt = state["params"], state["opt"]
    specs = train_state_shardings(state, mesh)["params"]
    memo = {}
    for n, p in trainable_parameters(model).items():
        memo[id(p)] = torch.nn.Parameter(local_slice(p.detach(), specs[n], mesh).clone())
    placed = copy.deepcopy(model, memo)
    placed._mesh, placed._train_specs = mesh, specs
    return {"params": placed, "opt": {
        "m": {n: local_slice(t, specs[n], mesh).clone() for n, t in opt["m"].items()},
        "v": {n: local_slice(t, specs[n], mesh).clone() for n, t in opt["v"].items()},
        "step": opt["step"].clone()}}


def gather_train_state(state: dict) -> dict:
    """The one-device train state of a placed one, on every rank (a
    collective: every rank calls it)."""
    model, opt = state["params"], state["opt"]
    mesh, specs = model._mesh, model._train_specs
    memo = {id(mesh): None, id(specs): None}
    with torch.no_grad():
        for n, p in trainable_parameters(model).items():
            memo[id(p)] = torch.nn.Parameter(_gather(p.detach(), specs[n], mesh).clone())
        whole = copy.deepcopy(model, memo)
        del whole._mesh, whole._train_specs
        return {"params": whole, "opt": {
            "m": {n: _gather(t, specs[n], mesh).clone() for n, t in opt["m"].items()},
            "v": {n: _gather(t, specs[n], mesh).clone() for n, t in opt["v"].items()},
            "step": opt["step"].clone()}}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def _split_microbatches(batch: dict, n_mb: int) -> list[dict]:
    b = batch["tokens"].shape[0]
    if b % n_mb:
        raise ValueError(f"global batch {b} not divisible by microbatches {n_mb}")
    size = b // n_mb
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n_mb)]


def _grads(total, params: dict) -> dict:
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}


class _Loss(torch.nn.Module):
    """``loss_fn`` as a module's forward, so that ``functional_call`` runs it
    on parameters other than the model's own."""

    def __init__(self, model: Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch: dict, split: BatchSplit):
        return loss_fn(self.model, batch, split)


def make_train_step(cfg: ModelConfig, run: TrainRunConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradients (accumulated over ``run.num_microbatches``), then
    one AdamW update of the parameters and moments in place. ``batch``
    holds tensors on the model's device; the metrics are 0-d tensors there
    ("loss", "ce", "aux", "ppl", "lr", "grad_norm"), read by nobody until
    the caller reads them.

    With ``mesh`` the state is placed on it (:func:`place_train_state`)
    and ``batch`` holds this rank's rows of the global batch (its block
    under the ``batch`` rule, over ``pod`` and ``data``); the metrics are
    the global batch's, on every rank."""
    acc_dt = torch_dtype(run.accum_dtype)
    if mesh is not None:
        return _mesh_train_step(cfg, run, mesh, acc_dt)

    def grad_fn(model, params, mb):
        total, metrics = loss_fn(model, mb)
        return {"loss": total.detach(), **{k: v.detach() for k, v in metrics.items()}}, \
            _grads(total, params)

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


def _sum_flat(grads: dict, mesh, axes) -> dict:
    """Every gradient summed over ``axes``: one all-reduce a dtype."""
    if not axes:
        return grads
    out = dict(grads)
    for dt in {g.dtype for g in grads.values()}:
        names = [n for n, g in grads.items() if g.dtype == dt]
        flat = all_reduce_sum(torch.cat([grads[n].reshape(-1) for n in names]), mesh, axes)
        lo = 0
        for n in names:
            out[n] = flat[lo:lo + grads[n].numel()].view(grads[n].shape)
            lo += grads[n].numel()
    return out


def _mesh_train_step(cfg: ModelConfig, run: TrainRunConfig, mesh, acc_dt):
    """The train step on ``mesh`` (see the module docstring)."""
    compress = run.grad_compression == "int8-pod" and "pod" in mesh.shape
    # the axes whose ranks hold the rows of one loss: every batch axis, or
    # under int8-pod the data axis of one pod
    loss_axes = tuple(a for a in (("data",) if compress else ("pod", "data"))
                      if a in mesh.shape and mesh.shape[a] > 1)
    n_ranks, me = mesh.axes_size(loss_axes), mesh.index(loss_axes)
    width = split_stats_size(cfg)
    n_mb = max(run.num_microbatches, 1)

    def reduce(v):
        return all_reduce_sum(v, mesh, loss_axes)

    def accumulate(model, full, batch):
        """This rank's shares of each microbatch's loss (the reference's
        microbatch ``i`` is rows ``[i * per, (i + 1) * per)`` of the loss's
        rows, which may lie on other ranks only): their gradients summed
        over the loss's ranks, and the metrics."""
        loss = _Loss(model)
        b = batch["tokens"].shape[0]
        rows = b * n_ranks
        if rows % n_mb:
            raise ValueError(f"global batch {rows} not divisible by microbatches {n_mb}")
        per, first = rows // n_mb, me * b
        dev = batch["tokens"].device
        g_acc = None if n_mb == 1 else {
            n: torch.zeros(t.shape, dtype=acc_dt, device=t.device) for n, t in full.items()}
        terms = []
        for i in range(n_mb):
            lo, hi = max(i * per, first), min((i + 1) * per, first + b)
            if hi <= lo:  # none of microbatch i's rows here: the same collective, zeros
                reduce(torch.zeros(width, device=dev))
                terms.append(torch.zeros(3, device=dev))
                continue
            mb = {k: v[lo - first:hi - first] for k, v in batch.items()}
            total, metrics = torch.func.functional_call(loss, {
                f"model.{n}": t for n, t in full.items()}, (mb, BatchSplit(per, lo - i * per,
                                                                           reduce)))
            grads = _grads(total, full)
            terms.append(torch.stack([total.detach(), metrics["ce"].detach(),
                                      metrics["aux"].detach()]))
            g_acc = grads if n_mb == 1 else {n: a + grads[n].to(acc_dt)
                                             for n, a in g_acc.items()}
        inv = 1.0 / n_mb
        if n_mb > 1:
            g_acc = {n: (g * inv).to(full[n].dtype) for n, g in g_acc.items()}
        per_mb = reduce(torch.stack(terms))  # (n_mb, 3): each microbatch's loss, ce, aux
        each = [{"loss": t[0], "ce": t[1], "aux": t[2], "ppl": torch.exp(t[1])} for t in per_mb]
        if n_mb == 1:
            metrics = each[0]
        else:
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in _METRICS}
            for m in each:
                metrics = {k: a + m[k] for k, a in metrics.items()}
            metrics = {k: m * inv for k, m in metrics.items()}
        return metrics, _sum_flat(g_acc, mesh, loss_axes)

    reducer = compressed_grad_fn(accumulate, mesh) if compress else accumulate

    def train_step(state: dict, batch: dict):
        model = state["params"]
        if getattr(model, "_mesh", None) is not mesh:
            raise ValueError("the train state is not placed on this step's mesh: "
                             "place_train_state(state, mesh)")
        specs = model._train_specs
        params = trainable_parameters(model)
        with torch.no_grad():
            full = {n: _gather(p.detach(), specs[n], mesh) for n, p in params.items()}
        full = {n: t.detach().requires_grad_(True) for n, t in full.items()}
        metrics, grads = reducer(model, full, batch)
        del full
        local = {n: local_slice(g, specs[n], mesh) for n, g in grads.items()}
        del grads
        _, _, opt_metrics = adamw_update(params, local, state["opt"], run.optimizer,
                                         shards=(mesh, specs))
        metrics.update(opt_metrics)
        return state, metrics

    return train_step


__all__ = ["TrainRunConfig", "full_shape", "gather_train_state", "init_train_state",
           "make_train_step", "place_train_state", "train_state_shardings"]
