"""The train step (port of ``repro/runtime/steps.py``): ``TrainRunConfig``,
``init_train_state``, ``abstract_train_state``, ``train_state_shardings``
and ``make_train_step``, on one device or on a mesh, the placement of a
train state on a mesh (``place_train_state``, ``gather_train_state``) and
a rank's training bytes there (``mesh_train_bytes``).

Gradients come from autograd on the float model (the reference
differentiates the same forward with ``jax.value_and_grad``; no kernel of
the port has a backward, and none is needed: training runs on float
weights). Microbatches accumulate their gradients in ``accum_dtype`` and
their metrics in f32, then take the mean, in the reference's order.

On a mesh the step computes what the reference's jitted step computes
under GSPMD: the one-device step on the global batch, the state placed by
:func:`train_state_shardings`. A rank holds its slice of the parameters
and both moments between steps. The forward runs the rank's rows of the
batch with the whole batch's loss
(:class:`~repro_torch.models.transformer.BatchSplit`: the rank's share of
it, so the shares' gradients sum to the whole batch's) one unit at a time
(:func:`~repro_torch.models.transformer.model_units`: the embedding, each
period of the pattern, the final norm with the head): a unit gathers its
parameters into full tensors as it starts, and in the backward sums their
gradients over the batch axes into the rank's slices
(:class:`_GatherUnit`, one collective per unit and dtype). Under
``remat="block"`` a period's recompute gathers it again, as the
reference's remat does inside its layer scan, so a rank holds about one
unit's full parameters and gradients at a time
(:func:`mesh_train_bytes`); under ``"none"`` autograd keeps the gathered
parameters and only the gradients are bounded. Microbatches accumulate
into slice-shaped accumulators; AdamW runs on the slices, the clip taking
the norm of the whole tree. Ranks that differ only on ``model`` repeat
the same rows. Under ``grad_compression="int8-pod"`` on a mesh with a
``pod`` axis each pod takes the loss of its own rows and the gradients'
slices cross the pods through
:func:`~repro_torch.runtime.compression.int8_psum`, which takes each
leaf's absmax over the whole leaf, as in the reference; elsewhere the
option changes nothing, as in the reference.

The reference's ``lower_*`` functions lower for XLA and its serve-step
builders wrap the model's ``prefill``/``decode_step``; they have no
counterpart here.
"""

from __future__ import annotations

import copy
import math
import weakref
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (
    BatchSplit,
    Transformer,
    Unit,
    abstract_params,
    init_model,
    loss_fn,
    model_units,
    split_stats_size,
)
from repro_torch.optim import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    trainable_parameters,
)
from repro_torch.runtime.collectives import all_reduce_sum, gather_dim, reduce_to_blocks
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


#: bytes of the full tensors that the mesh step's gathers hold alive, and
#: the most alive at once since :func:`reset_gathered`
gathered_live = 0
gathered_peak = 0


def reset_gathered() -> None:
    """Start a new high-water mark of :data:`gathered_peak`."""
    global gathered_peak
    gathered_peak = gathered_live


def _release(n: int) -> None:
    global gathered_live
    gathered_live -= n


def _hold(t: torch.Tensor) -> torch.Tensor:
    """Count ``t``'s bytes in :data:`gathered_live` until it is freed."""
    global gathered_live, gathered_peak
    n = t.numel() * t.element_size()
    gathered_live += n
    gathered_peak = max(gathered_peak, gathered_live)
    weakref.finalize(t, _release, n)
    return t


class _UnitPlan(NamedTuple):
    """How one unit's parameters cross the mesh: each leaf's spec and its
    dims' layouts, and the axes its gradients are summed over."""

    mesh: object
    specs: tuple
    layouts: tuple
    axes: tuple


def _unit_plan(unit: Unit, specs: dict, mesh, axes) -> _UnitPlan:
    sp = tuple(specs[n] for n in unit.names)
    return _UnitPlan(mesh, sp, tuple(tuple(spec_axes(e) for e in s) for s in sp), axes)


def _gather_unit(plan: _UnitPlan, slices) -> tuple:
    """The full tensors of this rank's slices (a leaf that no axis shards is
    its slice)."""
    fulls = []
    for s, spec in zip(slices, plan.specs):
        full = _gather(s, spec, plan.mesh)
        fulls.append(s if full is s else _hold(full))
    return tuple(fulls)


class _GatherUnit(torch.autograd.Function):
    """One unit's parameters on the mesh: the forward gathers this rank's
    slices into full tensors; the backward sums the full gradients over the
    loss's axes into this rank's slices
    (:func:`~repro_torch.runtime.collectives.reduce_to_blocks`)."""

    @staticmethod
    def forward(ctx, plan: _UnitPlan, *slices):
        ctx.plan = plan
        return _gather_unit(plan, slices)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        return (None, *reduce_to_blocks(list(grads), plan.layouts, plan.mesh, plan.axes))


def _idle_microbatch(plans: dict, params: dict, reduce, width: int, remat: bool, dev) -> dict:
    """What a rank that holds none of a microbatch's rows issues, in the
    order the ranks that hold some issue it, and the slices of the
    microbatch's gradient it receives. The forward gathers each unit; the
    loss sums its split statistics; the backward runs the units in reverse,
    a period gathered again under remat (its recompute), each unit's
    gradient reduced (zeros from this rank)."""
    with torch.no_grad():
        for unit, plan in plans.items():
            _gather_unit(plan, [params[n] for n in unit.names])
        reduce(torch.zeros(width, device=dev))
        grads: dict = {}
        for unit, plan in reversed(plans.items()):
            slices = [params[n] for n in unit.names]
            if remat and unit.kind == "period":
                _gather_unit(plan, slices)
            zeros = [torch.zeros(full_shape(s, spec, plan.mesh), dtype=s.dtype, device=s.device)
                     for s, spec in zip(slices, plan.specs)]
            for n, g in zip(unit.names, reduce_to_blocks(zeros, plan.layouts, plan.mesh,
                                                         plan.axes)):
                grads[n] = grads[n] + g if n in grads else g
    return grads


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
    remat = cfg.remat == "block"

    def reduce(v):
        return all_reduce_sum(v, mesh, loss_axes)

    def accumulate(model, batch):
        """This rank's shares of each microbatch's loss (the reference's
        microbatch ``i`` is rows ``[i * per, (i + 1) * per)`` of the loss's
        rows, which may lie on other ranks only), each microbatch's
        gradient summed over the loss's ranks unit by unit into this rank's
        slices and accumulated there, and the metrics."""
        params = trainable_parameters(model)
        plans = {u: _unit_plan(u, model._train_specs, mesh, loss_axes)
                 for u in model_units(model)}

        def unit_params(unit: Unit) -> dict:
            return dict(zip(unit.names, _GatherUnit.apply(
                plans[unit], *(params[n] for n in unit.names))))

        b = batch["tokens"].shape[0]
        rows = b * n_ranks
        if rows % n_mb:
            raise ValueError(f"global batch {rows} not divisible by microbatches {n_mb}")
        per, first = rows // n_mb, me * b
        dev = batch["tokens"].device
        g_acc = None if n_mb == 1 else {
            n: torch.zeros(p.shape, dtype=acc_dt, device=p.device) for n, p in params.items()}
        terms = []
        for i in range(n_mb):
            lo, hi = max(i * per, first), min((i + 1) * per, first + b)
            if hi <= lo:  # none of microbatch i's rows here: the same collectives, zeros
                grads = _idle_microbatch(plans, params, reduce, width, remat, dev)
                terms.append(torch.zeros(3, device=dev))
            else:
                mb = {k: v[lo - first:hi - first] for k, v in batch.items()}
                total, metrics = loss_fn(model, mb, BatchSplit(per, lo - i * per, reduce),
                                         unit_params)
                grads = _grads(total, params)
                terms.append(torch.stack([total.detach(), metrics["ce"].detach(),
                                          metrics["aux"].detach()]))
            g_acc = grads if n_mb == 1 else {n: a + grads[n].to(acc_dt)
                                             for n, a in g_acc.items()}
            del grads
        inv = 1.0 / n_mb
        if n_mb > 1:
            g_acc = {n: (g * inv).to(params[n].dtype) for n, g in g_acc.items()}
        per_mb = reduce(torch.stack(terms))  # (n_mb, 3): each microbatch's loss, ce, aux
        each = [{"loss": t[0], "ce": t[1], "aux": t[2], "ppl": torch.exp(t[1])} for t in per_mb]
        if n_mb == 1:
            metrics = each[0]
        else:
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in _METRICS}
            for m in each:
                metrics = {k: a + m[k] for k, a in metrics.items()}
            metrics = {k: m * inv for k, m in metrics.items()}
        return metrics, g_acc

    def train_step(state: dict, batch: dict):
        model = state["params"]
        if getattr(model, "_mesh", None) is not mesh:
            raise ValueError("the train state is not placed on this step's mesh: "
                             "place_train_state(state, mesh)")
        specs = model._train_specs
        reducer = compressed_grad_fn(accumulate, mesh, specs) if compress else accumulate
        metrics, grads = reducer(model, batch)
        _, _, opt_metrics = adamw_update(trainable_parameters(model), grads, state["opt"],
                                         run.optimizer, shards=(mesh, specs))
        metrics.update(opt_metrics)
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Abstract state and a rank's bytes
# ---------------------------------------------------------------------------
def abstract_train_state(cfg: ModelConfig, run: TrainRunConfig) -> dict:
    """The train state's shapes and dtypes on the ``meta`` device, nothing
    allocated (the reference's ``abstract_train_state``, its
    ``eval_shape``)."""
    return init_train_state(cfg, run, model=abstract_params(cfg))


def _local_shape(shape, spec, mesh) -> tuple[int, ...]:
    return tuple(n // mesh.axes_size(spec_axes(e)) for n, e in zip(shape, spec))


def mesh_train_bytes(cfg: ModelConfig, run: TrainRunConfig, mesh) -> dict:
    """A rank's training bytes on ``mesh`` (an abstract one serves), from
    the specs of :func:`train_state_shardings` alone: ``state``, its slices
    of the parameters and both moments, and the step; ``grads``, its
    gradient slices (and with microbatches their accumulators in
    ``accum_dtype``); ``gathered``, the full tensors of the units
    (:func:`~repro_torch.models.transformer.model_units`) alive at once:
    under ``remat="block"`` the largest unit's parameters and gradients,
    under ``"none"`` every period's and the head's parameters (autograd
    keeps them) and the largest unit's gradients; ``total``, their sum.
    Activations are not counted."""
    state = abstract_train_state(cfg, run)
    model, opt = state["params"], state["opt"]
    specs = train_state_shardings(state, mesh)["params"]
    params = trainable_parameters(model)
    local = {n: math.prod(_local_shape(p.shape, specs[n], mesh)) for n, p in params.items()}
    state_b = opt["step"].element_size() + sum(
        local[n] * (p.element_size() + opt["m"][n].element_size() + opt["v"][n].element_size())
        for n, p in params.items())
    grads_b = sum(local[n] * p.element_size() for n, p in params.items())
    if run.num_microbatches > 1:
        grads_b += sum(local.values()) * torch_dtype(run.accum_dtype).itemsize
    units = {u: sum(params[n].numel() * params[n].element_size() for n in u.names)
             for u in model_units(model)}
    largest = max(units.values())
    if cfg.remat == "block":
        gathered = 2 * largest
    else:
        gathered = sum(b for u, b in units.items() if u.kind != "embed") + largest
    return {"state": state_b, "grads": grads_b, "gathered": gathered,
            "total": state_b + grads_b + gathered}


__all__ = ["TrainRunConfig", "abstract_train_state", "full_shape", "gather_train_state",
           "init_train_state", "make_train_step", "mesh_train_bytes", "place_train_state",
           "reset_gathered", "train_state_shardings"]
