"""Gradient compression for the cross-pod axis (port of
``repro/runtime/compression.py``).

Each gradient leaf is scaled by its absmax over the pods (a MAX
all-reduce), rounded half to even to int8 codes in [-127, 127], the codes
summed as int32 over the pods and dequantized, the reference's order of
operations: ``scale = max(absmax, 1e-30) / 127``, ``q = clip(rint(g /
scale), -127, 127)``, ``(sum(q) * scale).to(g.dtype)``. Error feedback is
left out, as in the reference. The reference runs this inside a
partial-manual ``shard_map`` over ``pod`` (``shard_map_compat``); the port
has no counterpart of that wrapper: a rank already holds its pod's rows and
gradient, and the two all-reduces run over the mesh's ``pod`` group
(:mod:`repro_torch.runtime.collectives`). All leaves share one MAX
all-reduce and one int32 SUM all-reduce. A rank may hold its slices of the
leaves (the mesh train step's gradient): the MAX then runs over the leaves'
sharded axes too, so every slice takes its whole leaf's absmax, and the
codes are the whole leaf's.
"""

from __future__ import annotations

import torch

from repro_torch.runtime.collectives import all_reduce_max, all_reduce_sum
from repro_torch.runtime.sharding import spec_axes


def int8_codes(g: torch.Tensor, absmax: torch.Tensor):
    """(int8 codes, f32 scale) of ``g`` under the group's ``absmax``."""
    scale = torch.clamp(absmax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_psum(tree: dict, mesh, axes, specs: dict | None = None) -> dict:
    """The compressed sum of every leaf of ``tree`` (a dict of tensors)
    over the ranks that differ on ``axes``; each leaf keeps its dtype.
    With ``specs`` (a spec by name) each leaf is this rank's slice under
    its spec, and the absmax is taken over the whole leaf."""
    names = list(tree)
    absmax = torch.stack([torch.max(torch.abs(tree[n].to(torch.float32))) for n in names])
    sharded = {a for n in names for e in (specs or {}).get(n, ()) for a in spec_axes(e)
               if mesh.shape[a] > 1}
    all_reduce_max(absmax, mesh, tuple(axes) + tuple(a for a in mesh.axis_names
                                                     if a in sharded and a not in axes))
    codes, scales = zip(*(int8_codes(tree[n], absmax[i]) for i, n in enumerate(names)))
    total = torch.cat([q.reshape(-1).to(torch.int32) for q in codes])
    all_reduce_sum(total, mesh, axes)
    out, lo = {}, 0
    for n, q, scale in zip(names, codes, scales):
        t = total[lo:lo + q.numel()].view(q.shape)
        lo += q.numel()
        out[n] = (t.to(torch.float32) * scale).to(tree[n].dtype)
    return out


def compressed_grad_fn(grad_fn, mesh, specs: dict | None = None):
    """Wrap ``grad_fn(*args) -> (metrics, grads)``, which gives each pod's
    metrics and gradient, so that the gradient is summed over ``pod``
    through :func:`int8_psum` and divided by the pod count, and the metrics
    averaged over the pods. ``specs``: those of the slices ``grads`` holds
    (:func:`int8_psum`'s). Without a ``pod`` axis (or without a mesh)
    ``grad_fn`` itself."""
    if mesh is None or "pod" not in mesh.shape:
        return grad_fn
    n = mesh.shape["pod"]

    def wrapped(*args):
        metrics, grads = grad_fn(*args)
        grads = {k: g / n for k, g in int8_psum(grads, mesh, ("pod",), specs).items()}
        keys = list(metrics)
        vec = all_reduce_sum(torch.stack([metrics[k] for k in keys]), mesh, ("pod",))
        return {k: vec[i] / n for i, k in enumerate(keys)}, grads

    return wrapped


__all__ = ["compressed_grad_fn", "int8_codes", "int8_psum"]
