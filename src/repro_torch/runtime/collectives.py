"""Collectives over a mesh axis group, and the relayout of one dimension
between shardings (no reference counterpart: the reference's GSPMD
partitioner inserts these itself).

Every reduction is written on ``all_reduce``, which gloo runs on CUDA
tensors too (staging through the host) and NCCL runs inside a captured
CUDA graph. Under NCCL a gather is ``all_gather_into_tensor``; under gloo
it fills a zeroed full buffer with the local slice and sums over the
group, summing the *bits* (the buffer viewed as int32, or bytes), at most
one rank contributing a nonzero to each element, so the gathered value is
exact in any dtype (this moves the group size times the bytes of a
gather).

A layout is the tuple of mesh axes a dimension is sharded over, the first
major; ``()`` is replicated. ``calls`` and ``bytes`` count the collectives
issued on the host (a captured step counts at its capture) and the bytes
of their buffers.

:func:`reduce_to_blocks` is the mesh train step's gradient sum: full
tensors summed over the loss's axes, each rank keeping its block. Under
NCCL a tensor whose sharded dim lies on the reduced axes goes through
``reduce_scatter_tensor``; gloo, which has none, all-reduces the same
buffer and keeps the rank's row.
"""

from __future__ import annotations

import torch

#: collectives issued and the bytes of their buffers, since the last reset
calls = 0
nbytes = 0


def reset_counts() -> None:
    global calls, nbytes
    calls = nbytes = 0


def _count(x: torch.Tensor) -> None:
    global calls, nbytes
    calls += 1
    nbytes += x.numel() * x.element_size()


def all_reduce_sum(x: torch.Tensor, mesh, axes, *, exact: bool = False) -> torch.Tensor:
    """Sum ``x`` over the ranks that differ on ``axes``, in place; returns
    ``x``. ``exact``: at most one rank holds a nonzero in each element, and
    the bits are summed (so any dtype is exact, NaN and -0.0 included)."""
    import torch.distributed as dist

    if not axes:
        return x
    buf = _bits(x) if exact else x
    _count(buf)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return x


def all_reduce_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks that differ on ``axes``,
    in place; returns ``x``."""
    import torch.distributed as dist

    if not axes:
        return x
    _count(x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return x


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s storage as integers: int32 where its bytes allow, else uint8."""
    flat = x.reshape(-1).view(torch.uint8)
    return flat.view(torch.int32) if flat.numel() % 4 == 0 else flat


def shard_range(length: int, mesh, axes) -> tuple[int, int]:
    """This rank's [lo, hi) of a dimension of ``length`` sharded over ``axes``."""
    if not axes:
        return 0, length
    size = length // mesh.axes_size(axes)
    lo = mesh.index(axes) * size
    return lo, lo + size


def gather_dim(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The full tensor of a dimension sharded over ``axes`` (``x`` this
    rank's block): under NCCL an ``all_gather_into_tensor``, the blocks put
    in shard order; under gloo a zeroed buffer holding the local block,
    summed bitwise over the group."""
    if not axes:
        return x
    dim = dim % x.dim()
    if mesh.backend == "nccl":
        return _all_gather(x, dim, mesh, axes)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.axes_size(axes)
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, mesh.index(axes) * n, n).copy_(x)
    return all_reduce_sum(full, mesh, axes, exact=True)


def _all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    import torch.distributed as dist

    group = mesh.group(axes)
    shard, _ = _group_shards(mesh, axes)
    out = torch.empty((len(shard) * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _count(out)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    if dim == 0 and shard == sorted(shard):
        return out
    blocks = out.chunk(len(shard))
    return torch.cat([blocks[shard.index(i)] for i in range(len(shard))], dim=dim)


def _live(layout, mesh) -> tuple:
    return tuple(a for a in layout if mesh.shape[a] > 1)


def reduce_to_blocks(xs: list, layouts: list, mesh, axes) -> list:
    """Each full tensor of ``xs`` summed over the ranks that differ on
    ``axes``, as this rank's block: ``layouts[i][d]`` is the layout of dim
    ``d`` of ``xs[i]``. A tensor is first cut to its block on the dims
    whose layouts hold none of ``axes`` (every rank summed with holds the
    same block there). One with a single dim sharded over some of
    ``axes`` alone is reduce-scattered over those axes (one collective per
    dtype and those axes, the blocks in the group's rank order), then
    summed over the rest of ``axes``; any other is all-reduced (one
    collective per dtype) and then cut. Every rank of a group issues the
    same collectives: the choice depends on the layouts alone."""
    axes = _live(axes, mesh)
    out: list = [None] * len(xs)
    plain: dict = {}
    scatter: dict = {}
    for i, (x, layout) in enumerate(zip(xs, layouts)):
        later = []
        for d, lay in enumerate(layout):
            lay = _live(lay, mesh)
            if lay and not set(lay) & set(axes):
                x = x.narrow(d, *_lo_size(x.shape[d], mesh, lay))
            elif lay:
                later.append((d, lay))
        if not axes:
            out[i] = x
        elif len(later) == 1 and set(later[0][1]) <= set(axes):
            d, lay = later[0]
            scatter.setdefault((x.dtype, lay), []).append((i, d, x))
        else:
            plain.setdefault(x.dtype, []).append((i, later, x))
    for items in plain.values():
        flat = torch.cat([x.reshape(-1) for _, _, x in items])
        all_reduce_sum(flat, mesh, axes)
        lo = 0
        for i, later, x in items:
            y = flat[lo:lo + x.numel()].view(x.shape)
            lo += x.numel()
            for d, lay in later:
                y = y.narrow(d, *_lo_size(y.shape[d], mesh, lay))
            out[i] = y.clone() if later else y
    for (_, lay), items in scatter.items():
        n = mesh.axes_size(lay)
        order, me = _group_shards(mesh, lay)
        rows = torch.cat([x.movedim(d, 0).reshape(n, -1)[order] for _, d, x in items], dim=1)
        mine = _reduce_scatter_rows(rows, mesh, lay, me)
        rest = tuple(a for a in axes if a not in lay)
        if rest:
            all_reduce_sum(mine, mesh, rest)
        lo = 0
        for i, d, x in items:
            size = x.numel() // n
            shape = (x.shape[d] // n, *x.movedim(d, 0).shape[1:])
            out[i] = mine[lo:lo + size].view(shape).movedim(0, d).contiguous()
            lo += size
    return out


def _lo_size(length: int, mesh, axes) -> tuple[int, int]:
    lo, hi = shard_range(length, mesh, axes)
    return lo, hi - lo


def _group_shards(mesh, axes) -> tuple[list, int]:
    """The shard index of each rank of the group over ``axes``, in the
    group's rank order, and this rank's position in it."""
    import torch.distributed as dist

    group = mesh.group(axes)
    members = (dist.get_process_group_ranks(group) if group is not None
               else range(dist.get_world_size()))
    shard = [mesh.index(axes, r) for r in members]
    return shard, shard.index(mesh.index(axes))


def _reduce_scatter_rows(rows: torch.Tensor, mesh, axes, me: int) -> torch.Tensor:
    """Row ``me`` of ``rows`` (one row a rank of the group over ``axes``,
    in the group's rank order) summed over the group."""
    import torch.distributed as dist

    if mesh.backend != "nccl":
        return all_reduce_sum(rows, mesh, axes)[me].clone()
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    _count(rows)
    dist.reduce_scatter_tensor(out, rows.reshape(-1), group=mesh.group(axes))
    return out


def relayout(x: torch.Tensor, dim: int, have, want, mesh) -> torch.Tensor:
    """Move dimension ``dim`` of ``x`` from layout ``have`` to ``want``: a
    local slice where ``want`` refines ``have`` (``have``'s axes of more
    than one rank lead ``want``'s: replicated to sharded, or to a finer
    sharding), so every rank's ``want`` block lies inside its ``have``
    block; else a gather over ``have`` and a slice. The choice depends on
    the layouts alone, so every rank of a group issues the same
    collectives."""
    have, want = tuple(have), tuple(want)
    if have == want:
        return x
    dim = dim % x.dim()
    length = x.shape[dim] * mesh.axes_size(have)
    h_lo, _ = shard_range(length, mesh, have)
    w_lo, w_hi = shard_range(length, mesh, want)
    # axes of size 1 split nothing: ("model", "data") on a (1, tp) mesh is ("model",)
    h, w = ([a for a in axes if mesh.shape[a] > 1] for axes in (have, want))
    if w[:len(h)] != h:
        x = gather_dim(x, dim, mesh, have)
        h_lo = 0
    return x.narrow(dim, w_lo - h_lo, w_hi - w_lo)


__all__ = ["all_reduce_max", "all_reduce_sum", "gather_dim", "reduce_to_blocks", "relayout",
           "reset_counts", "shard_range"]
