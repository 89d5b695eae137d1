"""Mesh factories over ``torch.distributed`` (port of
``repro/launch/mesh.py``). Functions, not module-level constants: importing
this module touches no device and no process group.

One process per device is the model. Each process initialises its own
default process group: NCCL on CUDA, gloo on the CPU, rendezvous from the
usual ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` environment
(``torchrun`` sets it) or from a ``file://`` init method. The ranks form a
row-major grid over the mesh's axes, as the reference's device array:
1-D ``(data,)``, 2-D ``(data, model)``, 3-D ``(pod, data, model)``. Rank
``r`` runs on ``cuda:{LOCAL_RANK}`` unless the caller names one device for
every rank (two ranks sharing one card must use gloo: NCCL refuses two
ranks on one device).

A :class:`Mesh` holds the axis names and sizes, this rank's coordinates,
one process group for each set of axes (the rules shard a dimension over
one axis or over a tuple such as ``("model", "data")``), and its device.
:class:`AbstractMesh` has the shape alone, no process group: the analytic
budget (``launch/dryrun.py``) and the spec tests evaluate the sharding
rules on it at any size.

The production meshes keep the reference's shapes, (16, 16) and
(2, 16, 16). On the card's machines a model axis wider than one 8-GPU node
crosses the network; nothing here models that.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field

import torch

#: axis names by mesh rank, as in the reference
AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape alone: ``axis_names`` and ``axis_sizes`` (the
    reference's ``jax.sharding.AbstractMesh``)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def axes_size(self, axes) -> int:
        """The number of shards a dimension sharded over ``axes`` has."""
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n


@dataclass(frozen=True)
class Mesh(AbstractMesh):
    """A mesh of ranks: :class:`AbstractMesh` plus this rank, its
    coordinates on each axis, its device, the backend and one process group
    per set of axes (:meth:`group`)."""

    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    _groups: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (row-major rank order)."""
        return self.coords_of(self.rank)

    def coords_of(self, rank: int) -> dict[str, int]:
        """The coordinate of ``rank`` on each axis."""
        out, r = {}, rank
        for name, size in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = r % size
            r //= size
        return {n: out[n] for n in self.axis_names}

    def index(self, axes, rank: int | None = None) -> int:
        """This rank's (or ``rank``'s) shard along a dimension sharded over
        ``axes``, the first axis major (a ``PartitionSpec`` entry
        ``("model", "data")`` puts shard ``m * dp + d`` on rank (d, m))."""
        idx, c = 0, self.coords_of(self.rank if rank is None else rank)
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only on
        ``axes`` (any order), or None for the default group (all ranks)."""
        return self._groups[frozenset(axes)]

    @property
    def captures_collectives(self) -> bool:
        """Whether a decode step with this mesh's collectives inside can be
        captured as a CUDA graph: NCCL's can, gloo's stage through the host
        and run eagerly."""
        return self.backend == "nccl"


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _local_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def init_distributed(*, device=None, backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout: float | None = None) -> None:
    """Initialise this process's default process group, once. ``device``
    (default ``cuda:{LOCAL_RANK}``, or the CPU without a card) picks the
    backend unless ``backend`` is given; ``init_method`` defaults to the
    environment (``env://``), and ``rank``/``world_size`` to ``RANK`` and
    ``WORLD_SIZE``; ``timeout`` (seconds) bounds how long a collective
    waits for the other ranks."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if rank is not None or "RANK" not in os.environ:
        kw["rank"] = 0 if rank is None else rank
    if world_size is not None or "WORLD_SIZE" not in os.environ:
        kw["world_size"] = 1 if world_size is None else world_size
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if kw.get("world_size", 1) != 1:
            raise RuntimeError("no rendezvous: set MASTER_ADDR/MASTER_PORT (torchrun does) or "
                               "pass init_method='file://...'")
        # a lone rank rendezvous with itself through a store of its own
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(backend or _backend_for(dev), **kw)


def _build(shape: tuple[int, ...], *, device=None, backend=None, init_method=None, rank=None,
           world_size=None, timeout=None) -> Mesh:
    import torch.distributed as dist

    if len(shape) not in AXES or any(int(s) < 1 for s in shape):
        raise ValueError(f"mesh shape {shape}: 1, 2 or 3 positive sizes expected")
    names = AXES[len(shape)]
    init_distributed(device=device, backend=backend, init_method=init_method, rank=rank,
                     world_size=world_size, timeout=timeout)
    world = dist.get_world_size()
    me = dist.get_rank()
    size = 1
    for s in shape:
        size *= int(s)
    if size != world:
        raise ValueError(f"mesh {tuple(shape)} holds {size} ranks, the world has {world}")
    grid = torch.arange(world).reshape(tuple(int(s) for s in shape))
    groups = {}
    # every rank creates every group, in the same order (new_group is collective)
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), n):
            key = frozenset(names[a] for a in axes)
            if len(axes) == len(names) or all(shape[a] == 1 for a in range(len(names))
                                              if a not in axes):
                groups[key] = None  # every rank: the default group
                continue
            rest = [a for a in range(len(names)) if a not in axes]
            moved = grid.permute(*rest, *axes).reshape(-1, size // _prod(shape, rest))
            for ranks in moved.tolist():
                g = dist.new_group(ranks)
                if me in ranks:
                    groups[key] = g
    dev = _local_device(device)
    return Mesh(names, tuple(int(s) for s in shape), rank=me, device=dev,
                backend=dist.get_backend(), _groups=groups)


def _prod(shape, axes) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False):
    """The reference's production serving meshes: (16, 16) ``(data, model)``
    or, with ``multi_pod``, (2, 16, 16) ``(pod, data, model)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, abstract=abstract)


def make_mesh(shape: tuple[int, ...], *, abstract: bool = False, **init):
    """Elastic mesh: 1D -> (data,), 2D -> (data, model), 3D -> (pod, data,
    model). ``abstract`` gives the shape alone (no process group); otherwise
    the product must equal the world size, and ``init`` goes to
    :func:`init_distributed`."""
    shape = tuple(int(s) for s in shape)
    if abstract:
        if len(shape) not in AXES:
            raise ValueError(f"mesh shape {shape}: 1, 2 or 3 sizes expected")
        return AbstractMesh(AXES[len(shape)], shape)
    return _build(shape, **init)


def make_host_mesh(**init) -> Mesh:
    """Every rank of the world as a data-parallel mesh (tests, smoke)."""
    import torch.distributed as dist

    init_distributed(**init)
    return make_mesh((dist.get_world_size(),), **init)


def parse_mesh_spec(spec: str, **init) -> Mesh:
    """``"dp,tp"`` (e.g. ``"2,4"``) -> a (data, model) serving mesh over the
    world's ranks; the product must equal the world size, so each rank
    passes the same spec and gets the same mesh. ``"auto"`` spreads every
    rank over the data axis."""
    import torch.distributed as dist

    if spec == "auto":
        init_distributed(**init)
        return make_mesh((dist.get_world_size(),), **init)
    try:
        shape = tuple(int(x) for x in spec.split(","))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r} is not 'dp,tp' integers (e.g. '2,4') or 'auto'")
    if len(shape) != 2 or any(s < 1 for s in shape):
        raise SystemExit(f"--mesh {spec!r}: exactly two positive factors dp,tp expected")
    init_distributed(**init)
    n = dist.get_world_size()
    if shape[0] * shape[1] != n:
        raise SystemExit(f"--mesh {spec!r}: dp*tp = {shape[0] * shape[1]} but {n} global "
                         f"devices are visible")
    return make_mesh(shape, **init)


__all__ = ["AXES", "AbstractMesh", "Mesh", "init_distributed", "make_host_mesh", "make_mesh",
           "make_production_mesh", "parse_mesh_spec"]
