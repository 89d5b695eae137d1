"""One decode step captured as a CUDA graph and replayed: the port's
counterpart of the reference's compiled decode loops
(``repro/serving/engine.py`` ``_gen_impl``, a ``lax.while_loop`` in one
jitted program, and ``repro/serving/paged_engine.py`` ``_chunk_impl``).

A :class:`StepProgram` wraps a step function that reads and writes only
tensors that outlive it: the engine's static buffers (caches, device
position, tokens). On CUDA its first run executes the step once for real
on a side stream, which loads every kernel library, makes the paged
attention kernels' per-stream buffers and warms cuBLAS on that stream, and
then captures the step on the same stream into a ``torch.cuda.CUDAGraph``.
Every later step is a replay: one graph launch, no per-op host work and no
host read. On the CPU every run calls the step eagerly: the same
static-buffer step, the plain path the tests take.

The kernels' launch counters rise during a capture by what one step
launches, though a capture runs nothing. That rise is taken back after the
capture. What one replay launches is then read from the graph itself: the
captured kernel nodes are walked and each counted kernel is found by its
name (:data:`COUNTERS`). The capture raises unless that count equals the
wrappers' rise, and each replay adds it, so a counter still says how many
times its kernel ran on the device.

A failed capture or replay raises; nothing falls back to eager on CUDA.

:func:`record_step` builds one step's program text without replaying
anything (``PagedEngine.decode_step_program``): a throwaway capture on
CUDA, read and freed, or one eager run on the CPU, with the aten ops
dispatched during it recorded by a :class:`ProgramRecorder`.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import re
import time
from contextlib import nullcontext
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.gpfq_solve import gpfq_solve
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.quant_rmsnorm import quant_rmsnorm
from repro_torch.kernels.w4a8_mm import (
    w4a8_expert_matmul,
    w4a8_matmul,
    w4a8_sparse_expert_matmul,
    w4a8_sparse_matmul,
)
from repro_torch.models.layers import tapping

#: every kernel wrapper's launch counter, as (wrapper, attribute, pattern
#: of its kernel's mangled name); a wrapper adds one a launch, and each of
#: these kernels is one launch. B1e and B4e launch either tier of the
#: expert axis: the tile kernel with ``Experts`` set, or the decode tier's
#: ``w4a8_expert_decode_kernel``, its third argument ``Sparse``.
#: gpfq_solve's counters have no pattern: its solve is never captured, so
#: a capture must not move them.
COUNTERS = (
    (w4a8_matmul, "launches", re.compile(r"w4a8_kernelILi\d+ELb[01]ELb0ELb0E")),
    (w4a8_sparse_matmul, "launches", re.compile(r"w4a8_kernelILi\d+ELb[01]ELb1ELb0E")),
    (w4a8_expert_matmul, "launches", re.compile(
        r"w4a8_kernelILi\d+ELb[01]ELb0ELb1E|w4a8_expert_decode_kernelILi\d+ELb[01]ELb0E")),
    (w4a8_sparse_expert_matmul, "launches", re.compile(
        r"w4a8_kernelILi\d+ELb[01]ELb1ELb1E|w4a8_expert_decode_kernelILi\d+ELb[01]ELb1E")),
    (paged_decode_attention, "launches", re.compile(r"paged_attn_float_kernel")),
    (paged_decode_attention, "int8_launches", re.compile(r"paged_attn_int8_kernel")),
    (quant_rmsnorm, "launches", re.compile(r"quant_rmsnorm_(rows|staged)")),
    (gpfq_solve, "launches", None), (gpfq_solve, "masked_launches", None),
    (gpfq_solve, "device_kernels", None))

#: graph node types that run on the device: CU_GRAPH_NODE_TYPE_KERNEL,
#: _MEMCPY and _MEMSET (cuda.h)
_KERNEL_NODE = 0
_DEVICE_NODE_TYPES = (0, 1, 2)


def _counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr, _ in COUNTERS]


def _add_counts(delta, times: int) -> None:
    for (fn, attr, _), d in zip(COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + d * times)


def count_kernels(names) -> list[int]:
    """How many of the kernel ``names`` (mangled) each of :data:`COUNTERS`
    counts."""
    return [0 if pat is None else sum(1 for n in names if pat.search(n))
            for _, _, pat in COUNTERS]


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.cache
def _driver() -> ctypes.CDLL:
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphKernelNodeGetParams_v2.argtypes = [ctypes.c_void_p,
                                                 ctypes.POINTER(_KernelNodeParams)]
    for fn in (cu.cuFuncGetName, cu.cuKernelGetName):
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    return cu


def _check(err: int, call: str) -> None:
    if err:
        raise RuntimeError(f"{call} failed: CUDA driver error {err}")


def graph_contents(graph: torch.cuda.CUDAGraph) -> tuple[int, list[str]]:
    """The device operations of a captured graph (kept with
    ``keep_graph=True``): its kernel, copy and fill nodes, the device
    records one replay leaves in a profiler trace under its one correlation
    id; and its kernel nodes' mangled function names."""
    cu = _driver()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    params = _KernelNodeParams()
    name = ctypes.c_char_p()
    known: dict[int, str] = {}  # a function's name, by its handle
    ops, names = 0, []
    for node in nodes:
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        ops += kind.value in _DEVICE_NODE_TYPES
        if kind.value != _KERNEL_NODE:
            continue
        _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        handle = params.func or params.kern
        if handle not in known:
            if params.func:
                _check(cu.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
            else:
                _check(cu.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
            known[handle] = name.value.decode()
        names.append(known[handle])
    return ops, names


class StepProgram:
    """``step`` run ``n`` times by :meth:`run`: eagerly on the CPU, as
    replays of one captured CUDA graph on ``device`` when it is CUDA.

    After the first CUDA run: ``rise`` is what one replay adds to each of
    :data:`COUNTERS`, counted by name in the graph, ``device_ops`` the
    device operations one replay runs, ``names`` its kernel nodes' names,
    ``capture_s`` the host seconds of the first run (the real warm-up
    step, the capture, the walk of the graph's nodes and its
    instantiation) and ``walk_s`` those of the walk. :meth:`close` frees
    the graph."""

    def __init__(self, step, device):
        self.step = step
        self.device = torch.device(device)
        self.graph = None
        self.rise = [0] * len(COUNTERS)
        self.device_ops = 0
        self.names: list[str] = []
        self.capture_s = self.walk_s = None
        self.replays = 0

    def run(self, n: int = 1) -> None:
        if self.device.type != "cuda":
            for _ in range(n):
                self.step()
            return
        if n > 0 and self.graph is None:
            self._capture()
            n -= 1
        for _ in range(n):
            self.graph.replay()
        _add_counts(self.rise, n)
        self.replays += n

    def _capture(self, during=None) -> None:
        """The warm-up step, then the capture (inside ``during``, a context
        such as a :class:`ProgramRecorder`, when given)."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.step()  # the warm-up is a real step
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _counts()
        # an unreachable graph that the cyclic collector frees mid-capture
        # frees device memory, which invalidates the capture: collect first,
        # and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side), during or nullcontext():
                self.step()
        finally:
            if collecting:
                gc.enable()
        counted = [a - b for a, b in zip(_counts(), before)]
        _add_counts(counted, -1)  # the capture ran nothing
        t1 = time.perf_counter()
        self.device_ops, self.names = graph_contents(graph)
        self.rise = count_kernels(self.names)
        self.walk_s = time.perf_counter() - t1
        if self.rise != counted:
            raise RuntimeError(f"the captured step holds {self.rise} of the counted kernels "
                               f"{[f'{fn.__name__}.{a}' for fn, a, _ in COUNTERS]}, its "
                               f"wrappers counted {counted} launches during the capture")
        graph.instantiate()
        current.wait_stream(side)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def close(self) -> None:
        """Free the graph and its private memory pool, and drop the step
        (whose closure holds the buffers it reads)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.step = None


class ProgramRecorder(TorchDispatchMode):
    """Records the aten ops dispatched inside it, in order, each as (name,
    dispatched by a serving tap (:func:`~repro_torch.models.layers.tapping`),
    the storages of the arguments its schema marks as written, by data
    pointer). A write is recognised by the op's schema alone; kernels
    called through ``ctypes`` are not ops and are not recorded."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, bool, frozenset]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        written = set()
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(t, torch.Tensor):
                    written.add(t.untyped_storage().data_ptr())
        self.ops.append((str(func), tapping(), frozenset(written)))
        return func(*args, **kwargs)


@dataclass(frozen=True)
class ProgramText:
    """One step's program: ``ops`` as a :class:`ProgramRecorder` saw them;
    on CUDA ``nodes``, the kernel nodes' names of its captured graph, and
    ``device_ops``, the graph's device operations."""

    ops: tuple
    nodes: tuple | None = None
    device_ops: int | None = None

    @property
    def op_names(self) -> tuple:
        return tuple(n for n, _, _ in self.ops)

    @property
    def text(self) -> tuple:
        """The kernel nodes' names on CUDA, the ops' names on the CPU."""
        return self.nodes if self.nodes is not None else self.op_names

    def untapped(self) -> tuple:
        """The names of the ops no tap dispatched."""
        return tuple(n for n, tap, _ in self.ops if not tap)

    def taps(self) -> int:
        return sum(tap for _, tap, _ in self.ops)

    def writes(self, storage: int) -> bool:
        """Whether an op writes the storage at data pointer ``storage``."""
        return any(storage in w for _, _, w in self.ops)


def record_step(step, device) -> ProgramText:
    """The program of one ``step`` on ``device``, replaying nothing: on CUDA
    a throwaway :class:`StepProgram` whose warm-up is a real step (its
    launches count) and whose capture is recorded, read and freed (its
    counted rise taken back, as for any capture); on the CPU one eager
    step, recorded."""
    device = torch.device(device)
    rec = ProgramRecorder()
    if device.type != "cuda":
        with rec:
            step()
        return ProgramText(tuple(rec.ops))
    program = StepProgram(step, device)
    try:
        program._capture(during=rec)
        return ProgramText(tuple(rec.ops), tuple(program.names), program.device_ops)
    finally:
        program.close()


__all__ = ["COUNTERS", "ProgramRecorder", "ProgramText", "StepProgram", "count_kernels",
           "graph_contents", "record_step"]
