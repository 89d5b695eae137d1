"""The completeness check of a ``torch.profiler`` trace
(:mod:`repro_torch.trace`) held to fake records on the CPU, and the card
tests' trace helper: ``test_torch_*_kernel.py`` and
``test_torch_decode_graph.py`` import :func:`complete_trace` and
:func:`traced_kernels` from here. This file imports no JAX.

A trace opens with WARMUP short device sleeps, whose records the profiler
may lose; a count by name is taken only on a trace in which every launch
after them has a device record, and every CUDA graph replay as many device
records as its graph has device nodes.
"""

from types import SimpleNamespace

import pytest
import torch

from repro_torch.serving.graphs import COUNTERS, count_kernels
from repro_torch.trace import (
    WARMUP,
    launches_recorded,
    record_gaps,
    replay_spans_ns,
    traced_kernels,
)


def complete_trace(fn, attempts: int = 4, graph_ops: int | None = None):
    """``fn`` under torch.profiler (CPU and CUDA activities), after WARMUP
    short device sleeps and a synchronize, until the trace is complete
    (:func:`launches_recorded`; ``graph_ops`` device records a graph
    replay), at most ``attempts`` times; ``fn`` must repeat the same work
    each time. Count its kernels with :func:`traced_kernels`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(WARMUP):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        if launches_recorded(prof.profiler.kineto_results.events(), graph_ops=graph_ops):
            return prof
    raise AssertionError(f"the profiler lost device kernel records in {attempts} traces")


# ---------------------------------------------------------------------------
# The checks on fake records (CPU)
# ---------------------------------------------------------------------------

class _Kineto:
    """A kineto event as ``launches_recorded`` reads it (a record 1 ns
    long)."""

    def __init__(self, name, corr, start, device):
        self._name, self._corr, self._start, self._device = name, corr, start, device

    def end_ns(self):
        return self._start + 1

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def device_type(self):
        return self._device


def _trace(n_launches, lost=(), api="cudaLaunchKernel"):
    """Host launch records 0..n-1 (correlation ids 100 + i), a device record
    for each id not in ``lost``, and host records of other calls."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Kineto("cudaStreamSynchronize", 1, 0, cpu)]
    for i in range(n_launches):
        events.append(_Kineto(api, 100 + i, 10 * i, cpu))
        if i not in lost:
            events.append(_Kineto(f"kernel_{i}", 100 + i, 10 * i + 5, cuda))
    return events[::-1]  # the records' order is not the launches' order


@pytest.mark.parametrize("api", ["cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"])
def test_complete_trace_holds_every_launch(api):
    assert launches_recorded(_trace(WARMUP + 5, api=api))


@pytest.mark.parametrize("lost", [(WARMUP,), (WARMUP + 4,), (0, WARMUP + 2)])
def test_lost_device_record_after_warmup_is_incomplete(lost):
    assert not launches_recorded(_trace(WARMUP + 5, lost=lost))


def test_lost_warmup_records_do_not_count():
    """The sleeps that open the trace may lose their records: they are
    there to take the loss."""
    assert launches_recorded(_trace(WARMUP + 3, lost=range(WARMUP)))


def _graph_trace(ops_recorded, n_kernels=WARMUP + 2, api="cudaGraphLaunch"):
    """A complete kernel trace, then one graph launch (correlation id 900)
    with ``ops_recorded`` device records."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = _trace(n_kernels) + [_Kineto(api, 900, 10_000, cpu)]
    events += [_Kineto(f"node_{i}", 900, 10_005 + i, cuda) for i in range(ops_recorded)]
    return events


@pytest.mark.parametrize("api", ["cudaGraphLaunch", "cuGraphLaunch"])
def test_graph_replay_complete_with_every_node(api):
    assert launches_recorded(_graph_trace(40, api=api), graph_ops=40)


@pytest.mark.parametrize("recorded,graph_ops", [(39, 40), (41, 40), (40, None), (0, 40)])
def test_graph_replay_with_lost_or_unknown_nodes_is_incomplete(recorded, graph_ops):
    """A replay that lost a node's record, or one whose graph's node count
    the caller did not give, leaves the trace incomplete."""
    assert not launches_recorded(_graph_trace(recorded), graph_ops=graph_ops)


@pytest.mark.parametrize("lost", [(), (0, 3), (WARMUP + 1,), tuple(range(WARMUP + 4))])
def test_record_gaps_name_the_lost_launches(lost):
    """The gaps are the launches without a device record, in launch order,
    whatever the order of the records."""
    assert record_gaps(_trace(WARMUP + 4, lost=lost)) == (sorted(lost), [])


def test_record_gaps_count_each_replays_records():
    assert record_gaps(_graph_trace(37)) == ([], [37])


def test_traced_kernels_keep_kernels_and_copies():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(key, device=cuda, annotation=False):
        return SimpleNamespace(key=key, device_type=device, is_user_annotation=annotation)

    events = [ev("quant_rmsnorm_rows"), ev("Memcpy DtoH (Device -> Pageable)"),
              ev("void at::native::spin_kernel(long)"), ev("my_range", annotation=True),
              ev("aten::add", device=cpu)]
    assert [e.key for e in traced_kernels(events)] == [
        "quant_rmsnorm_rows", "Memcpy DtoH (Device -> Pageable)"]


def test_replay_span_runs_from_first_to_last_device_record():
    """A replay's device span: its first record's start to its last one's
    end, whatever the order of the records; launches outside graphs have
    none."""
    assert replay_spans_ns(_graph_trace(40)) == [40]
    assert replay_spans_ns(_graph_trace(40)[::-1]) == [40]
    assert replay_spans_ns(_trace(WARMUP + 2)) == []


#: mangled names of the port's kernels as a graph's kernel nodes give them
_W4A8 = "_ZN12_GLOBAL__N_111w4a8_kernelILi{}ELb{}ELb{}ELb{}E{}EEvNS_7ProblemE"
_NODES = [_W4A8.format(16, 0, 0, 0, "f"), _W4A8.format(4, 1, 0, 0, "13__nv_bfloat16"),
          _W4A8.format(16, 0, 1, 0, "13__nv_bfloat16"),
          _W4A8.format(16, 0, 0, 1, "13__nv_bfloat16"), _W4A8.format(4, 1, 0, 1, "f"),
          _W4A8.format(16, 1, 1, 1, "13__nv_bfloat16"),
          "_ZN12_GLOBAL__N_123paged_attn_float_kernelI13__nv_bfloat16tLi3EEEvPKT_",
          "_ZN12_GLOBAL__N_122paged_attn_int8_kernelI13__nv_bfloat16Li3EEEvPKT_",
          "_ZN12_GLOBAL__N_118quant_rmsnorm_rowsILb1ELi8ELi1ELi128EEEvPKv",
          "_ZN12_GLOBAL__N_120quant_rmsnorm_stagedILb0ELi4EEEvPKv",
          "_ZN12_GLOBAL__N_118empty_probe_kernelEv",
          "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIiEEEEviT0_T1_",
          "_ZN12_GLOBAL__N_116gpfq_gram_kernelEPKfS1_Pfii"]


def test_graph_kernels_are_counted_by_name():
    """A graph's kernel nodes counted for each launch counter: B1 dense and
    B4 2:4 apart by w4a8_kernel's Sparse argument and both apart from their
    expert-axis forms B1e and B4e by its Experts argument, B2 and B3 apart,
    B6's two forms and not its probe, and no library kernel or gpfq_solve
    kernel."""
    counts = dict(zip(((fn.__name__, attr) for fn, attr, _ in COUNTERS),
                      count_kernels(_NODES)))
    assert counts == {("w4a8_matmul", "launches"): 2, ("w4a8_sparse_matmul", "launches"): 1,
                      ("w4a8_expert_matmul", "launches"): 2,
                      ("w4a8_sparse_expert_matmul", "launches"): 1,
                      ("paged_decode_attention", "launches"): 1,
                      ("paged_decode_attention", "int8_launches"): 1,
                      ("quant_rmsnorm", "launches"): 2, ("gpfq_solve", "launches"): 0,
                      ("gpfq_solve", "masked_launches"): 0, ("gpfq_solve", "device_kernels"): 0}
