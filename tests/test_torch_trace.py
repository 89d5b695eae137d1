"""Counting device kernels by name in a ``torch.profiler`` trace, for the
card tests of the port's kernels (``test_torch_*_kernel.py`` import
:func:`complete_trace` and :func:`traced_kernels` from here). This file
imports no JAX.

The profiler can lose the device records of a trace's first kernels (more
of them after earlier traces in the process) and now and then others; it
keeps the host's launch records. So a trace opens with WARMUP short device
sleeps, and a count by name is taken only on a trace in which every launch
after them has a device record. The tests here hold that check to fake
records on the CPU.
"""

import re
from types import SimpleNamespace

import pytest
import torch

#: short device sleeps that open every trace before the traced work
WARMUP = 16
#: kernel launch records of the CUDA runtime and driver APIs
LAUNCH_RECORD = re.compile(r"cu(da)?LaunchKernel")


def launches_recorded(events, skip: int = WARMUP) -> bool:
    """True if every host launch record of ``events`` (kineto events: the
    trace's ``prof.profiler.kineto_results.events()``) after the first
    ``skip`` has a device record with its correlation id."""
    cpu = torch.autograd.DeviceType.CPU
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() == cpu and LAUNCH_RECORD.match(e.name()))
    recorded = {e.correlation_id() for e in events if e.device_type() != cpu}
    return all(c in recorded for _, c in launches[skip:])


def complete_trace(fn, attempts: int = 4):
    """``fn`` under torch.profiler (CPU and CUDA activities), after WARMUP
    short device sleeps and a synchronize, until the trace is complete
    (:func:`launches_recorded`), at most ``attempts`` times; ``fn`` must
    repeat the same work each time. Count its kernels with
    :func:`traced_kernels`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(WARMUP):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        if launches_recorded(prof.profiler.kineto_results.events()):
            return prof
    raise AssertionError(f"the profiler lost device kernel records in {attempts} traces")


def traced_kernels(events):
    """The device records of ``events`` (a trace's ``key_averages()`` or
    ``events()``) without the opening sleeps or annotations."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
            and "spin_kernel" not in e.key]


# ---------------------------------------------------------------------------
# The checks on fake records (CPU)
# ---------------------------------------------------------------------------

class _Kineto:
    """A kineto event as ``launches_recorded`` reads it."""

    def __init__(self, name, corr, start, device):
        self._name, self._corr, self._start, self._device = name, corr, start, device

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


def test_traced_kernels_keep_kernels_and_copies():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(key, device=cuda, annotation=False):
        return SimpleNamespace(key=key, device_type=device, is_user_annotation=annotation)

    events = [ev("quant_rmsnorm_rows"), ev("Memcpy DtoH (Device -> Pageable)"),
              ev("void at::native::spin_kernel(long)"), ev("my_range", annotation=True),
              ev("aten::add", device=cpu)]
    assert [e.key for e in traced_kernels(events)] == [
        "quant_rmsnorm_rows", "Memcpy DtoH (Device -> Pageable)"]
