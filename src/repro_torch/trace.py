"""Counting device work in a ``torch.profiler`` trace: the one check of a
trace's completeness, shared by ``chip_smoke.py`` and the card tests.

The profiler can lose the device records of a trace's first kernels (more
of them after earlier traces in the process) and now and then others; it
keeps the host's launch records. So a trace opens with :data:`WARMUP` short
device sleeps, and a count by name is taken only on a trace in which every
launch after them has a device record. A CUDA graph replay is one host
record (``cudaGraphLaunch``) whose device records, one per kernel, copy and
fill node of the graph, all carry its correlation id: a trace that holds
replays is complete only when each has as many device records as the
captured graph has device nodes
(:attr:`~repro_torch.serving.graphs.StepProgram.device_ops`).
"""

from __future__ import annotations

import re
from collections import Counter

import torch

#: short device sleeps that open every trace before the traced work (16
#: were too few late in a long process, where one run of ``chip_smoke.py``
#: lost the records of 22 of 24 traced decode steps)
WARMUP = 64
#: kernel launch records of the CUDA runtime and driver APIs
LAUNCH_RECORD = re.compile(r"cu(da)?LaunchKernel")
#: CUDA graph launch records of the same
GRAPH_RECORD = re.compile(r"cu(da)?GraphLaunch")


def record_gaps(events) -> tuple[list[int], list[int]]:
    """Where a trace lost device records: the indices, in launch order, of
    the host launch records of ``events`` (kineto events) that have no
    device record with their correlation id, and for each graph launch the
    number of device records under its correlation id."""
    cpu = torch.autograd.DeviceType.CPU
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() == cpu and LAUNCH_RECORD.match(e.name()))
    graphs = [e.correlation_id() for e in events
              if e.device_type() == cpu and GRAPH_RECORD.match(e.name())]
    recorded = Counter(e.correlation_id() for e in events if e.device_type() != cpu)
    return ([i for i, (_, c) in enumerate(launches) if not recorded[c]],
            [recorded[c] for c in graphs])


def launches_recorded(events, skip: int = WARMUP, graph_ops: int | None = None) -> bool:
    """True if every host launch record of ``events`` (kineto events: the
    trace's ``prof.profiler.kineto_results.events()``) after the first
    ``skip`` has a device record with its correlation id, and every graph
    launch has ``graph_ops`` of them (a trace with a graph launch and no
    ``graph_ops`` is not complete)."""
    lost, graph_records = record_gaps(events)
    return all(i < skip for i in lost) and all(n == graph_ops for n in graph_records)


def replay_spans_ns(events) -> list[int]:
    """For each graph launch in ``events`` (kineto events), the device time
    from its first device record's start to its last one's end."""
    cpu = torch.autograd.DeviceType.CPU
    graphs = {e.correlation_id() for e in events
              if e.device_type() == cpu and GRAPH_RECORD.match(e.name())}
    first, last = {}, {}
    for e in events:
        c = e.correlation_id()
        if e.device_type() != cpu and c in graphs:
            first[c] = min(first.get(c, e.start_ns()), e.start_ns())
            last[c] = max(last.get(c, e.end_ns()), e.end_ns())
    return [last[c] - first[c] for c in sorted(first)]


def traced_kernels(events):
    """The device records of ``events`` (a trace's ``key_averages()`` or
    ``events()``) without the opening sleeps or annotations: kernels and
    copies."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
            and "spin_kernel" not in e.key]


__all__ = ["GRAPH_RECORD", "LAUNCH_RECORD", "WARMUP", "launches_recorded", "record_gaps",
           "replay_spans_ns", "traced_kernels"]
