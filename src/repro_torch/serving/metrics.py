"""Per-request serving latency accounting: TTFT and inter-token latency
percentiles, bucketed by priority class.
(port of ``repro/serving/metrics.py``: a copy, pure numpy)

The serve loop stamps wall-clock times host-side: one ``submitted`` per
request (its arrival), one ``tokens`` per admit / decode chunk (every
token the chunk produced shares the chunk-end timestamp — intra-chunk
gaps therefore read as zero and the inter-token distribution's tail
measures exactly the stalls an operator feels: head-of-line prefills,
admission waits, preemption restarts). ``ttft`` is the gap from arrival
to the *first* token ever produced — a preempt-and-requeue restart
re-emits tokens but cannot move a request's TTFT.

``summary()`` emits microsecond-suffixed percentile keys
(``ttft_p50_us`` … ``itl_p99_us``), overall and per class under
``class_<p>`` — the shapes ``scripts/bench_compare.py`` classifies as
lower-is-better.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class _Rec:
    priority: int
    t_submit: float
    times: list = field(default_factory=list)  # one wall-clock per token
    n_preempt: int = 0


class ServeMetrics:
    def __init__(self):
        self._recs: dict[int, _Rec] = {}

    # ------------------------------------------------------------------
    # Recording (called by the serve loops)
    # ------------------------------------------------------------------
    def submitted(self, uid: int, priority: int, t: float) -> None:
        if uid not in self._recs:  # resubmission after preemption keeps t0
            self._recs[uid] = _Rec(priority=priority, t_submit=t)

    def tokens(self, uid: int, n: int, t: float) -> None:
        self._recs[uid].times.extend([t] * n)

    def preempted(self, uid: int) -> None:
        rec = self._recs[uid]
        rec.n_preempt += 1
        # the produced tokens are discarded and will be re-emitted; keep
        # only the first timestamp so TTFT survives and the restart's
        # re-decode gap lands in the inter-token distribution honestly
        del rec.times[1:]

    # ------------------------------------------------------------------
    # Reporting
    # ------------------------------------------------------------------
    @staticmethod
    def _pcts(vals: list[float]) -> dict:
        if not vals:
            return {}
        a = np.asarray(vals, np.float64) * 1e6  # seconds -> us
        return {"p50_us": float(np.percentile(a, 50)),
                "p99_us": float(np.percentile(a, 99))}

    def _section(self, recs: list[_Rec]) -> dict:
        ttft = [r.times[0] - r.t_submit for r in recs if r.times]
        itl: list[float] = []
        for r in recs:
            itl.extend(float(b - a) for a, b in zip(r.times, r.times[1:]))
        out = {"n_requests": len(recs),
               "n_preemptions": sum(r.n_preempt for r in recs)}
        out.update({f"ttft_{k}": v for k, v in self._pcts(ttft).items()})
        out.update({f"itl_{k}": v for k, v in self._pcts(itl).items()})
        return out

    def summary(self) -> dict:
        recs = list(self._recs.values())
        out = self._section(recs)
        for p in sorted({r.priority for r in recs}):
            out[f"class_{p}"] = self._section(
                [r for r in recs if r.priority == p])
        return out
