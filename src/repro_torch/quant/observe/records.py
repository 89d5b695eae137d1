"""Observer records: what calibration saw, per site, and the plan schema
(port of ``repro/quant/observe/records.py``).

A :class:`SiteObservation` aggregates one *slot-granular* site (``layer %
period``: repeats of a slot share one packed datapath in the serving
artifact, so any per-site decision is shared across repeats). It joins
three sources:

* the site's **overflow certificate**
  (:mod:`repro_torch.core.overflow`): exact worst-case partial sums of the
  integer codes, its ``headroom_bits`` margin, and the certificate-exact
  register floor (:func:`~repro_torch.core.overflow.min_feasible_p_bits`);
* the site's **activation observer**
  (:meth:`repro_torch.core.calibration.ActObserver.snapshot`): the
  percentile-calibrated quantizer range against the true extremes;
* the site's **footprint** (weight count, repeats) for budget accounting.

:class:`MixedPrecisionPlan` is the search's output: per-site
:class:`~repro_torch.quant.spec.DatapathSpec` overrides plus an optional KV
section (static page scales and per-head bits). It duck-types as the
mapping ``calibrate_and_quantize(plan=...)`` consumes, and its JSON is the
reference's: a plan written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from repro_torch.core.overflow import min_feasible_p_bits
from repro_torch.quant.spec import DatapathMismatchError, DatapathSpec

#: plan file schema version (the reference's; plans are a calibration-side
#: artifact, versioned apart from the serving artifact)
PLAN_VERSION = 1


@dataclass(frozen=True)
class SiteObservation:
    """Everything the search needs to know about one slot-granular site."""

    name: str  # "slot0/mixer.wq"
    k: int  # reduction depth
    n_repeats: int  # physical instances sharing this slot's datapath
    spec: DatapathSpec  # the datapath calibration certified
    headroom_bits: float | None  # min over repeats; None = no certificate
    p_floor: int  # certificate-exact minimum P_I (max over repeats)
    n_weights: int  # integer codes per instance
    act: dict  # merged ActObserver.snapshot() over repeats

    @property
    def p_inner(self) -> int:
        return self.spec.p_inner

    @property
    def slack_bits(self) -> int:
        """Whole register bits the certificate leaves unused."""
        return max(self.p_inner - self.p_floor, 0)


@dataclass
class ObserverReport:
    """Per-site observations for a whole quantized model."""

    sites: dict[str, SiteObservation]

    def __iter__(self) -> Iterator[SiteObservation]:
        return iter(self.sites.values())

    def accumulator_bits(self) -> int:
        """The global accumulator budget configured: inner register widths
        summed over every physical site instance."""
        return sum(s.p_inner * s.n_repeats for s in self)

    def floor_accumulator_bits(self) -> int:
        """The certificate-exact lower bound on the same sum."""
        return sum(s.p_floor * s.n_repeats for s in self)

    def binding_site(self) -> str | None:
        """The site whose certificate headroom binds (arg-min)."""
        worst, name = None, None
        for s in self:
            if s.headroom_bits is not None and (worst is None or s.headroom_bits < worst):
                worst, name = s.headroom_bits, s.name
        return name

    def summary(self) -> dict:
        return {
            "n_sites": len(self.sites),
            "accumulator_bits": self.accumulator_bits(),
            "floor_accumulator_bits": self.floor_accumulator_bits(),
            "binding_site": self.binding_site(),
        }


def _merge_snapshots(snaps: list[dict]) -> dict:
    """Union of per-repeat activation ranges (the slot's quantizer covers
    every repeat it serves)."""
    if not snaps:
        return {}
    out = dict(snaps[0])
    for s in snaps[1:]:
        out["lo"] = min(out["lo"], s["lo"])
        out["hi"] = max(out["hi"], s["hi"])
        out["min_seen"] = min(out["min_seen"], s["min_seen"])
        out["max_seen"] = max(out["max_seen"], s["max_seen"])
        out["absmax"] = max(out["absmax"], s["absmax"])
        out["n_batches"] = out["n_batches"] + s["n_batches"]
    return out


def collect_observations(qm) -> ObserverReport:
    """The per-site observer report of a calibrated
    :class:`~repro_torch.quant.pipeline.QuantizedModel`. Repeats of a slot
    fold: headroom takes the min, the register floor the max (one datapath
    certifies every repeat), activation ranges the union. Repeats
    calibrated for different datapaths raise
    :class:`~repro_torch.quant.spec.DatapathMismatchError`."""
    period = qm.cfg.period
    by_slot: dict[str, list] = {}
    for i, b in enumerate(qm.blocks):
        for name, ql in b.quantized_linears():
            by_slot.setdefault(f"slot{i % period}/{name}", []).append(ql)

    sites: dict[str, SiteObservation] = {}
    for key, qls in by_slot.items():
        spec = qls[0].spec
        for ql in qls[1:]:
            if ql.spec is not None and spec is not None and not spec.matches(ql.spec):
                raise DatapathMismatchError(
                    f"site {key}: repeats calibrated for different datapaths "
                    f"({spec.describe()} vs {ql.spec.describe()})")
        k = int(qls[0].q_int.shape[-2])
        certs = [ql.cert for ql in qls if ql.cert is not None]
        headroom = min(c.headroom_bits for c in certs) if certs else None
        p_floor = (max(min_feasible_p_bits(c, k) for c in certs) if certs
                   else (spec.p_inner if spec is not None else 32))
        snaps = [ql.aux["observer"].snapshot() for ql in qls
                 if isinstance(ql.aux, dict) and ql.aux.get("observer") is not None]
        sites[key] = SiteObservation(
            name=key, k=k, n_repeats=len(qls), spec=spec,
            headroom_bits=float(headroom) if headroom is not None else None,
            p_floor=int(p_floor), n_weights=int(np.prod(tuple(qls[0].q_int.shape))),
            act=_merge_snapshots(snaps))
    return ObserverReport(sites=sites)


# ---------------------------------------------------------------------------
# The plan schema
# ---------------------------------------------------------------------------
_SPEC_FIELDS = (
    "w_bits", "act_bits", "act_signed", "tile", "p_inner", "p_outer",
    "static_act", "act_scale", "act_zp", "version", "sparsity",
)


def _spec_to_json(spec: DatapathSpec) -> dict:
    return {f: getattr(spec, f) for f in _SPEC_FIELDS}


def _spec_from_json(d: dict) -> DatapathSpec:
    return DatapathSpec(**{f: d[f] for f in _SPEC_FIELDS if f in d})


@dataclass
class MixedPrecisionPlan:
    """A searched per-site datapath assignment, as a portable artifact.

    ``sites`` maps slot-granular names ("slot0/mixer.wq") to the
    :class:`DatapathSpec` the site is served with. ``kv`` is the optional
    attention section: per attention slot, calibrated static page scales
    (lists of shape (R, n_kv_heads)) and per-head KV bit widths
    (:mod:`repro_torch.quant.observe.kv`). ``meta`` records the search's
    provenance. ``get``/``__iter__``/``__contains__``/``__len__`` delegate
    to ``sites``."""

    sites: dict[str, DatapathSpec] = field(default_factory=dict)
    kv: dict | None = None
    meta: dict = field(default_factory=dict)

    def get(self, key: str, default=None):
        return self.sites.get(key, default)

    def __getitem__(self, key: str) -> DatapathSpec:
        return self.sites[key]

    def __contains__(self, key: str) -> bool:
        return key in self.sites

    def __iter__(self) -> Iterator[str]:
        return iter(self.sites)

    def __len__(self) -> int:
        return len(self.sites)

    def keys(self):
        return self.sites.keys()

    def items(self):
        return self.sites.items()

    def to_json(self) -> dict:
        return {
            "plan_version": PLAN_VERSION,
            "sites": {k: _spec_to_json(v) for k, v in sorted(self.sites.items())},
            "kv": self.kv,
            "meta": self.meta,
        }

    @classmethod
    def from_json(cls, d: dict) -> "MixedPrecisionPlan":
        v = d.get("plan_version")
        if v != PLAN_VERSION:
            raise ValueError(f"unsupported plan_version {v!r} (expected {PLAN_VERSION})")
        return cls(sites={k: _spec_from_json(s) for k, s in d.get("sites", {}).items()},
                   kv=d.get("kv"), meta=d.get("meta", {}))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "MixedPrecisionPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


__all__ = [
    "PLAN_VERSION",
    "MixedPrecisionPlan",
    "ObserverReport",
    "SiteObservation",
    "collect_observations",
]
