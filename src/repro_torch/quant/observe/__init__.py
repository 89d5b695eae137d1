"""repro_torch.quant.observe: observers and the headroom-driven
mixed-precision search (port of ``repro/quant/observe``).

  calibrate (uniform)  ->  observe            ->  search          ->  re-spec / re-calibrate
  per-site certs           per-site act ranges    per-site (w, P_I)   tightened artifact,
  (headroom_bits)          + cert headroom        + per-head KV bits   same Eq. 3 guarantee

* :mod:`.records` — :class:`SiteObservation`, :class:`ObserverReport`
  (fed by ``LayerStats``'s ``ActObserver``) and the
  :class:`MixedPrecisionPlan` schema;
* :mod:`.search` — :func:`search_plan` (headroom -> per-site ``(w_bits,
  P_I)`` under a global accumulator budget) and :func:`apply_plan`
  (certificate-exact re-spec: same codes, tighter registers, re-issued
  certificates);
* :mod:`.saturation` — :class:`SaturationCounters`, the serving-side
  observer (static-quantizer clip counts and code extrema counted on the
  device inside the captured decode step, per-site and per-KV-head
  accumulator watermarks at report time); see
  ``repro_torch.models.layers.attach_observer``;
* :mod:`.kv` — :func:`observe_kv_ranges` (calibrated static KV page
  scales, which drop requantize-on-append) and per-head KV bits.
"""

from .kv import observe_kv_ranges, plan_kv_scales, search_kv_bits
from .records import MixedPrecisionPlan, ObserverReport, SiteObservation, collect_observations
from .saturation import SaturationCounters
from .search import apply_plan, plan_accumulator_bits, search_plan

__all__ = [
    "MixedPrecisionPlan",
    "ObserverReport",
    "SaturationCounters",
    "SiteObservation",
    "apply_plan",
    "collect_observations",
    "observe_kv_ranges",
    "plan_accumulator_bits",
    "plan_kv_scales",
    "search_kv_bits",
    "search_plan",
]
