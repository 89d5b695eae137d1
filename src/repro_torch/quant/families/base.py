"""Quantizable-site adapter protocol (port of
``repro/quant/families/base.py``, enumeration half).

An adapter names the (K, C) linear reductions a block component owns,
from the model config alone. The tap-forward half of the protocol
(``forward_with_taps``), which calibration drives, arrives with the
calibration slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class SiteSpec:
    """One quantizable linear reduction inside a block component.

    ``path`` addresses the weight inside the component; ``k``/``c`` are the
    reduction depth and output width; ``stacked`` is the expert-stack size
    of (E, K, C) weights (None for plain 2D sites); ``use_bias`` marks the
    output-side projection that carries the corrected bias; ``datapath`` is
    an optional per-site :class:`~repro_torch.quant.spec.DatapathSpec`
    override."""

    name: str
    path: tuple[str, ...]
    k: int
    c: int
    stacked: int | None = None
    use_bias: bool = False
    datapath: "object | None" = None

    def datapath_for(self, ptq) -> "object":
        """This site's serving datapath: the explicit override, else
        ``ptq.to_datapath_spec`` at this depth (``ptq`` may also be a
        DatapathSpec, used as is)."""
        if self.datapath is not None:
            return self.datapath
        if hasattr(ptq, "to_datapath_spec"):
            return ptq.to_datapath_spec(self.k)
        return ptq


class BlockAdapter:
    """Base class for family adapters: ``kind`` ("mixer" or "ffn") and
    ``name`` (the LayerSpec value they implement)."""

    kind: str = ""
    name: str = ""

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        raise NotImplementedError

    def forward_with_taps(self, p, x, ctx, tap):
        raise NotImplementedError(
            "tap-forwards drive AXE calibration, which arrives with the "
            "calibration slice of the port")
