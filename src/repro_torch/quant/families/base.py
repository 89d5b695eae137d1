"""Quantizable-site adapter protocol (port of
``repro/quant/families/base.py``).

Per block component (mixer or ffn) an adapter gives:

  * ``enumerate_sites(cfg)`` — the named (K, C) linear reductions it owns,
    from the model config alone;
  * ``forward_with_taps(p, x, ctx, tap)`` — the component forward over
    paired (analog, quantized) activation streams, every quantizable matmul
    routed through ``tap``: calibration streams statistics and quantizes
    the site there (GPFQ's lockstep propagation, paper Eq. 9); the
    simulated-integer forward looks the stored site up (the pair collapses,
    see :func:`both`);
  * two SmoothQuant hooks naming the weights that consume the component's
    normed input.

``p`` is a dict of the component's float weights (tensors), keyed by site
name. Everything that is not a tap stays in high precision (paper §C.1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.config import ModelConfig

#: A pair of (analog, quantized) activation streams; in the simulated-integer
#: forward both are the same object.
Pair = tuple[torch.Tensor, torch.Tensor]

#: tap(site_name, x_pair, stats_from=...) -> y_pair, provided by the pipeline
TapFn = Callable[..., Pair]


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


@dataclass
class TapContext:
    """Per-call context threaded through ``forward_with_taps``."""

    cfg: ModelConfig
    positions: torch.Tensor | None = None


def both(f, *pairs: Pair) -> Pair:
    """Apply a float (non-tap) op to each stream of the paired activations;
    when every pair carries one object on both sides, the op runs once and
    the identity is kept."""
    q = f(*(p[1] for p in pairs))
    if all(p[0] is p[1] for p in pairs):
        return (q, q)
    return (f(*(p[0] for p in pairs)), q)


class BlockAdapter:
    """Base class for family adapters: ``kind`` ("mixer" or "ffn") and
    ``name`` (the LayerSpec value they implement)."""

    kind: str = ""
    name: str = ""

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        raise NotImplementedError

    def input_weight_absmax(self, p: dict, cfg: ModelConfig) -> torch.Tensor | None:
        """Per-input-dim abs-max of the weights consuming the normed input
        (SmoothQuant); None disables equalization for this component."""
        return None

    def scale_input_weights(self, p: dict, s_eq: torch.Tensor, cfg: ModelConfig) -> dict:
        """``p`` with every consumer of the normed input row-scaled by ``s_eq``."""
        return p

    def forward_with_taps(self, p: dict, x: Pair, ctx: TapContext, tap: TapFn) -> Pair:
        raise NotImplementedError
