"""Serving-side saturation counters (port of
``repro/quant/observe/saturation.py``).

What the paged decode step reports for each observed packed site, when an
observer is attached to :mod:`repro_torch.models.layers`
(``attach_observer`` / ``site_scope`` there):

* **static-quantizer clip counts**: how many activation values the
  calibrated static quantizer clipped;
* **activation-code extrema**: the sub-alphabet the traffic exercised.

The counters have two halves.

* **The device half**, :class:`CounterBlock`: one row per label, allocated
  once, before the decode step is captured, and never rebound. Each row
  holds ``n_calls``, ``clip_count`` and ``clip_total`` (int64) and
  ``code_min``, ``code_max`` (f32). A tap updates its row in place (adds
  for the counts, a min and a max for the extrema), with no host read and
  no value from the host but the shapes, so the captured step (a CUDA
  graph, replayed ``k`` times) keeps counting correctly. The reference
  reports each call to the host through ``jax.debug.callback``; a graph
  cannot call the host.
* **The host half**, :class:`SaturationCounters`: the reference's
  accumulation and report, in its dict schema. :meth:`~SaturationCounters.fold`
  reads the whole block to the host once, adds it in, and zeroes the
  block in place; the totals are the reference's, call for call.

Everything heavier is computed at report time on the host:

* per-site **accumulator watermarks**: the observed code extrema joined
  with the packed site's integer weights (all repeats of the slot) give
  the exact worst partial sum restricted to the observed code range, an
  empirical watermark bounded above by the certificate;
* per-KV-head **attention watermarks**: page-pool code extrema (the sink
  page of idle rows left out) against the
  :class:`~repro_torch.quant.spec.AttnDatapathSpec` register bounds.

With no observer attached (the default) the decode step holds no tap and
writes no counter: ``PagedEngine.assert_observation_transparent``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

#: columns of a row of :class:`CounterBlock`'s block, in bytes: three int64
#: counts, then two f32 extrema
_COUNT_BYTES, _ROW_BYTES = 24, 32


@dataclass
class _SiteCounter:
    n_calls: int = 0
    clip_count: int = 0
    clip_total: int = 0
    code_min: float = math.inf
    code_max: float = -math.inf


class CounterBlock:
    """The device half: a fixed (labels, 32)-byte block on ``device``,
    viewed as ``counts`` (n, 3) int64 (``n_calls``, ``clip_count``,
    ``clip_total``) and ``extrema`` (n, 2) f32 (``code_min``,
    ``code_max``), so one copy reads it all. Made once; never rebound."""

    def __init__(self, labels, device):
        self.labels = tuple(labels)
        self.rows = {label: i for i, label in enumerate(self.labels)}
        n = len(self.labels)
        empty = torch.zeros((n, _ROW_BYTES), dtype=torch.uint8)
        ext = empty[:, _COUNT_BYTES:].view(torch.float32)
        ext[:, 0], ext[:, 1] = math.inf, -math.inf
        #: the zeroed block (inf / -inf extrema), copied in by :meth:`clear`
        self._empty = empty.to(device)
        self.buf = self._empty.clone()
        self.counts = self.buf[:, :_COUNT_BYTES].view(torch.int64)
        self.extrema = self.buf[:, _COUNT_BYTES:].view(torch.float32)

    def write(self, label: str, n_total: int, n_clip, code_min, code_max) -> None:
        """One call's observation, into ``label``'s row in place: ``n_total``
        a shape (a constant of the captured step), ``n_clip`` (an int64
        0-d tensor, or None for a quantizer that cannot clip) and the code
        extrema (0-d tensors) on the block's device."""
        row = self.rows.get(label)
        if row is None:
            raise KeyError(f"no counter row for {label!r}: the block holds {self.labels}")
        counts = self.counts[row]
        counts[0].add_(1)
        if n_clip is not None:
            counts[1].add_(n_clip)
        counts[2].add_(n_total)
        ext = self.extrema[row]
        ext[0].clamp_(max=code_min)
        ext[1].clamp_(min=code_max)

    def clear(self) -> None:
        self.buf.copy_(self._empty)

    def read(self) -> dict[str, tuple]:
        """The rows that recorded a call, as host values (one read)."""
        host = self.buf.cpu()
        counts = host[:, :_COUNT_BYTES].view(torch.int64).tolist()
        ext = host[:, _COUNT_BYTES:].view(torch.float32).tolist()
        return {label: (*counts[i], *ext[i]) for i, label in enumerate(self.labels)
                if counts[i][0]}


@dataclass
class SaturationCounters:
    """Host-side accumulation of per-site serving observations, and the
    device block that the decode step's taps write
    (:meth:`allocate`)."""

    sites: dict[str, _SiteCounter] = field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()
        self.block: CounterBlock | None = None

    # -- the device half -----------------------------------------------------
    def allocate(self, labels, device) -> CounterBlock:
        """Make the device block, one row per label (before any capture)."""
        self.block = CounterBlock(labels, device)
        return self.block

    def write(self, label: str, n_total: int, n_clip, code_min, code_max) -> None:
        """A tap's target: :meth:`CounterBlock.write` on the device block."""
        if self.block is None:
            raise RuntimeError("SaturationCounters has no device block: allocate() one "
                               "for the engine's labels before the decode step runs")
        self.block.write(label, n_total, n_clip, code_min, code_max)

    def fold(self) -> None:
        """Add the device block into the host counters (one host read) and
        zero it in place."""
        if self.block is None:
            return
        rows = self.block.read()
        self.block.clear()
        with self._lock:
            for label, (n, clip, total, lo, hi) in rows.items():
                c = self.sites.setdefault(label, _SiteCounter())
                c.n_calls += n
                c.clip_count += clip
                c.clip_total += total
                c.code_min = min(c.code_min, lo)
                c.code_max = max(c.code_max, hi)

    # -- recording (the reference's callback target) -------------------------
    def record(self, label: str, n_total: int, n_clip, code_min, code_max) -> None:
        """Fold one call's observation for ``label`` on the host, as the
        reference's ``jax.debug.callback`` target does."""
        with self._lock:
            c = self.sites.setdefault(label, _SiteCounter())
            c.n_calls += 1
            c.clip_count += int(n_clip)
            c.clip_total += int(n_total)
            c.code_min = min(c.code_min, float(code_min))
            c.code_max = max(c.code_max, float(code_max))

    def reset(self) -> None:
        """Clear the host counters and zero the device block in place."""
        with self._lock:
            self.sites.clear()
        if self.block is not None:
            self.block.clear()

    # -- reporting -----------------------------------------------------------
    def report(self, params=None, pools=None, attn_spec=None) -> dict:
        """ServeMetrics-style summary dict of the host counters (call
        :meth:`fold` first to take in the device block).

        ``params``: optional serving model, which adds per-site accumulator
        watermarks (each observed site's integer codes, all repeats,
        unpacked on the host once). ``pools`` + ``attn_spec``: optional
        paged-cache pools (one per layer, the sink page last) and
        :class:`AttnDatapathSpec`, which add per-KV-head attention
        watermarks, layers folded by pattern slot (``params``' period, else
        1)."""
        out: dict = {"sites": {}}
        with self._lock:
            items = [(k, _SiteCounter(**vars(v))) for k, v in self.sites.items()]
        for label, c in sorted(items):
            sec = {
                "n_calls": c.n_calls,
                "clip_count": c.clip_count,
                "clip_total": c.clip_total,
                "clip_frac": c.clip_count / c.clip_total if c.clip_total else 0.0,
                "code_min": c.code_min if c.n_calls else None,
                "code_max": c.code_max if c.n_calls else None,
            }
            if params is not None and c.n_calls:
                leaves = _find_site_leaf(params, label)
                if leaves is not None:
                    sec.update(_leaf_watermark(leaves, c.code_min, c.code_max))
            out["sites"][label] = sec
        if pools is not None and attn_spec is not None:
            period = params.cfg.period if params is not None else 1
            out["kv_heads"] = _kv_watermarks(pools, attn_spec, period)
        return out


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------
def observed_labels(model) -> tuple[str, ...]:
    """The labels the paged decode step reports under, from the model's
    pattern and packed sites: ``slot{s}/{mixer|ffn}.{site}`` for every
    packed, non-stacked site of a layer ``i`` with ``s = i % period`` (an
    MoE's expert stacks are unobserved, as in the reference, whose experts
    do not go through ``pmm``)."""
    from repro_torch.models.layers import PackedLinear

    labels = set()
    for i, block in enumerate(model.layers):
        s = i % model.cfg.period
        for kind in ("mixer", "ffn"):
            comp = getattr(block, kind)
            if comp is None:
                continue
            for name, site in comp.named_children():
                if isinstance(site, PackedLinear) and not site.stacked:
                    labels.add(f"slot{s}/{kind}.{name}")
    return tuple(sorted(labels))


# ---------------------------------------------------------------------------
# Report-time analysis (host only)
# ---------------------------------------------------------------------------
def _find_site_leaf(params, label: str):
    """Resolve "slot0/mixer.wq" against a serving model: the site's packed
    leaf in every layer of the slot (one per repeat; the reference's
    leaf is their stack), or None."""
    try:
        slot_part, site = label.split("/", 1)
        kind, name = site.split(".", 1)
        slot = int(slot_part.removeprefix("slot"))
        period = params.cfg.period
        comps = [getattr(block, kind) for block in params.layers[slot::period]]
    except (AttributeError, ValueError, TypeError):
        return None
    leaves = [_find_named_packed(comp, name) for comp in comps if comp is not None]
    if not leaves or any(leaf is None for leaf in leaves):
        return None
    return leaves


def _find_named_packed(node, name: str):
    """The packed site ``name`` of a component, searched depth first."""
    from repro_torch.models.layers import PackedLinear

    v = getattr(node, name, None)
    if isinstance(v, PackedLinear):
        return v
    for child in node.children():
        if not isinstance(child, PackedLinear):
            found = _find_named_packed(child, name)
            if found is not None:
                return found
    return None


def _leaf_watermark(leaves, code_min: float, code_max: float) -> dict:
    """Exact worst-case accumulator use of a site's codes (every repeat's
    leaf) restricted to the observed activation-code range: the per-site
    watermark. Bounded above by the analytic certificate (which assumes
    the full alphabet). A 2:4 site's codes are its compressed ones, as the
    reference takes them."""
    from repro_torch.core.alphabet import accumulator_range
    from repro_torch.kernels.w4a8_mm import unpack_int4

    spec = leaves[0].spec
    if spec is None:
        return {}
    # the per-tile code sums are integers: taken exactly on the leaves'
    # device, then in float64 as the reference's
    w = torch.stack([unpack_int4(leaf.packed) for leaf in leaves]).to(torch.int32)
    k = w.shape[-2]
    w = w.reshape(-1, k, w.shape[-1])  # fold repeat/expert stacking
    t = spec.tile if spec.tile else k
    pad = (-k) % t
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    n_tiles = (k + pad) // t
    # (R, C, n_tiles, T)
    q_ct = w.transpose(1, 2).reshape(w.shape[0], w.shape[2], n_tiles, t)
    pos = q_ct.clamp(min=0).sum(-1).cpu().numpy().astype(np.float64)
    neg = q_ct.clamp(max=0).sum(-1).cpu().numpy().astype(np.float64)
    emp_hi = float((code_max * pos + code_min * neg).max())
    emp_lo = float((code_min * pos + code_max * neg).min())
    peak = max(emp_hi, -emp_lo, 1.0)
    _, hi_lim = accumulator_range(spec.p_inner)
    return {
        "watermark_hi": emp_hi,
        "watermark_lo": emp_lo,
        "watermark_bits": math.log2(peak) + 1.0,  # + sign bit
        "p_inner": spec.p_inner,
        "headroom_bits_observed": math.log2(hi_lim) - math.log2(peak),
    }


def _bits_needed(peak: float) -> float:
    return math.log2(max(peak, 1.0)) + 1.0


def _code_absmax(pages: torch.Tensor) -> np.ndarray:
    """Per-kv-head max |code| of an int8 pool's pages, the sink page (the
    last, written by idle rows) left out: (nkv,) float64."""
    live = pages[:-1].to(torch.int16).abs()  # int16: |-128| stays exact
    return live.amax(dim=(0, 1, 3)).cpu().numpy().astype(np.float64)


def _kv_watermarks(pools, attn_spec, period: int = 1) -> dict:
    """Per-KV-head attention accumulator watermarks from pool codes: the
    layers of pattern slot ``s`` (``i % period == s``) fold into
    ``slot{s}``, as the reference's stacked pools do."""
    maxima: dict[int, tuple] = {}
    for i, pool in enumerate(pools):
        if not isinstance(pool, dict) or "k_scales" not in pool:
            continue
        k, v = _code_absmax(pool["k_pages"]), _code_absmax(pool["v_pages"])
        s = i % period
        if s in maxima:
            k, v = np.maximum(maxima[s][0], k), np.maximum(maxima[s][1], v)
        maxima[s] = (k, v)
    out: dict = {}
    for s in sorted(maxima):
        k_max, v_max = maxima[s]
        heads = {}
        for h in range(k_max.shape[0]):
            qk_peak = attn_spec.head_dim * attn_spec.q_qmax * float(k_max[h])
            pv_peak = attn_spec.block_size * attn_spec.prob_qmax * float(v_max[h])
            heads[f"head{h}"] = {
                "k_code_max": float(k_max[h]),
                "v_code_max": float(v_max[h]),
                "qk_watermark_bits": _bits_needed(qk_peak),
                "pv_watermark_bits": _bits_needed(pv_peak),
                "p_qk": attn_spec.p_qk,
                "p_pv": attn_spec.p_pv,
            }
        out[f"slot{s}"] = heads
    return out


__all__ = ["CounterBlock", "SaturationCounters", "observed_labels"]
