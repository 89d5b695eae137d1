"""Calibrated static KV page scales and per-head KV bit assignment (port of
``repro/quant/observe/kv.py``).

The dynamic int8 KV path
(:func:`repro_torch.models.layers._append_kv_page_quant`) re-derives a
page's scale on every appended token: the scale grows monotonically and
the page's codes rescale in place. When calibration bounds each head's K/V
magnitude, a **static per-(repeat, kv-head) scale** replaces it: an append
is one quantize-and-store, every code is rounded once, and the scale is
known at plan time, so the :class:`~.records.MixedPrecisionPlan` carries
it.

Per-head **bits** ride the same mechanism: a head demoted to ``b < 8`` bits
keeps the int8 container but its scale is computed against ``2**(b-1) -
1``; out-of-calibration drift still hard-clips at the int8 limit, so the
8-bit :class:`~repro_torch.quant.spec.AttnDatapathSpec` bound holds.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


@torch.inference_mode()
def observe_kv_ranges(model, cfg, batches, max_len: int | None = None) -> dict:
    """Per-(repeat, kv-head) K/V abs-max over calibration prefills.

    ``model`` is a float or packed
    :class:`~repro_torch.models.transformer.Transformer` (``prefill``
    routes every site through its module either way), on the device it
    runs on. Returns ``{"slots": {slot_index: {"k_absmax": (R, nkv)
    ndarray, "v_absmax": ...}}}`` over every attention slot of
    ``cfg.pattern``: layer ``r * period + s`` is row ``r`` of slot ``s``.
    The ranges are post-RoPE, what the page pools store."""
    from repro_torch.models.transformer import prefill

    device = model.embedding.embed.device
    slots: dict[int, dict] = {i: {"k_absmax": None, "v_absmax": None}
                              for i, spec in enumerate(cfg.pattern) if spec.mixer == "attn"}
    for batch in batches:
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long, device=device)
        S = tokens.shape[1]
        _, caches = prefill(model, {"tokens": tokens}, max_len or S)
        for i, rec in slots.items():
            for side in ("k", "v"):
                # (B, L, nkv, hd) per repeat -> (R, nkv); zero padding cannot inflate
                amax = np.stack([
                    torch.amax(torch.abs(caches[r * cfg.period + i][side].to(torch.float32)),
                               dim=(0, 1, 3)).cpu().numpy()
                    for r in range(cfg.repeats)])
                key = f"{side}_absmax"
                rec[key] = amax if rec[key] is None else np.maximum(rec[key], amax)
    return {"slots": slots}


def search_kv_bits(ranges: dict, *, kv_bits: int = 8, low_bits: int | None = None,
                   low_frac: float = 0.25) -> dict:
    """Per-head KV bits and static scales from observed ranges.

    Every head takes ``kv_bits``; with ``low_bits``, heads whose abs-max is
    below ``low_frac`` of the slot's largest head are demoted to
    ``low_bits``. Returns the plan's JSON-able ``kv`` section::

        {"kv_bits_default": 8,
         "slots": {"0": {"k_scale": [[...]], "v_scale": [[...]],
                          "k_bits": [[...]], "v_bits": [[...]]}}}

    Scales are ``absmax / (2**(bits-1) - 1)`` with a 1e-8 floor (the
    dynamic path's floor)."""
    out: dict = {"kv_bits_default": kv_bits, "slots": {}}
    for slot, rec in ranges["slots"].items():
        sec = {}
        for side in ("k", "v"):
            amax = np.asarray(rec[f"{side}_absmax"], np.float64)
            bits = np.full(amax.shape, kv_bits, np.int64)
            if low_bits is not None:
                ref = amax.max(axis=-1, keepdims=True)
                bits = np.where(amax < low_frac * ref, low_bits, bits)
            qmax = 2.0 ** (bits - 1) - 1.0
            scale = np.maximum(amax / qmax, 1e-8)
            sec[f"{side}_scale"] = scale.tolist()
            sec[f"{side}_bits"] = bits.tolist()
        out["slots"][str(slot)] = sec
    return out


def plan_kv_scales(kv_section: dict | None, *, device="cuda"):
    """A plan's ``kv`` section as per-slot f32 tensors on ``device``:
    ``{slot_index: {"k": (R, nkv), "v": (R, nkv)}}``, the form
    ``decode_step_paged(kv_scales=...)`` and ``PagedEngine(kv_scales=...)``
    take. None when the section is absent (dynamic KV quantization)."""
    if not kv_section:
        return None
    dev = resolve_device(device)
    return {int(slot): {"k": torch.as_tensor(sec["k_scale"], dtype=torch.float32, device=dev),
                        "v": torch.as_tensor(sec["v_scale"], dtype=torch.float32, device=dev)}
            for slot, sec in kv_section["slots"].items()}


__all__ = ["observe_kv_ranges", "plan_kv_scales", "search_kv_bits"]
