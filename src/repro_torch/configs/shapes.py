"""The assigned input-shape set (one per LM-family cell) and the stand-ins
the analytic budget takes (port of ``repro/configs/shapes.py``): tensors on
the ``meta`` device, shapes and dtypes only, nothing allocated.

  train_4k     seq 4,096   x global_batch 256   (training)
  prefill_32k  seq 32,768  x global_batch 32    (inference prefill)
  decode_32k   seq 32,768  x global_batch 128   (decode: 1 token, 32k cache)
  long_500k    seq 524,288 x global_batch 1     (long-context decode;
               sub-quadratic families only)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, TRAIN),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, PREFILL),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, DECODE),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, DECODE),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k runs only for sub-quadratic (SSM/hybrid/linear-attn)
    families; every other shape applies to every architecture."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for the data inputs of the step function."""
    from repro_torch.models.layers import torch_dtype

    b, s = shape.global_batch, shape.seq_len
    if shape.kind in (TRAIN, PREFILL):
        specs = {}
        s_text = s
        if cfg.frontend == "vision_stub" and cfg.frontend_tokens:
            s_text = s - cfg.frontend_tokens
            specs["pixel_embeds"] = torch.empty((b, cfg.frontend_tokens, cfg.d_model),
                                                dtype=torch_dtype(cfg.act_dtype), device="meta")
        specs["tokens"] = torch.empty((b, s_text), dtype=torch.int32, device="meta")
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta")}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache of a decode shape, as meta tensors (one dict a
    layer, :func:`~repro_torch.models.transformer.init_cache`)."""
    from repro_torch.models.transformer import init_cache

    assert shape.kind == DECODE
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
