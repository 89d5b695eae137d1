"""The dense ``tiny-lm-*`` width ladder of the paper's experiments and the
per-family rungs ``tiny-moe``, ``tiny-ssm``, ``tiny-xlstm`` and
``tiny-hybrid`` (port of ``repro/configs/paper.py``)."""

from __future__ import annotations

from repro_torch.models.config import (
    LayerSpec,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
    uniform_pattern,
)


def _tiny(name: str, d_model: int, n_layers: int, d_ff: int, heads: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=d_ff,
        vocab=512,
        pattern=uniform_pattern("attn", "mlp"),
        max_seq_len=256,
        param_dtype="float32",
        act_dtype="float32",
        remat="none",
    )


def _tiny_moe() -> ModelConfig:
    """4-expert top-2 MoE at tiny-lm-xs width: the expert-stacked (E, K, C)
    PTQ path end to end."""
    return _tiny("tiny-moe", 64, 2, 128, 4).scaled(
        family="moe",
        pattern=uniform_pattern("attn", "moe"),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
    )


def _tiny_ssm() -> ModelConfig:
    """2-layer Mamba-1 stack (no FFN blocks, as in the original arch)."""
    return _tiny("tiny-ssm", 64, 2, 128, 4).scaled(
        family="ssm",
        pattern=uniform_pattern("mamba", "none"),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    )


def _tiny_xlstm() -> ModelConfig:
    """2-layer xLSTM with one mLSTM and one sLSTM block (period-2 pattern)."""
    return _tiny("tiny-xlstm", 64, 2, 128, 4).scaled(
        family="xlstm",
        pattern=(LayerSpec("mlstm", "none"), LayerSpec("slstm", "none")),
        xlstm=XLSTMConfig(mlstm_expand=2, mlstm_heads=4, slstm_heads=4, chunk=32),
    )


def _tiny_hybrid() -> ModelConfig:
    """Jamba-flavored period-2 hybrid (mamba+mlp, attn+moe): adapter
    composition across families inside one stack."""
    return _tiny("tiny-hybrid", 64, 2, 128, 4).scaled(
        family="hybrid",
        pattern=(LayerSpec("mamba", "mlp"), LayerSpec("attn", "moe")),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    )


PAPER_MODELS = {
    "tiny-lm-xs": lambda: _tiny("tiny-lm-xs", 64, 4, 192, 4),
    "tiny-lm-s": lambda: _tiny("tiny-lm-s", 128, 4, 384, 4),
    "tiny-lm-m": lambda: _tiny("tiny-lm-m", 256, 4, 768, 8),
    "tiny-lm-l": lambda: _tiny("tiny-lm-l", 512, 4, 1536, 8),
    "tiny-moe": _tiny_moe,
    "tiny-ssm": _tiny_ssm,
    "tiny-xlstm": _tiny_xlstm,
    "tiny-hybrid": _tiny_hybrid,
}
