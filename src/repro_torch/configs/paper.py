"""The dense ``tiny-lm-*`` width ladder of the paper's experiments (port of
``repro/configs/paper.py``). The MoE/SSM/xLSTM/hybrid rungs arrive with the
family slice of the port."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig, uniform_pattern


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


PAPER_MODELS = {
    "tiny-lm-xs": lambda: _tiny("tiny-lm-xs", 64, 4, 192, 4),
    "tiny-lm-s": lambda: _tiny("tiny-lm-s", 128, 4, 384, 4),
    "tiny-lm-m": lambda: _tiny("tiny-lm-m", 256, 4, 768, 8),
    "tiny-lm-l": lambda: _tiny("tiny-lm-l", 512, 4, 1536, 8),
}
