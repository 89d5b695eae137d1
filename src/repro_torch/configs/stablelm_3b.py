"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
(port of ``repro/configs/stablelm_3b.py``).

Full multi-head attention (kv == heads, head dim 80), LayerNorm + SwiGLU,
RoPE.
"""

from repro_torch.models.config import ModelConfig, uniform_pattern

ARCH_ID = "stablelm-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        pattern=uniform_pattern("attn", "mlp"),
        norm="layernorm",
        act="swiglu",
        max_seq_len=32_768,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=128,
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
