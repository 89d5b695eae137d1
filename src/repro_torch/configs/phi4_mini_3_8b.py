"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 (port of ``repro/configs/phi4_mini_3_8b.py``).

RoPE + SwiGLU + GQA (head dim 128, 3 query heads a KV head); the 200k
vocab makes the embedding and head the largest tensors.
"""

from repro_torch.models.config import ModelConfig, uniform_pattern

ARCH_ID = "phi4-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab=200064,
        pattern=uniform_pattern("attn", "mlp"),
        max_seq_len=32_768,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
