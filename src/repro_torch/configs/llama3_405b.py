"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 (port of ``repro/configs/llama3_405b.py``). RoPE theta 500k,
128k vocab; 16 query heads a KV head. The full model does not fit one
card: the port runs its smoke config.
"""

from repro_torch.models.config import ModelConfig, uniform_pattern

ARCH_ID = "llama3-405b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab=128256,
        pattern=uniform_pattern("attn", "mlp"),
        rope_theta=500_000.0,
        max_seq_len=32_768,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
