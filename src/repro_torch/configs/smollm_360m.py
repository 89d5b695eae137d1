"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
(port of ``repro/configs/smollm_360m.py``).

LLaMA-architecture small model: RMSNorm + SwiGLU + RoPE, 3-way grouped-query
attention.
"""

from repro_torch.models.config import ModelConfig, uniform_pattern

ARCH_ID = "smollm-360m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab=49152,
        pattern=uniform_pattern("attn", "mlp"),
        max_seq_len=32_768,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=60,
        n_heads=3,
        n_kv_heads=1,
        d_ff=128,
        vocab=128,
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
