"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 (port of ``repro/configs/dbrx_132b.py``). The full
model does not fit one card: the port runs its smoke config.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, uniform_pattern

ARCH_ID = "dbrx-132b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        pattern=uniform_pattern("attn", "moe"),
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752, group_size=1024),
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
        n_kv_heads=2,
        d_ff=64,
        vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, group_size=64),
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
