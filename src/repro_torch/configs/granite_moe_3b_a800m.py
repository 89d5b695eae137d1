"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 (port of
``repro/configs/granite_moe_3b_a800m.py``).

Fine-grained MoE: every FFN is a 40-expert top-8 layer with a small (512)
expert hidden size; the dispatch group is 256 tokens.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, uniform_pattern

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,
        pattern=uniform_pattern("attn", "moe"),
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, group_size=256),
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
        d_ff=32,
        vocab=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, group_size=64),
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
