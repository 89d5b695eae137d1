"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba:attention 1:7 interleave
[arXiv:2403.19887; hf] (port of ``repro/configs/jamba_1_5_large_398b.py``).

Pattern period 8 (attention at slot 4, Mamba elsewhere; MoE every other
layer) repeated 9x. The full model does not fit one card; its smoke config
and one Mamba block at its widths do.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig, jamba_pattern

ARCH_ID = "jamba-1.5-large-398b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        pattern=jamba_pattern(period=8, attn_at=4),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, group_size=1024),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        max_seq_len=524_288,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        name=ARCH_ID + "-smoke",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, group_size=64),
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
