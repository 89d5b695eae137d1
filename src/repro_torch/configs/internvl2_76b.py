"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, an InternLM2-class backbone (port of
``repro/configs/internvl2_76b.py``).

The InternViT frontend is a stub: 256 precomputed patch embeddings a
sample (``pixel_embeds``) are prepended to the text sequence, and the loss
is masked over that prefix. The engines feed tokens only and refuse it,
as the reference's cannot serve it either. The full model does not fit
one card: the port runs its smoke config.
"""

from repro_torch.models.config import ModelConfig, uniform_pattern

ARCH_ID = "internvl2-76b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        pattern=uniform_pattern("attn", "mlp"),
        frontend="vision_stub",
        frontend_tokens=256,
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
        d_ff=128,
        vocab=128,
        frontend_tokens=8,
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
