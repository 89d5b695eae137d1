"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 (port of
``repro/configs/xlstm_350m.py``).

sLSTM + mLSTM blocks [arXiv:2405.04517; unverified], 1:7 sLSTM:mLSTM mix.
d_ff == 0: xLSTM blocks carry their own up/down projections (ffn = none).
"""

from repro_torch.models.config import ModelConfig, XLSTMConfig, xlstm_pattern

ARCH_ID = "xlstm-350m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        pattern=xlstm_pattern(period=8, slstm_at=0),
        xlstm=XLSTMConfig(mlstm_expand=2, mlstm_heads=4, slstm_heads=4, chunk=64),
        max_seq_len=524_288,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        name=ARCH_ID + "-smoke",
        n_layers=8,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        vocab=128,
        xlstm=XLSTMConfig(mlstm_expand=2, mlstm_heads=2, slstm_heads=2, chunk=8),
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
