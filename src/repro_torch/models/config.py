"""Model configuration schema (port of ``repro/models/config.py``).

A model is a token embedding, a stack of layers, a final norm and an LM
head. Each layer is a (mixer, ffn) pair described by a :class:`LayerSpec`;
a stack is ``pattern`` repeated ``n_layers // period`` times. The port
serves the attention, Mamba (:class:`SSMConfig`), mLSTM and sLSTM
(:class:`XLSTMConfig`) mixers with MLP or MoE (:class:`MoEConfig`) FFNs;
:func:`jamba_pattern` and :func:`xlstm_pattern` build the hybrid and xLSTM
stacks.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    group_size: int = 1024  # dispatch group size (GShard-style)
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # default ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block internals (arXiv:2405.04517)."""

    mlstm_expand: int = 2  # up-projection factor for mLSTM blocks
    mlstm_heads: int = 4
    slstm_heads: int = 4
    slstm_proj_factor: float = 4.0 / 3.0  # post-block FFN factor
    chunk: int = 64  # chunkwise-parallel length for mLSTM


@dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | mamba | mlstm | slstm | none
    ffn: str  # mlp | moe | none


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)
    d_head: int | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 10_000.0
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    attn_logit_softcap: float | None = None
    frontend: str | None = None
    frontend_tokens: int = 0
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    attn_chunk: int = 1024
    attn_chunk_threshold: int = 8192
    remat: str = "block"
    scan_layers: bool = True
    prefill_mode: str = "parallel"
    vocab_pad_multiple: int = 128

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.pattern)}"
            )
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")
        needs_moe = any(s.ffn == "moe" for s in self.pattern)
        if needs_moe and self.moe is None:
            raise ValueError(f"{self.name}: pattern uses moe but moe config is None")
        needs_ssm = any(s.mixer == "mamba" for s in self.pattern)
        if needs_ssm and self.ssm is None:
            raise ValueError(f"{self.name}: pattern uses mamba but ssm config is None")
        needs_xlstm = any(s.mixer in ("mlstm", "slstm") for s in self.pattern)
        if needs_xlstm and self.xlstm is None:
            raise ValueError(f"{self.name}: pattern uses xlstm but xlstm config is None")

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def repeats(self) -> int:
        return self.n_layers // self.period

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab + m - 1) // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """True when the stack's sequence mixing is not dominated by full
        attention (SSM / linear-recurrent / hybrid families)."""
        attn_frac = sum(1 for s in self.pattern if s.mixer == "attn") / self.period
        return attn_frac < 0.5

    @property
    def dt_rank(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    def layer_spec(self, i: int) -> LayerSpec:
        """The pattern entry of layer ``i`` (layer ``r * period + s`` is
        repeat ``r`` of slot ``s``)."""
        return self.pattern[i % self.period]

    def scaled(self, **updates) -> "ModelConfig":
        return replace(self, **updates)


def uniform_pattern(mixer: str = "attn", ffn: str = "mlp") -> tuple[LayerSpec, ...]:
    return (LayerSpec(mixer, ffn),)


def jamba_pattern(period: int = 8, attn_at: int = 4) -> tuple[LayerSpec, ...]:
    """Jamba (arXiv:2403.19887): 1 attention per ``period`` layers, MoE every
    other layer; the rest are Mamba + dense MLP."""
    specs = []
    for i in range(period):
        mixer = "attn" if i == attn_at else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        specs.append(LayerSpec(mixer, ffn))
    return tuple(specs)


def xlstm_pattern(period: int = 8, slstm_at: int = 0) -> tuple[LayerSpec, ...]:
    """xLSTM [7:1] mix: one sLSTM block per period, the rest mLSTM; blocks
    carry their own projections (d_ff == 0 -> ffn "none")."""
    return tuple(
        LayerSpec("slstm" if i == slstm_at else "mlstm", "none") for i in range(period)
    )


def param_count(cfg: ModelConfig) -> dict:
    """Parameters counted analytically, {"total", "active"} (port of the
    reference's ``param_count``; MoE "active" counts top-k experts)."""
    d, v = cfg.d_model, cfg.vocab
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    total = v * d  # embedding
    if not cfg.tie_embeddings:
        total += v * d  # head
    active = total
    per_pattern = []
    for spec in cfg.pattern:
        n = 0
        if spec.mixer == "attn":
            n += d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        elif spec.mixer == "mamba":
            s = cfg.ssm
            d_in = s.expand * d
            n += d * 2 * d_in  # in_proj (x, z)
            n += d_in * s.d_conv  # conv
            n += d_in * (cfg.dt_rank + 2 * s.d_state)  # x -> dt, B, C
            n += cfg.dt_rank * d_in  # dt_proj
            n += d_in * s.d_state + d_in  # A_log, D
            n += d_in * d  # out_proj
        elif spec.mixer == "mlstm":
            d_in = cfg.xlstm.mlstm_expand * d
            n += d * 2 * d_in  # up proj (x, z)
            n += 3 * d_in * d_in  # q, k, v
            n += 2 * d_in  # i, f gates
            n += d_in * d  # down proj
        elif spec.mixer == "slstm":
            x = cfg.xlstm
            n += 4 * d * d + 4 * d * (d // x.slstm_heads)  # in + block-diagonal recurrent
            n += int(2 * d * d * x.slstm_proj_factor)  # post FFN up/down
        n_active = n
        if spec.ffn == "mlp":
            m = 3 * d * cfg.d_ff if cfg.act == "swiglu" else 2 * d * cfg.d_ff
            n += m
            n_active += m
        elif spec.ffn == "moe":
            mo = cfg.moe
            per_exp = 3 * d * mo.d_ff_expert if cfg.act == "swiglu" else 2 * d * mo.d_ff_expert
            n += mo.n_experts * per_exp + d * mo.n_experts
            n_active += mo.top_k * per_exp + d * mo.n_experts
        per_pattern.append((n, n_active))
    total += cfg.repeats * sum(p[0] for p in per_pattern)
    active += cfg.repeats * sum(p[1] for p in per_pattern)
    # norms (2 per layer + final)
    total += (2 * cfg.n_layers + 1) * d
    active += (2 * cfg.n_layers + 1) * d
    return {"total": int(total), "active": int(active)}
