"""Model assembly, dense pattern (port of ``repro/models/transformer.py``).

The reference stacks each pattern slot's parameters over repeats and scans
over them; the port keeps one :class:`Block` per layer in an
``nn.ModuleList`` and loops (layer ``r * period + s`` is repeat ``r`` of
slot ``s``). Decode caches are per-layer ``{"k", "v"}`` dicts, written in
place. MoE, Mamba and xLSTM mixers arrive with the family slice and raise
here.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import resolve_device

from .config import LayerSpec, ModelConfig
from .layers import (
    MLP,
    Attention,
    Embedding,
    Linear,
    Norm,
    attention,
    attention_decode,
    embed,
    lm_logits,
    mlp,
    norm,
    torch_dtype,
)

AUX_LOSS_WEIGHT = 0.01


def _check_dense(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "none") or spec.ffn not in ("mlp", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer {spec} — only the dense pattern (attn, "
                f"mlp) is ported; MoE/SSM/xLSTM arrive with the family slice")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: modality frontends are not ported")


class Block(nn.Module):
    """One layer: ``norm1`` + ``mixer`` (Attention) and ``norm2`` + ``ffn``
    (MLP); a component is None where the pattern says "none"."""

    def __init__(self, spec: LayerSpec, norm1=None, mixer=None, norm2=None, ffn=None):
        super().__init__()
        self.spec = spec
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn


class Transformer(nn.Module):
    """Token embedding, ``cfg.n_layers`` blocks, final norm, LM head."""

    def __init__(self, cfg: ModelConfig, embedding: Embedding, layers: list[Block],
                 final_norm: Norm):
        super().__init__()
        _check_dense(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} blocks for {cfg.n_layers} layers")
        self.cfg = cfg
        self.embedding = embedding
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, {"tokens": tokens})[0]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _normal(shape, std, gen, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std
    return w.to(dtype)


def _init_block(spec: LayerSpec, cfg: ModelConfig, gen, device) -> Block:
    dt = torch_dtype(cfg.param_dtype)
    d, hd, nh, nkv, f = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def new_norm():
        b = torch.zeros(d, dtype=dt, device=device) if cfg.norm == "layernorm" else None
        return Norm(torch.ones(d, dtype=dt, device=device), b)

    def lin(k, n, std):
        return Linear(_normal((k, n), std, gen, dt, device))

    block = Block(spec, norm1=new_norm())
    if spec.mixer == "attn":
        s = 1.0 / math.sqrt(d)
        block.mixer = Attention(lin(d, nh * hd, s), lin(d, nkv * hd, s),
                                lin(d, nkv * hd, s), lin(nh * hd, d, s))
    if spec.ffn == "mlp":
        block.norm2 = new_norm()
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        if cfg.act == "swiglu":
            block.ffn = MLP(wg=lin(d, f, s_in), wu=lin(d, f, s_in), wd=lin(f, d, s_out))
        else:
            block.ffn = MLP(wi=lin(d, f, s_in), wd=lin(f, d, s_out))
    return block


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda",
               generator: torch.Generator | None = None) -> Transformer:
    """A randomly initialised model with the reference's shapes and
    distributions (normal weights scaled by 1/sqrt(fan_in), embedding by
    0.02, unit norms), drawn from ``generator`` (default: a generator on
    ``device`` seeded with ``seed``). The draws differ from ``jax.random``;
    tests carry weights across with ``repro_torch.interop``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    v, d = cfg.vocab_padded, cfg.d_model
    embedding = Embedding(
        _normal((v, d), 0.02, gen, dt, dev),
        None if cfg.tie_embeddings else _normal((v, d), 1.0 / math.sqrt(d), gen, dt, dev),
    )
    layers = [_init_block(cfg.layer_spec(i), cfg, gen, dev) for i in range(cfg.n_layers)]
    final_norm = Norm(torch.ones(d, dtype=dt, device=dev))
    return Transformer(cfg, embedding, layers, final_norm)


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------
def _embed_inputs(model: Transformer, tokens):
    x = embed(model.embedding, tokens.long(), model.cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, positions


def _apply_block(block: Block, cfg: ModelConfig, x, positions):
    if block.mixer is not None:
        y, _ = attention(block.mixer, norm(block.norm1, x, cfg.norm), cfg, positions)
        x = x + y
    if block.ffn is not None:
        x = x + mlp(block.ffn, norm(block.norm2, x, cfg.norm), cfg)
    return x


def forward(model: Transformer, batch: dict):
    """batch: {"tokens": (B, S) int}. Returns (logits (B, S, V_padded), aux)."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, batch["tokens"])
    for block in model.layers:
        x = _apply_block(block, cfg, x, positions)
    x = norm(model.final_norm, x, cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # dense: no router loss
    return lm_logits(model.embedding, x, cfg), aux


def loss_fn(model: Transformer, batch: dict):
    """Next-token cross entropy. Returns (total, {"ce", "aux", "ppl"})."""
    logits, aux = forward(model, batch)
    pred = logits[:, :-1].to(torch.float32)
    labels = batch["tokens"][:, 1:].long()
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        nll = nll * m
        denom = torch.clamp(torch.sum(m), min=1.0)
    else:
        denom = torch.tensor(float(nll.numel()), device=nll.device)
    ce = torch.sum(nll) / denom
    total = ce + AUX_LOSS_WEIGHT * aux
    return total, {"ce": ce, "aux": aux, "ppl": torch.exp(ce)}


# ---------------------------------------------------------------------------
# KV caches, prefill, decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Per-layer ``{"k", "v"}`` caches of (B, max_len, nkv, hd) in act dtype."""
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.act_dtype)
    return [
        {"k": torch.zeros(shape, dtype=dt, device=dev),
         "v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.layer_spec(i).mixer == "attn" else {}
        for i in range(cfg.n_layers)
    ]


def prefill(model: Transformer, batch: dict, max_len: int):
    """Run the prompt; returns (logits, caches ready for decode at index S)."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, batch["tokens"])
    B, S, _ = x.shape
    caches = init_cache(cfg, B, max_len, device=x.device)
    for block, cache in zip(model.layers, caches):
        if block.mixer is not None:
            y, (k, v) = attention(block.mixer, norm(block.norm1, x, cfg.norm), cfg, positions)
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            x = x + y
        if block.ffn is not None:
            x = x + mlp(block.ffn, norm(block.norm2, x, cfg.norm), cfg)
    x = norm(model.final_norm, x, cfg.norm)
    return lm_logits(model.embedding, x, cfg), caches


def decode_step(model: Transformer, tokens, caches, index: int):
    """One decode step. tokens: (B, 1); ``index`` the position being
    written. Updates ``caches`` in place; returns (logits (B, 1, V), caches)."""
    cfg = model.cfg
    x = embed(model.embedding, tokens.long(), cfg)
    for block, cache in zip(model.layers, caches):
        if block.mixer is not None:
            h = norm(block.norm1, x, cfg.norm)
            y, _, _ = attention_decode(block.mixer, h, cfg, cache["k"], cache["v"], index)
            x = x + y
        if block.ffn is not None:
            x = x + mlp(block.ffn, norm(block.norm2, x, cfg.norm), cfg)
    x = norm(model.final_norm, x, cfg.norm)
    return lm_logits(model.embedding, x, cfg), caches
