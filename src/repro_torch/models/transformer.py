"""Model assembly: attention, Mamba, mLSTM and sLSTM mixers with MLP or
MoE FFNs (port of ``repro/models/transformer.py``).

The reference stacks each pattern slot's parameters over repeats and scans
over them; the port keeps one :class:`Block` per layer in an
``nn.ModuleList`` and loops (layer ``r * period + s`` is repeat ``r`` of
slot ``s``), one period at a time in :func:`forward`, the reference's scan
body, under a checkpoint when ``cfg.remat == "block"``. Decode caches are
per-layer dicts, written in place: an attention layer's ``{"k", "v"}``, a
recurrent layer's dense state (Mamba ``{"conv", "ssm"}``, mLSTM ``{"conv",
"C", "n", "m"}``, sLSTM ``{"h", "c", "n", "m"}``). The modality frontends
are stubs, as in the reference:
``vision_stub`` takes precomputed ``pixel_embeds`` (B, P, d) in front of
the tokens (:func:`forward`, :func:`prefill`; :func:`loss_fn` masks the
prefix), ``audio_stub`` takes codec tokens as plain tokens.

A model is built with its float leaves' gradients off (serving);
``model.requires_grad_(True)`` turns them on for training
(:func:`~repro_torch.runtime.steps.init_train_state`). Packed sites hold
buffers, which never take gradients.
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device

from .config import LayerSpec, ModelConfig
from .moe import MoE, current_split, moe, replay_split, split_routing
from .ssm import init_mamba, mamba, mamba_decode, mamba_state_shapes
from .xlstm import (
    init_mlstm,
    init_slstm,
    mlstm,
    mlstm_decode,
    mlstm_state_shapes,
    slstm,
    slstm_decode,
    slstm_state_shapes,
)
from .layers import (
    MLP,
    Attention,
    Embedding,
    Linear,
    Norm,
    attention,
    attention_decode,
    decode_position,
    embed,
    lm_logits,
    mlp,
    norm,
    normal_weight,
    packed_backend,
    paged_attention_decode,
    site_scope,
    torch_dtype,
    use_packed_backend,
)

AUX_LOSS_WEIGHT = 0.01


class RecurrentMixer(NamedTuple):
    """A recurrent mixer's functions: ``init(cfg, gen, device)``, the
    parallel ``forward(p, x, cfg, return_state=False)``, the one-step
    ``decode(p, x, cfg, *state)`` that updates ``state`` (the buffers named
    by ``state``, in that order) in place, and ``state_shapes(cfg, batch)``,
    {name: (shape, dtype)}."""

    init: Callable
    forward: Callable
    decode: Callable
    state_shapes: Callable
    state: tuple[str, ...]


#: the recurrent mixers: dense per-sequence state instead of a KV cache
RECURRENT = {
    "mamba": RecurrentMixer(init_mamba, mamba, mamba_decode, mamba_state_shapes,
                            ("conv", "ssm")),
    "mlstm": RecurrentMixer(init_mlstm, mlstm, mlstm_decode, mlstm_state_shapes,
                            ("conv", "C", "n", "m")),
    "slstm": RecurrentMixer(init_slstm, slstm, slstm_decode, slstm_state_shapes,
                            ("h", "c", "n", "m")),
}


def is_kv_pool(pool: dict) -> bool:
    """Whether a paged cache's layer pool holds KV pages (an attention
    layer's, in the port's or the reference's layout) rather than a
    recurrent layer's dense lanes."""
    return "k_pages" in pool


_FRONTENDS = (None, "vision_stub", "audio_stub")


def _check_ported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "none", *RECURRENT) or spec.ffn not in (
                "mlp", "moe", "none"):
            raise NotImplementedError(f"{cfg.name}: unknown layer {spec}")
    if cfg.frontend not in _FRONTENDS:
        raise NotImplementedError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")


def frontend_prefix(cfg: ModelConfig) -> int:
    """Positions the vision stub's ``pixel_embeds`` take in front of the
    tokens (0 for other configs)."""
    return cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0


def check_servable(model) -> None:
    """What the engines take: a model with its gradients off, and tokens
    only, as the reference's engines feed (a config whose inputs include a
    ``pixel_embeds`` prefix raises)."""
    cfg = model.cfg
    if any(p.requires_grad for p in model.parameters()):
        raise ValueError(f"{cfg.name}: serving takes a model with gradients off "
                         f"(model.requires_grad_(False))")
    if frontend_prefix(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the engines feed tokens only, and a {cfg.frontend} model needs "
            f"{cfg.frontend_tokens} pixel_embeds a sequence; forward, loss_fn and prefill "
            f"take them (batch['pixel_embeds'])")


class Block(nn.Module):
    """One layer: ``norm1`` + ``mixer`` (Attention, Mamba, MLSTM or SLSTM)
    and ``norm2`` + ``ffn`` (MLP or MoE); a component is None where the
    pattern says "none"."""

    def __init__(self, spec: LayerSpec, norm1=None, mixer=None, norm2=None, ffn=None):
        super().__init__()
        self.spec = spec
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn


class Transformer(nn.Module):
    """Token embedding, ``cfg.n_layers`` blocks, final norm, LM head."""

    def __init__(self, cfg: ModelConfig, embedding: Embedding, layers: list[Block],
                 final_norm: Norm):
        super().__init__()
        _check_ported(cfg)
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
def _init_block(spec: LayerSpec, cfg: ModelConfig, gen, device) -> Block:
    dt = torch_dtype(cfg.param_dtype)
    d, hd, nh, nkv, f = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def new_norm():
        b = torch.zeros(d, dtype=dt, device=device) if cfg.norm == "layernorm" else None
        return Norm(torch.ones(d, dtype=dt, device=device), b)

    def lin(k, n, std):
        return Linear(normal_weight((k, n), std, gen, dt, device))

    block = Block(spec, norm1=new_norm())
    if spec.mixer == "attn":
        s = 1.0 / math.sqrt(d)
        block.mixer = Attention(lin(d, nh * hd, s), lin(d, nkv * hd, s),
                                lin(d, nkv * hd, s), lin(nh * hd, d, s))
    elif spec.mixer in RECURRENT:
        block.mixer = RECURRENT[spec.mixer].init(cfg, gen, device)
    if spec.ffn == "mlp":
        block.norm2 = new_norm()
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        if cfg.act == "swiglu":
            block.ffn = MLP(wg=lin(d, f, s_in), wu=lin(d, f, s_in), wd=lin(f, d, s_out))
        else:
            block.ffn = MLP(wi=lin(d, f, s_in), wd=lin(f, d, s_out))
    elif spec.ffn == "moe":
        block.norm2 = new_norm()
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

        def stack(k, n, std):
            return Linear(normal_weight((e, k, n), std, gen, dt, device))

        sites = ({"wg": stack(d, f, s_in), "wu": stack(d, f, s_in)} if cfg.act == "swiglu"
                 else {"wi": stack(d, f, s_in)})
        block.ffn = MoE(router=lin(d, e, s_in), **sites, wd=stack(f, d, s_out))
    return block


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda",
               generator: torch.Generator | None = None) -> Transformer:
    """A randomly initialised model with the reference's shapes and
    distributions (normal weights scaled by 1/sqrt(fan_in), embedding by
    0.02, unit norms), drawn from ``generator`` (default: a generator on
    ``device`` seeded with ``seed``). The draws differ from ``jax.random``;
    tests carry weights across with ``repro_torch.interop``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    v, d = cfg.vocab_padded, cfg.d_model
    embedding = Embedding(
        normal_weight((v, d), 0.02, gen, dt, dev),
        None if cfg.tie_embeddings else normal_weight((v, d), 1.0 / math.sqrt(d), gen, dt, dev),
    )
    layers = [_init_block(cfg.layer_spec(i), cfg, gen, dev) for i in range(cfg.n_layers)]
    final_norm = Norm(torch.ones(d, dtype=dt, device=dev),
                      torch.zeros(d, dtype=dt, device=dev) if cfg.norm == "layernorm" else None)
    return Transformer(cfg, embedding, layers, final_norm)


def abstract_params(cfg: ModelConfig) -> Transformer:
    """The model's parameter tree on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``abstract_params``, for the
    sharding rules and the analytic budget)."""
    return init_model(cfg, device="meta", generator=torch.Generator())


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------
def _embed_inputs(model: Transformer, batch: dict, pos_offset: int = 0):
    """Token embedding, after the vision stub's ``pixel_embeds`` prefix;
    positions from ``pos_offset`` over the whole sequence."""
    x = embed(model.embedding, batch["tokens"].long(), model.cfg)
    if frontend_prefix(model.cfg):
        x = torch.cat([batch["pixel_embeds"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(pos_offset, pos_offset + S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _ffn(block: Block, cfg: ModelConfig, x):
    """The block's FFN residual on ``x`` (an MoE FFN's load-balance loss
    skipped: prefill and decode)."""
    h = norm(block.norm2, x, cfg.norm)
    if block.spec.ffn == "moe":
        return x + moe(block.ffn, h, cfg, aux=False)[0]
    return x + mlp(block.ffn, h, cfg)


def _train_block(block: Block, cfg: ModelConfig, x, positions, aux):
    """One block of :func:`forward`: (x, ``aux`` plus an MoE FFN's
    load-balance loss), as the reference's ``_apply_block`` carries them."""
    if block.mixer is not None:
        h = norm(block.norm1, x, cfg.norm)
        if block.spec.mixer == "attn":
            y, _ = attention(block.mixer, h, cfg, positions)
        else:
            y = RECURRENT[block.spec.mixer].forward(block.mixer, h, cfg)
        x = x + y
    if block.ffn is not None:
        h = norm(block.norm2, x, cfg.norm)
        if block.spec.ffn == "moe":
            y, loss = moe(block.ffn, h, cfg)
            x, aux = x + y, aux + loss
        else:
            x = x + mlp(block.ffn, h, cfg)
    return x, aux


class Unit(NamedTuple):
    """A span of the model that runs as one and takes its parameters as one
    (:func:`forward`'s ``params``): ``"embed"``, the token embedding;
    ``"period"`` ``index``, layers ``index * P`` to ``(index + 1) * P - 1``
    with P = ``len(cfg.pattern)``, the reference's scan body; ``"head"``,
    the final norm and the LM head (the embedding again when tied).
    ``names``: the state names of the parameters it computes with."""

    kind: str
    index: int
    names: tuple[str, ...]


def model_units(model: Transformer) -> list[Unit]:
    """The units of ``model`` in the order :func:`forward` runs them."""
    names = [n for n, _ in model.named_parameters()]

    def under(prefix: str) -> tuple[str, ...]:
        return tuple(n for n in names if n.startswith(prefix))

    period = len(model.cfg.pattern)
    layers = [Unit("period", r, sum((under(f"layers.{i}.") for i in
                                     range(r * period, (r + 1) * period)), ()))
              for r in range(model.cfg.n_layers // period)]
    head = "embedding.head" if model.embedding.head is not None else "embedding.embed"
    return [Unit("embed", 0, ("embedding.embed",)), *layers,
            Unit("head", 0, under("final_norm.") + (head,))]


class _Apply(nn.Module):
    """Runs ``fn(*args)``: with :func:`torch.func.functional_call` on it,
    ``fn`` reads the model's attributes swapped for the given tensors."""

    def __init__(self, model: Transformer):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(*args)


def _in_unit(model: Transformer, params, unit: Unit, fn, *args):
    """``fn(*args)`` computing with ``params(unit)`` in place of the unit's
    parameters (with the model's own where ``params`` is None)."""
    if params is None:
        return fn(*args)
    tensors = {f"model.{n}": t for n, t in params(unit).items()}
    # no parameter is registered under two names (a tied head reads
    # embedding.embed), so the search for ties over the whole model is skipped
    return torch.func.functional_call(_Apply(model), tensors, (fn, *args), tie_weights=False)


def _recompute_contexts():
    """A period checkpoint's contexts (its ``context_fn``): the first run
    as it is; the recompute, which autograd may run on its own device
    thread, under the thread-local state the first run saw: the MoE split
    (the statistics discarded, the first run appended them) and the packed
    backend."""
    return nullcontext(), _replay(current_split(), packed_backend())


@contextmanager
def _replay(split, backend: str):
    with replay_split(split), use_packed_backend(backend):
        yield


def _head(model: Transformer, x):
    x = norm(model.final_norm, x, model.cfg.norm)
    return lm_logits(model.embedding, x, model.cfg)


def forward(model: Transformer, batch: dict, params: Callable | None = None):
    """batch: {"tokens": (B, S) int[, "pixel_embeds": (B, P, d)]}. Returns
    (logits (B, P + S, V_padded) over the frontend prefix too, aux), ``aux``
    the MoE blocks' summed load-balance loss (0 without them).

    The stack runs one period of ``cfg.pattern`` at a time, the
    reference's scan body. With ``cfg.remat == "block"`` and grad enabled
    each period runs under a non-reentrant checkpoint (the reference's
    ``jax.checkpoint``): its activations are recomputed in the backward,
    the same ops on the same inputs, so the gradients are those of
    ``"none"`` bit for bit. ``params``, when given, hands each unit
    (:func:`model_units`) the tensors it computes with: ``params(unit)``
    returns {state name: tensor} for the unit's parameters, called as the
    unit starts (and again in a period's recompute); without it every unit
    computes with the model's own parameters."""
    cfg = model.cfg
    period = len(cfg.pattern)
    repeats = cfg.n_layers // period
    units = model_units(model) if params is not None else [None] * (repeats + 2)
    x, positions = _in_unit(model, params, units[0], _embed_inputs, model, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "block" and torch.is_grad_enabled()

    def run(r, x, aux):
        def body(x, aux):
            for block in model.layers[r * period:(r + 1) * period]:
                x, aux = _train_block(block, cfg, x, positions, aux)
            return x, aux

        return _in_unit(model, params, units[1 + r], body, x, aux)

    for r in range(repeats):
        if remat:
            x, aux = checkpoint(run, r, x, aux, use_reentrant=False,
                                context_fn=_recompute_contexts)
        else:
            x, aux = run(r, x, aux)
    return _in_unit(model, params, units[-1], _head, model, x), aux


class BatchSplit(NamedTuple):
    """A batch whose rows lie on several ranks: ``rows`` rows in all, this
    rank's from ``row0``; ``reduce(v)`` sums the 1-D tensor ``v`` in place
    over the ranks that hold the other rows and returns it."""

    rows: int
    row0: int
    reduce: Callable


def split_stats_size(cfg: ModelConfig) -> int:
    """The length of the vector :func:`loss_fn` with a split reduces: the
    loss's token count and each MoE block's top-1 expert counts."""
    n_moe = sum(cfg.layer_spec(i).ffn == "moe" for i in range(cfg.n_layers))
    return 1 + n_moe * (cfg.moe.n_experts if n_moe else 0)


def loss_fn(model: Transformer, batch: dict, split: BatchSplit | None = None,
            params: Callable | None = None):
    """Next-token cross entropy over the text positions (the vision stub's
    prefix masked, as in the reference). Returns (total, {"ce", "aux",
    "ppl"}). ``params``: :func:`forward`'s.

    With ``split`` the batch holds this rank's rows of a larger one, and
    the terms are this rank's shares of the whole batch's loss (their sum
    over the ranks is that loss, and so is the sum of their gradients): the
    cross entropy's token count and the MoE load-balance loss's factors
    (each a mean over the whole batch's tokens) are summed over the ranks
    first, in one ``split.reduce`` (:func:`split_stats_size`); ``ppl`` is
    left to the caller."""
    if split is None:
        logits, aux = forward(model, batch, params)
        stats = ()
    else:
        with split_routing(split.rows, split.row0) as stats:
            logits, aux = forward(model, batch, params)
    pred = logits[:, frontend_prefix(model.cfg):][:, :-1].to(torch.float32)
    labels = batch["tokens"][:, 1:].long()
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        nll = nll * m
        count = torch.sum(m)
    else:
        count = torch.tensor(float(nll.numel()), device=nll.device)
    if split is not None:
        vec = split.reduce(torch.cat([count.reshape(1)] + [c for c, _ in stats]))
        count, n_tok = vec[0], split.rows * logits.shape[1]
        e = model.cfg.moe.n_experts if stats else 0
        for i, (_, prob) in enumerate(stats):
            density = vec[1 + i * e:1 + (i + 1) * e] / n_tok
            aux = aux + e * torch.sum(density * (prob / n_tok))
    denom = torch.clamp(count, min=1.0) if mask is not None else count
    ce = torch.sum(nll) / denom
    total = ce + AUX_LOSS_WEIGHT * aux
    return total, {"ce": ce, "aux": aux, "ppl": torch.exp(ce)}


# ---------------------------------------------------------------------------
# KV caches, prefill, decode
# ---------------------------------------------------------------------------
def recurrent_state_shapes(spec: LayerSpec, cfg: ModelConfig, batch: int) -> dict:
    """{name: (shape, dtype)} of a recurrent mixer's decode state for
    ``batch`` sequences ({} for other mixers)."""
    rec = RECURRENT.get(spec.mixer)
    return {} if rec is None else rec.state_shapes(cfg, batch)


def _zero_state(spec: LayerSpec, cfg: ModelConfig, batch: int, device, shard=None) -> dict:
    """A recurrent layer's zeroed decode state; with ``shard`` (its mixer's
    mesh layout) the state's compute layout: the rank's channels or heads."""
    out = {}
    for name, (shape, dt) in recurrent_state_shapes(spec, cfg, batch).items():
        if shard is not None:
            dim, axes = shard.states[name]
            shape = list(shape)
            shape[dim] //= shard.mesh.axes_size(axes)
        out[name] = torch.zeros(shape, dtype=dt, device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
               kv_heads: int | None = None):
    """Per-layer decode caches: ``{"k", "v"}`` of (B, max_len, nkv, hd) in
    the act dtype for an attention layer, the zeroed dense state of a
    recurrent one (:func:`recurrent_state_shapes`). ``kv_heads`` overrides
    nkv (a rank's kv heads under a mesh)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (batch, max_len, kv_heads or cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.act_dtype)
    caches = []
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i)
        if spec.mixer == "attn":
            caches.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)})
        else:
            caches.append(_zero_state(spec, cfg, batch, dev))
    return caches


def _mixer_decode(block: Block, cfg: ModelConfig, h, cache: dict):
    """One recurrent mixer's decode step on its dense state, in place."""
    rec = RECURRENT[block.spec.mixer]
    return rec.decode(block.mixer, h, cfg, *(cache[name] for name in rec.state))[0]


def _mixer_decode_lanes(block: Block, cfg: ModelConfig, h, pool: dict):
    """:func:`_mixer_decode` on a paged cache's slot lanes. Under a mesh
    the lanes are held as the engine placed them (``MixerShard.store``):
    each state is moved to its compute layout (every slot, the rank's
    channels or heads), stepped, and written back in place."""
    sh = getattr(block.mixer, "_shard", None)
    if sh is None:
        return _mixer_decode(block, cfg, h, pool)
    live = {name: sh.lanes_in(name, lanes) for name, lanes in pool.items()}
    y = _mixer_decode(block, cfg, h, live)
    for name, lanes in pool.items():
        sh.lanes_out(name, lanes, live[name])
    return y


def _mixer_prefill(block: Block, cfg: ModelConfig, h):
    """A recurrent mixer over the prompt: (y, its end-of-sequence state).
    ``cfg.prefill_mode`` "parallel" runs the chunkwise-parallel forms;
    "stepwise" reruns the sequence through the decode recurrence from a
    zero state (exact but sequential; the reference's baseline)."""
    if cfg.prefill_mode == "parallel":
        return RECURRENT[block.spec.mixer].forward(block.mixer, h, cfg, return_state=True)
    B, S, _ = h.shape
    state = _zero_state(block.spec, cfg, B, h.device, getattr(block.mixer, "_shard", None))
    ys = [_mixer_decode(block, cfg, h[:, t:t + 1], state)[:, 0] for t in range(S)]
    return torch.stack(ys, dim=1), state


def prefill(model: Transformer, batch: dict, max_len: int, prefix_kv=None,
            pos_offset: int = 0, caches=None):
    """Run the prompt; returns (logits, caches ready for decode at index S).

    ``caches``, when given, are :func:`init_cache`-shaped caches of at
    least ``max_len`` positions that the prompt's KV is written into (a
    captured decode step's static caches); positions past S keep what they
    held, and decode masks them until it writes them. A recurrent layer's
    end-of-prompt state is copied into its cache buffers.

    ``prefix_kv`` enables suffix prefill against a cached prompt prefix:
    a per-layer list whose attention entries are ``{"k", "v"}`` of (B, L,
    nkv, hd), the RoPE'd KV of the first L prompt tokens, and whose other
    entries are ``{}``. ``batch["tokens"]`` then holds only the uncached
    suffix, ``pos_offset`` must equal L, and the returned caches hold the
    suffix's KV only. A vision stub's ``batch["pixel_embeds"]`` go in front
    of the tokens, so decode continues at P + S."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, batch, pos_offset)
    B, S, _ = x.shape
    if caches is None:
        caches = init_cache(cfg, B, max_len, device=x.device, kv_heads=_local_kv_heads(model))
        for block, cache in zip(model.layers, caches):
            sh = getattr(block.mixer, "_shard", None)
            if block.spec.mixer != "attn" and sh is not None:  # a mesh rank's compute layout
                cache.update(_zero_state(block.spec, cfg, B, x.device, sh))
    for i, (block, cache) in enumerate(zip(model.layers, caches)):
        if block.mixer is not None:
            h = norm(block.norm1, x, cfg.norm)
            if block.spec.mixer == "attn":
                pkv = None if prefix_kv is None else (prefix_kv[i]["k"], prefix_kv[i]["v"])
                y, (k, v) = attention(block.mixer, h, cfg, positions, prefix_kv=pkv)
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
            else:
                y, state = _mixer_prefill(block, cfg, h)
                for name, t in state.items():
                    cache[name].copy_(t)
            x = x + y
        if block.ffn is not None:
            x = _ffn(block, cfg, x)
    x = norm(model.final_norm, x, cfg.norm)
    return lm_logits(model.embedding, x, cfg), caches


def _local_kv_heads(model: Transformer) -> int | None:
    """The kv heads of this rank's attention layers under a mesh (None
    without one)."""
    for block in model.layers:
        sh = getattr(block.mixer, "_shard", None)
        if sh is not None and hasattr(sh, "kv_lo"):
            return sh.kv_hi - sh.kv_lo
    return None


def decode_step(model: Transformer, tokens, caches, index):
    """One decode step. tokens: (B, 1); ``index`` the position being
    written, a 0-d int32 tensor on the model's device (read there alone:
    one captured step serves every position) or a Python int. Updates
    ``caches`` in place (KV and recurrent states); returns (logits (B, 1,
    V), caches)."""
    cfg = model.cfg
    x = embed(model.embedding, tokens.long(), cfg)
    index = decode_position(index, x.device)
    for block, cache in zip(model.layers, caches):
        if block.mixer is not None:
            h = norm(block.norm1, x, cfg.norm)
            if block.spec.mixer == "attn":
                y, _, _ = attention_decode(block.mixer, h, cfg, cache["k"], cache["v"], index)
            else:
                y = _mixer_decode(block, cfg, h, cache)
            x = x + y
        if block.ffn is not None:
            x = _ffn(block, cfg, x)
    x = norm(model.final_norm, x, cfg.norm)
    return lm_logits(model.embedding, x, cfg), caches


# ---------------------------------------------------------------------------
# Paged KV cache and decode
# ---------------------------------------------------------------------------
def init_paged_cache(cfg: ModelConfig, num_slots: int, num_blocks: int, block_size: int,
                     max_pages: int, *, kv_dtype: str | None = None, device="cuda"):
    """Paged decode cache: one KV page pool per attention layer plus the
    continuous-batching state.

    Pools are ``k_pages``/``v_pages`` of (num_blocks + 1, block_size, nkv,
    hd) per layer (the reference stacks them, (R, num_blocks, ...)); the
    extra last page is a write sink for idle slots, whose block-table rows
    hold the sentinel ``num_blocks`` (the reference drops those writes).
    ``kv_dtype="int8"`` stores quantized pages: int8 codes plus
    per-(page, kv-head) ``k_scales``/``v_scales`` (num_blocks + 1, nkv) f32,
    zero until admission or the first append stamps them. ``free_list``,
    ``free_top`` and ``page_refcounts`` mirror the host allocator
    (:class:`~repro_torch.serving.scheduler.PoolState`): ``page_refcounts``
    counts the block-table rows holding a page plus one while the prefix
    cache holds it. A recurrent layer's pool is its dense state with one
    lane a slot, (num_slots, ...), as the reference's (R, num_slots, ...):
    admission installs a prompt's end state into the slot's lane, and every
    decode step steps every lane."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = torch.int8 if kv_dtype == "int8" else torch_dtype(kv_dtype or cfg.act_dtype)
    pools = []
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i)
        if spec.mixer != "attn":
            pools.append(_zero_state(spec, cfg, num_slots, dev))
            continue
        kv = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
        pool = {"k_pages": torch.zeros(kv, dtype=dt, device=dev),
                "v_pages": torch.zeros(kv, dtype=dt, device=dev)}
        if dt == torch.int8:
            sc = (num_blocks + 1, cfg.n_kv_heads)
            pool["k_scales"] = torch.zeros(sc, dtype=torch.float32, device=dev)
            pool["v_scales"] = torch.zeros(sc, dtype=torch.float32, device=dev)
        pools.append(pool)

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "pools": pools,
        "block_table": torch.full((num_slots, max_pages), num_blocks, dtype=torch.int32,
                                  device=dev),
        "seq_lens": zeros((num_slots,)),
        "active": zeros((num_slots,), torch.bool),
        "uids": zeros((num_slots,)),
        "steps": zeros((num_slots,)),
        "last_tok": zeros((num_slots,)),
        "free_list": torch.arange(num_blocks, dtype=torch.int32, device=dev),
        "free_top": zeros(()),
        "page_refcounts": zeros((num_blocks,)),
    }


def decode_step_paged(model: Transformer, tokens, cache: dict, *, attn_impl: str = "auto",
                      attn_spec=None, assert_bounds: bool = False, watermarks=None,
                      kv_scales=None):
    """One decode step over the paged cache. tokens: (num_slots, 1) int.

    Every slot advances at its own ``cache["seq_lens"]`` position; idle
    slots (``active`` False) compute but write only to the sink page and do
    not advance; a recurrent layer steps every slot's lane, idle ones too,
    as the reference does (their outputs are discarded and admission
    overwrites the lane). ``attn_spec`` is an optional
    :class:`~repro_torch.quant.spec.AttnDatapathSpec` request.
    ``assert_bounds``/``watermarks`` reach the int8 attention kernel (B3).
    ``kv_scales``: calibrated static KV page scales, a sequence aligned with
    ``cfg.pattern`` (attention slots ``{"k": (R, nkv), "v": (R, nkv)}`` f32,
    others ``{}``), as in the reference; layer ``r * period + s`` appends
    under row ``r`` of slot ``s`` (a view, no device work). None keeps the
    dynamic requantize-on-append.
    Layer ``i``'s attention and FFN run under the site scopes
    ``slot{i % period}/mixer`` and ``/ffn``, so an attached serving
    observer (:func:`~repro_torch.models.layers.attach_observer`) taps
    their packed sites, as in the reference; no other program sets one.
    Updates the cache in place; returns (logits (num_slots, 1, V), cache)."""
    cfg = model.cfg
    x = embed(model.embedding, tokens.long(), cfg)
    table, lens, active = cache["block_table"], cache["seq_lens"], cache["active"]
    for i, (block, pool) in enumerate(zip(model.layers, cache["pools"])):
        r, s = divmod(i, cfg.period)
        if block.mixer is not None and block.spec.mixer != "attn":
            h = norm(block.norm1, x, cfg.norm)
            with site_scope(f"slot{s}/mixer"):
                x = x + _mixer_decode_lanes(block, cfg, h, pool)
        elif block.mixer is not None:
            h = norm(block.norm1, x, cfg.norm)
            sks = kv_scales[s] if kv_scales is not None and kv_scales[s] else None
            with site_scope(f"slot{s}/mixer"):
                y, _ = paged_attention_decode(block.mixer, h, cfg, pool, table, lens, active,
                                              impl=attn_impl, attn_spec=attn_spec,
                                              assert_bounds=assert_bounds,
                                              watermarks=watermarks,
                                              static_kv_scales=None if sks is None else
                                              {"k": sks["k"][r], "v": sks["v"][r]})
            x = x + y
        if block.ffn is not None:
            with site_scope(f"slot{s}/ffn"):
                x = _ffn(block, cfg, x)
    x = norm(model.final_norm, x, cfg.norm)
    lens.add_(active.to(lens.dtype))
    return lm_logits(model.embedding, x, cfg), cache
