"""Logical-axis sharding rules with divisibility fallbacks (port of
``repro/runtime/sharding.py``), resolved on a :class:`~repro_torch.launch.
mesh.Mesh` of ``torch.distributed`` ranks or on an
:class:`~repro_torch.launch.mesh.AbstractMesh`.

A spec is a tuple with one entry a dimension, entry for entry what the
reference's ``PartitionSpec`` holds: None (replicated), one axis name, or a
tuple of names (the first axis major). Every resolution checks
divisibility (dimension % product of the axis sizes) and drops the
annotation when it does not divide, and an axis taken by an earlier
dimension is not reused by a later one.

Leaves are matched by the reference's names. The port's leaf path is the
``keystr`` key path of the reference's tree without the layer index:
``("layers", "mixer", "wq", "packed")`` for ``layers.3.mixer.wq.packed``
(:func:`param_paths`); a float :class:`~repro_torch.models.layers.Linear`
without a bias is the reference's bare array under the site's name, as in
``interop``. The reference stacks a pattern slot over repeats with a
leading (R, ...) axis that never shards; a port leaf is one layer's, so
its spec is the reference's without that first entry.

Placement (:func:`host_to_global`, :func:`shard_model`) keeps this rank's
slice of a full value that every rank holds alike (a seeded init or a
loaded artifact), as the reference's ``make_array_from_callback`` does.

Logical axes:
  batch   -> ("pod", "data")   pure data parallel
  expert  -> "data"            expert parallelism for MoE stacks
  model / heads / kv_heads / ffn / vocab -> "model"   tensor parallelism
  data_in -> "data"            FSDP-style weight sharding (row dim)
"""

from __future__ import annotations

import copy
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.runtime.collectives import relayout, shard_range

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "expert": ("data",),
    "data_in": ("data",),
    "model": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "seq": ("model",),  # sequence parallelism (opt-in annotations)
}

# Serving rules for packed-int4 decode: weights are 4x smaller, so they fit
# without the FSDP dim: TP over both mesh axes, weights stationary, the
# (small) decode activations move instead.
SERVING_QUANT_RULES: dict[str, tuple[str, ...]] = {
    **DEFAULT_RULES,
    "data_in": (),
    "model": ("model", "data"),
    "heads": ("model", "data"),
    "kv_heads": ("model",),
    "ffn": ("model", "data"),
    "vocab": ("model", "data"),
}

_state = threading.local()


def _current():
    return getattr(_state, "active", None)


@contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Activate logical-axis resolution against ``mesh`` for model code."""
    prev = _current()
    _state.active = (mesh, rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _state.active = prev


def _mesh_axes_for(logical, mesh, rules: dict) -> tuple[str, ...]:
    if logical is None:
        return ()
    return tuple(a for a in rules.get(logical, ()) if a in mesh.shape)


def resolve_spec(shape, names, mesh, rules: dict) -> tuple:
    """Logical names -> a spec, with the per-dim divisibility fallback; a
    mesh axis taken by an earlier dim is unavailable to later dims."""
    spec = []
    used: set[str] = set()
    for dim, name in zip(shape, names):
        axes = tuple(a for a in _mesh_axes_for(name, mesh, rules) if a not in used)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if axes and dim % size == 0 and dim > 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            spec.append(None)
    return tuple(spec)


def spec_axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes, first major (() when replicated)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def prefer_expert_sharding(n_experts: int) -> bool:
    """True when the expert axis can shard ``n_experts`` on the active mesh."""
    active = _current()
    if active is None:
        return True
    mesh, rules = active
    axes = _mesh_axes_for("expert", mesh, rules)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return bool(axes) and size > 1 and n_experts % size == 0


def logical_constraint(x, names):
    """The spec of ``x`` under the active rules; ``x`` itself (and no spec)
    without them. The port places tensors where they are made, so this only
    resolves and checks: a no-op without active rules, as in the reference."""
    active = _current()
    if active is None:
        return x
    mesh, rules = active
    if len(names) != x.dim():
        raise ValueError(f"names {names} rank != array rank {x.dim()}")
    return resolve_spec(tuple(x.shape), names, mesh, rules)


# ---------------------------------------------------------------------------
# Parameter sharding by leaf name
# ---------------------------------------------------------------------------
# 2D weights, (in, out) convention: name -> logical names per dim.
_W2 = {
    # row-parallel producers: input dim FSDP-sharded, output dim TP-sharded
    "wq": ("data_in", "model"),
    "wk": ("data_in", "model"),
    "wv": ("data_in", "model"),
    "wg": ("data_in", "model"),
    "wu": ("data_in", "model"),
    "wi": ("data_in", "model"),
    "up": ("data_in", "model"),
    "in_proj": ("data_in", "model"),
    "w_in": ("data_in", "model"),
    # column-parallel consumers: input dim TP-sharded, output dim FSDP-sharded
    "wo": ("model", "data_in"),
    "wd": ("model", "data_in"),
    "down": ("model", "data_in"),
    "out_proj": ("model", "data_in"),
    # vocab-parallel embeddings (rows = vocab)
    "embed": ("vocab", "data_in"),
    "head": ("vocab", "data_in"),
    # mamba inner projections (d_in is the TP dim)
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "A_log": ("model", None),
    "conv_w": (None, "model"),
    "router": (None, None),
}
# 3D MoE expert stacks: EP over data when the expert count divides it,
# otherwise (the dedup/divisibility fallback) FSDP row-sharding over data
_W3 = {
    "wg": ("expert", "data_in", "model"),
    "wu": ("expert", "data_in", "model"),
    "wi": ("expert", "data_in", "model"),
    "wd": ("expert", "model", "data_in"),
}
_W1 = {
    "conv_b": ("model",),
    "D": ("model",),
    "dt_bias": ("model",),
    "skip": ("model",),
    "f_bias": (None,),
    "norm_w": (None,),
    "w": (None,),
    "b": (None,),
}
_W4 = {
    "r": (None, None, None, "model"),  # sLSTM block-diag recurrent
}

_PACKED_LEAF_SUFFIXES = (
    "packed", "meta", "scale", "col_sums", "bias", "act_scale", "act_zp",
    "spec_arr",
)
#: packed-leaf members that are tiny per-site metadata (static activation
#: quantizer scalars, the serialized DatapathSpec twin): always replicated
_REPLICATED_SUFFIXES = ("act_scale", "act_zp", "spec_arr")


def _leaf_logical_names(path, leaf) -> tuple:
    """Logical names for one leaf of ``leaf.ndim`` dims at key ``path``.

    A packed site's leaves sit under the weight's name; ``meta`` (the 2:4
    index leaf, (K//4, N)) co-shards with ``packed``: both fall through to
    the weight-name table, so a rank holding a shard of the codes holds
    the matching shard of the indices. ``scale``/``col_sums``/``bias``
    shard only the channel dim, except the expert axis of MoE stacks,
    which co-shards with the codes."""
    keys = [k for k in path if isinstance(k, str)]
    name = keys[-1] if keys else None
    suffix = None
    if name in _PACKED_LEAF_SUFFIXES and len(keys) >= 2:
        suffix, name = name, keys[-2]
    ndim = len(leaf.shape)
    if suffix in _REPLICATED_SUFFIXES:
        return (None,) * ndim
    table = {1: _W1, 2: _W2, 3: _W3, 4: _W4}.get(ndim, {})
    names = table.get(name, (None,) * ndim)
    if suffix in ("scale", "col_sums", "bias"):
        chan = names[-1] if names else None
        mids = [None] * (ndim - 1)
        if mids and names and names[0] == "expert":
            mids[0] = "expert"
        names = (*mids, chan)
    return names


def param_paths(model) -> dict[str, tuple[str, ...]]:
    """The reference key path (without the layer index) of every tensor of
    the port's model, by its state name (``model.state_dict()`` keys)."""
    from repro_torch.models.layers import Linear

    out = {}
    for mod_name, mod in model.named_modules():
        keys = tuple(k for k in mod_name.split(".") if k and not k.isdigit())
        for attr, t in list(mod._parameters.items()) + list(mod._buffers.items()):
            if t is None:
                continue
            full = f"{mod_name}.{attr}" if mod_name else attr
            if isinstance(mod, Linear) and attr == "w" and mod.bias is None:
                out[full] = keys  # the reference's bare weight array
            else:
                out[full] = (*keys, attr)
    return out


def param_shardings(model, mesh, rules: dict | None = None) -> dict[str, tuple]:
    """The spec of every tensor of a model (parameters and buffers; a
    ``meta``-device model gives them without allocating), by state name."""
    rules = rules or DEFAULT_RULES
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    return {name: resolve_spec(tuple(tensors[name].shape),
                               _leaf_logical_names(path, tensors[name]), mesh, rules)
            for name, path in param_paths(model).items()}


def batch_shardings(batch: dict, mesh, rules: dict | None = None) -> dict:
    """Batch dict: dim 0 = global batch -> ("pod", "data")."""
    rules = rules or DEFAULT_RULES
    return {k: resolve_spec(tuple(v.shape), ("batch",) + (None,) * (v.dim() - 1), mesh, rules)
            for k, v in batch.items()}


#: paged-cache bookkeeping leaves (block tables, free-list stack, per-slot
#: scalars): tiny int32/bool state every rank holds in full. The page pools
#: shard like dense KV (kv_heads dim); the page axis never shards.
_PAGED_ADMIN_LEAVES = (
    "block_table", "seq_lens", "active", "uids", "steps", "last_tok",
    "free_list", "free_top", "page_refcounts",
)

#: a recurrent state leaf's trailing dims (after the slot/batch dim)
_STATE_TRAILING = {
    "conv": (None, "ffn"),
    "ssm": ("ffn", None),
    "C": ("heads", None, None),
    "n": ("heads", None),
    "m": ("heads",),
    "h": (None,),
    "c": (None,),
}


def cache_shardings(cache, cfg, mesh, rules: dict | None = None):
    """Specs of a decode cache, in its structure: the paged cache's dict
    (``pools`` a list, one dict a layer) or the dense cache's list of
    per-layer dicts (:func:`~repro_torch.models.transformer.init_cache`).

    Pools (``k_pages``/``v_pages`` (nb + 1, bs, nkv, hd)) shard kv heads;
    their int8 ``k_scales``/``v_scales`` (nb + 1, nkv) co-shard with them;
    admin leaves replicate. Dense KV (B, S, nkv, hd) shards the batch and
    kv heads, or, where kv_heads does not divide the model axis, the
    sequence (the reference's context-parallel fallback). Recurrent state
    (slots or batch, ...) shards the batch and its channel dims."""
    rules = rules or DEFAULT_RULES
    model_size = mesh.shape.get("model", 1)
    paged = isinstance(cache, dict) and "free_list" in cache

    def one(top, name, leaf):
        if paged and top != "pools" and top not in _PAGED_ADMIN_LEAVES:
            # loud by design: a silently-replicated new pool leaf is the
            # bug class the mesh tests exist to catch
            raise ValueError(
                f"unknown paged cache leaf {top!r}: not under 'pools' and "
                f"not in _PAGED_ADMIN_LEAVES {_PAGED_ADMIN_LEAVES}; declare "
                "its sharding explicitly in runtime.sharding")
        nd = leaf.dim()
        if name in _PAGED_ADMIN_LEAVES:
            return (None,) * nd
        if name in ("k_pages", "v_pages") and nd == 4:
            names = (None, None, "kv_heads", None)
        elif name in ("k_scales", "v_scales") and nd == 2:
            names = (None, "kv_heads")
        elif name in ("k", "v") and nd == 4:
            nkv = leaf.shape[2]
            names = ("batch", None, "kv_heads", None) if nkv % model_size == 0 else \
                ("batch", "seq", None, None)
        else:
            names = ("batch", *_STATE_TRAILING.get(name, (None,) * (nd - 1)))[:nd]
        return resolve_spec(tuple(leaf.shape), names, mesh, rules)

    if not paged:
        return [{k: one(None, k, v) for k, v in layer.items()} for layer in cache]
    out = {}
    for top, v in cache.items():
        if top == "pools":
            out[top] = [{k: one(top, k, leaf) for k, leaf in pool.items()} for pool in v]
        else:
            out[top] = one(top, top, v)
    return out


def replicated(tensor) -> tuple:
    """The replicated spec of ``tensor``."""
    return (None,) * tensor.dim()


def paged_engine_shardings(model, cache, cfg, mesh, rules: dict | None = None):
    """(param specs, cache specs) for the paged engine: pools kv-head
    sharded, admin leaves replicated, every token output replicated."""
    rules = SERVING_QUANT_RULES if rules is None else rules
    return param_shardings(model, mesh, rules), cache_shardings(cache, cfg, mesh, rules)


def rows_sharding(shape, mesh, rules: dict | None = None) -> tuple:
    """Row (dim 0) sharding for per-request host inputs: batched-admit
    prompt blocks shard over the data axis when the row count divides it."""
    rules = DEFAULT_RULES if rules is None else rules
    return resolve_spec(tuple(shape), ("batch",) + (None,) * (len(shape) - 1), mesh, rules)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def local_slice(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a full tensor under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n = mesh.axes_size(axes)
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axes) * size, size)
    return x


def host_to_global(tree, specs, mesh):
    """This rank's slice of every tensor of ``tree`` (a tensor, or dicts,
    lists and tuples of them, as ``specs``), as contiguous copies. Every
    rank must hold the identical full value."""
    if isinstance(tree, torch.Tensor):
        return local_slice(tree, specs, mesh).contiguous().clone()
    if isinstance(tree, dict):
        return {k: host_to_global(v, specs[k], mesh) for k, v in tree.items()}
    return type(tree)(host_to_global(v, s, mesh) for v, s in zip(tree, specs))


def host_read(x: torch.Tensor) -> np.ndarray:
    """A replicated tensor read to host memory: every rank holds it whole,
    so the local copy is the global value."""
    return x.detach().to("cpu", copy=True).numpy()


@dataclass(frozen=True)
class SiteShard:
    """A sharded matmul site: its input dim ``k`` and output dim ``n`` are
    sharded over these axes (() replicated); ``scale``/``bias`` are the
    axes its per-channel vectors were placed under. An expert-stacked
    site's experts are sharded over ``e``: it holds experts ``[e_lo,
    e_hi)`` (:meth:`experts`) of every leaf but its replicated per-expert
    quantizer (``act_scale``/``act_zp``), which it slices."""

    mesh: object
    k: tuple
    n: tuple
    scale: tuple = ()
    bias: tuple = ()
    col_sums: tuple = ()
    e: tuple = ()

    def experts(self, n_experts: int) -> tuple[int, int]:
        """This rank's [lo, hi) of ``n_experts`` stacked experts."""
        return shard_range(n_experts, self.mesh, self.e)


@dataclass(frozen=True)
class MixerShard:
    """A recurrent mixer's layout on this rank: the d_in channels of its
    float leaves (conv, D, dt_bias, A_log, skip) over ``ch``, the heads its
    cell steps over ``heads`` (mLSTM: C/n/m and q/k/v), the mLSTM input
    gate's head columns over ``wi``, the sLSTM recurrent matrix's last dim
    over ``rec``. ``states`` maps each decode state to the dim and axes it
    is computed in; ``store`` (set by the paged engine) to the spec its
    slot lanes are held under, whose slot axis (dim 0, ``batch``) may be
    sharded too. :meth:`lanes_in` and :meth:`lanes_out` move a state
    between the two; both pick slices or gathers from the layouts alone, so
    every rank issues the same collectives."""

    mesh: object
    ch: tuple = ()
    heads: tuple = ()
    wi: tuple = ()
    rec: tuple = ()
    states: dict = field(default_factory=dict)
    store: dict | None = None

    def lanes_in(self, name: str, lanes: torch.Tensor) -> torch.Tensor:
        """The stored ``lanes`` of state ``name`` in its compute layout:
        every slot, this rank's channels or heads (a view of ``lanes``
        where no gather is needed). Where the slots are sharded (``data``
        > 1) this gathers every slot's state, each step: a token moves the
        whole state and a step holds it, so the slot sharding saves
        storage between steps, not peak memory."""
        dim, axes = self.states[name]
        spec = self.store[name]
        x = relayout(lanes, 0, spec_axes(spec[0]), (), self.mesh)
        return relayout(x, dim, spec_axes(spec[dim]), axes, self.mesh)

    def lanes_out(self, name: str, lanes: torch.Tensor, state: torch.Tensor) -> None:
        """Write ``state`` (compute layout) back into the stored ``lanes``
        in place, unless ``state`` is a view of them already."""
        back = self.to_store(name, state)
        back = relayout(back, 0, (), spec_axes(self.store[name][0]), self.mesh)
        if back.data_ptr() != lanes.data_ptr():
            lanes.copy_(back)

    def to_store(self, name: str, state: torch.Tensor) -> torch.Tensor:
        """``state`` (rows whole, compute layout) in its stored channel
        layout; its rows are untouched."""
        dim, axes = self.states[name]
        return relayout(state, dim, axes, spec_axes(self.store[name][dim]), self.mesh)

    def slots(self, name: str, num_slots: int) -> tuple[int, int]:
        """The [lo, hi) of the ``num_slots`` lanes this rank holds."""
        return shard_range(num_slots, self.mesh, spec_axes(self.store[name][0]))


@dataclass(frozen=True)
class AttnShard:
    """An attention layer's heads on this rank: q heads ``[q_lo, q_hi)``
    sharded over ``q``, kv heads ``[kv_lo, kv_hi)`` over ``kv`` (the pools'
    spec), and the kv heads ``[need_lo, need_hi)`` its q heads read; the q
    heads pad with zero heads to whole groups over those, ``pad`` before
    and after."""

    mesh: object
    q: tuple
    kv: tuple
    q_lo: int
    q_hi: int
    kv_lo: int
    kv_hi: int
    need_lo: int
    need_hi: int
    pad: tuple


@dataclass(frozen=True)
class EmbedShard:
    """The embedding's rows (vocab) and columns (d_model) sharded over
    these axes, and the LM head's, when untied."""

    mesh: object
    rows: tuple
    cols: tuple
    head_rows: tuple
    head_cols: tuple


def _attn_shard(cfg, mesh, rules, kv_axes) -> AttnShard:
    """Head layout of one attention layer. kv heads follow the pools; q
    heads shard over the rules' ``heads`` axes where they divide and stay
    inside this rank's kv heads (a q chunk over ("model", "data") model
    major lies in the kv chunk over "model"), else over the kv axes, else
    replicate."""
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    g = nh // nkv
    q_axes = ()
    for cand in (spec_axes(resolve_spec((nh,), ("heads",), mesh, rules)[0]), kv_axes):
        if cand and nh % mesh.axes_size(cand) == 0 and cand[:len(kv_axes)] == kv_axes:
            q_axes = cand
            break
    nq, nk = nh // mesh.axes_size(q_axes), nkv // mesh.axes_size(kv_axes)
    q_lo, kv_lo = mesh.index(q_axes) * nq, mesh.index(kv_axes) * nk
    need_lo, need_hi = q_lo // g, (q_lo + nq - 1) // g + 1
    if not (kv_lo <= need_lo and need_hi <= kv_lo + nk):
        raise AssertionError(f"q heads {q_lo}..{q_lo + nq} read kv heads outside "
                             f"{kv_lo}..{kv_lo + nk}")
    return AttnShard(mesh, q_axes, kv_axes, q_lo, q_lo + nq, kv_lo, kv_lo + nk, need_lo,
                     need_hi, (q_lo - need_lo * g, need_hi * g - q_lo - nq))


def _mixer_shard(mod, pre: str, specs: dict, cfg, mesh, rules) -> MixerShard:
    """The layout of a Mamba, mLSTM or sLSTM mixer from its leaves' specs:
    channels from ``conv_b`` (every d_in-long float leaf must agree), the
    mLSTM's heads as the rules resolve ``heads`` on its head count, the
    sLSTM recurrent matrix's last dim as ``r`` was placed."""
    from repro_torch.models.ssm import Mamba
    from repro_torch.models.xlstm import MLSTM

    if isinstance(mod, Mamba) or isinstance(mod, MLSTM):
        ch = spec_axes(specs[pre + "conv_b"][0])
        leaves = ("conv_w", "D", "dt_bias", "A_log") if isinstance(mod, Mamba) else (
            "conv_w", "skip")
        for leaf in leaves:
            dim = 1 if leaf == "conv_w" else 0
            if spec_axes(specs[pre + leaf][dim]) != ch:
                raise AssertionError(f"{pre}{leaf}: channels over "
                                     f"{specs[pre + leaf][dim]}, conv_b over {ch}")
    if isinstance(mod, Mamba):
        return MixerShard(mesh, ch=ch, states={"conv": (2, ch), "ssm": (1, ch)})
    if isinstance(mod, MLSTM):
        h = cfg.xlstm.mlstm_heads
        heads = spec_axes(resolve_spec((h,), ("heads",), mesh, rules)[0])
        return MixerShard(mesh, ch=ch, heads=heads, wi=spec_axes(specs[pre + "wi"][-1]),
                          states={"conv": (2, ch), "C": (1, heads), "n": (1, heads),
                                  "m": (1, heads)})
    return MixerShard(mesh, rec=spec_axes(specs[pre + "r"][-1]),
                      states={name: (1, ()) for name in ("h", "c", "n", "m")})


def shard_model(model, mesh, rules: dict | None = None, *, kv_axes=None):
    """A copy of ``model`` holding this rank's slice of every tensor under
    the rules (default :data:`SERVING_QUANT_RULES`), its sites (expert
    stacks too), attention layers, recurrent mixers and embedding annotated
    with their layouts; the model is left as it is. ``kv_axes``: the pools' kv-head axes (default: as the rules resolve
    ``kv_heads`` on the head count)."""
    from repro_torch.models.layers import Attention, Embedding, Linear, PackedLinear
    from repro_torch.models.ssm import Mamba
    from repro_torch.models.xlstm import MLSTM, SLSTM

    rules = SERVING_QUANT_RULES if rules is None else rules
    cfg = model.cfg
    specs = param_shardings(model, mesh, rules)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    memo = {}
    for name, t in tensors.items():
        local = local_slice(t.detach(), specs[name], mesh).contiguous().clone()
        memo[id(t)] = (torch.nn.Parameter(local, requires_grad=False)
                       if isinstance(t, torch.nn.Parameter) else local)
    placed = copy.deepcopy(model, memo)
    if kv_axes is None:
        kv_axes = spec_axes(resolve_spec((cfg.n_kv_heads,), ("kv_heads",), mesh, rules)[0])
    for mod_name, mod in placed.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        if isinstance(mod, PackedLinear):
            ps = specs[pre + "packed"]
            mod._shard = SiteShard(
                mesh, spec_axes(ps[-2]), spec_axes(ps[-1]), spec_axes(specs[pre + "scale"][-1]),
                () if mod.bias is None else spec_axes(specs[pre + "bias"][-1]),
                () if mod.col_sums is None else spec_axes(specs[pre + "col_sums"][-1]),
                spec_axes(ps[0]) if mod.stacked else ())
        elif isinstance(mod, Linear) and mod.w.dim() == 3:
            ws = specs[pre + "w"]
            mod._shard = SiteShard(mesh, spec_axes(ws[1]), spec_axes(ws[2]), (),
                                   () if mod.bias is None else spec_axes(specs[pre + "bias"][-1]),
                                   (), spec_axes(ws[0]))
        elif isinstance(mod, (Mamba, MLSTM, SLSTM)):
            mod._shard = _mixer_shard(mod, pre, specs, cfg, mesh, rules)
        elif isinstance(mod, Linear) and mod.w.dim() == 2:
            ws = specs[pre + "w"]
            mod._shard = SiteShard(mesh, spec_axes(ws[0]), spec_axes(ws[1]), (),
                                   () if mod.bias is None else spec_axes(specs[pre + "bias"][-1]))
        elif isinstance(mod, Attention):
            mod._shard = _attn_shard(cfg, mesh, rules, kv_axes)
        elif isinstance(mod, Embedding):
            es = specs[pre + "embed"]
            hs = specs.get(pre + "head", es)
            mod._shard = EmbedShard(mesh, spec_axes(es[0]), spec_axes(es[1]), spec_axes(hs[0]),
                                    spec_axes(hs[1]))
    placed._mesh = mesh
    return placed


__all__ = ["DEFAULT_RULES", "SERVING_QUANT_RULES", "AttnShard", "EmbedShard", "MixerShard",
           "SiteShard",
           "axis_rules", "batch_shardings", "cache_shardings", "host_read", "host_to_global",
           "local_slice", "logical_constraint", "paged_engine_shardings", "param_paths",
           "param_shardings", "prefer_expert_sharding", "replicated", "resolve_spec",
           "rows_sharding", "shard_model", "spec_axes"]
