"""Carry the JAX package's parameters into the port.

:func:`params_from_numpy` takes a parameter tree of the JAX package
(``repro.models.transformer.init_model``, ``pack_decode_params`` or
``packed_params_from_artifact``) with its arrays converted to numpy, and
builds the port's :class:`~repro_torch.models.transformer.Transformer`
computing the same function. The reference stacks each pattern slot's
leaves over repeats, ``(R, ...)``; layer ``r * period + s`` of the port
takes slice ``r`` of slot ``s``. Mamba, mLSTM and sLSTM mixers become
:class:`~repro_torch.models.ssm.Mamba`, :class:`~repro_torch.models.xlstm.MLSTM`
and :class:`~repro_torch.models.xlstm.SLSTM`: their sites as below, their
other leaves (conv, gates, A/D, recurrent matrices, norms) float tensors.
An MoE FFN becomes
:class:`~repro_torch.models.moe.MoE`: its router a float ``Linear`` and its
expert stacks (E, K, C) sites. Packed leaves become
:class:`~repro_torch.models.layers.PackedLinear` modules whose
:class:`~repro_torch.quant.spec.DatapathSpec` is rebuilt from ``spec_arr``
(the reference's static ``spec`` node is not an array and is ignored); a
2:4 leaf's ``meta`` rides along. :func:`params_to_numpy` goes the other
way on a float model, and :func:`reference_tree`,
:func:`train_state_tree` and their loaders lay a model, its gradients or
optimizer moments and a train state out as the reference's trees, the
layout the checkpoints share.

:func:`quantized_model_from_numpy` carries a calibrated reference
``QuantizedModel`` (``repro.quant.pipeline``) into the port's
:class:`~repro_torch.quant.pipeline.QuantizedModel`: per site the integer
codes, scales, corrected bias, activation quantizer, spec, certificate,
solver config and activation-observer state, so that the port's
mixed-precision search runs over the *same* codes as the reference's.

:func:`paged_cache_from_numpy` carries the reference's paged cache
(``repro.models.transformer.init_paged_cache``, arrays as numpy) into the
port's layout: one pool per layer, an attention pool with the write-sink
page added, a recurrent layer's (num_slots, ...) state lanes as they are.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Attention,
    Embedding,
    Linear,
    Norm,
    PackedLinear,
)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba
from repro_torch.models.transformer import Block, Transformer, is_kv_pool
from repro_torch.models.xlstm import MLSTM, SLSTM
from repro_torch.quant.spec import DatapathSpec


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _site(leaf, r: int, device) -> torch.nn.Module:
    if isinstance(leaf, dict) and "packed" in leaf:
        arrays = {k: to_tensor(np.asarray(v)[r], device)
                  for k, v in leaf.items() if k != "spec"}
        spec_arr = arrays["spec_arr"]  # (L,), or (E, L) for an expert stack
        spec = DatapathSpec.from_array(
            spec_arr.reshape(-1, spec_arr.shape[-1])[0].cpu().numpy()).leaf_spec()
        return PackedLinear(
            packed=arrays["packed"], meta=arrays.get("meta"), scale=arrays["scale"],
            col_sums=arrays.get("col_sums"), spec=spec, spec_arr=arrays["spec_arr"],
            act_scale=arrays.get("act_scale"), act_zp=arrays.get("act_zp"),
            bias=arrays.get("bias"))
    if isinstance(leaf, dict):  # high-precision site of a calibrated artifact
        bias = leaf.get("bias")
        return Linear(to_tensor(np.asarray(leaf["w"])[r], device),
                      None if bias is None else to_tensor(np.asarray(bias)[r], device))
    return Linear(to_tensor(np.asarray(leaf)[r], device))


def _norm(p: dict, r: int | None, device) -> Norm:
    def get(k):
        a = np.asarray(p[k])
        return to_tensor(a if r is None else a[r], device)

    return Norm(get("w"), get("b") if "b" in p else None)


_MIXERS = {"attn": Attention, "mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}


def params_from_numpy(tree: dict, cfg: ModelConfig, *, device="cuda") -> Transformer:
    """The port's model for a JAX parameter tree of numpy arrays."""
    dev = resolve_device(device)
    emb = tree["embedding"]
    embedding = Embedding(to_tensor(emb["embed"], dev),
                          to_tensor(emb["head"], dev) if "head" in emb else None)
    layers = []
    for i in range(cfg.n_layers):
        r, s = divmod(i, cfg.period)
        slot = tree["layers"][s]
        block = Block(cfg.layer_spec(i), norm1=_norm(slot["norm1"], r, dev))
        if "mixer" in slot:
            mixer = _MIXERS[cfg.layer_spec(i).mixer]
            floats = getattr(mixer, "FLOAT_LEAVES", ())
            block.mixer = mixer(**{
                n: to_tensor(np.asarray(v)[r], dev) if n in floats else _site(v, r, dev)
                for n, v in slot["mixer"].items()})
        if "ffn" in slot:
            block.norm2 = _norm(slot["norm2"], r, dev)
            ffn = MoE if cfg.layer_spec(i).ffn == "moe" else MLP
            block.ffn = ffn(**{n: _site(v, r, dev) for n, v in slot["ffn"].items()})
        layers.append(block)
    return Transformer(cfg, embedding, layers, _norm(tree["final_norm"], None, dev))


# ---------------------------------------------------------------------------
# The port's float model in the reference's tree (checkpoints, parity)
# ---------------------------------------------------------------------------
def _leaf_index(model: Transformer) -> dict[tuple, list[str]]:
    """For every leaf of the reference's parameter tree, its path (keys and
    slot indices) and the port's parameter names that fill it: one name
    outside the layer stack, one a repeat (in repeat order) inside it."""
    cfg = model.cfg
    index: dict[tuple, list[str]] = {("embedding", "embed"): ["embedding.embed"]}
    if model.embedding.head is not None:
        index[("embedding", "head")] = ["embedding.head"]

    def norm(path, prefix, nm):
        index.setdefault((*path, "w"), []).append(f"{prefix}.w")
        if nm.b is not None:
            index.setdefault((*path, "b"), []).append(f"{prefix}.b")

    for i, block in enumerate(model.layers):
        s = i % cfg.period
        pre = f"layers.{i}"
        for part in ("norm1", "mixer", "norm2", "ffn"):
            mod = getattr(block, part)
            if mod is None:
                continue
            if isinstance(mod, Norm):
                norm(("layers", s, part), f"{pre}.{part}", mod)
                continue
            for n in getattr(mod, "FLOAT_LEAVES", ()):
                index.setdefault(("layers", s, part, n), []).append(f"{pre}.{part}.{n}")
            for n, site in mod.named_children():
                if not isinstance(site, Linear) or site.bias is not None:
                    raise TypeError(f"{pre}.{part}.{n}: the reference's parameter tree holds "
                                    f"float weights only, not a {type(site).__name__}")
                index.setdefault(("layers", s, part, n), []).append(f"{pre}.{part}.{n}.w")
    norm(("final_norm",), "final_norm", model.final_norm)
    return index


def _nest(flat: dict[tuple, object], period: int) -> dict:
    """Paths to the reference's nested tree: dicts, with ``layers`` a tuple
    of one dict a pattern slot."""
    tree: dict = {"layers": [{} for _ in range(period)]}
    for path, leaf in flat.items():
        node = tree["layers"][path[1]] if path[0] == "layers" else tree
        for key in path[2:-1] if path[0] == "layers" else path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    tree["layers"] = tuple(tree["layers"])
    return tree


def reference_tree(model: Transformer, named: dict | None = None, *,
                   spec: bool = False) -> dict:
    """The reference's parameter tree of the port's float model: nested
    dicts, ``layers`` a tuple of pattern slots, each leaf stacked over
    repeats, (R, ...), as host tensors (copies) of the leaf's dtype.
    ``named`` maps the model's parameter names to other tensors of the
    same shapes (gradients, optimizer moments) to lay out instead;
    ``spec`` gives meta tensors, shapes and dtypes only (a restore
    target)."""
    named = dict(model.named_parameters()) if named is None else named
    flat = {}
    for path, names in _leaf_index(model).items():
        ts = [named[n] for n in names]
        shape = ((len(ts),) if path[0] == "layers" else ()) + tuple(ts[0].shape)
        if spec:
            flat[path] = torch.empty(shape, dtype=ts[0].dtype, device="meta")
        elif path[0] == "layers":
            flat[path] = torch.stack([t.detach().cpu() for t in ts])
        else:
            flat[path] = ts[0].detach().to("cpu", copy=True)
    return _nest(flat, model.cfg.period)


def _at(tree: dict, path: tuple):
    node = tree["layers"][path[1]] if path[0] == "layers" else tree
    for key in path[2:] if path[0] == "layers" else path:
        node = node[key]
    return node


def load_reference_tree_(model: Transformer, tree: dict, named: dict | None = None) -> None:
    """Copy a reference parameter tree (numpy arrays or tensors; the
    inverse of :func:`reference_tree`) into the model's parameters, or into
    ``named`` tensors keyed by the model's parameter names, in place."""
    named = dict(model.named_parameters()) if named is None else named
    with torch.no_grad():
        for path, names in _leaf_index(model).items():
            leaf = _at(tree, path)
            src = leaf if isinstance(leaf, torch.Tensor) else to_tensor(leaf, "cpu")
            for r, n in enumerate(names):
                dst = named[n]
                part = src[r] if path[0] == "layers" else src
                if tuple(part.shape) != tuple(dst.shape):
                    raise ValueError(f"{n}: tree leaf {path} has shape {tuple(part.shape)}, "
                                     f"the model's {tuple(dst.shape)}")
                dst.copy_(part)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 as ``ml_dtypes.bfloat16`` (the JAX
    package's numpy bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy_tree(v) for v in tree)
    return to_numpy(tree)


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of :func:`params_from_numpy` on a float model: the
    reference's parameter tree (``init_model``'s), layers stacked over
    repeats, with its leaf shapes and dtypes, as numpy arrays."""
    return _numpy_tree(reference_tree(model))


def _placed(model) -> bool:
    return getattr(model, "_mesh", None) is not None


def _full_meta(model, named: dict) -> dict:
    """Meta tensors of the full shapes of a placed model's blocks."""
    from repro_torch.runtime.steps import full_shape

    return {n: torch.empty(full_shape(t, model._train_specs[n], model._mesh), dtype=t.dtype,
                           device="meta") for n, t in named.items()}


def train_state_tree(state: dict, *, spec: bool = False) -> dict:
    """A train state (:func:`~repro_torch.runtime.steps.init_train_state`)
    in the reference's layout: ``params``, ``opt.m`` and ``opt.v`` as
    reference trees, ``opt.step`` a 0-d int32 tensor (host copies, or meta
    tensors under ``spec``). A state placed on a mesh
    (:func:`~repro_torch.runtime.steps.place_train_state`) gives its whole
    leaves: gathered, a collective every rank calls (or, under ``spec``,
    their full shapes)."""
    model, opt = state["params"], state["opt"]
    if _placed(model) and spec:
        named = _full_meta(model, dict(model.named_parameters()))
        return {"params": reference_tree(model, named, spec=True),
                "opt": {"m": reference_tree(model, _full_meta(model, opt["m"]), spec=True),
                        "v": reference_tree(model, _full_meta(model, opt["v"]), spec=True),
                        "step": torch.empty((), dtype=opt["step"].dtype, device="meta")}}
    if _placed(model):
        from repro_torch.runtime.steps import gather_train_state

        return train_state_tree(gather_train_state(state))
    step = opt["step"]
    return {"params": reference_tree(model, spec=spec),
            "opt": {"m": reference_tree(model, opt["m"], spec=spec),
                    "v": reference_tree(model, opt["v"], spec=spec),
                    "step": (torch.empty((), dtype=step.dtype, device="meta") if spec
                             else step.detach().to("cpu", copy=True))}}


def train_state_to_numpy(state: dict) -> dict:
    """:func:`train_state_tree` as numpy arrays: the reference's train state."""
    tree = train_state_tree(state)
    return {"params": _numpy_tree(tree["params"]),
            "opt": {k: _numpy_tree(tree["opt"][k]) for k in ("m", "v")}
            | {"step": to_numpy(tree["opt"]["step"])}}


def load_train_state_(state: dict, tree: dict) -> None:
    """Copy a reference train state (numpy arrays or tensors) into the
    port's ``state`` in place: parameters, both moments and the step. A
    state placed on a mesh takes this rank's slice of each whole leaf, on
    any mesh (the reference's resharding restore)."""
    from repro_torch.runtime.sharding import local_slice

    model, opt = state["params"], state["opt"]
    parts = ((dict(model.named_parameters()), tree["params"]), (opt["m"], tree["opt"]["m"]),
             (opt["v"], tree["opt"]["v"]))
    for named, sub in parts:
        if not _placed(model):
            load_reference_tree_(model, sub, named)
            continue
        full = {n: torch.empty(t.shape, dtype=t.dtype)
                for n, t in _full_meta(model, named).items()}
        load_reference_tree_(model, sub, full)
        with torch.no_grad():
            for n, t in named.items():
                t.copy_(local_slice(full[n], model._train_specs[n], model._mesh))
    step = tree["opt"]["step"]
    opt["step"].copy_(step if isinstance(step, torch.Tensor) else torch.as_tensor(np.asarray(step)))


def restore_params_(model: Transformer, ckpt_dir: str) -> int | None:
    """The newest checkpoint's ``params`` under ``ckpt_dir`` (a
    :class:`~repro_torch.checkpoint.CheckpointManager` root, written by
    either package's trainer) copied into ``model`` in place, cast to its
    dtypes. Returns the step, or None when there is no checkpoint."""
    from repro_torch.checkpoint import CheckpointManager

    restored = CheckpointManager(ckpt_dir).restore_latest(
        {"params": reference_tree(model, spec=True)})
    if restored is None:
        return None
    step, tree, _ = restored
    load_reference_tree_(model, tree["params"])
    return step


def _cert(c):
    """A reference certificate (or per-expert stack of them) as the port's."""
    from repro_torch.core.overflow import CertReport, StackedCertReport

    if c is None:
        return None
    if hasattr(c, "reports"):
        return StackedCertReport(reports=tuple(_cert(r) for r in c.reports))
    return CertReport(**{f.name: getattr(c, f.name) for f in fields(CertReport)})


def _quantized_linear(ql, device):
    from repro_torch.core.axe import PTQConfig, QuantizedLinear
    from repro_torch.core.calibration import ActObserver
    from repro_torch.core.quantizers import ActQuantParams

    def f32(a):
        return None if a is None else torch.from_numpy(np.array(a, np.float32)).to(device)

    aux = {}
    obs = ql.aux.get("observer") if isinstance(ql.aux, dict) else None
    if obs is not None:
        aux["observer"] = ActObserver(
            **{f.name: getattr(obs, f.name) for f in fields(ActObserver) if f.name != "dim_absmax"},
            dim_absmax=np.array(obs.dim_absmax, np.float64))
    spec = None
    if ql.spec is not None:
        spec = DatapathSpec(**{f.name: getattr(ql.spec, f.name) for f in fields(DatapathSpec)})
    return QuantizedLinear(
        q_int=f32(ql.q_int), scale=f32(ql.scale),
        act=ActQuantParams(scale=float(ql.act.scale), zero_point=int(ql.act.zero_point),
                           bits=int(ql.act.bits), signed=bool(ql.act.signed)),
        bias=f32(ql.bias), cert=_cert(ql.cert),
        cfg=PTQConfig(**{f.name: getattr(ql.cfg, f.name) for f in fields(PTQConfig)}),
        spec=spec, aux=aux)


def quantized_model_from_numpy(qm, cfg: ModelConfig, *, device="cuda"):
    """The port's :class:`~repro_torch.quant.pipeline.QuantizedModel` for a
    calibrated reference ``QuantizedModel`` whose arrays are numpy (anything
    ``np.asarray`` converts is taken). Codes become f32 code carriers,
    scales and biases f32 tensors on ``device``; certificates, specs, the
    solver config and the observers' state are copied field by field;
    sites, norms and embedding keep the reference's names and values."""
    from repro_torch.core.axe import PTQConfig
    from repro_torch.quant.families import get_adapter
    from repro_torch.quant.pipeline import QuantizedBlock, QuantizedComponent, QuantizedModel

    dev = resolve_device(device)

    def norm_dict(d):
        return None if d is None else {k: to_tensor(np.asarray(v), dev) for k, v in d.items()}

    emb = qm.embedding
    embedding = Embedding(to_tensor(emb["embed"], dev),
                          to_tensor(emb["head"], dev) if "head" in emb else None)
    fn = qm.final_norm
    final_norm = Norm(to_tensor(fn["w"], dev), to_tensor(fn["b"], dev) if "b" in fn else None)
    blocks = []
    for i, b in enumerate(qm.blocks):
        nb = QuantizedBlock(spec=cfg.layer_spec(i), norm1=norm_dict(b.norm1),
                            norm2=norm_dict(b.norm2))
        for kind in ("mixer", "ffn"):
            comp = getattr(b, kind)
            if comp is None:
                continue
            specs = {s.name: s for s in get_adapter(kind, comp.adapter).enumerate_sites(cfg)}
            params = {k: None if v is None or k in specs else to_tensor(np.asarray(v), dev)
                      for k, v in comp.params.items()}
            setattr(nb, kind, QuantizedComponent(
                adapter=comp.adapter, kind=comp.kind, params=params,
                linears={n: _quantized_linear(ql, dev) for n, ql in comp.linears.items()},
                specs=specs))
        blocks.append(nb)
    ptq = PTQConfig(**{f.name: getattr(qm.ptq, f.name) for f in fields(PTQConfig)})
    return QuantizedModel(cfg=cfg, ptq=ptq, embedding=embedding, final_norm=final_norm,
                          blocks=blocks)


def paged_cache_from_numpy(cache: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    """The port's paged cache for a reference paged cache of numpy arrays:
    layer ``r * period + s`` takes slice ``r`` of slot ``s``'s stacked pools
    (R, num_blocks, ...), and each pool gains the zero sink page at index
    num_blocks; the allocator and per-slot leaves carry over as they are."""
    dev = resolve_device(device)
    pools = []
    for i in range(cfg.n_layers):
        r, s = divmod(i, cfg.period)
        pool = {}
        sink = is_kv_pool(cache["pools"][s])
        for name, a in cache["pools"][s].items():
            t = to_tensor(np.asarray(a)[r], dev)
            pool[name] = torch.cat([t, torch.zeros_like(t[:1])]) if sink else t
        pools.append(pool)
    out = {k: to_tensor(v, dev) for k, v in cache.items() if k != "pools"}
    out["pools"] = pools
    return out
