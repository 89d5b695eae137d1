"""Packed-int4 serving models (port of ``repro/quant/serve_packed.py``):
dense sites, and 2:4 sparse sites stored compressed (packed kept codes
plus ``meta`` positions) when their spec says ``sparsity="2:4"``.

Two sources of packed sites:

  * :func:`pack_decode_params` — round-to-nearest codes of the float
    weights, the shape-compatible fallback when no calibrated artifact is
    supplied (dynamic activation quantization);
  * :func:`load_flat_artifact` + :func:`packed_params_from_artifact` — the
    v2 artifact that ``repro_torch.launch.quantize --out`` (or the JAX
    package's ``repro.launch.quantize --out``) writes: AXE codes, scales,
    corrected biases, per-site DatapathSpecs and static activation
    quantizers, packed at load;
  * :func:`serving_params_from_quantized` — the same, straight from a
    calibrated :class:`~repro_torch.quant.pipeline.QuantizedModel` in
    memory. :func:`export_quantized_artifact` flattens one to the v2 disk
    format.

Both return a new :class:`~repro_torch.models.transformer.Transformer`
whose quantizable sites are :class:`~repro_torch.models.layers.PackedLinear`
modules; untouched modules (embedding, norms) are shared with the input
model. Which sites get packed comes from the site registry
(:mod:`repro_torch.quant.families`).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.alphabet import weight_alphabet
from repro_torch.core.quantizers import quantize_int, weight_scales
from repro_torch.core.sparsity import is_2to4, mask_2to4
from repro_torch.kernels.w4a8_mm import compress_2to4, pack_int4
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Attention, Linear, Norm, PackedLinear, site_codes
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba
from repro_torch.models.xlstm import MLSTM, SLSTM

from .families import SiteSpec, check_supported, get_adapter
from .spec import (
    _SPEC_ARR_LEN,
    ARTIFACT_VERSION,
    DatapathMismatchError,
    DatapathSpec,
    is_packed_leaf,
    leaf_datapath,
)

__all__ = [
    "ensure_col_sums",
    "ensure_datapath_spec",
    "export_quantized_artifact",
    "load_flat_artifact",
    "pack_decode_params",
    "packable_sites",
    "packed_params_from_artifact",
    "packed_weight_bytes",
    "plan_expected_specs",
    "serving_params_from_quantized",
    "upgrade_packed_params",
]

#: the serving module of each family adapter's component
_COMPONENTS = {"attn": Attention, "mlp": MLP, "moe": MoE, "mamba": Mamba, "mlstm": MLSTM,
               "slstm": SLSTM}


def _component_fields(comp) -> dict:
    """A component module's constructor arguments: its child modules (sites,
    an MoE router) and its float leaves (``FLOAT_LEAVES``)."""
    fields = dict(comp.named_children())
    fields.update({name: getattr(comp, name) for name in getattr(comp, "FLOAT_LEAVES", ())})
    return fields


def packable_sites(cfg: ModelConfig):
    """Per pattern slot: {"mixer": (SiteSpec...), "ffn": (SiteSpec...)} of
    sites with an even (packable) reduction depth."""
    check_supported(cfg)
    slots = []
    for spec in cfg.pattern:
        slot = {}
        for kind, name in (("mixer", spec.mixer), ("ffn", spec.ffn)):
            if name == "none":
                slot[kind] = ()
                continue
            sites = get_adapter(kind, name).enumerate_sites(cfg)
            slot[kind] = tuple(s for s in sites if s.k % 2 == 0)
        slots.append(slot)
    return slots


def _spec_arr(spec: DatapathSpec, device, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """The persistable f32 array twin of a site's spec, broadcast over an
    expert stack's leading axis (``lead``)."""
    arr = torch.tensor(spec.to_array(), dtype=torch.float32, device=device)
    return arr.expand(*lead, arr.shape[0]).contiguous()


def _rtn_codes(w: torch.Tensor, w_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Round-to-nearest codes + per-channel scales for a (K, N) weight,
    through the calibration path's alphabet/quantizer, with the serving
    1e-8 scale floor."""
    alpha = weight_alphabet(w_bits)
    wf = w.to(torch.float32)
    scale = weight_scales(wf, alpha, axis=-2, eps=1e-8)
    return quantize_int(wf / scale, alpha), scale


def _pack_leaf(w: torch.Tensor, spec: DatapathSpec | None = None) -> PackedLinear:
    """(K, N) float weight, or an (E, K, N) expert stack, -> RTN-packed
    site with bf16 scales and the
    pack-time ``col_sums``. RTN ships no activation quantizer, so the
    embedded spec has ``static_act`` cleared. A 2:4 spec masks the RTN
    codes (mask, then round: no error feedback) and stores them
    compressed."""
    spec = replace((spec or DatapathSpec()).leaf_spec(), static_act=False)
    if spec.w_bits > 4:
        raise ValueError(
            f"int4 packing supports w_bits <= 4, got {spec.w_bits}; "
            f"serve this site as a high-precision leaf instead")
    q, scale = _rtn_codes(w, spec.w_bits)
    packed, meta = pack_int4(q), None
    if spec.sparsity is not None:
        if w.shape[-2] % 4:
            raise ValueError(
                f"2:4 sparsity needs K % 4 == 0, got K={w.shape[-2]}; "
                f"serve this site dense or in high precision instead")
        q = q * mask_2to4(q)
        packed, meta = compress_2to4(q)
    return PackedLinear(
        packed=packed,
        meta=meta,
        scale=scale.to(torch.bfloat16),
        col_sums=q.sum(dim=-2, keepdim=True).to(torch.int32),
        spec=spec,
        spec_arr=_spec_arr(spec, w.device, tuple(w.shape[:-2])),
    )


def _replace_sites(model, new_site):
    """A new Transformer whose site modules are ``new_site(layer, kind,
    name, module)`` (or the old module when it returns None)."""
    from repro_torch.models.transformer import Block, Transformer

    layers = []
    for i, block in enumerate(model.layers):
        new = Block(block.spec, block.norm1, block.mixer, block.norm2, block.ffn)
        for kind in ("mixer", "ffn"):
            comp = getattr(block, kind)
            if comp is None:
                continue
            comp = type(comp)(**_component_fields(comp))
            for name, mod in list(comp.named_children()):
                repl = new_site(i, kind, name, mod)
                if repl is not None:
                    setattr(comp, name, repl)
            setattr(new, kind, comp)
        layers.append(new)
    return Transformer(model.cfg, model.embedding, layers, model.final_norm)


def pack_decode_params(model, cfg: ModelConfig | None = None, ptq=None):
    """Replace every registered quantizable site with its RTN-packed
    artifact. ``ptq`` (a DatapathSpec, or an object with
    ``to_datapath_spec``) selects the datapath each site is stamped with;
    default the recipe datapath. Sites whose spec asks for more than 4 bits
    become RTN-dequantized float sites."""
    cfg = cfg or model.cfg
    slots = packable_sites(cfg)

    def new_site(i, kind, name, mod):
        by_name = {s.path[-1]: s for s in slots[i % cfg.period][kind]}
        if name not in by_name:
            return None
        site = by_name[name]
        spec = (site.datapath_for(ptq) if ptq is not None else site.datapath) or DatapathSpec()
        if spec.sparsity is not None and site.k % 4 != 0:
            # 2:4 groups need K % 4 == 0; Eq. 22 halves depth and tile
            # alike, so P_O stays valid for the dense codes served here
            spec = replace(spec, sparsity=None)
        if spec.w_bits > 4:
            q, s = _rtn_codes(mod.w, spec.w_bits)
            return Linear((q * s).to(mod.w.dtype))
        return _pack_leaf(mod.w, spec)

    return _replace_sites(model, new_site)


# ---------------------------------------------------------------------------
# Calibrated artifacts (the v2 disk format)
# ---------------------------------------------------------------------------
def _f32(a, device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _site_rec_leaf(rec: dict, site: SiteSpec, name: str, device):
    """One layer's site record -> a serving site.

    ``rec``: {"q": (K, C) int8-valued codes, "scale": (1, C) (numpy arrays
    or tensors), "spec":
    DatapathSpec with act numerics, "bias": optional (C,)}; an expert-stacked
    site's record carries (E, K, C) codes, (E, 1, C) scales and biases, and
    its one static activation quantizer goes to every expert. Returns a
    PackedLinear, or a float :class:`Linear` (dequantized weight plus the
    corrected bias) when the codes have no int4 container (w_bits > 4, odd
    K, or a 2:4 spec at K % 4 != 0). A 2:4 spec requires 2:4 codes, else
    :class:`DatapathMismatchError`, and packs them compressed."""
    spec = rec["spec"]
    q = _f32(rec["q"], device)
    scale = _f32(rec["scale"], device)
    bias = rec.get("bias")
    bias = _f32(bias, device) if site.use_bias and bias is not None else None
    if spec.w_bits > 4 or site.k % 2 != 0 or (spec.sparsity is not None and site.k % 4 != 0):
        return Linear(q * scale, bias)
    packed, meta = pack_int4(q), None
    if spec.sparsity is not None:
        # the certificate holds at the 2:4 effective depth only
        if not is_2to4(q):
            raise DatapathMismatchError(
                f"site {name}: certified sparsity={spec.sparsity!r} but the codes "
                f"are not 2:4 (some group of 4 along K has more than 2 nonzeros) — "
                f"the certificate's effective-depth bound would not hold for these "
                f"weights")
        packed, meta = compress_2to4(q)
    lead = tuple(q.shape[:-2])  # (E,) for an expert stack
    act_scale = act_zp = None
    if spec.static_act:
        act_scale = torch.full(lead, spec.act_scale, dtype=torch.float32, device=device)
        act_zp = torch.full(lead, float(spec.act_zp), dtype=torch.float32, device=device)
    return PackedLinear(
        packed=packed,
        meta=meta,
        scale=scale,
        col_sums=q.sum(dim=-2, keepdim=True).to(torch.int32),
        spec=spec.leaf_spec(),
        spec_arr=_spec_arr(spec, device, lead),
        act_scale=act_scale,
        act_zp=act_zp,
        bias=bias,
    )


def serving_params_from_quantized(qm):
    """The packed serving model straight from a calibrated QuantizedModel:
    AXE codes, per-channel scales, static activation quantizers, corrected
    biases and per-site specs, with the equalization-folded norms and the
    float embedding and final norm of the calibrated model."""
    from repro_torch.models.transformer import Block, Transformer

    cfg = qm.cfg
    layers = []
    for b in qm.blocks:
        def norm_of(d):
            return None if d is None else Norm(d["w"], d.get("b"))

        block = Block(b.spec, norm1=norm_of(b.norm1), norm2=norm_of(b.norm2))
        for kind in ("mixer", "ffn"):
            comp = getattr(b, kind)
            if comp is None:
                continue
            sites = {}
            for name, site in comp.specs.items():
                ql = comp.linears[name]
                rec = {"q": ql.q_int, "scale": ql.scale, "spec": ql.spec, "bias": ql.bias}
                sites[site.path[-1]] = _site_rec_leaf(rec, site, name, ql.q_int.device)
            cls = _COMPONENTS[comp.adapter]
            floats = getattr(cls, "FLOAT_LEAVES", ())
            for name, v in comp.params.items():
                if v is not None:  # an MoE router (a Linear), a mixer's float leaves
                    sites[name] = v if name in floats else Linear(v)
            setattr(block, kind, cls(**sites))
        layers.append(block)
    return Transformer(cfg, qm.embedding, layers, qm.final_norm)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def export_quantized_artifact(qm) -> tuple[dict, dict]:
    """Flatten a calibrated QuantizedModel into the v2 on-disk artifact:
    {"layer{i}/{kind}.{site}/{q,scale,bias,spec}"} numpy leaves (codes raw
    int8, scales and biases float32, the spec's float64 array; an expert
    stack's (E, K, C) codes and (E, 1, C) scales and biases) plus the
    equalization-folded norms ``layer{i}/norm{1,2}/{w,b}`` and MoE routers
    ``layer{i}/ffn.float/router``, and the meta dict with the schema
    version — the keys, dtypes and meta of the reference's exporter."""
    artifact: dict[str, np.ndarray] = {}
    site_specs = []
    for name, ql in qm.quantized_linears():
        artifact[f"{name}/q"] = _np(ql.q_int).astype(np.int8)
        artifact[f"{name}/scale"] = _np(ql.scale).astype(np.float32)
        if ql.bias is not None:
            artifact[f"{name}/bias"] = _np(ql.bias).astype(np.float32)
        spec = ql.spec if ql.spec is not None else ql.cfg.to_datapath_spec(
            ql.q_int.shape[-2], ql.act)
        artifact[f"{name}/spec"] = spec.to_array()
        site_specs.append(spec)
    site_keys = {s.key() for s in site_specs}
    for i, b in enumerate(qm.blocks):
        for norm_name in ("norm1", "norm2"):
            nrm = getattr(b, norm_name)
            if nrm is not None:
                for k, v in nrm.items():
                    artifact[f"layer{i}/{norm_name}/{k}"] = _np(v)
        # the router consumes the equalized input: its folded weights
        # travel with the artifact, or routing would differ at serving
        if b.ffn is not None and b.ffn.params.get("router") is not None:
            artifact[f"layer{i}/ffn.float/router"] = _np(b.ffn.params["router"])
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "arch": qm.cfg.name,
        "n_layers": qm.cfg.n_layers,
        "mixed_precision": len(site_keys) > 1,
        "datapath": (
            site_specs[0].describe() if len(site_keys) == 1
            else f"mixed: {len(site_keys)} site datapaths"
        ) if site_specs else "empty",
    }
    return artifact, meta


def load_flat_artifact(directory: str) -> tuple[dict, dict]:
    """Read a flat artifact directory (``manifest.json`` + ``.npy``
    leaves, as the JAX package's ``save_pytree`` writes a flat dict)."""
    from repro_torch.checkpoint.manager import read_manifest

    flat, meta = read_manifest(directory)
    return {_flat_key(k): v for k, v in flat.items()}, meta


def _flat_key(name: str) -> str:
    # keystr of a flat string key: "['layer0/mixer.wq/q']"
    if name.startswith("['") and name.endswith("']"):
        return name[2:-2]
    return name


def packed_params_from_artifact(flat: dict, model, cfg: ModelConfig | None = None,
                                meta: dict | None = None, strict: bool | None = None,
                                *, device=None):
    """Rebuild the packed serving model from a saved AXE artifact.

    ``model`` supplies the leaves the artifact does not carry (embedding,
    final norm); quantized sites and norms come from the artifact. A
    mismatched schema version, arch or depth raises
    :class:`DatapathMismatchError`, as do partial coverage under ``strict``
    (default: the meta's ``mixed_precision`` flag), artifact sites the
    model does not enumerate, and an artifact that matches no site."""
    cfg = cfg or model.cfg
    device = device if device is not None else model.embedding.embed.device
    if meta is not None:
        v = meta.get("artifact_version")
        if v != ARTIFACT_VERSION:
            raise DatapathMismatchError(
                f"artifact schema version {v!r} != supported {ARTIFACT_VERSION}")
        for field, want in (("arch", cfg.name), ("n_layers", cfg.n_layers)):
            got = meta.get(field)
            if got is not None and got != want:
                raise DatapathMismatchError(
                    f"artifact was exported for {field}={got!r} but the "
                    f"serving config is {field}={want!r} — an arch-mismatched "
                    f"artifact would silently serve float weights")
    check_supported(cfg)
    if strict is None:
        strict = bool(meta and meta.get("mixed_precision"))
    consumed: set[str] = set()
    missing: list[str] = []
    loaded: dict[tuple[int, str], dict] = {}
    for s, pattern_spec in enumerate(cfg.pattern):
        layer_ids = [r * cfg.period + s for r in range(cfg.repeats)]
        for kind, fam in (("mixer", pattern_spec.mixer), ("ffn", pattern_spec.ffn)):
            if fam == "none":
                continue
            for site in get_adapter(kind, fam).enumerate_sites(cfg):
                names = [f"layer{i}/{kind}.{site.name}" for i in layer_ids]
                present = [n for n in names if f"{n}/q" in flat]
                consumed.update(f"{n}/q" for n in present)
                if len(present) != len(names):
                    if present or strict:
                        missing.append(f"slot{s}/{kind}.{site.name} (have "
                                       f"{len(present)}/{len(names)} repeats)")
                    continue
                specs = [DatapathSpec.from_array(flat[f"{n}/spec"]) for n in names]
                for r, sp in enumerate(specs):
                    if not specs[0].matches(sp):
                        raise DatapathMismatchError(
                            f"site {names[0]}: repeat 0 certified "
                            f"{specs[0].describe()} but repeat {r} certified "
                            f"{sp.describe()} — one slot cannot serve two datapaths")
                for i, n, sp in zip(layer_ids, names, specs):
                    rec = {"q": flat[f"{n}/q"], "scale": flat[f"{n}/scale"],
                           "spec": sp, "bias": flat.get(f"{n}/bias")}
                    loaded.setdefault((i, kind), {})[site.path[-1]] = _site_rec_leaf(
                        rec, site, n, device)
    if missing:
        raise DatapathMismatchError(
            f"artifact does not cover {len(missing)} site(s) the model "
            f"enumerates: {missing} — refusing the silent float fallback "
            f"(strict={strict})")
    unknown = sorted(k for k in flat if k.endswith("/q") and k not in consumed)
    if unknown:
        raise DatapathMismatchError(
            f"artifact carries quantized sites this model does not "
            f"enumerate: {unknown}")
    if not loaded:
        raise DatapathMismatchError(
            "no quantized site in the artifact matched this model config — "
            "refusing to silently serve the float weights")

    out = _replace_sites(model, lambda i, kind, name, mod:
                         loaded.get((i, kind), {}).get(name))
    for i, block in enumerate(out.layers):
        router = flat.get(f"layer{i}/ffn.float/router")
        if router is not None and isinstance(block.ffn, MoE):
            block.ffn.router = Linear(torch.as_tensor(np.asarray(router), device=device))
        for norm_name in ("norm1", "norm2"):
            key = f"layer{i}/{norm_name}/w"
            if key in flat and getattr(block, norm_name) is not None:
                b = flat.get(f"layer{i}/{norm_name}/b")
                setattr(block, norm_name, Norm(
                    torch.as_tensor(np.asarray(flat[key]), device=device),
                    None if b is None else torch.as_tensor(np.asarray(b), device=device)))
    return out


def plan_expected_specs(cfg: ModelConfig, plan, base: DatapathSpec) -> dict:
    """The total ``site-key -> DatapathSpec`` map
    :func:`~repro_torch.quant.spec.validate_datapath` takes: every *packed*
    site the model enumerates, valued by the mixed-precision plan's entry
    when it has one, else the uniform ``base``. Sites without an int4
    container (w_bits > 4, such as a plan's w8-promoted sites, an odd
    reduction depth, or a 2:4 spec at K % 4 != 0) serve float ``Linear``
    modules and are left out, as :func:`_site_rec_leaf` builds them. A plan
    key naming no site of the model raises here, before anything serves."""
    expected: dict[str, DatapathSpec] = {}
    known: set[str] = set()
    plan = plan if plan is not None else {}
    for s, pattern_spec in enumerate(cfg.pattern):
        for kind, fam in (("mixer", pattern_spec.mixer), ("ffn", pattern_spec.ffn)):
            if fam == "none":
                continue
            for site in get_adapter(kind, fam).enumerate_sites(cfg):
                key = f"slot{s}/{kind}.{site.name}"
                known.add(key)
                spec = plan.get(key)
                spec = base if spec is None else spec
                if spec.w_bits > 4 or site.k % 2 != 0 or (
                        spec.sparsity is not None and site.k % 4 != 0):
                    continue
                expected[key] = spec
    unknown = sorted(set(plan) - known)
    if unknown:
        raise DatapathMismatchError(
            f"mixed-precision plan names sites this model does not enumerate: "
            f"{unknown}; model sites: {sorted(known)}")
    return expected


# ---------------------------------------------------------------------------
# Legacy-artifact upgrade shims (one-time, in place)
# ---------------------------------------------------------------------------
def _packed_modules(model):
    return [m for m in model.modules() if is_packed_leaf(m)]


def ensure_col_sums(model):
    """Fill the pack-time ``col_sums`` of packed sites that predate it (one
    full unpack per site, once). Updates the sites in place; returns the
    model."""
    for leaf in _packed_modules(model):
        if leaf.col_sums is None:
            leaf.col_sums = site_codes(leaf).to(torch.int32).sum(dim=-2, keepdim=True)
    return model


def ensure_datapath_spec(model, default: DatapathSpec | None = None):
    """Attach a DatapathSpec to packed sites without one: decoded from the
    ``spec_arr`` twin when present, else ``default`` (the recipe
    datapath) stamped with the legacy schema version. In place."""
    for leaf in _packed_modules(model):
        if leaf.spec is not None:
            continue
        spec = leaf_datapath(leaf)
        if spec is not None:
            leaf.spec = spec.leaf_spec()
            continue
        spec = replace((default or DatapathSpec()).leaf_spec(),
                       version=1 if leaf.col_sums is not None else 0)
        leaf.spec = spec
        leaf.spec_arr = _spec_arr(spec, leaf.packed.device)
    return model


def upgrade_packed_params(model, default: DatapathSpec | None = None):
    """The full legacy upgrade: specs first (so the stamped version is the
    schema the site arrived with), then ``col_sums``. Idempotent."""
    return ensure_col_sums(ensure_datapath_spec(model, default))


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------
def packed_weight_bytes(cfg: ModelConfig, *, scale_bytes_per: int = 2,
                        static_act: bool = False, with_bias: bool = False,
                        sparsity: str | None = None) -> dict:
    """Analytic packed-artifact bytes (codes + per-channel scale +
    ``col_sums`` + spec twin + optional static-act and bias) against the
    bf16 baseline. Defaults describe the RTN :func:`pack_decode_params`
    model (bf16 scales, dynamic act, no bias). ``sparsity="2:4"`` counts
    every site with K % 4 == 0 compressed: K/4 code bytes plus K/4 meta
    bytes per column, the same as dense K/2 at int4 (2:4 buys the halved
    certified depth, not bytes); other sites are counted dense."""
    elems = code = scale = col = spec_b = act = bias = meta_b = 0
    for slot in packable_sites(cfg):
        for kind in ("mixer", "ffn"):
            for s in slot[kind]:
                st = s.stacked or 1
                elems += s.k * s.c * st
                if sparsity is not None and s.k % 4 == 0:
                    code += s.k * s.c * st // 4  # 2 kept codes per group
                    meta_b += s.k * s.c * st // 4  # one position byte per group
                else:
                    code += s.k * s.c * st // 2  # an int8 byte holds 2 codes
                scale += s.c * st * scale_bytes_per
                col += s.c * st * 4  # int32
                spec_b += st * _SPEC_ARR_LEN * 4  # f32 spec_arr twin
                if static_act:
                    act += st * (4 + 4)  # f32 act_scale + act_zp
                if with_bias and s.use_bias:
                    bias += s.c * st * 4
    r = cfg.repeats
    total = (code + meta_b + scale + col + spec_b + act + bias) * r
    return {
        "weight_elems": elems * r,
        "bf16_bytes": 2 * elems * r,
        "packed_code_bytes": code * r,
        "meta_bytes": meta_b * r,
        "scale_bytes": scale * r,
        "col_sums_bytes": col * r,
        "spec_bytes": spec_b * r,
        "act_bytes": act * r,
        "bias_bytes": bias * r,
        "packed_bytes": total,
    }
