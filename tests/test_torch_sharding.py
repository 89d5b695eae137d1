"""Port parity of the sharding rules (``repro_torch.runtime.sharding``)
against the reference's (``repro.runtime.sharding``), evaluated without
devices: the reference's on ``jax.sharding.AbstractMesh``, the port's on
its ``AbstractMesh``. Every leaf's spec must equal the reference's, entry
for entry, with the reference's leading repeats axis (never sharded)
dropped for a layer's leaf. Covered: the ten registry architectures at
full width (the port's ``abstract_params``, meta tensors) on the meshes
(1, 1), (2, 4), (4, 2), (16, 16) and (2, 16, 16) under both rule sets; RTN
packed trees of smoke configs (2:4 ``meta`` leaves, tiny-moe's expert
stacks); paged caches with float and int8 pages and dense caches (the
sequence fallback); the unknown-leaf refusal; and ``relayout`` between
every pair of layouts on 2 and 4 gloo ranks.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as JT
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.quant.spec import DatapathSpec as JDatapathSpec
from repro.runtime import sharding as jshard
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
from repro_torch.quant.serve_packed import pack_decode_params
from repro_torch.quant.spec import DatapathSpec
from repro_torch.runtime import sharding as shard

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = ((1, 1), (2, 4), (4, 2), (16, 16), (2, 16, 16))
RULES = {"default": (jshard.DEFAULT_RULES, shard.DEFAULT_RULES),
         "serving": (jshard.SERVING_QUANT_RULES, shard.SERVING_QUANT_RULES)}


def _meshes(shape):
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    return JAbstractMesh(shape, names), make_mesh(shape, abstract=True)


def _entry(e):
    return tuple(e) if isinstance(e, (tuple, list)) else e


def _ref_specs(tree) -> dict:
    """{key path (dict keys and slot indices): spec tuple} of a reference
    sharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    out = {}
    for path, sh in flat:
        key = tuple(e.key if hasattr(e, "key") else e.idx for e in path)
        out[key] = tuple(_entry(e) for e in sh.spec)
    return out


def _held(port: dict, ref: dict, to_ref) -> int:
    """Every port leaf's spec equals its reference leaf's (the repeats entry
    dropped where ``to_ref`` says the leaf is stacked), and every reference
    leaf has a port leaf. Returns the number of leaves compared."""
    seen = set()
    for name, spec in port.items():
        key, stacked = to_ref(name)
        assert key in ref, f"{name}: no reference leaf {key}"
        want = ref[key][1:] if stacked else ref[key]
        want = want + (None,) * (len(spec) - len(want))
        assert tuple(_entry(e) for e in spec) == want, f"{name} ({key}): {spec} != {want}"
        seen.add(key)
    assert seen == set(ref), f"reference leaves with no port leaf: {sorted(set(ref) - seen)[:5]}"
    return len(port)


def _param_key(model):
    paths = shard.param_paths(model)
    period = model.cfg.period

    def to_ref(name):
        parts = name.split(".")
        if parts[0] == "layers":
            return ("layers", int(parts[1]) % period, *paths[name][1:]), True
        return paths[name], False

    return to_ref


@pytest.fixture(scope="module")
def abstract_trees():
    """Both packages' parameter trees of every registry architecture at
    full width, shapes only."""
    return {arch: (JT.abstract_params(j_get_config(arch)), T.abstract_params(get_config(arch)))
            for arch in ARCH_IDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("rules", sorted(RULES))
def test_param_specs_match_reference(abstract_trees, arch, rules):
    jtree, model = abstract_trees[arch]
    assert all(t.is_meta for t in model.parameters())
    jr, pr = RULES[rules]
    for shape in MESHES:
        jm, pm = _meshes(shape)
        n = _held(shard.param_shardings(model, pm, pr),
                  _ref_specs(jshard.param_shardings(jtree, jm, jr)), _param_key(model))
        assert n == len(list(model.parameters()))


def _packed_pair(arch, ptq=None):
    """The reference's RTN-packed tree of a small config, shapes only
    (traced, not run), and the port's packed model of the same config."""
    jcfg = j_get_smoke(arch) if arch in ARCH_IDS else j_get_config(arch)
    jp = jax.eval_shape(lambda k: j_pack(JT.init_model(k, jcfg), jcfg,
                                         None if ptq is None else JDatapathSpec(**ptq)),
                        jax.random.key(0))
    cfg = get_smoke(arch) if arch in ARCH_IDS else get_config(arch)
    pp = pack_decode_params(T.init_model(cfg, 0, device="cpu"), None,
                            None if ptq is None else DatapathSpec(**ptq))
    return jp, pp


@pytest.mark.parametrize("arch,ptq", [("smollm-360m", None), ("tiny-lm-xs", {"sparsity": "2:4"}),
                                      ("tiny-moe", None), ("tiny-moe", {"sparsity": "2:4"})])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_packed_specs_match_reference(arch, ptq, rules):
    jtree, model = _packed_pair(arch, ptq)
    leaves = dict(model.named_buffers())
    if ptq:
        assert any(n.endswith(".meta") for n in leaves), "no 2:4 meta leaf"
    if arch == "tiny-moe":
        assert any(t.dim() == 3 and n.endswith(".packed") for n, t in leaves.items())
    jr, pr = RULES[rules]
    for shape in ((2, 4), (4, 2), (2, 2, 2)):
        names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
        jm, pm = JAbstractMesh(shape, names), make_mesh(shape, abstract=True)
        ref = {k: v for k, v in _ref_specs(jshard.param_shardings(jtree, jm, jr)).items()
               if k[-1] != "spec"}  # the reference's static spec node is no array
        _held(shard.param_shardings(model, pm, pr), ref, _param_key(model))


def _cache_key(period, paged):
    def to_ref(name):
        if paged and name[0] == "pools":
            return ("pools", name[1] % period, name[2]), True
        if not paged:
            return (name[0] % period, name[1]), True
        return (name[0],), False
    return to_ref


def _flat_cache(specs, paged):
    if not paged:
        return {(i, k): s for i, layer in enumerate(specs) for k, s in layer.items()}
    out = {}
    for top, v in specs.items():
        if top == "pools":
            out.update({("pools", i, k): s for i, pool in enumerate(v) for k, s in pool.items()})
        else:
            out[(top,)] = v
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["act", "int8", "dense"])
def test_cache_specs_match_reference(arch, kind):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for rules in sorted(RULES):
        jr, pr = RULES[rules]
        for shape in MESHES:
            jm, pm = _meshes(shape)
            if kind == "dense":
                jc = JT.init_cache(jcfg, 128, 1024, abstract=True)
                pc = T.init_cache(cfg, 128, 1024, device="meta")
            else:
                kv = "int8" if kind == "int8" else None
                jc = JT.init_paged_cache(jcfg, 64, 32, 64, 16, abstract=True, kv_dtype=kv)
                pc = T.init_paged_cache(cfg, 64, 32, 64, 16, device="meta", kv_dtype=kv)
            port = _flat_cache(shard.cache_shardings(pc, cfg, pm, pr), kind != "dense")
            ref = _ref_specs(jshard.cache_shardings(jc, jcfg, jm, jr))
            _held(port, ref, _cache_key(cfg.period, kind != "dense"))


def test_dense_kv_sequence_fallback():
    """llama3-405b's 8 kv heads do not divide a 16-wide model axis: its
    dense KV shards the sequence instead, as in the reference."""
    cfg = get_config("llama3-405b")
    specs = shard.cache_shardings(T.init_cache(cfg, 128, 1024, device="meta"), cfg,
                                  make_mesh((16, 16), abstract=True))
    assert specs[0]["k"] == ("data", "model", None, None)
    specs = shard.cache_shardings(T.init_cache(cfg, 128, 1024, device="meta"), cfg,
                                  make_mesh((2, 4), abstract=True))
    assert specs[0]["k"] == ("data", None, "model", None)


def test_unknown_paged_leaf_raises_and_admin_leaves():
    cfg = get_smoke("smollm-360m")
    cache = T.init_paged_cache(cfg, 4, 8, 8, 4, device="meta")
    assert set(cache) - {"pools"} == set(shard._PAGED_ADMIN_LEAVES)
    assert set(shard._PAGED_ADMIN_LEAVES) == set(jshard._PAGED_ADMIN_LEAVES)
    cache["stray"] = cache["seq_lens"]
    with pytest.raises(ValueError, match="unknown paged cache leaf 'stray'"):
        shard.cache_shardings(cache, cfg, make_mesh((2, 2), abstract=True))


def test_rows_and_batch_shardings_match_reference():
    for shape in ((2, 4), (4, 2), (2, 2, 2)):
        names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
        jm, pm = JAbstractMesh(shape, names), make_mesh(shape, abstract=True)
        for rows in (1, 2, 3, 4, 8):
            want = tuple(_entry(e) for e in jshard.rows_sharding((rows, 16), jm).spec)
            assert tuple(_entry(e) for e in shard.rows_sharding((rows, 16), pm)) == want


@pytest.mark.parametrize("shape", ["1,2", "2,2"])
def test_relayout_every_pair(tmp_path, shape):
    """``relayout`` between replicated, sharded over one axis and over an
    axis tuple (both orders), on every dim and dtype, equals this rank's
    slice of the full tensor, on gloo CPU ranks."""
    world = int(np.prod([int(x) for x in shape.split(",")]))
    outs = [tmp_path / f"o{r}.json" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), "--rank", str(r),
         "--world", str(world), "--mesh", shape, "--init", f"file://{tmp_path}/rdv",
         "--out", str(outs[r]), "--cases", "relayout"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, logs[r][-3000:]
        res = json.load(open(outs[r]))["relayout"]
        assert res["pairs"] >= (16 if world == 2 else 25) and not res["wrong"], res["wrong"][:5]
