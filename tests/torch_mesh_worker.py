"""One rank of the mesh-serving tests (``tests/test_torch_mesh_serving.py``).

    python tests/torch_mesh_worker.py --rank R --world N --mesh dp,tp \\
        --init file:///tmp/x/rdv --params params.pkl --out out_R.json [--cases a,b] \\
        [--family-params families.pkl]

Each rank joins a gloo group through ``--init`` (a ``file://`` rendezvous),
builds the (data, model) mesh and runs the cases in order: every serving
trace of :func:`trace` through the mesh engine (``traces``), the local
shard shapes (``contract``), the refusals and ``relayout``; for
``tests/test_torch_mesh_families.py`` the MoE and recurrent rungs'
traces (``families``), expert-stacked sites on their shards
(``stacked_sites``), the per-expert range reduce (``range_reduce``) and
the fused in_proj/up split (``fused_split``). It writes what the test
holds across ranks and against the one-device engine, which the test runs
itself on the same traces (:func:`serve_trace` and
:func:`serve_family` without a mesh): streams, free state, allocator and
rank digests, shapes, counters and refusals. No JAX: the reference's
parameters arrive as pickled trees of numpy arrays.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import pickle
import sys
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.quant.serve_packed import pack_decode_params  # noqa: E402
from repro_torch.runtime import sharding as shardlib  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    PagedConfig,
    PagedEngine,
    Request,
    SamplerConfig,
    SchedulerPolicy,
)

GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, seed=5)
LENS = [(8, 8, 0), (8, 6, 1), (16, 8, 0), (8, 12, 1), (24, 4, 0)]


def tiny_cfg():
    """The reference mesh tests' model: tiny-lm-xs, 2 layers, vocab 128
    (n_kv_heads 4, so tp = 2 shards the pools)."""
    return get_config("tiny-lm-xs").scaled(n_layers=2, vocab=128)


def pc(**kw):
    base = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4,
                chunk_max=4, attn_impl="auto")
    base.update(kw)
    return PagedConfig(**base)


def reqs(lens, seed=11, vocab=128):
    rng = np.random.default_rng(seed)
    return [Request(uid=u, prompt=rng.integers(0, vocab, size=s).astype(np.int32), max_new=m,
                    priority=p) for u, (s, m, p) in enumerate(lens)]


def prefix_reqs(vocab=128):
    rng = np.random.default_rng(3)
    stem = rng.integers(0, vocab, size=16).astype(np.int32)
    return [Request(uid=u, prompt=np.concatenate(
        [stem, rng.integers(0, vocab, size=4).astype(np.int32)]), max_new=6) for u in range(4)]


def copies(rs):
    return [Request(r.uid, r.prompt.copy(), r.max_new, r.priority) for r in rs]


def streams(out) -> dict:
    return {str(u): np.asarray(v).tolist() for u, v in sorted(out.items())}


def models(ctx, key: str):
    """The traces' models, built once a process: ``model`` (tiny-lm-xs, the
    port's seeded init), ``jmodel`` (the reference's parameters),
    ``packed`` (``model`` RTN-packed), ``smollm`` (smollm-360m's smoke,
    RTN-packed: 15 q / 5 kv heads, so tp = 2 replicates q/k/v and the pools
    while wo's K shards mid-head)."""
    cache = ctx.setdefault("models", {})
    if key not in cache:
        if key == "jmodel":
            with open(ctx["params"], "rb") as f:
                cache[key] = params_from_numpy(pickle.load(f), tiny_cfg(), device="cpu")
        elif key == "model":
            cache[key] = init_model(tiny_cfg(), 0, device="cpu")
        elif key == "packed":
            cache[key] = pack_decode_params(models(ctx, "model"))
        else:
            cache[key] = pack_decode_params(init_model(get_smoke("smollm-360m"), 0, device="cpu"))
    return cache[key]


def trace(name: str) -> dict:
    """A serving case: its model, requests, paged config (``ref`` the
    one-device engine's, where it differs), sampler and rules."""
    lens = [(8, 6, 0), (8, 4, 1), (24, 6, 0), (8, 5, 0), (16, 4, 1), (8, 3, 0)]
    return {
        "cold_greedy": dict(model="jmodel", reqs=reqs(LENS), paged=pc()),
        "shared_prefix": dict(model="model", reqs=prefix_reqs(), paged=pc(prefix_cache=True)),
        "int8_kv": dict(model="model", reqs=reqs(LENS), paged=pc(kv_dtype="int8")),
        "int8_prefix": dict(model="jmodel", reqs=prefix_reqs(),
                            paged=pc(kv_dtype="int8", prefix_cache=True)),
        # a tight pool forces preempt-and-requeue; the one-device engine's
        # pool is roomy FIFO
        "preempt": dict(model="model", reqs=reqs([(8, 24, 0), (8, 24, 1), (8, 24, 1)]),
                        paged=pc(num_blocks=6, sched=SchedulerPolicy(admit_window=2,
                                                                     watermark=(1, 4))),
                        ref=pc()),
        "batched_admit": dict(model="model", reqs=reqs(lens, seed=7),
                              paged=pc(num_blocks=24, max_concurrency=4,
                                       sched=SchedulerPolicy(admit_window=4, batch_max=3,
                                                             prefill_chunk=16))),
        "sampled": dict(model="model", reqs=reqs(LENS), paged=pc(), sampler=SAMPLED),
        "rtn_packed": dict(model="packed", reqs=reqs(LENS), paged=pc()),
        "rtn_packed_int8": dict(model="packed", reqs=reqs(LENS), paged=pc(kv_dtype="int8")),
        "smollm_smoke": dict(model="smollm", reqs=reqs(LENS), paged=pc()),
        "default_rules": dict(model="model", reqs=reqs(LENS), paged=pc(),
                              rules=shardlib.DEFAULT_RULES),
    }[name]


TRACES = ("cold_greedy", "shared_prefix", "int8_kv", "int8_prefix", "preempt", "batched_admit",
          "sampled", "rtn_packed", "rtn_packed_int8", "smollm_smoke", "default_rules")


def free_state(eng) -> dict:
    """An engine's device free state, its host allocator and its counters."""
    return {"free": {leaf: shardlib.host_read(eng.cache[leaf]).astype(np.int64).tolist()
                     for leaf in ("free_list", "page_refcounts", "free_top")},
            "pool_free": np.asarray(eng.pool_state.free_list).astype(np.int64).tolist(),
            "pool_digest": eng.pool_state.digest(), "preemptions": eng.preemptions,
            "batch_admits": eng.batch_admits, "prefill_chunks": eng.prefill_chunks,
            "hits": None if eng.prefix_cache is None else eng.prefix_cache.hits}


def serve_trace(ctx, name: str, mesh=None) -> tuple:
    """One trace through the mesh engine (``mesh``) or the one-device
    engine (the trace's ``ref`` config): (engine, its record)."""
    t = trace(name)
    paged = t["paged"] if mesh is not None else t.get("ref", t["paged"])
    eng = PagedEngine(models(ctx, t["model"]), None, paged, t.get("sampler", GREEDY),
                      device="cpu", mesh=mesh, shard_rules=t.get("rules"))
    rec = {"streams": streams(eng.serve(copies(t["reqs"]))), **free_state(eng)}
    return eng, rec


def case_traces(ctx):
    """Every serving trace through the mesh engine, with a digest of each
    rank's streams and free state; the sampled trace's noise checked
    collective-safe."""
    out = {}
    for name in TRACES:
        if name == "smollm_smoke" and ctx["mesh"].shape["data"] > 1:
            continue  # smollm's fallback runs on (1, 2)
        eng, rec = serve_trace(ctx, name, ctx["mesh"])
        h = hashlib.blake2b(digest_size=16)
        for uid, toks in rec["streams"].items():
            h.update(np.asarray(toks, np.int32).tobytes())
        for leaf in ("free_list", "page_refcounts"):
            h.update(np.asarray(rec["free"][leaf], np.int32).tobytes())
        h.update(rec["pool_digest"].encode())
        rec["digest"] = h.hexdigest()
        rec["step_mode"] = eng.step_mode
        if name == "sampled":
            eng.assert_sampling_keys_collective_safe()
            rec["keys_safe"] = True
        if name == "smollm_smoke":
            attn = eng.model.layers[0].mixer
            rec["wo_k"], rec["wq_n"] = list(attn.wo._shard.k), list(attn.wq._shard.n)
            rec["wo_packed"] = list(attn.wo.packed.shape)
        out[name] = rec
    return out


def case_contract(ctx):
    """The out-shardings contract as local shard shapes: pools hold nkv/tp
    heads, scales co-shard with them, admin leaves are whole."""
    cfg = tiny_cfg()
    eng = PagedEngine(models(ctx, "model"), None, pc(kv_dtype="int8"), GREEDY, device="cpu",
                      mesh=ctx["mesh"])
    eng.serve(reqs(LENS[:2]))
    pool = eng.cache["pools"][0]
    specs = eng.shardings[1]
    return {"k_pages": list(pool["k_pages"].shape), "k_scales": list(pool["k_scales"].shape),
            "k_pages_spec": list(map(_entry, specs["pools"][0]["k_pages"])),
            "k_scales_spec": list(map(_entry, specs["pools"][0]["k_scales"])),
            "admin": {n: list(eng.cache[n].shape) for n in shardlib._PAGED_ADMIN_LEAVES},
            "admin_specs": {n: list(map(_entry, specs[n])) for n in shardlib._PAGED_ADMIN_LEAVES},
            "nkv": cfg.n_kv_heads, "hd": cfg.head_dim}


def _entry(e):
    return e if e is None or isinstance(e, str) else list(e)


def case_refusals(ctx):
    """Each refusal of a mesh engine, by the exception it raised."""
    mesh, model = ctx["mesh"], models(ctx, "model")
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - recorded for the test
            out[name] = [type(e).__name__, str(e)]

    attempt("kernel", lambda: PagedEngine(model, None, pc(attn_impl="kernel"), GREEDY,
                                          device="cpu", mesh=mesh))
    attempt("observe", lambda: PagedEngine(model, None, pc(), GREEDY, device="cpu", mesh=mesh,
                                           observe=True))
    eng = PagedEngine(model, None, pc(), GREEDY, device="cpu", mesh=mesh)
    attempt("arrivals", lambda: eng.serve(reqs(LENS[:2]), arrivals=[0.0, 0.0]))
    for arch in ("granite-moe-3b-a800m", "tiny-ssm"):  # served now, as in the reference
        cfg = get_smoke(arch) if arch != "tiny-ssm" else get_config(arch)
        attempt(arch, lambda cfg=cfg: PagedEngine(init_model(cfg, 0, device="cpu"), None, pc(),
                                                  GREEDY, device="cpu", mesh=mesh).serve(
            reqs(LENS[:2], vocab=cfg.vocab)))
    return out


def case_relayout(ctx):
    """``relayout`` between every pair of layouts (replicated, each axis,
    each axis tuple in both orders) on dims 0 and 1 in three dtypes, held
    to this rank's slice of the full tensor."""
    from repro_torch.runtime.collectives import relayout

    mesh = ctx["mesh"]
    names = mesh.axis_names
    layouts = [()] + [(a,) for a in names] + [(a, b) for a in names for b in names if a != b]
    wrong, pairs = [], 0
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        full = torch.as_tensor(rng.integers(-1000, 1000, size=(8, 12))).to(dtype)
        full[0, 0] = -0.0 if dtype != torch.int32 else 0
        for dim in (0, 1):
            for have in layouts:
                for want in layouts:
                    pairs += 1
                    x = shardlib.local_slice(full, tuple(have if d == dim else None
                                                         for d in range(2)), mesh)
                    got = relayout(x.contiguous(), dim, have, want, mesh)
                    ref = shardlib.local_slice(full, tuple(want if d == dim else None
                                                           for d in range(2)), mesh)
                    if not torch.equal(got, ref):
                        wrong.append([str(dtype), dim, list(have), list(want)])
    return {"pairs": pairs // 6, "wrong": wrong}


# ---------------------------------------------------------------------------
# MoE and recurrent patterns under the mesh (tests/test_torch_mesh_families.py)
# ---------------------------------------------------------------------------
#: the rungs each mesh serves: tiny-moe expert-parallel on (2, 1) and (2, 2),
#: tensor-parallel inside its experts on (1, 2); the recurrent rungs on
#: (1, 2) and (2, 2)
FAMILY_MESHES = {"1,2": ("tiny-moe", "tiny-ssm", "tiny-xlstm", "tiny-hybrid"),
                 "2,1": ("tiny-moe",),
                 "2,2": ("tiny-moe", "tiny-ssm", "tiny-xlstm", "tiny-hybrid")}
#: (model kind, page dtype) of each family trace: ``cold`` and ``int8`` (the
#: float model) are held to the reference's one-device engine, the packed
#: ones to the port's (itself held to the reference's in the families' own
#: tests)
FAMILY_TRACES = {"cold": ("float", "act"), "int8": ("float", "int8"),
                 "packed_int8": ("packed", "int8"), "sparse": ("sparse", "act")}
FAMILY_LENS = [(8, 6, 0), (8, 5, 1), (8, 7, 0), (8, 4, 0), (8, 5, 0)]


def family_traces(arch: str, mesh: str | None = None) -> tuple:
    """The traces a rung serves on ``mesh`` (all of them without one): 2:4
    stacks on tiny-moe only. (2, 2) leaves out the traces whose layout
    another of its traces runs: the float model's int8 pages (the packed
    model's int8 trace runs them; (1, 2) and (2, 1) hold them to the
    reference) and the 2:4 stacks (the packed stacks' expert and K/N
    shards; B4e's shards run on (1, 2) and (2, 1))."""
    return tuple(t for t in FAMILY_TRACES
                 if (arch == "tiny-moe" or not t.startswith("sparse"))
                 and not (mesh == "2,2" and t in ("int8", "sparse")))


def family_paged(kv: str):
    """Four slots, so a (2, 2) mesh shards the recurrent slot lanes over
    ``data`` (and a fifth request admits into a freed slot)."""
    return pc(kv_dtype=kv, max_concurrency=4)


def family_model(ctx, arch: str, kind: str):
    """A rung's model from the reference's parameters: ``float``,
    ``packed`` (RTN) or ``sparse`` (RTN at 2:4)."""
    from repro_torch.quant.spec import DatapathSpec

    cache = ctx.setdefault("family_models", {})
    key = (arch, kind)
    if key not in cache:
        if kind == "float":
            with open(ctx["family_params"], "rb") as f:
                tree = pickle.load(f)[arch]
            cache[key] = params_from_numpy(tree, get_config(arch), device="cpu")
        else:
            cache[key] = pack_decode_params(
                family_model(ctx, arch, "float"),
                ptq=DatapathSpec(sparsity="2:4") if kind == "sparse" else None)
    return cache[key]


def serve_family(ctx, arch: str, name: str, mesh=None) -> tuple:
    """One rung's trace through the mesh engine (``mesh``) or the
    one-device engine: (engine, its record)."""
    kind, kv = FAMILY_TRACES[name]
    eng = PagedEngine(family_model(ctx, arch, kind), None, family_paged(kv), GREEDY,
                      device="cpu", mesh=mesh)
    rec = {"streams": streams(eng.serve(reqs(FAMILY_LENS, vocab=eng.cfg.vocab))),
           **free_state(eng), "state_bytes": eng.state_bytes,
           "state_bytes_one_device": eng.state_bytes_one_device}
    return eng, rec


def _digest(rec) -> str:
    h = hashlib.blake2b(digest_size=16)
    for uid, toks in rec["streams"].items():
        h.update(np.asarray(toks, np.int32).tobytes())
    for leaf in ("free_list", "page_refcounts"):
        h.update(np.asarray(rec["free"][leaf], np.int32).tobytes())
    h.update(rec["pool_digest"].encode())
    return h.hexdigest()


def case_families(ctx):
    """Every family trace of the mesh's rungs through the mesh engine, with
    each rank's digest, its stacked sites' and mixers' layouts and its
    recurrent lanes' shapes."""
    mesh = ctx["mesh"]
    out = {}
    spec = ",".join(str(mesh.shape[a]) for a in ("data", "model"))
    for arch in FAMILY_MESHES[spec]:
        for name in family_traces(arch, spec):
            eng, rec = serve_family(ctx, arch, name, mesh)
            rec["digest"] = _digest(rec)
            layouts = {}
            for i, block in enumerate(eng.model.layers):
                for part in ("mixer", "ffn"):
                    mod = getattr(block, part)
                    for site in ("wg", "wu", "wd"):
                        sh = getattr(getattr(mod, site, None), "_shard", None)
                        if block.spec.ffn == "moe" and part == "ffn" and sh is not None:
                            layouts[f"{i}.{site}"] = {
                                "e": list(sh.e), "k": list(sh.k), "n": list(sh.n),
                                "experts": getattr(mod, site).packed.shape[0]
                                if hasattr(getattr(mod, site), "packed")
                                else getattr(mod, site).w.shape[0]}
                sh = getattr(block.mixer, "_shard", None)
                if isinstance(sh, shardlib.MixerShard):
                    layouts[f"{i}.mixer"] = {
                        "ch": list(sh.ch), "heads": list(sh.heads), "rec": list(sh.rec),
                        "lanes": {n: list(t.shape) for n, t in eng.cache["pools"][i].items()}}
            rec["layouts"] = layouts
            out[f"{arch}/{name}"] = rec
    return out


def _stacked_site_check(mesh, full, loc, k: int, x_seed: int) -> bool:
    """One stacked site on its shard (``loc``, placed by ``shard_model``)
    against the whole site (``full``) on the same rows: bit-equal."""
    from repro_torch.models.layers import packed_linear

    sh = loc._shard
    e = full.packed.shape[0]
    g = torch.Generator().manual_seed(x_seed)
    x = torch.randn((e, 6, k), generator=g)
    x[:, 4:] = 0  # capacity rows the dispatch left empty
    x[e - 1] = 0  # an expert that got no token
    x[0, 0, : k // 2] *= 4  # one expert's range set on one K half
    want = packed_linear(x, full)
    got = packed_linear(shardlib.local_slice(x, (sh.e or None, None, sh.k or None), mesh)
                        .contiguous(), loc)
    return torch.equal(got, shardlib.local_slice(want, (sh.e or None, None, sh.n or None), mesh))


def case_stacked_sites(ctx):
    """tiny-moe's expert-stacked sites, dense and 2:4, with dynamic and
    with static (calibrated-style, one per expert) activation quantizers,
    each on this rank's expert, K and N shards against the whole site on
    the same rows; the layouts they run under."""
    from dataclasses import replace

    mesh, out = ctx["mesh"], {}
    for kind in ("packed", "sparse"):
        for static in (False, True):
            model = copy.deepcopy(family_model(ctx, "tiny-moe", kind))
            cfg = model.cfg
            for block in model.layers:
                if static and block.spec.ffn == "moe":
                    for site in ("wg", "wu", "wd"):
                        leaf = getattr(block.ffn, site)
                        e = leaf.packed.shape[0]
                        leaf.act_scale = 0.01 + 0.01 * torch.arange(e, dtype=torch.float32)
                        leaf.act_zp = torch.full((e,), 128.0) - torch.arange(e).float()
                        leaf.spec = replace(leaf.spec, static_act=True)
            placed = shardlib.shard_model(model, mesh)
            for i, block in enumerate(model.layers):
                if block.spec.ffn != "moe":
                    continue
                for j, site in enumerate(("wg", "wu", "wd")):
                    full, loc = getattr(block.ffn, site), getattr(placed.layers[i].ffn, site)
                    k = cfg.d_model if site != "wd" else cfg.moe.d_ff_expert
                    out[f"{kind}/{'static' if static else 'dynamic'}/{i}.{site}"] = {
                        "equal": _stacked_site_check(mesh, full, loc, k, 10 * i + j),
                        "e": list(loc._shard.e), "k": list(loc._shard.k),
                        "n": list(loc._shard.n), "local": list(loc.packed.shape)}
    return out


def case_range_reduce(ctx):
    """``quantize_activations(per_expert=True, range_reduce=)`` on this
    rank's K shard of (E, M, K) rows against the unsharded quantizer:
    codes (the rank's columns), scales and zero points equal."""
    from repro_torch.kernels.ops import quantize_activations
    from repro_torch.runtime.collectives import all_reduce_max

    mesh = ctx["mesh"]
    axes = ("model", "data")
    g = torch.Generator().manual_seed(4)
    x = torch.randn((5, 7, 64), generator=g)
    x[1] = x[1].abs()  # no negative value: the zero point is 0
    x[2] = 0  # an expert that got no token: the 1e-8 scale floor
    x[3, :, :8] *= 50  # one expert's range held by one rank alone
    want = quantize_activations(x, per_expert=True)
    part = shardlib.local_slice(x, (None, None, axes), mesh).contiguous()
    got = quantize_activations(part, per_expert=True,
                               range_reduce=lambda r: all_reduce_max(r, mesh, axes))
    solo = quantize_activations(part, per_expert=True)
    return {"codes": torch.equal(got[0], shardlib.local_slice(want[0], (None, None, axes),
                                                              mesh)),
            "scale": torch.equal(got[1], want[1]), "zp": torch.equal(got[2], want[2]),
            "unreduced_differs": not torch.equal(solo[1], want[1])}


def case_fused_split(ctx):
    """The fused in_proj (Mamba) and up (mLSTM) on two or more ranks: each
    rank's xin and z are its channels of each half of the whole output,
    not its contiguous N shard (which on two ranks holds all of one
    half)."""
    from repro_torch.models.layers import pmm
    from repro_torch.models.ssm import split_halves

    mesh, out = ctx["mesh"], {}
    for arch, site in (("tiny-ssm", "in_proj"), ("tiny-xlstm", "up")):
        model = family_model(ctx, arch, "packed")
        placed = shardlib.shard_model(model, mesh)
        full, loc = model.layers[0].mixer, placed.layers[0].mixer
        sh = loc._shard
        x = torch.randn((2, 3, model.cfg.d_model), generator=torch.Generator().manual_seed(1))
        xin, z = torch.chunk(pmm(full, site, x), 2, dim=-1)
        got = split_halves(loc, pmm(loc, site, x)) if arch == "tiny-ssm" else tuple(
            shardlib.local_slice(t, (None, None, sh.ch), mesh)
            for t in torch.chunk(pmm(loc, site, x), 2, dim=-1))
        want = [shardlib.local_slice(t, (None, None, sh.ch), mesh) for t in (xin, z)]
        naive = getattr(loc, site)(x)  # the rank's contiguous N shard, not relaid
        out[arch] = {"equal": all(torch.equal(a, b) for a, b in zip(got, want)),
                     "n_axes": list(getattr(loc, site)._shard.n), "ch": list(sh.ch),
                     "naive_is_own_channels": naive.shape == torch.cat(want, -1).shape
                     and torch.equal(naive, torch.cat(want, -1))}
    return out


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--params", default=None)
    ap.add_argument("--family-params", default=None,
                    help="pickled {arch: the reference's numpy parameter tree}")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a collective waits for the other ranks")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    shape = tuple(int(x) for x in args.mesh.split(","))
    mesh = make_mesh(shape, device="cpu", init_method=args.init, rank=args.rank,
                     world_size=args.world, timeout=args.timeout)
    ctx = {"mesh": mesh, "params": args.params, "family_params": args.family_params}
    results = {"coords": mesh.coords}
    rc = 0
    for name in args.cases.split(","):
        try:
            results[name] = CASES[name](ctx)
        except Exception:  # noqa: BLE001 - the test reports it
            results[name] = {"error": traceback.format_exc()}
            rc = 1
    with open(args.out, "w") as f:
        json.dump(results, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
