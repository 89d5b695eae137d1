"""One rank of the mesh-serving tests (``tests/test_torch_mesh_serving.py``).

    python tests/torch_mesh_worker.py --rank R --world N --mesh dp,tp \\
        --init file:///tmp/x/rdv --params params.pkl --out out_R.json [--cases a,b]

Each rank joins a gloo group through ``--init`` (a ``file://`` rendezvous),
builds the (data, model) mesh and runs the cases in order: every serving
trace of :func:`trace` through the mesh engine (``traces``), the local
shard shapes (``contract``), the refusals and ``relayout``. It writes what
the test holds across ranks and against the one-device engine, which the
test runs itself on the same traces (:func:`serve_trace` without a mesh):
streams, free state, allocator and rank digests, shapes, counters and
refusals. No JAX: the reference's parameters arrive as a pickled tree of
numpy arrays.
"""

from __future__ import annotations

import argparse
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
    for arch in ("granite-moe-3b-a800m", "tiny-ssm"):
        cfg = get_smoke(arch) if arch != "tiny-ssm" else get_config(arch)
        attempt(arch, lambda cfg=cfg: PagedEngine(init_model(cfg, 0, device="cpu"), None, pc(),
                                                  GREEDY, device="cpu", mesh=mesh))
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


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--params", default=None)
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
    ctx = {"mesh": mesh, "params": args.params}
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
