"""Mesh-sharded paged serving on gloo CPU ranks: the reference's
``tests/test_mesh_serving.py`` cases for the port's ``PagedEngine(mesh=)``.

Both meshes, (1, 2) and (2, 2), spawn their ranks together
(``tests/torch_mesh_worker.py``, no JAX, one torch thread a rank,
rendezvous through a ``file://`` in ``tmp_path``, a timeout a spawn); each
rank serves every trace through the mesh engine and writes what it saw,
and this process serves the same traces through the one-device engine. The model is tiny-lm-xs with
2 layers and vocab 128 (n_kv_heads 4: tp = 2 really shards the pools).
Greedy streams of the cold and the int8 + prefix-cache traces are held to
the reference's one-device engine (computed here with JAX, its parameters
handed to the ranks pickled as numpy); every other case to the port's own
one-device engine on the same model, as the reference holds its mesh
engine. Free state, the allocator digest and a digest of each rank's
streams and free state must agree on every rank.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models.transformer import init_model as j_init_model
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mesh_worker as W  # noqa: E402

MESHES = ("1,2", "2,2")
CASES = ("traces", "contract", "refusals")
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's params (pickled for the ranks) and its one-device
    greedy streams of the cold and the int8 + prefix-cache traces."""
    cfg = j_get_config("tiny-lm-xs").scaled(n_layers=2, vocab=128)
    params = j_init_model(jax.random.key(0), cfg)
    base = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4,
                chunk_max=4, attn_impl="ref")

    def serve(name, **kw):
        eng = JPagedEngine(params, cfg, JPagedConfig(**base, **kw), JSampler(temperature=0.0))
        out = eng.serve([JRequest(r.uid, r.prompt.copy(), r.max_new, r.priority)
                         for r in W.trace(name)["reqs"]])
        return W.streams(out)

    path = tmp_path_factory.mktemp("params") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return {"params": str(path), "cold_greedy": serve("cold_greedy"),
            "int8_prefix": serve("int8_prefix", kv_dtype="int8", prefix_cache=True)}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """{mesh: [each rank's results]}: the ranks of both meshes spawned
    together, one process a rank."""
    root = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"))
    procs = {}
    for mesh in MESHES:
        world = int(np.prod([int(x) for x in mesh.split(",")]))
        d = root / mesh.replace(",", "x")
        d.mkdir()
        procs[mesh] = [(d / f"r{r}.json", subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), "--rank", str(r),
             "--world", str(world), "--mesh", mesh, "--init", f"file://{d}/rdv",
             "--params", reference["params"], "--out", str(d / f"r{r}.json"),
             "--cases", ",".join(CASES)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for r in range(world)]
    out = {}
    try:
        for mesh, ps in procs.items():
            logs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for _, p in ps]
            for r, (path, _) in enumerate(ps):
                assert path.exists(), f"mesh {mesh} rank {r} wrote nothing: {logs[r][-3000:]}"
            out[mesh] = [json.load(open(path)) for path, _ in ps]
    finally:
        for ps in procs.values():
            for _, p in ps:
                p.kill()
    return out


@pytest.fixture(scope="module")
def one_device(reference):
    """Every trace through the port's one-device engine, in this process."""
    ctx = {"params": reference["params"]}
    return {name: W.serve_trace(ctx, name)[1] for name in W.TRACES}


def _case(ranks, mesh, name):
    res = [r[name] for r in ranks[mesh]]
    for r, rec in enumerate(res):
        assert "error" not in rec, f"rank {r}: {rec['error'] if isinstance(rec, dict) else rec}"
    return res


def _held(ranks, one_device, mesh, name, *, free=True):
    """The trace's streams on every rank equal to the one-device engine's,
    the free state equal to it (``free``: the same pool) and to the rank's
    host allocator, and the ranks' digests equal. Returns the records."""
    res = [r[name] for r in _case(ranks, mesh, "traces")]
    want = one_device[name]
    for rec in res:
        assert rec["streams"] == want["streams"]
        if free:
            assert rec["free"] == want["free"]
            assert rec["pool_digest"] == want["pool_digest"]
        assert rec["free"]["free_list"] == rec["pool_free"]
    assert len({rec["digest"] for rec in res}) == 1, "a rank diverged"
    return res


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_are_the_mesh(ranks, mesh):
    dp, tp = (int(x) for x in mesh.split(","))
    coords = sorted((r["coords"]["data"], r["coords"]["model"]) for r in ranks[mesh])
    assert coords == [(d, m) for d in range(dp) for m in range(tp)]


@pytest.mark.parametrize("mesh", MESHES)
def test_cold_greedy_matches_reference(ranks, one_device, reference, mesh):
    for rec in _held(ranks, one_device, mesh, "cold_greedy"):
        assert rec["streams"] == reference["cold_greedy"]


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_prefix_matches_reference(ranks, one_device, reference, mesh):
    for rec in _held(ranks, one_device, mesh, "int8_prefix"):
        assert rec["streams"] == reference["int8_prefix"]
        assert rec["hits"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_shared_prefix_identity(ranks, one_device, mesh):
    res = _held(ranks, one_device, mesh, "shared_prefix")
    assert all(rec["hits"] == one_device["shared_prefix"]["hits"] > 0 for rec in res)


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_kv_identity(ranks, one_device, mesh):
    _held(ranks, one_device, mesh, "int8_kv")


@pytest.mark.parametrize("mesh", MESHES)
def test_preempted_and_resumed_identity(ranks, one_device, mesh):
    """A tight pool forces preempt-and-requeue on the mesh engine; streams
    still equal the roomy FIFO engine's."""
    res = _held(ranks, one_device, mesh, "preempt", free=False)
    assert all(rec["preemptions"] >= 1 for rec in res)


@pytest.mark.parametrize("mesh", MESHES)
def test_batched_admit_identity(ranks, one_device, mesh):
    res = _held(ranks, one_device, mesh, "batched_admit")
    assert all(rec["batch_admits"] >= 1 and rec["prefill_chunks"] >= 1 for rec in res)


@pytest.mark.parametrize("mesh", MESHES)
def test_sampled_identity(ranks, one_device, mesh):
    """temperature > 0: the counter-based noise is a function of (seed,
    uid, step) alone, identical on every rank
    (``assert_sampling_keys_collective_safe``)."""
    res = _held(ranks, one_device, mesh, "sampled")
    assert all(rec["keys_safe"] for rec in res)


@pytest.mark.parametrize("mesh", MESHES)
def test_out_shardings_contract(ranks, mesh):
    """Pools shard kv heads over ``model`` (a local ``k_pages`` holds nkv/tp
    heads), scales co-shard with them, admin leaves are whole everywhere."""
    tp = int(mesh.split(",")[1])
    for rec in _case(ranks, mesh, "contract"):
        assert rec["k_pages_spec"] == [None, None, "model", None]
        assert rec["k_scales_spec"] == [None, "model"]
        assert rec["k_pages"][2:] == [rec["nkv"] // tp, rec["hd"]]
        assert rec["k_scales"][1] == rec["nkv"] // tp
        for name, spec in rec["admin_specs"].items():
            assert all(e is None for e in spec), name
        assert rec["admin"]["free_list"] == rec["admin"]["page_refcounts"] == [16]
        assert rec["admin"]["block_table"] == [3, 4]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kv", ["rtn_packed", "rtn_packed_int8"])
def test_rtn_packed_identity(ranks, one_device, mesh, kv):
    """An RTN-packed model: B1's plain version on K and N shards (wo/wd
    row-sharded: the dynamic quantizer's range taken over the ranks, the
    accumulators summed before the epilogue)."""
    _held(ranks, one_device, mesh, kv)


def test_smollm_smoke_mid_head_fallback(ranks, one_device):
    """smollm-360m's smoke (15 q / 5 kv heads) at tp = 2: q/k/v and the pools
    replicate, while wo's K shards mid-head (relaid by ``relayout``)."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke("smollm-360m")
    assert cfg.n_heads % 2 and cfg.n_kv_heads % 2
    for rec in _held(ranks, one_device, "1,2", "smollm_smoke"):
        assert rec["wo_k"] == ["model", "data"]
        assert rec["wo_packed"] == [cfg.n_heads * cfg.head_dim // 4, cfg.d_model]
        assert rec["wq_n"] == ["model", "data"]


@pytest.mark.parametrize("mesh", MESHES)
def test_default_rules_identity(ranks, one_device, mesh):
    """Under DEFAULT_RULES (FSDP rows over ``data``: q/k/v/wg/wu shard K and
    N, the embedding's d columns too) the stream is unchanged."""
    _held(ranks, one_device, mesh, "default_rules")


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_refusals(ranks, mesh):
    """A mesh engine refuses the attention kernels, and (under more than one
    process) observation and wall-clock arrivals, as the reference does; MoE
    and recurrent patterns serve (granite's smoke and tiny-ssm build and
    serve two requests)."""
    for rec in _case(ranks, mesh, "refusals"):
        assert rec["kernel"][0] == "ValueError" and "reference attention" in rec["kernel"][1]
        assert rec["observe"][0] == "ValueError" and "single-controller" in rec["observe"][1]
        assert rec["arrivals"][0] == "ValueError" and "single-controller" in rec["arrivals"][1]
        for arch in ("granite-moe-3b-a800m", "tiny-ssm"):
            assert rec[arch] is None, rec[arch]


def test_multiprocess_battery(tmp_path):
    """``scripts/torch_run_multiprocess.py --procs 2``: the reference's
    three-battery run over gloo ranks ends PASS."""
    script = os.path.join(os.path.dirname(HERE), "scripts", "torch_run_multiprocess.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"))
    res = subprocess.run([sys.executable, script, "--procs", "2", "--rdv", str(tmp_path)],
                         capture_output=True, text=True, timeout=SPAWN_TIMEOUT, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1].startswith("[torch_run_multiprocess] PASS")


def test_serve_launcher_mesh(capsys):
    """``serve.py --paged --mesh 1,2`` on two gloo ranks (``torchrun
    --standalone``): rank 0 alone prints ``sample:``, the tokens of the
    one-device run."""
    from repro_torch.launch import serve

    args = ["--arch", "tiny-lm-xs", "--packed", "--paged", "--block-size", "8", "--batch", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    serve.main(args)
    want = [ln for ln in capsys.readouterr().out.splitlines() if "sample:" in ln]
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *args,
                          "--mesh", "1,2"], capture_output=True, text=True, env=env,
                         timeout=SPAWN_TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = [ln for ln in res.stdout.splitlines() if "sample:" in ln]
    assert len(want) == 1 and got == want
    assert res.stdout.count("[serve] mesh: {'data': 1, 'model': 2}") == 2
