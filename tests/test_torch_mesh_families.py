"""MoE and recurrent patterns under the mesh, on gloo CPU ranks: the port's
``PagedEngine(mesh=)`` serving tiny-moe (expert-parallel on (2, 1) and
(2, 2), tensor-parallel inside its experts on (1, 2), dense and 2:4),
tiny-ssm, tiny-xlstm and tiny-hybrid (on (1, 2) and (2, 2)).

The three meshes spawn their ranks together, once for all rungs
(``tests/torch_mesh_worker.py``, no JAX, one torch thread a rank, a
``file://`` rendezvous in ``tmp_path``). Each rank serves every trace of
its rungs on its mesh (``family_traces``, four slots so that a (2, 2) mesh
shards the recurrent slot lanes) and writes what it saw. The greedy streams of the
float model's cold float-page and int8-page traces are held to the
reference's one-device engine, run here with JAX on the same parameters
(the port's seeded init laid out as the reference's tree, handed to the
ranks pickled as numpy); every trace, the RTN-packed model's (dense and
2:4) too, to the port's one-device engine, run here too. Free state, the
allocator digest and a digest of each rank's streams and free state must
agree on every rank. Unit cases: each expert-stacked site on its expert,
K and N shards bit-equal to its unsharded self; the per-expert range
reduce; the fused in_proj/up split.
"""

import json
import os
import pickle
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mesh_worker as W  # noqa: E402

MESHES = tuple(W.FAMILY_MESHES)
CASES = ("families", "stacked_sites", "range_reduce", "fused_split")
SPAWN_TIMEOUT = 240
#: (mesh, rung, trace) of every family trace a rank serves
RUNS = [(m, a, t) for m, archs in W.FAMILY_MESHES.items() for a in archs
        for t in W.family_traces(a, m)]
#: the traces held to the reference's one-device engine
REFERENCE_TRACES = ("cold", "int8")


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """Every rung's parameters (the port's seeded init in the reference's
    tree), pickled for the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.interop import params_to_numpy
    from repro_torch.models.transformer import init_model

    trees = {arch: params_to_numpy(init_model(get_config(arch), 0, device="cpu"))
             for arch in W.FAMILY_MESHES["1,2"]}
    path = tmp_path_factory.mktemp("params") / "families.pkl"
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    return {"path": str(path), "trees": trees}


@pytest.fixture(scope="module")
def spawned(params, tmp_path_factory):
    """The ranks of all three meshes, started together (they run while the
    reference serves): {mesh: [(out path, process)]}."""
    root = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for mesh in MESHES:
        world = int(np.prod([int(x) for x in mesh.split(",")]))
        d = root / mesh.replace(",", "x")
        d.mkdir()
        procs[mesh] = [(d / f"r{r}.json", subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), "--rank", str(r),
             "--world", str(world), "--mesh", mesh, "--init", f"file://{d}/rdv",
             "--family-params", params["path"], "--out", str(d / f"r{r}.json"),
             "--cases", ",".join(CASES)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for r in range(world)]
    yield procs
    for ps in procs.values():
        for _, p in ps:
            p.kill()


@pytest.fixture(scope="module")
def reference(params, spawned):
    """The reference's one-device greedy streams of the float model's cold
    (float pages) and int8 (int8 pages) traces of each rung."""
    base = dict(block_size=8, num_blocks=16, max_concurrency=4, max_pages_per_seq=4,
                chunk_max=4, attn_impl="ref")
    out = {}
    for arch, tree in params["trees"].items():
        cfg = j_get_config(arch)
        jparams = jax.tree.map(jax.numpy.asarray, tree)
        for name in REFERENCE_TRACES:
            kind, kv = W.FAMILY_TRACES[name]
            assert kind == "float"
            eng = JPagedEngine(jparams, cfg, JPagedConfig(**base, kv_dtype=kv),
                               JSampler(temperature=0.0))
            res = eng.serve([JRequest(r.uid, r.prompt.copy(), r.max_new, r.priority)
                             for r in W.reqs(W.FAMILY_LENS, vocab=cfg.vocab)])
            out[(arch, name)] = W.streams(res)
    return out


@pytest.fixture(scope="module")
def ranks(spawned, reference):
    """{mesh: [each rank's results]}."""
    out = {}
    for mesh, ps in spawned.items():
        logs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for _, p in ps]
        for r, (path, _) in enumerate(ps):
            assert path.exists(), f"mesh {mesh} rank {r} wrote nothing: {logs[r][-3000:]}"
        out[mesh] = [json.load(open(path)) for path, _ in ps]
    return out


@pytest.fixture(scope="module")
def one_device(params):
    """Every rung's every trace through the port's one-device engine."""
    ctx = {"family_params": params["path"]}
    return {(a, t): W.serve_family(ctx, a, t)[1] for a in W.FAMILY_MESHES["1,2"]
            for t in W.family_traces(a)}


def _case(ranks, mesh, name):
    res = [r[name] for r in ranks[mesh]]
    for r, rec in enumerate(res):
        assert "error" not in rec, f"rank {r}: {rec['error'] if isinstance(rec, dict) else rec}"
    return res


def _held(ranks, one_device, mesh, arch, trace):
    """The trace's streams, free state and allocator digest on every rank
    equal to the one-device engine's, and the ranks' digests equal."""
    res = [r[f"{arch}/{trace}"] for r in _case(ranks, mesh, "families")]
    want = one_device[(arch, trace)]
    for rec in res:
        assert rec["streams"] == want["streams"]
        assert rec["free"] == want["free"]
        assert rec["pool_digest"] == want["pool_digest"]
        assert rec["free"]["free_list"] == rec["pool_free"]
    assert len({rec["digest"] for rec in res}) == 1, "a rank diverged"
    return res


@pytest.mark.parametrize("mesh,arch,trace", RUNS)
def test_family_trace_matches_one_device(ranks, one_device, reference, mesh, arch, trace):
    """Each rung's trace on each mesh: streams, free state and digests equal
    to the port's one-device engine on every rank; the cold and int8 traces
    also to the reference's one-device engine."""
    for rec in _held(ranks, one_device, mesh, arch, trace):
        if trace in REFERENCE_TRACES:
            assert rec["streams"] == reference[(arch, trace)]


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_stacks_run_on_their_shards(ranks, mesh):
    """tiny-moe's 4 experts: expert-parallel where ``data`` has 2 ranks (2
    a rank), tensor-parallel inside the experts over ``model`` (wg/wu N,
    wd K) where it has 2."""
    sizes = dict(zip(("data", "model"), (int(x) for x in mesh.split(","))))

    def live(axes):  # axes of more than one rank
        return [a for a in axes if sizes[a] > 1]

    for rank in _case(ranks, mesh, "families"):
        layouts = rank["tiny-moe/packed_int8"]["layouts"]
        assert {k.split(".")[1] for k in layouts} == {"wg", "wu", "wd"}
        for key, lay in layouts.items():
            assert lay["experts"] == 4 // sizes["data"]
            assert live(lay["e"]) == live(["data"])
            k, n = (lay["k"], lay["n"]) if key.endswith("wd") else (lay["n"], lay["k"])
            assert live(k) == live(["model"]) and n == [], key


@pytest.mark.parametrize("mesh", ("1,2", "2,2"))
def test_recurrent_lanes_are_placed_by_their_specs(ranks, mesh):
    """A rank holds its channels (and heads) of every recurrent lane, and
    on (2, 2) half the slots: 1 / world of the one-device state bytes (the
    sLSTM's h/c/n/m are whole on every rank, sharded by slot only)."""
    dp, tp = (int(x) for x in mesh.split(","))
    for rank in _case(ranks, mesh, "families"):
        for arch in ("tiny-ssm", "tiny-xlstm", "tiny-hybrid"):
            rec = rank[f"{arch}/packed_int8"]
            mixers = [v for k, v in rec["layouts"].items() if k.endswith("mixer")]
            assert mixers
            for lay in mixers:
                for name, shape in lay["lanes"].items():
                    assert shape[0] == 4 // dp, (arch, name, shape)
            if arch != "tiny-xlstm":
                assert rec["state_bytes"] * dp * tp == rec["state_bytes_one_device"]
            else:
                assert rec["state_bytes"] * dp * tp > rec["state_bytes_one_device"]
                assert rec["state_bytes"] * dp < rec["state_bytes_one_device"]


@pytest.mark.parametrize("mesh", MESHES)
def test_stacked_site_on_its_shard_is_bit_equal(ranks, mesh):
    """Every expert-stacked site of tiny-moe, dense and 2:4, dynamic and
    static activation quantizers, on the rank's experts and K/N shards:
    bit-equal to the whole site (a K-sharded one reduces its per-expert
    range and sums B1e/B4e's accumulators before the epilogue)."""
    dp, tp = (int(x) for x in mesh.split(","))
    for rank in _case(ranks, mesh, "stacked_sites"):
        assert len(rank) == 2 * 2 * 2 * 3  # kinds x quantizers x layers x sites
        for key, rec in rank.items():
            assert rec["equal"], key
            assert rec["local"][0] == 4 // dp
        k_sharded = [key for key, rec in rank.items() if rec["k"] and tp > 1]
        assert len(k_sharded) == (8 if tp > 1 else 0)


@pytest.mark.parametrize("mesh", MESHES)
def test_per_expert_range_reduce(ranks, mesh):
    """``quantize_activations(per_expert=True, range_reduce=)`` on a K shard
    gives the unsharded codes, scales and zero points."""
    for rec in _case(ranks, mesh, "range_reduce"):
        assert rec["codes"] and rec["scale"] and rec["zp"]
        assert rec["unreduced_differs"]


@pytest.mark.parametrize("mesh", ("1,2", "2,2"))
def test_fused_projection_split(ranks, mesh):
    """Mamba's in_proj and the mLSTM's up (N = 2 d_in, N-sharded): each
    rank gets its channels of xin and of z, which its contiguous N shard
    is not."""
    for rank in _case(ranks, mesh, "fused_split"):
        for arch, rec in rank.items():
            assert rec["equal"], arch
            assert rec["n_axes"] and rec["ch"]
            assert not rec["naive_is_own_channels"], arch


@pytest.mark.parametrize("arch", ["tiny-moe", "tiny-xlstm"])
def test_serve_launcher_mesh_families(arch, capsys):
    """``serve.py --paged --mesh 1,2`` on two gloo ranks: rank 0 alone prints
    ``sample:``, the tokens of the one-device run; each rank prints what it
    holds (all 4 experts, wd's K over ``model``; half the recurrent state)."""
    from repro_torch.launch import serve

    args = ["--arch", arch, "--packed", "--paged", "--block-size", "8", "--batch", "2",
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
    if arch == "tiny-moe":
        assert res.stdout.count("[serve] experts: 4 of 4 a stacked site") == 2
    else:
        held = [ln for ln in res.stdout.splitlines() if "recurrent state:" in ln]
        assert len(held) == 2
        mine, one = (float(v) for v in re.findall(r"([0-9.]+) MiB", held[0]))
        assert 0 < mine < one
