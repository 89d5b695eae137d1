"""Training on the mesh: the port's sharded train step
(``repro_torch.runtime.steps.make_train_step(cfg, run, mesh)`` on a state
placed by ``train_state_shardings``), ``runtime/compression``'s int8
gradient all-reduce over ``pod``, checkpoints across rank counts and
``launch/train.py`` under ``torchrun``, against the reference.

The reference's own mesh train step runs in spawned JAX processes with
four host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``;
this file run as a script; three side by side, each a share of the
cases), jitted as its launcher jits it, on the meshes
(pod, data, model) of ``tests/torch_train_worker.py``'s ``CASES``:
(1, 2, 1), (1, 1, 2), (2, 2, 1) and (1, 2, 1) with four microbatches,
(2, 1, 2) under ``int8-pod``, tiny-moe and tiny-xlstm on (1, 2, 1), the
smollm smoke at 4 layers under ``remat="block"`` on (1, 2, 2) with two
microbatches, tiny-moe under ``remat="block"`` on (1, 2, 1); and
``SLICE_CASES``' (2, 2, 1) under ``int8-pod`` (two data ranks in a pod:
the compression sees slices). The port's gloo ranks (the worker, no JAX,
a ``file://`` rendezvous) run the same cases from the same parameters,
two worlds of 2 and 4 ranks started together with the reference's.
Every step's loss and gradient norm at rel 1e-5 and the whole train
state after steps 1 and 8 at atol 1e-5, the tolerances of
``test_train_steps_match_reference``. Also: the gathered parameters a
step holds alive at once under ``remat="block"`` (at most a unit and the
embedding's and head's leaves, below the whole tree), ``mesh_train_bytes``
against each rank's placed state, ``abstract_train_state`` leaf for leaf
against the reference's, the specs
of ``train_state_shardings`` leaf for leaf against the reference's at full
width, ``int8_psum`` against the reference's on a size-1 pod bit for bit,
a checkpoint written by 2 ranks restored on 1 and one written on 1
restored on 2, ``torchrun --nproc-per-node 2 -m repro_torch.launch.train``
resuming a one-device run, the MoE refusal of a rank that would cut a
routing group, and the NCCL form of a gather (``all_gather_into_tensor``)
against the gloo form on (2, 2).
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
sys.path.insert(0, HERE)

import torch_train_worker as W  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402

#: the ranks' worlds: size -> the cases its ranks run, in order
WORLDS = {2: ["dense_1x2x1", "dense_1x1x2", "micro_1x2x1", "moe_1x2x1", "xlstm_1x2x1",
              "moe_remat_1x2x1", "ckpt_out", "ckpt_in"],
          4: ["dense_2x2x1", "int8_2x1x2", "remat_1x2x2", "int8_2x2x1", "gather_order"]}
SPAWN_TIMEOUT = 240
METRICS = ("loss", "ce", "ppl", "grad_norm", "lr")


def j_config(arch: str):
    """The reference's twin of ``W.config``."""
    from dataclasses import replace

    from repro.configs import get_config, get_smoke

    arch, _, variant = arch.partition("/")
    if arch == "smollm-360m":
        cfg = get_smoke(arch).scaled(n_layers=2, vocab=64, remat="none")
    else:
        cfg = get_config(arch).scaled(vocab=64)
        cfg = cfg.scaled(moe=replace(cfg.moe, group_size=32)) if cfg.moe else cfg
    if variant:
        *layers, remat = variant.split("-")
        cfg = cfg.scaled(remat=remat, **({"n_layers": int(layers[0])} if layers else {}))
    return cfg


#: every case the reference runs: the ranks' cases and (2, 1, 1) under int8-pod
REF_CASES = dict(W.CASES, int8_2x1x1=("smollm-360m", (2, 1, 1), "int8-pod", 1),
                 **W.SLICE_CASES)
#: the reference's cases split over processes that run side by side
REF_SPLIT = (["dense_1x2x1", "moe_1x2x1", "int8_2x1x2", "moe_remat_1x2x1"],
             ["xlstm_1x2x1", "dense_1x1x2", "int8_2x1x1", "int8_2x2x1"],
             ["dense_2x2x1", "micro_1x2x1", "remat_1x2x2"])


def reference_main(params_path: str, out_path: str, names: list[str]) -> None:
    """The reference's mesh train step on the cases ``names``, as its
    launcher runs it: the state placed by ``train_state_shardings``, the
    batch by ``batch_shardings``, the step jitted under ``axis_rules``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.optim import init_opt_state
    from repro.runtime.sharding import axis_rules, batch_shardings
    from repro.runtime.steps import TrainRunConfig, make_train_step, train_state_shardings

    with open(params_path, "rb") as f:
        params = pickle.load(f)
    out = {}
    for name in names:
        arch, shape, comp, n_mb = REF_CASES[name]
        cfg = j_config(arch)
        run = TrainRunConfig(num_microbatches=n_mb, grad_compression=comp)
        mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                    ("pod", "data", "model"))
        p = jax.tree.map(jnp.asarray, params[arch])
        state = {"params": p, "opt": init_opt_state(p, run.optimizer)}
        state = jax.device_put(state, train_state_shardings(state, mesh))
        step = make_train_step(cfg, run, mesh)

        def wrapped(s, b, step=step, mesh=mesh):
            with axis_rules(mesh):
                return step(s, b)

        jstep = jax.jit(wrapped)
        rec, data = {}, W.data()
        for i in range(W.STEPS):
            host = data.batch(i)
            state, m = jstep(state, jax.device_put(host, batch_shardings(host, mesh)))
            for k in METRICS:
                rec.setdefault(k, []).append(float(m[k]))
            if i + 1 in W.HELD:
                rec[f"state{i + 1}"] = jax.tree.map(np.asarray, state)
        out[name] = rec
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# Fixtures: the reference process and the ranks, started together
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's initial parameters of each arch (pickled numpy), a
    one-device port checkpoint at step ``W.CKPT_AT`` (for ``ckpt_in``),
    then the reference's processes, both worlds of ranks and the
    launcher's resume (:func:`_launch_resume`), started together:
    {"procs": {"ref": [(out path, process)], world: [...]}, "launcher": ...}."""
    import jax

    from repro.models import transformer as JT
    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("train")
    params = {arch: jax.tree.map(np.asarray, JT.init_model(jax.random.key(0), j_config(arch)))
              for arch in W.ARCHS}
    path = root / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    one = _one_device(params, W.CKPT_AT)
    CheckpointManager(str(root / "ckpt" / "one")).save(
        W.CKPT_AT, interop.train_state_tree(one), blocking=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {"ref": [(root / f"ref{i}.pkl", subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference", str(path),
         str(root / f"ref{i}.pkl"), ",".join(names)], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for i, names in enumerate(REF_SPLIT)]}
    for world, cases in WORLDS.items():
        d = root / f"w{world}"
        d.mkdir()
        procs[world] = [(d / f"r{r}.pkl", subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_train_worker.py"), "--rank", str(r),
             "--world", str(world), "--init", f"file://{d}/rdv", "--params", str(path),
             "--ckpt-root", str(root / "ckpt"), "--out", str(d / f"r{r}.pkl"),
             "--cases", ",".join(cases)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for r in range(world)]
    launcher = _launch_resume(root / "launch", env)
    yield {"procs": procs, "params": params, "root": root, "launcher": launcher}
    launcher.kill()
    for entry in procs.values():
        for _, p in entry:
            p.kill()


def _one_device(params, steps: int):
    """The port's one-device dense case trained ``steps`` steps."""
    import torch

    from repro_torch import interop
    from repro_torch.runtime import init_train_state, make_train_step

    cfg, run = W.config("smollm-360m"), W.run_config()
    state = init_train_state(cfg, run, model=interop.params_from_numpy(
        params["smollm-360m"], cfg, device="cpu"))
    step, data = make_train_step(cfg, run), W.data()
    for i in range(steps):
        state, _ = step(state, {"tokens": torch.from_numpy(data.batch(i)["tokens"])})
    return state


def _collect(path, proc, what):
    log = proc.communicate(timeout=SPAWN_TIMEOUT)[0]
    assert path.exists(), f"{what} wrote nothing (rc {proc.returncode}): {log[-4000:]}"
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(spawned):
    """{"ref": the reference's records, name: [each rank's record]}."""
    procs = spawned["procs"]
    out = {"ref": {}}
    for path, p in procs["ref"]:
        out["ref"].update(_collect(path, p, "a reference process"))
    assert sorted(out["ref"]) == sorted(REF_CASES)
    for world, cases in WORLDS.items():
        ranks = [_collect(path, p, f"rank {r} of {world}")
                 for r, (path, p) in enumerate(procs[world])]
        for name in cases:
            for r, rec in enumerate(ranks):
                assert "error" not in rec[name], f"{name} rank {r}: {rec[name]['error']}"
            out[name] = [rec[name] for rec in ranks]
    return out


def _keyed(tree) -> dict:
    import jax

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_trees_close(got, want, atol):
    got, want = _keyed(got), _keyed(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k].astype(np.float64), w.astype(np.float64), atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The mesh train step against the reference's
# ---------------------------------------------------------------------------
def _tie_limited(got, want, atol, outer, share):
    """Every leaf within ``outer`` and all but ``share`` of the elements
    within ``atol``; returns the count beyond ``atol``."""
    got, want = _keyed(got), _keyed(want)
    assert got.keys() == want.keys()
    over = total = 0
    for k, w in want.items():
        d = np.abs(got[k].astype(np.float64) - w.astype(np.float64))
        assert d.max() <= outer, (k, float(d.max()))
        over += int((d > atol).sum())
        total += d.size
    assert over <= share * total, (over, total)
    return over


@pytest.mark.parametrize("name", list(W.CASES))
def test_mesh_train_steps_match_reference(results, name):
    """Eight steps: every step's metrics (the same on every rank) within
    rel 1e-5 of the reference's mesh step, the whole train state after
    steps 1 and 8 within atol 1e-5; a rank holds its slices (a data axis
    of 2 halves the FSDP rows).

    Under ``int8-pod`` a gradient element whose code sits at a rounding
    tie takes the neighbouring code when its float order differs by an
    ulp, and AdamW carries the flip on: the reference's own (2, 1, 2) and
    (2, 1, 1) runs differ by more than 1e-5 after 8 steps (asserted here).
    So there the loss is held at rel 1e-5, the gradient norm at rel 1e-4,
    and the state tie-limited: every element within 1e-4, all but 1% of
    them within 1e-5."""
    ref, ranks = results["ref"][name], results[name]
    for rec in ranks[1:]:
        assert {k: rec[k] for k in METRICS} == {k: ranks[0][k] for k in METRICS}
    int8 = W.CASES[name][2] == "int8-pod"
    for i in range(W.STEPS):
        for k in METRICS:
            rel = 1e-4 if int8 and k == "grad_norm" else 1e-5
            assert ranks[0][k][i] == pytest.approx(ref[k][i], rel=rel), (i, k)
    for s in W.HELD:
        if int8:
            _tie_limited(ranks[0][f"state{s}"], ref[f"state{s}"], 1e-5, 1e-4, 0.01)
        else:
            _assert_trees_close(ranks[0][f"state{s}"], ref[f"state{s}"], atol=1e-5)
    if int8:  # the reference against itself on a mesh without a model axis
        self_diff = max(np.abs(a - b).max() for a, b in zip(
            _keyed(ref["state8"]).values(), _keyed(results["ref"]["int8_2x1x1"]["state8"]).values()))
        assert self_diff > 1e-5
    _, shape, _, _ = W.CASES[name]
    held = ranks[0]["held"]
    if shape[1] > 1:
        assert held["embedding.embed"][1] * shape[1] == W.config(W.CASES[name][0]).d_model


def test_int8_pod_on_slices_matches_reference(results):
    """``int8-pod`` on (2, 2, 1): two data ranks inside each pod, so each
    rank's gradient reaches the compression as its slice of the leaf (the
    FSDP rows), and the absmax must be the whole leaf's, over the pod and
    the data axis, as the reference takes it. Held to the int8 cases' bar
    of :func:`test_mesh_train_steps_match_reference`: the loss within rel
    1e-5 of the reference's mesh step, the gradient norm within rel 1e-4,
    the state after steps 1 and 8 tie-limited. (That test's other check,
    that the reference's own (2, 1, 1) run lies more than 1e-5 away, does
    not hold on this mesh: 7.7e-6.)"""
    name = "int8_2x2x1"
    ref, ranks = results["ref"][name], results[name]
    for rec in ranks[1:]:
        assert {k: rec[k] for k in METRICS} == {k: ranks[0][k] for k in METRICS}
    for i in range(W.STEPS):
        for k in METRICS:
            rel = 1e-4 if k == "grad_norm" else 1e-5
            assert ranks[0][k][i] == pytest.approx(ref[k][i], rel=rel), (i, k)
    for s in W.HELD:
        _tie_limited(ranks[0][f"state{s}"], ref[f"state{s}"], 1e-5, 1e-4, 0.01)
    assert ranks[0]["held"]["embedding.embed"][1] * 2 == W.config("smollm-360m").d_model


def test_int8_pod_differs_from_uncompressed(results):
    """(2, 1, 2) under ``int8-pod`` is not the uncompressed step: its
    per-pod loss and its rounded gradient move the state elsewhere than
    (2, 2, 1) does, as in the reference."""
    a, b = results["int8_2x1x2"][0], results["dense_2x2x1"][0]
    ra, rb = results["ref"]["int8_2x1x2"], results["ref"]["dense_2x2x1"]
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)  # pmean of per-pod means
    diff = max(np.abs(x - y).max() for x, y in zip(_keyed(a["state8"]).values(),
                                                    _keyed(b["state8"]).values()))
    ref_diff = max(np.abs(x - y).max() for x, y in zip(_keyed(ra["state8"]).values(),
                                                        _keyed(rb["state8"]).values()))
    assert diff > 1e-5 and ref_diff > 1e-5


#: the cases whose config recomputes each period (``remat="block"``)
REMAT_CASES = [n for n, c in W.CASES.items() if W.config(c[0]).remat == "block"]


@pytest.mark.parametrize("name", REMAT_CASES)
def test_gathered_parameters_stay_within_a_unit(results, name):
    """Under ``remat="block"`` the full parameters a step gathers and holds
    alive at once never exceed the largest unit's (a period, the
    embedding, or the final norm with the head) plus the embedding's and
    the head's whole leaves, and stay strictly below the whole tree's: no
    rank holds the whole model."""
    for r, rec in enumerate(results[name]):
        peak, units = rec["gathered_peak"], rec["units"]
        bound = max(units.values()) + sum(rec["leaves"].values())
        assert 0 < peak <= bound, (r, peak, bound, units)
        assert peak < rec["tree_bytes"], (r, peak, rec["tree_bytes"])


@pytest.mark.parametrize("name", list(W.CASES | W.SLICE_CASES))
def test_mesh_train_bytes_match_placed_state(results, name):
    """``mesh_train_bytes`` from the specs alone against the placed state
    on each rank: its parameter, moment and step tensors' bytes, the
    gradient slices (with their accumulators under microbatches), and the
    gathered units its formula names."""
    arch, _, _, n_mb = (W.CASES | W.SLICE_CASES)[name]
    remat = W.config(arch).remat == "block"
    for r, rec in enumerate(results[name]):
        got, units = rec["bytes"], rec["units"]
        assert got["state"] == rec["state_bytes"], r
        assert got["grads"] == rec["grad_bytes"] * (2 if n_mb > 1 else 1), r
        largest = max(units.values())
        want = 2 * largest if remat else sum(
            b for u, b in units.items() if not u.startswith("embed")) + largest
        assert got["gathered"] == want, r
        assert got["total"] == got["state"] + got["grads"] + got["gathered"], r


def test_all_gather_puts_blocks_in_shard_order(results):
    """The gather NCCL runs (``all_gather_into_tensor``, the group's blocks
    reordered to shard order) equals the bitwise-sum gather on (2, 2) gloo
    ranks, over one axis and both orders of two, on dims 0 and 1."""
    for r, rec in enumerate(results["gather_order"]):
        assert len(rec) == 8 and all(rec.values()), (r, rec)


# ---------------------------------------------------------------------------
# Checkpoints across rank counts, and the launcher
# ---------------------------------------------------------------------------
def test_checkpoint_from_two_ranks_restores_on_one(spawned, results):
    """The ranks' step-3 checkpoint restored on one device, trained on to
    step 5: the ranks' step-5 state within atol 1e-5."""
    import torch

    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import init_train_state, make_train_step

    cfg, run = W.config("smollm-360m"), W.run_config()
    state = init_train_state(cfg, run, seed=1, device="cpu")
    mgr = CheckpointManager(str(spawned["root"] / "ckpt" / "two"))
    at, tree, _ = mgr.restore_latest(interop.train_state_tree(state, spec=True))
    assert at == W.CKPT_AT
    interop.load_train_state_(state, tree)
    step, data = make_train_step(cfg, run), W.data()
    for i in range(at, W.CKPT_END):
        state, _ = step(state, {"tokens": torch.from_numpy(data.batch(i)["tokens"])})
    for rec in results["ckpt_out"]:
        _assert_trees_close(interop.train_state_to_numpy(state), rec["end"], atol=1e-5)


def test_checkpoint_from_one_device_restores_on_two_ranks(spawned, results):
    """A one-device step-3 checkpoint restored onto (1, 2, 1): the ranks'
    gathered state equals it bit for bit; trained on to step 5 it is the
    one-device run's step-5 state within atol 1e-5."""
    from repro_torch import interop

    want = interop.train_state_to_numpy(_one_device(spawned["params"], W.CKPT_AT))
    end = interop.train_state_to_numpy(_one_device(spawned["params"], W.CKPT_END))
    for rec in results["ckpt_in"]:
        assert rec["at"] == W.CKPT_AT
        _assert_trees_close(rec["restored"], want, atol=0.0)
        _assert_trees_close(rec["end"], end, atol=1e-5)


LAUNCH = ["--arch", "tiny-lm-xs", "--steps", "4", "--batch", "4", "--seq", "16", "--lr", "1e-3",
          "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]


def _launch_resume(root, env):
    """A one-device launcher run of 4 steps (``full``) and one of 2
    (``part``), here; then ``torchrun --nproc-per-node 2`` resuming
    ``part`` to step 4, started (returned, running)."""
    from repro_torch.launch import train

    train.main(LAUNCH + ["--ckpt-dir", str(root / "full")])
    train.main(LAUNCH[:3] + ["2"] + LAUNCH[4:] + ["--ckpt-dir", str(root / "part")])
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *LAUNCH,
                             "--ckpt-dir", str(root / "part")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_train_launcher_resumes_on_two_ranks(spawned):
    """A one-device launcher run checkpointed at step 2 of 4, resumed by
    ``torchrun --nproc-per-node 2`` on the host mesh: rank 0 alone prints
    the resume and the loss lines, and the step-4 checkpoint is the
    uninterrupted one-device run's within atol 1e-6."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import read_manifest

    proc = spawned["launcher"]
    out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    assert out.count("[train] resumed from step 2") == 1
    assert "mesh={'data': 2} (gloo)" in out
    assert len(re.findall(r"\[train\] step \d+ loss", out)) == 2
    root = spawned["root"] / "launch"
    a, b = CheckpointManager(str(root / "full")), CheckpointManager(str(root / "part"))
    assert a.latest_step() == b.latest_step() == 4
    want, got = read_manifest(a.directory(4))[0], read_manifest(b.directory(4))[0]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_worker_imports_neither_jax_nor_the_reference():
    """The ranks' worker runs the port alone: no import of JAX or of the
    JAX package."""
    import ast

    tree = ast.parse(open(os.path.join(HERE, "torch_train_worker.py")).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert mods and not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]


# ---------------------------------------------------------------------------
# Specs, compression, refusals (in this process)
# ---------------------------------------------------------------------------
MESHES = ((1, 1), (2, 4), (16, 16), (2, 16, 16))


def _entry(e):
    return tuple(e) if isinstance(e, (tuple, list)) else e


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_shardings_match_reference(arch):
    """``train_state_shardings`` of an abstract train state at full width:
    params, m and v leaf for leaf the reference's specs (its repeats entry
    dropped), the step replicated, on four meshes."""
    import jax
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.configs import get_config as j_get_config
    from repro.runtime.steps import TrainRunConfig as JTrainRunConfig
    from repro.runtime.steps import abstract_train_state
    from repro.runtime.steps import train_state_shardings as j_shardings
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import init_opt_state, trainable_parameters
    from repro_torch.runtime import TrainRunConfig, train_state_shardings
    from repro_torch.runtime.sharding import param_paths

    jstate = abstract_train_state(j_get_config(arch), JTrainRunConfig())
    model = T.abstract_params(get_config(arch))
    model.requires_grad_(True)
    state = {"params": model,
             "opt": init_opt_state(trainable_parameters(model), TrainRunConfig().optimizer)}
    paths, period = param_paths(model), model.cfg.period
    for shape in MESHES:
        names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
        want = j_shardings(jstate, JAbstractMesh(shape, names))
        got = train_state_shardings(state, make_mesh(shape, abstract=True))
        assert got["opt"]["step"] == () and want["opt"]["step"].spec == jax.sharding.PartitionSpec()
        for part, sub in (("params", want["params"]), ("m", want["opt"]["m"]),
                          ("v", want["opt"]["v"])):
            specs = got["params"] if part == "params" else got["opt"][part]
            flat = jax.tree_util.tree_flatten_with_path(
                sub, is_leaf=lambda x: hasattr(x, "spec"))[0]
            ref = {tuple(e.key if hasattr(e, "key") else e.idx for e in p):
                   tuple(_entry(e) for e in sh.spec) for p, sh in flat}
            seen = set()
            for name, spec in specs.items():
                parts = name.split(".")
                stacked = parts[0] == "layers"
                key = (("layers", int(parts[1]) % period, *paths[name][1:]) if stacked
                       else paths[name])
                w = ref[key][1:] if stacked else ref[key]
                w = w + (None,) * (len(spec) - len(w))
                assert tuple(_entry(e) for e in spec) == w, (shape, part, name)
                seen.add(key)
            assert seen == set(ref), (shape, part)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_matches_reference(arch):
    """``abstract_train_state`` at full width: the reference's
    ``abstract_train_state`` leaf for leaf (params, m, v, step) in shape
    and dtype, every tensor on the ``meta`` device (nothing allocated)."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.runtime.steps import TrainRunConfig as JTrainRunConfig
    from repro.runtime.steps import abstract_train_state as j_abstract_train_state
    from repro_torch.configs import get_config
    from repro_torch.interop import train_state_tree
    from repro_torch.runtime import TrainRunConfig, abstract_train_state

    state = abstract_train_state(get_config(arch), TrainRunConfig())
    tensors = [*state["params"].parameters(), *state["params"].buffers(),
               *state["opt"]["m"].values(), *state["opt"]["v"].values(), state["opt"]["step"]]
    assert all(t.is_meta for t in tensors)
    got = jax.tree_util.tree_flatten_with_path(train_state_tree(state, spec=True))[0]
    want = jax.tree_util.tree_flatten_with_path(
        j_abstract_train_state(j_get_config(arch), JTrainRunConfig()))[0]
    assert [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got] == [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype))
                                 for k, v in want]


def test_int8_psum_matches_reference_on_a_one_rank_pod():
    """The port's ``int8_psum`` over a size-1 ``pod`` (a world of one rank)
    against the reference's inside ``shard_map`` on a one-device ``pod``
    mesh: f32 and bf16 leaves, a zero leaf and ties at half a code, bit for
    bit; the codes are the rounded ones (half to even)."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.distributed as dist
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.runtime.compression import int8_psum as j_int8_psum
    from repro.runtime.compression import shard_map_compat
    from repro_torch.interop import to_numpy, to_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.compression import int8_codes, int8_psum

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(16, 8)).astype(np.float32),
            "b": (rng.normal(size=(33,)) * 1e-3).astype(np.float32),
            "z": np.zeros((4,), np.float32),
            "t": np.array([127.0, 0.5, 1.5, -2.5, 3.5, -0.5], np.float32)}
    jtree = dict(jax.tree.map(jnp.asarray, tree), h=jnp.asarray(tree["a"][:3], jnp.bfloat16))
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("pod",))
    want = shard_map_compat(lambda t: j_int8_psum(t, "pod"), jmesh, (P(),), P(),
                            frozenset({"pod"}))(jtree)
    ttree = {k: to_tensor(np.asarray(v), "cpu") for k, v in jtree.items()}
    mesh = make_mesh((1, 1, 1), device="cpu", rank=0, world_size=1)
    try:
        got = int8_psum(ttree, mesh, ("pod",))
    finally:
        dist.destroy_process_group()
    for k in jtree:
        w, g = np.asarray(want[k]), to_numpy(got[k])
        assert g.dtype == w.dtype and g.view(np.uint8).tobytes() == w.view(np.uint8).tobytes(), k
    q, _ = int8_codes(ttree["t"], torch.tensor(127.0))
    assert q.tolist() == [127, 0, 2, -2, 4, 0]


def test_moe_rank_cutting_a_routing_group_refuses():
    """A rank's rows must be whole routing groups: tiny-moe's 16-token
    rows against a group of 32 raise with the reason; whole groups route
    as the one-device model does (a one-rank split equals no split)."""
    import torch

    from repro_torch.models.transformer import BatchSplit, init_model, loss_fn

    cfg = W.config("tiny-moe")
    model = init_model(cfg, 0, device="cpu")
    tokens = torch.from_numpy(W.data().batch(0)["tokens"])
    with pytest.raises(ValueError, match="cut a routing group of 32"):
        loss_fn(model, {"tokens": tokens[1:2]}, BatchSplit(8, 1, lambda v: v))
    total, metrics = loss_fn(model, {"tokens": tokens})
    total_s, metrics_s = loss_fn(model, {"tokens": tokens}, BatchSplit(8, 0, lambda v: v))
    assert float(total_s) == pytest.approx(float(total), rel=1e-6)
    assert float(metrics_s["aux"]) == pytest.approx(float(metrics["aux"]), rel=1e-6)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        sys.path.insert(0, SRC)
        reference_main(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
