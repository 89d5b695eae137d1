"""Port parity of training and checkpoint restore: ``repro_torch.optim``,
``repro_torch.runtime.steps``, ``repro_torch.checkpoint`` and
``repro_torch.launch.train`` against ``repro``.

AdamW on the same parameters and gradients, and the train step on the same
weights (carried with ``interop.params_from_numpy``) and batches, with 1
and 2 microbatches, within f32 tolerance; the reference's checkpoint tests
and its resume test at its tolerances on the port; checkpoints read across
both packages, bf16 leaves included; the reference's end-to-end round trip
(train, quantize --ckpt-dir, serve --ckpt-dir) through the port's
launchers; and a reference-trained checkpoint calibrated by both
packages' launchers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import load_pytree as j_load_pytree
from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core import PTQConfig as JPTQConfig
from repro.data import DataConfig, TokenBatcher
from repro.models import transformer as JT
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import adamw_update as j_adamw_update
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim import lr_at_step as j_lr_at_step
from repro.quant import calibrate_and_quantize as j_calibrate
from repro.runtime.steps import TrainRunConfig as JTrainRunConfig
from repro.runtime.steps import init_train_state as j_init_train_state
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.configs import get_smoke
from repro_torch.launch import quantize as quantize_launcher
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.optim import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    lr_at_step,
)
from repro_torch.quant.serve_packed import load_flat_artifact
from repro_torch.runtime import TrainRunConfig, init_train_state, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for torch while a test runs: the train steps are
    many small ops, and with the suite's parallel workers sharing the cores
    each op's thread team would wait on the others' (a launcher round trip
    of seconds ran for minutes). The previous count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keyed(tree):
    """{keystr: leaf} of a tree of either package (tensors as numpy)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (interop.to_numpy(v) if isinstance(v, torch.Tensor)
                                      else np.asarray(v)) for p, v in flat}


def _assert_trees_close(got, want, atol, rtol=0.0):
    got, want = _keyed(got), _keyed(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k].astype(np.float64), w.astype(np.float64), atol=atol,
                                   rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1, clip_norm=1.0)


def test_adamw_matches_reference():
    """Three updates of the same parameters (f32 and a bf16 leaf) with the
    same gradients, the first clipped: parameters, moments, step, learning
    rate and gradient norm within f32 tolerance of the reference's."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "h": (3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if k == "h" else jnp.float32)
               for k, v in params.items()}
    tparams = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "h" else torch.float32)
               for k, v in params.items()}
    jcfg, cfg = JOptimizerConfig(**OPT), OptimizerConfig(**OPT)
    jstate, state = j_init_opt_state(jparams, jcfg), init_opt_state(tparams, cfg)
    for i in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) * (10.0 if i == 0 else 0.1)
                 for k, s in shapes.items()}
        jparams, jstate, jm = j_adamw_update(
            jparams, {k: jnp.asarray(g, jparams[k].dtype) for k, g in grads.items()}, jstate,
            jcfg)
        tparams, state, m = adamw_update(
            tparams, {k: torch.from_numpy(g).to(tparams[k].dtype) for k, g in grads.items()},
            state, cfg)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        for k in shapes:
            atol = 1e-2 if k == "h" else 1e-6  # one bf16 ulp at these magnitudes
            np.testing.assert_allclose(tparams[k].float().numpy(),
                                       np.asarray(jparams[k], np.float32), atol=atol, err_msg=k)
            np.testing.assert_allclose(state["m"][k].numpy(), np.asarray(jstate["m"][k]),
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(state["v"][k].numpy(), np.asarray(jstate["v"][k]),
                                       atol=1e-6, err_msg=k)


def test_adamw_matches_reference_math():
    """The reference's closed form for step 1 (m_hat = g, v_hat = g^2)."""
    rng = np.random.default_rng(0)
    w, g = rng.normal(size=(8,)).astype(np.float32), rng.normal(size=(8,)).astype(np.float32)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=1, weight_decay=0.0,
                          clip_norm=1e9, min_lr_ratio=1.0)
    params = {"w": torch.from_numpy(w.copy())}
    state = init_opt_state(params, cfg)
    new, state, _ = adamw_update(params, {"w": torch.from_numpy(g)}, state, cfg)
    np.testing.assert_allclose(new["w"].numpy(), w - 1e-2 * g / (np.abs(g) + cfg.eps),
                               rtol=1e-5)
    assert int(state["step"]) == 1


def test_lr_schedule_matches_reference():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    jcfg = JOptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 200):
        assert float(lr_at_step(cfg, step)) == pytest.approx(float(j_lr_at_step(jcfg, step)),
                                                             rel=1e-6, abs=1e-9)
    assert float(lr_at_step(cfg, 0)) == 0.0
    assert abs(float(lr_at_step(cfg, 110)) - 0.1) < 1e-6


def test_grad_clipping_applied():
    params = {"w": torch.zeros(4)}
    cfg = OptimizerConfig(clip_norm=1.0, warmup_steps=0, total_steps=1, weight_decay=0.0,
                          min_lr_ratio=1.0, lr=1.0)
    _, _, metrics = adamw_update(params, {"w": torch.tensor([100.0, 0, 0, 0])},
                                 init_opt_state(params, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def _smoke_pair():
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=64, remat="none")
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=64, remat="none")
    return jcfg, cfg


def _data():
    return TokenBatcher(DataConfig(vocab=64, seq_len=16, global_batch=4))


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches):
    """One and eight train steps on a 2-layer smollm smoke: every step's
    loss and gradient norm, and the whole train state after steps 1 and 8,
    within f32 tolerance of the reference's."""
    jcfg, cfg = _smoke_pair()
    jrun = JTrainRunConfig(num_microbatches=microbatches)
    run = TrainRunConfig(num_microbatches=microbatches)
    jstate = j_init_train_state(jax.random.key(0), jcfg, jrun)
    model = interop.params_from_numpy(_np(jstate["params"]), cfg, device="cpu")
    state = init_train_state(cfg, run, model=model)
    jstep, step = jax.jit(j_make_train_step(jcfg, jrun)), make_train_step(cfg, run)
    data = _data()
    for i in range(8):
        b = data.batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        for key in ("loss", "ce", "ppl", "grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5), (i, key)
        if i in (0, 7):
            _assert_trees_close(interop.train_state_to_numpy(state), _np(jstate), atol=1e-5)


def test_train_step_refusals():
    """``int8-pod`` compresses across pods only, as in the reference: with
    no mesh the step is the plain step bit for bit, and on a mesh with no
    ``pod`` axis the reducer is left as it is; a batch the microbatches do
    not divide is refused."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.compression import compressed_grad_fn

    jcfg, cfg = _smoke_pair()
    states = [init_train_state(cfg, TrainRunConfig(), device="cpu") for _ in range(2)]
    steps = [make_train_step(cfg, TrainRunConfig(grad_compression=c)) for c in ("int8-pod", "none")]
    for i in range(2):
        got, want = (step(st, _torch_batch(_data().batch(i)))[1]
                     for step, st in zip(steps, states))
        assert all(torch.equal(got[k], want[k]) for k in want)
    for (_, a), (_, b) in zip(*(st["params"].named_parameters() for st in states)):
        assert torch.equal(a, b)
    fn = object()
    assert compressed_grad_fn(fn, make_mesh((2, 2), abstract=True)) is fn
    assert compressed_grad_fn(fn, None) is fn
    state = init_train_state(cfg, TrainRunConfig(num_microbatches=3), device="cpu")
    step = make_train_step(cfg, TrainRunConfig(num_microbatches=3))
    with pytest.raises(ValueError, match="not divisible"):
        step(state, _torch_batch(_data().batch(0)))


# ---------------------------------------------------------------------------
# Checkpoint (ports of the reference's tests)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
            "nest": {"b": torch.arange(7, dtype=torch.int32),
                     "h": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)).to(
                         torch.bfloat16)},
            "seq": (torch.ones(2), torch.tensor(5, dtype=torch.int32))}
    d = str(tmp_path / "ck")
    save_pytree(tree, d, {"step": 5})
    target = jax.tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)
    restored, meta = load_pytree(target, d)
    assert meta["step"] == 5
    for k, v in _keyed(tree).items():
        got = _keyed(restored)[k]
        assert got.dtype == v.dtype and got.shape == v.shape
        np.testing.assert_array_equal(got.astype(np.float64), v.astype(np.float64))


def test_checkpoint_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(2)}
    for s in (10, 20, 30):
        mgr.save(s, tree, blocking=True)
    assert mgr.latest_step() == 30
    assert not os.path.exists(mgr.directory(10))  # retention
    step, restored, meta = mgr.restore_latest(tree)
    assert step == 30 and meta["step"] == 30
    # the async writer snapshots first: an in-place update after save()
    # does not reach the file
    mgr.save(40, tree)
    tree["w"].add_(1.0)
    mgr.wait()
    assert float(mgr.restore(40, tree)[0]["w"][0]) == 1.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    save_pytree({"w": torch.ones(4)}, d)
    with pytest.raises(ValueError):
        load_pytree({"w": torch.ones(5)}, d)
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree({"v": torch.ones(4)}, d)


def test_train_resume_bit_exact(tmp_path):
    """Interrupted-and-resumed training == uninterrupted training, at the
    reference test's tolerances."""
    _, cfg = _smoke_pair()
    run = TrainRunConfig()
    data = _data()
    step_fn = make_train_step(cfg, run)

    def run_steps(state, lo, hi):
        for i in range(lo, hi):
            state, m = step_fn(state, _torch_batch(data.batch(i)))
        return state, float(m["loss"])

    s_full, loss_full = run_steps(init_train_state(cfg, run, device="cpu"), 0, 8)
    s_half, _ = run_steps(init_train_state(cfg, run, device="cpu"), 0, 4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, interop.train_state_tree(s_half), blocking=True)
    s_new = init_train_state(cfg, run, seed=1, device="cpu")  # other weights, restored over
    _, tree, _ = mgr.restore_latest(interop.train_state_tree(s_new, spec=True))
    interop.load_train_state_(s_new, tree)
    s_resumed, loss_resumed = run_steps(s_new, 4, 8)
    assert loss_resumed == pytest.approx(loss_full, rel=1e-6)
    for (_, a), (_, b) in zip(s_full["params"].named_parameters(),
                              s_resumed["params"].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------
def test_train_state_checkpoints_cross_both_ways(tmp_path):
    """The port's train state after two steps, saved by the port, restored
    by the reference's ``load_pytree`` into its own train state's structure
    equal leaf for leaf (names, shapes, dtypes, values); the reference's
    saved and restored by the port, equal likewise."""
    jcfg, cfg = _smoke_pair()
    run, jrun = TrainRunConfig(), JTrainRunConfig()
    data = _data()
    state = init_train_state(cfg, run, device="cpu")
    step = make_train_step(cfg, run)
    for i in range(2):
        state, _ = step(state, _torch_batch(data.batch(i)))
    save_pytree(interop.train_state_tree(state), str(tmp_path / "port"), {"step": 2})
    jtarget = jax.eval_shape(lambda k: j_init_train_state(k, jcfg, jrun), jax.random.key(0))
    jtree, meta = j_load_pytree(jtarget, str(tmp_path / "port"))
    assert meta == {"step": 2}
    _assert_trees_close(_np(jtree), interop.train_state_to_numpy(state), atol=0)

    jstate = j_init_train_state(jax.random.key(3), jcfg, jrun)
    jstep = jax.jit(j_make_train_step(jcfg, jrun))
    for i in range(2):
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, data.batch(i)))
    JCheckpointManager(str(tmp_path / "ref")).save(2, jstate, blocking=True)
    restored = CheckpointManager(str(tmp_path / "ref")).restore_latest(
        interop.train_state_tree(state, spec=True))
    assert restored[0] == 2
    interop.load_train_state_(state, restored[1])
    _assert_trees_close(interop.train_state_to_numpy(state), _np(jstate), atol=0)


def test_bf16_params_cross_both_ways(tmp_path):
    """A bf16 model's parameter tree: the port writes each bf16 leaf as the
    reference does, its files and manifest byte for byte the reference's,
    and the port restores the reference's exactly. (The reference's own
    ``load_pytree`` cannot cast such a leaf, ``|V2`` on disk, back to
    bfloat16, for its own files as for the port's: a reference-side limit
    that the identical bytes make moot.)"""
    jcfg = j_get_smoke("musicgen-medium").scaled(param_dtype="bfloat16", act_dtype="bfloat16")
    cfg = get_smoke("musicgen-medium").scaled(param_dtype="bfloat16", act_dtype="bfloat16")
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = interop.params_from_numpy(_np(jparams), cfg, device="cpu")
    tree = interop.reference_tree(model)
    assert tree["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    save_pytree({"params": tree}, str(tmp_path / "port"), {"step": 1})
    j_save_pytree({"params": jparams}, str(tmp_path / "ref"), {"step": 1})
    files = sorted(os.listdir(tmp_path / "ref"))
    assert files == sorted(os.listdir(tmp_path / "port")) and "manifest.json" in files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f
    for d in ("port", "ref"):
        with pytest.raises(ValueError, match="cast"):
            j_load_pytree({"params": jparams}, str(tmp_path / d))
    other = interop.params_from_numpy(_np(JT.init_model(jax.random.key(1), jcfg)), cfg,
                                      device="cpu")
    got, meta = load_pytree({"params": interop.reference_tree(other, spec=True)},
                            str(tmp_path / "ref"))
    assert meta == {"step": 1}
    interop.load_reference_tree_(other, got["params"])
    _assert_trees_close(interop.params_to_numpy(other), _np(jparams), atol=0)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------
def test_train_quantize_serve_roundtrip(tmp_path, capsys):
    """The reference's end-to-end test through the port's launchers on
    tiny-lm-xs: the loss falls, the checkpoint calibrates with every site
    certified and a quantized perplexity under 1.5x the float one, and
    serve --ckpt-dir restores it. A second launch resumes from the latest
    checkpoint."""
    ckpt = str(tmp_path / "run")
    args = ["--arch", "tiny-lm-xs", "--steps", "80", "--batch", "8", "--seq", "64",
            "--ckpt-dir", ckpt, "--ckpt-every", "40", "--log-every", "40", "--lr", "1e-3",
            "--device", "cpu"]
    state, losses = train_launcher.main(args)
    assert losses[-1] < losses[0] and len(losses) == 80
    assert CheckpointManager(ckpt).latest_step() == 80
    _, more = train_launcher.main([*args[:3], "90", *args[4:]])
    assert len(more) == 10 and "[train] resumed from step 80" in capsys.readouterr().out

    report = quantize_launcher.main(
        ["--arch", "tiny-lm-xs", "--ckpt-dir", ckpt, "--algorithm", "gpfq", "--p-bits", "16",
         "--tile", "64", "--calib-batches", "2", "--calib-batch-size", "2", "--seq", "64",
         "--eval-batches", "2", "--out", str(tmp_path / "q"), "--device", "cpu"])
    assert report["cert"]["ok"]
    assert report["quant_ppl"] < report["float_ppl"] * 1.5
    assert os.path.exists(tmp_path / "q" / "quantized" / "manifest.json")

    out = serve_launcher.main(["--arch", "tiny-lm-xs", "--ckpt-dir", ckpt, "--batch", "4",
                               "--prompt-len", "16", "--max-new", "8", "--device", "cpu"])
    assert out.shape == (4, 24)
    assert out.min() >= 0 and out.max() < 512
    assert "[serve] restored step 90" in capsys.readouterr().out


def test_reference_checkpoint_calibrates_in_the_port(tmp_path):
    """A checkpoint the reference's trainer wrote (200 steps: the float
    perplexity falls from about the vocabulary's 512 to under 100),
    calibrated by both packages' quantize launchers (--ckpt-dir, 4
    calibration batches of 4, 8 eval batches): every site certified in both at equal
    budgets (the spec arrays' datapath slots: bits, tile, P_I, P_O,
    signedness, sparsity and the static quantizer's presence, bit for bit;
    where every code upstream agrees, the static quantizer's scale within
    rtol 1e-4 and zero point within 1), the float perplexity within 1e-4
    (the same restored weights), and the codes and quantized perplexity held
    as tests/test_torch_calibration.py holds them: codes against the
    reference's agreement with its own run on every layer weight one ulp
    larger, within 0.05 overall and 0.1 per site, and the quantized
    perplexity within 1% of the reference's (the port reads 0.4%).
    Round-to-nearest in place of GPFQ fails both (0.71 against 0.79
    overall, 4.9% off), as does GPFQ without its error feedback (0.71,
    3.5% off)."""
    from repro.launch.quantize import main as j_quantize_main
    from repro.launch.train import main as j_train_main

    ckpt = str(tmp_path / "run")
    j_train_main(["--arch", "tiny-lm-xs", "--steps", "200", "--batch", "8", "--seq", "64",
                  "--ckpt-dir", ckpt, "--ckpt-every", "200", "--log-every", "200",
                  "--lr", "1e-3"])
    qargs = ["--arch", "tiny-lm-xs", "--ckpt-dir", ckpt, "--calib-batches", "4",
             "--calib-batch-size", "4", "--seq", "64", "--eval-batches", "8"]
    jrep = j_quantize_main([*qargs, "--out", str(tmp_path / "jq")])
    rep = quantize_launcher.main([*qargs, "--out", str(tmp_path / "q"), "--device", "cpu"])
    assert rep["cert"]["ok"] and jrep["cert"]["ok"]
    assert rep["cert"]["n_certified"] == jrep["cert"]["n_certified"] == 7 * 4
    assert jrep["float_ppl"] < 100
    assert rep["float_ppl"] == pytest.approx(jrep["float_ppl"], rel=1e-4)
    assert rep["quant_ppl"] == pytest.approx(jrep["quant_ppl"], rel=1e-2)
    assert rep["datapath"] == jrep["datapath"]
    flat, _ = load_flat_artifact(str(tmp_path / "q" / "quantized"))
    jflat, _ = load_flat_artifact(str(tmp_path / "jq" / "quantized"))
    assert flat.keys() == jflat.keys()
    # the yardstick: the reference on the same batches, every layer weight
    # one ulp larger
    jcfg = j_get_config("tiny-lm-xs")
    restored = JCheckpointManager(ckpt).restore_latest(
        {"params": JT.init_model(jax.random.key(0), jcfg)})[1]["params"]
    ulp = dict(restored, layers=jax.tree.map(lambda a: a * np.float32(1 + 2**-23),
                                             restored["layers"]))
    data = TokenBatcher(DataConfig(vocab=jcfg.vocab, seq_len=64, global_batch=4, seed=0))
    calib = [data.batch(10_000 + i) for i in range(4)]
    jl_yard = dict(j_calibrate(ulp, jcfg, calib, JPTQConfig()).quantized_linears())
    equal = equal_yard = total = 0
    upstream_equal = True
    for name, ql in jl_yard.items():
        key = f"{name}/q"
        spec, jspec = flat[f"{name}/spec"], jflat[f"{name}/spec"]
        datapath = [i for i in range(spec.size) if i not in (8, 9)]  # 8, 9: act scale, zp
        np.testing.assert_array_equal(spec[datapath], jspec[datapath], err_msg=name)
        if upstream_equal:
            np.testing.assert_allclose(spec[8], jspec[8], rtol=1e-4, err_msg=name)
            assert abs(spec[9] - jspec[9]) <= 1, name
        same = int((flat[key] == jflat[key]).sum())
        same_yard = int((np.asarray(ql.q_int).astype(np.int8) == jflat[key]).sum())
        print(f"[codes] {name}: {same / flat[key].size:.4f} equal to the reference's; the "
              f"reference one ulp apart {same_yard / flat[key].size:.4f}")
        assert same >= same_yard - 0.1 * flat[key].size, name
        upstream_equal = upstream_equal and same == flat[key].size
        equal, equal_yard, total = equal + same, equal_yard + same_yard, total + flat[key].size
    print(f"[codes] overall {equal / total:.4f} equal to the reference's; the reference one "
          f"ulp apart {equal_yard / total:.4f}; quantized ppl: port {rep['quant_ppl']:.4f}, "
          f"reference {jrep['quant_ppl']:.4f}")
    assert equal / total >= equal_yard / total - 0.05
