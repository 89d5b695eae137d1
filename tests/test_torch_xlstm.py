"""Port parity of the xLSTM blocks (``repro_torch.models.xlstm`` against
``repro.models.xlstm``) and of the recurrent stacks' decode, on inputs made
with numpy from a seed, f32.

The mLSTM cells (recurrent and chunkwise, ragged tails included) are held
to the reference and to each other within atol 1e-4 / rtol 1e-3, as
``tests/test_models.py:84`` holds the reference's two forms; the sLSTM scan
and both blocks with their end states within atol 1e-4. The stabilizers
start at NEG = -1e30 in f32, where ``exp(-m)`` is inf. Decode from a
prefill's state equals the full forward at the next position
(``tests/test_models.py:55``) on the xlstm-350m and jamba-1.5-large-398b
smoke configs, at the reference's atol/rtol 2e-3, with the states written
in place.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.configs import get_smoke
from repro_torch.interop import params_from_numpy, to_tensor
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.layers import Linear

torch.set_float32_matmul_precision("highest")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cell_inputs(rng, B=2, H=3, S=24, dh=8):
    q, k, v = (rng.normal(size=(B, H, S, dh)).astype(np.float32) for _ in range(3))
    ig = (rng.normal(size=(B, H, S)) * 2).astype(np.float32)
    fg = (rng.normal(size=(B, H, S)) * 2 + 1).astype(np.float32)
    return q, k, v, ig, fg


def test_mlstm_cells_match_reference_and_each_other(rng):
    """tests/test_models.py:84 in the port, and each form against the
    reference's: chunks of 6 and 8 divide 24, 7 leaves a ragged tail of 3
    (padded with i-gate NEG, f-gate +30), 24 is one chunk."""
    args = _cell_inputs(rng)
    j_rec = np.asarray(JX.mlstm_cell_recurrent(*(jnp.asarray(a) for a in args)))
    h_rec = X.mlstm_cell_recurrent(*(_t(a) for a in args))
    np.testing.assert_allclose(h_rec.numpy(), j_rec, atol=1e-4, rtol=1e-3)
    for chunk in (6, 7, 8, 24):
        h_chk, (C, n, m) = X.mlstm_cell_chunkwise(*(_t(a) for a in args), chunk=chunk,
                                                  return_state=True)
        j_chk, (jC, jn, jm) = JX.mlstm_cell_chunkwise(*(jnp.asarray(a) for a in args),
                                                      chunk=chunk, return_state=True)
        np.testing.assert_allclose(h_chk.numpy(), h_rec.numpy(), atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(h_chk.numpy(), np.asarray(j_chk), atol=1e-4, rtol=1e-3)
        for got, want in ((C, jC), (n, jn), (m, jm)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)


def _cfgs():
    jcfg, cfg = j_get_smoke("xlstm-350m"), get_smoke("xlstm-350m")
    return jcfg, cfg


def _mixer(jparams, kind):
    p = {k: to_tensor(np.asarray(v), "cpu") for k, v in jparams.items()}
    cls = X.MLSTM if kind == "mlstm" else X.SLSTM
    return cls(**{k: v if k in cls.FLOAT_LEAVES else Linear(v) for k, v in p.items()})


def test_slstm_scan_and_block_match_reference(rng):
    jcfg, cfg = _cfgs()
    jparams = JX.init_slstm(jax.random.key(1), jcfg)
    p = _mixer(jparams, "slstm")
    proj = (rng.normal(size=(2, 11, 4 * cfg.d_model)) * 2).astype(np.float32)
    jhs, jfinal = JX.slstm_scan(jparams, jnp.asarray(proj), jcfg)
    hs, final = X.slstm_scan(p.r, _t(proj), cfg)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=1e-4, rtol=1e-4)
    for got, want in zip(final, jfinal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    jy, jst = JX.slstm(jparams, jnp.asarray(x), jcfg, return_state=True)
    y, st = X.slstm(p, _t(x), cfg, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    for name in ("h", "c", "n", "m"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]), atol=1e-4,
                                   rtol=1e-4)
    # decode from the block's state, in place
    jh, jc, jn, jm = (jst[k] for k in ("h", "c", "n", "m"))
    h, c, n, m = (st[k].clone() for k in ("h", "c", "n", "m"))
    ptrs = [t.data_ptr() for t in (h, c, n, m)]
    xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jy_t, jh, jc, jn, jm = JX.slstm_decode(jparams, jnp.asarray(xt), jcfg, jh, jc, jn, jm)
    y_t, *new = X.slstm_decode(p, _t(xt), cfg, h, c, n, m)
    assert [t.data_ptr() for t in new] == ptrs
    np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4, rtol=1e-4)


def test_mlstm_block_and_decode_match_reference(rng):
    """The block with its end state (S = 13 at chunk 8: a ragged tail), then
    three decode steps from that state, written in place."""
    jcfg, cfg = _cfgs()
    jparams = JX.init_mlstm(jax.random.key(2), jcfg)
    p = _mixer(jparams, "mlstm")
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jy, jst = JX.mlstm(jparams, jnp.asarray(x[:, :13]), jcfg, return_state=True)
    y, st = X.mlstm(p, _t(x[:, :13]), cfg, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    for name in ("conv", "C", "n", "m"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    j = [jst[k] for k in ("conv", "C", "n", "m")]
    s = [st[k].clone() for k in ("conv", "C", "n", "m")]
    ptrs = [t.data_ptr() for t in s]
    for t in range(13, 16):
        jy_t, *j = JX.mlstm_decode(jparams, jnp.asarray(x[:, t:t + 1]), jcfg, *j)
        y_t, *new = X.mlstm_decode(p, _t(x[:, t:t + 1]), cfg, *s)
        assert [a.data_ptr() for a in new] == ptrs
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), atol=1e-4, rtol=1e-4)
    for got, want in zip(s, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_short_prompt_state_pads_the_conv_tail(rng):
    """A prompt shorter than the conv window (S = 2 < 3): the conv state is
    left-padded with zeros, as the reference pads it."""
    jcfg, cfg = _cfgs()
    jparams = JX.init_mlstm(jax.random.key(3), jcfg)
    x = rng.normal(size=(1, 2, cfg.d_model)).astype(np.float32)
    _, jst = JX.mlstm(jparams, jnp.asarray(x), jcfg, return_state=True)
    _, st = X.mlstm(_mixer(jparams, "mlstm"), _t(x), cfg, return_state=True)
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(jst["conv"]), atol=1e-5)
    assert torch.equal(st["conv"][:, 0], torch.zeros_like(st["conv"][:, 0]))


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_decode_matches_forward(arch):
    """tests/test_models.py:55 in the port: prefill(15) then one decode
    step equals the full forward at position 15, and the port's decode the
    reference's, at atol/rtol 2e-3 (MoE capacity raised, as there)."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    if cfg.moe is not None:
        jcfg = jcfg.scaled(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = np.array(jax.random.randint(jax.random.key(0), (2, 16), 0, cfg.vocab))
    lf, _ = T.forward(model, {"tokens": torch.as_tensor(tokens)})
    _, caches = T.prefill(model, {"tokens": torch.as_tensor(tokens[:, :15])}, max_len=32)
    ld, _ = T.decode_step(model, torch.as_tensor(tokens[:, 15:16]), caches, 15)
    np.testing.assert_allclose(ld[:, 0].numpy(), lf[:, 15].numpy(), atol=2e-3, rtol=2e-3)
    _, jcache = JT.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :15])}, jcfg, max_len=32)
    jld, _ = JT.decode_step(jparams, jnp.asarray(tokens[:, 15:16]), jcache, jnp.int32(15),
                            jcfg)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["tiny-xlstm", "tiny-hybrid"])
def test_stepwise_prefill_matches_parallel(arch):
    """``prefill_mode="stepwise"`` (the decode recurrence over the prompt
    from a zero state) gives the parallel prefill's logits, and its conv,
    SSM and sLSTM ``h`` states, within f32 tolerance. The stepwise run's
    stabilizer starts at m = 0 where the parallel one starts at NEG, so
    C, n, c and m carry another (cancelling) scale and are not compared."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    model = T.init_model(cfg, 0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)))
    lp, cp = T.prefill(model, {"tokens": tokens}, 16)
    model.cfg = cfg.scaled(prefill_mode="stepwise")
    ls, cs = T.prefill(model, {"tokens": tokens}, 16)
    torch.testing.assert_close(ls, lp, atol=1e-4, rtol=1e-4)
    for a, b, spec in zip(cs, cp, (cfg.layer_spec(i) for i in range(cfg.n_layers))):
        if spec.mixer == "attn":
            continue
        for name in set(a) & {"conv", "ssm", "h"}:
            torch.testing.assert_close(a[name], b[name], atol=1e-4, rtol=1e-4)
