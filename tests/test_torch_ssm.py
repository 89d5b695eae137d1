"""Port parity of the Mamba-1 block (``repro_torch.models.ssm`` against
``repro.models.ssm``) on inputs made with numpy from a seed, f32.

The causal conv is held to the reference within atol 1e-6 (a few adds of
the same products); the chunked selective scan, whose within-chunk
doubling scan combines in another order than ``lax.associative_scan``,
within atol 1e-5, its end state too; the ragged tail's padding (abar = 1,
bu = 0) is exact: the state after a padded scan equals the state of the
unpadded one bit for bit. The block's prefill and its decode steps from
the prefill's state within atol 1e-4, and the chunked prefill equals the
stepwise recurrence (``tests/test_models.py:120``) within atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import SSMConfig as JSSMConfig
from repro_torch.interop import to_tensor
from repro_torch.models import ssm as S
from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig
from repro_torch.models.layers import Linear

torch.set_float32_matmul_precision("highest")


def _cfgs(d=16, d_state=4):
    kw = dict(name="t", family="ssm", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2,
              d_ff=32, vocab=64)
    return (JModelConfig(pattern=(JLayerSpec("mamba", "none"),),
                         ssm=JSSMConfig(d_state=d_state, d_conv=4, expand=2), **kw),
            ModelConfig(pattern=(LayerSpec("mamba", "none"),),
                        ssm=SSMConfig(d_state=d_state, d_conv=4, expand=2), **kw))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _block(jparams) -> S.Mamba:
    p = {k: to_tensor(np.asarray(v), "cpu") for k, v in jparams.items()}
    return S.Mamba(*(Linear(p[n]) for n in ("in_proj", "x_proj", "dt_proj", "out_proj")),
                   *(p[n] for n in S.Mamba.FLOAT_LEAVES))


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = _cfgs()
    jparams = JS.init_mamba(jax.random.key(0), jcfg)
    return jcfg, cfg, jparams, _block(jparams)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, rng):
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    y, s = S._causal_conv(_t(x), _t(w), _t(b), None if st is None else _t(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _scan_inputs(rng, B=2, S_=37, d_in=6, n=4):
    xin = rng.normal(size=(B, S_, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S_, d_in)))).astype(np.float32) * 0.1
    b = rng.normal(size=(B, S_, n)).astype(np.float32)
    c = rng.normal(size=(B, S_, n)).astype(np.float32)
    a = -np.exp(rng.normal(size=(d_in, n))).astype(np.float32)
    d = rng.normal(size=(d_in,)).astype(np.float32)
    return xin, dt, b, c, a, d


@pytest.mark.parametrize("chunk", [4, 256])
def test_selective_scan_matches_reference(chunk, rng):
    """Chunk 4 over 37 steps (nine chunks and a ragged tail of one step
    padded to four) and chunk 256 (one chunk of 37): the outputs and the
    end-of-sequence state."""
    args = _scan_inputs(rng)
    jy, jh = JS.selective_scan(*(jnp.asarray(a) for a in args), 4, chunk=chunk,
                               return_state=True)
    y, h = S.selective_scan(*(_t(a) for a in args), 4, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)


def test_selective_scan_padded_tail_is_exact(rng):
    """The ragged tail's padding keeps the state bit for bit: a scan of 36
    steps in chunks of 4 (no tail) and of the same 36 steps followed by one
    more in chunks of 8 agree on the 36-step prefix's state when the 37th
    step is the identity (dt = 0: abar = 1, bu = 0)."""
    xin, dt, b, c, a, d = _scan_inputs(rng, S_=40)
    dt[:, 36:] = 0.0
    _, h36 = S.selective_scan(*(_t(v[:, :36]) for v in (xin, dt, b, c)), _t(a), _t(d), 4,
                              chunk=36, return_state=True)
    _, h40 = S.selective_scan(*(_t(v) for v in (xin, dt, b, c)), _t(a), _t(d), 4,
                              chunk=36, return_state=True)  # 40 = 36 + 4 padded to 72
    assert torch.equal(h36, h40)


def test_scan_chunk_is_the_recurrence(rng):
    """The doubling scan equals the step-by-step recurrence it replaces."""
    abar = _t(rng.uniform(0.5, 1.0, size=(2, 13, 3, 4)))
    bu = _t(rng.normal(size=(2, 13, 3, 4)))
    h0 = _t(rng.normal(size=(2, 3, 4)))
    hs, h = [], h0
    for t in range(13):
        h = abar[:, t] * h + bu[:, t]
        hs.append(h)
    torch.testing.assert_close(S._scan_chunk(h0, abar, bu), torch.stack(hs, 1),
                               atol=1e-5, rtol=1e-5)


def test_mamba_prefill_then_decode_matches_reference(block, rng):
    """``mamba(return_state=True)`` over 12 steps, then 5 decode steps from
    its state, with the states written in place."""
    jcfg, cfg, jparams, p = block
    x = rng.normal(size=(2, 17, 16)).astype(np.float32)
    jy, jst = JS.mamba(jparams, jnp.asarray(x[:, :12]), jcfg, chunk=4, return_state=True)
    y, st = S.mamba(p, _t(x[:, :12]), cfg, chunk=4, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]), atol=1e-4,
                                   rtol=1e-4)
    jconv, jssm = jst["conv"], jst["ssm"]
    conv, ssm = st["conv"].clone(), st["ssm"].clone()
    conv_ptr, ssm_ptr = conv.data_ptr(), ssm.data_ptr()
    for t in range(12, 17):
        jy_t, jconv, jssm = JS.mamba_decode(jparams, jnp.asarray(x[:, t:t + 1]), jcfg,
                                            jconv, jssm)
        y_t, c2, s2 = S.mamba_decode(p, _t(x[:, t:t + 1]), cfg, conv, ssm)
        assert c2.data_ptr() == conv_ptr and s2.data_ptr() == ssm_ptr  # in place
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ssm.numpy(), np.asarray(jssm), atol=1e-4, rtol=1e-4)


def test_mamba_chunked_scan_matches_stepwise(block, rng):
    """tests/test_models.py:120 in the port: the chunked prefill equals the
    exact per-step recurrence from a zero state."""
    _, cfg, _, p = block
    x = _t(rng.normal(size=(2, 12, 16)))
    y_par = S.mamba(p, x, cfg, chunk=4)
    conv = torch.zeros((2, 3, 32))
    ssm = torch.zeros((2, 32, 4))
    ys = [S.mamba_decode(p, x[:, t:t + 1], cfg, conv, ssm)[0] for t in range(12)]
    torch.testing.assert_close(torch.cat(ys, 1), y_par, atol=1e-4, rtol=1e-4)


def test_state_shapes_match_reference(block):
    jcfg, cfg, _, _ = block
    shapes = S.mamba_state_shapes(cfg, 3)
    jshapes = JS.mamba_state_shapes(jcfg, 3)
    assert {k: v[0] for k, v in shapes.items()} == {k: v.shape for k, v in jshapes.items()}
