"""Port parity of the W4A8 kernel module: ``repro_torch.kernels`` against
``repro.kernels`` on the same numpy inputs.

Integer quantities (packed layouts, activation codes, int32 tile partials)
must be bit-exact. The GEMM output is held to rtol 1e-6 in f32 and
compared bit for bit in bf16: both sides run the same f32 epilogue
``(acc - corr) * sw`` on the same exact integer accumulator, so the
outputs are expected to be bit-equal. The reference runs its Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pack_int4 as jpack
from repro.kernels import unpack_int4 as junpack
from repro.kernels import w4a8_decode_matmul as j_decode
from repro.kernels import w4a8_matmul as j_matmul
from repro.kernels.ops import quantize_activations as j_quantize
from repro.kernels.ref import w4a8_matmul_ref as j_ref
from repro.kernels.ref import w4a8_tile_partials_ref as j_partials
from repro_torch.kernels import _build
from repro_torch.kernels.ops import quantize_activations
from repro_torch.kernels.ref import w4a8_matmul_ref, w4a8_tile_partials_ref
from repro_torch.kernels.w4a8_mm import (
    _fit_block,
    check_inner,
    pack_int4,
    unpack_int4,
    w4a8_decode_matmul,
    w4a8_matmul,
    w4a8_matmul_kernel,
    w4a8_matmul_plain,
)

_ACT = {"u8": (np.uint8, jnp.uint8, 0, 256), "s8": (np.int8, jnp.int8, -128, 128)}
_OUT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernel itself (it has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU interpret mode")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(y: torch.Tensor):
    return y.float().numpy() if y.dtype == torch.bfloat16 else y.numpy()


def _operands(rng, m, k, n, act="u8"):
    np_dt, _, lo, hi = _ACT[act]
    q = rng.integers(-8, 8, size=(k, n))  # full int4 range, -8 included
    x = rng.integers(lo, hi, size=(m, k)).astype(np_dt)  # full 8-bit range
    scale = rng.uniform(0.001, 0.1, size=(n,)).astype(np.float32)
    return q, x, scale


def _assert_out_equal(y_port, y_jax, out):
    y_jax = np.asarray(y_jax.astype(jnp.float32))
    if out == "f32":
        np.testing.assert_allclose(_np(y_port), y_jax, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(_np(y_port), y_jax)


@pytest.mark.parametrize("k", [2, 64, 256])
def test_pack_unpack_bit_exact(k, rng):
    q = rng.integers(-8, 8, size=(k, 32))
    packed = pack_int4(_t(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack(jnp.asarray(q))))
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), q)
    # stacked leading dims pass through, as in the reference
    stacked = rng.integers(-8, 8, size=(3, k, 8))
    np.testing.assert_array_equal(
        unpack_int4(pack_int4(_t(stacked))).numpy(),
        np.asarray(junpack(jpack(jnp.asarray(stacked)))))


@pytest.mark.parametrize("case", ["mixed", "positive", "negative", "wide"])
def test_quantize_activations_bit_exact(case, rng):
    x = rng.standard_normal((7, 96)).astype(np.float32)
    if case == "positive":
        x = np.abs(x) + 0.5
    elif case == "negative":
        x = -np.abs(x) - 0.5
    elif case == "wide":
        x = x * 1e3
    codes, scale, zp = quantize_activations(_t(x))
    jc, js, jz = j_quantize(jnp.asarray(x))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    assert scale.item() == float(js) and zp.item() == float(jz)


@pytest.mark.parametrize("act", ["u8", "s8"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize(
    "m,k,n,bm,bn,bk",
    [
        (64, 128, 64, 64, 64, 64),
        (128, 256, 128, 64, 64, 128),
        (64, 512, 128, 32, 128, 64),
        (256, 128, 256, 128, 128, 128),
    ],
)
def test_w4a8_matmul_shape_sweep(m, k, n, bm, bn, bk, act, out, rng):
    q, x, scale = _operands(rng, m, k, n, act)
    wp = np.asarray(jpack(jnp.asarray(q)))
    y_jax = j_matmul(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale), 0.02, 131,
                     interpret=True, block_m=bm, block_n=bn, block_k=bk,
                     out_dtype=_OUT[out][1])
    y = w4a8_matmul(_t(x), _t(wp), _t(scale), 0.02, 131, block_k=bk,
                    out_dtype=_OUT[out][0])
    assert y.shape == (m, n) and y.dtype == _OUT[out][0]
    _assert_out_equal(y, y_jax, out)


@pytest.mark.parametrize("act,out", [("u8", "f32"), ("s8", "bf16")])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 7, 8, 16, 100, 130, 250])
def test_w4a8_matmul_ragged_m(m, act, out, rng):
    k, n = 128, 64
    q, x, scale = _operands(rng, m, k, n, act)
    wp = np.asarray(jpack(jnp.asarray(q)))
    y_jax = j_matmul(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale), 0.02, 131,
                     interpret=True, out_dtype=_OUT[out][1])
    y = w4a8_matmul(_t(x), _t(wp), _t(scale), 0.02, 131, out_dtype=_OUT[out][0])
    assert y.shape == (m, n)
    _assert_out_equal(y, y_jax, out)


@pytest.mark.parametrize("act,out", [("u8", "f32"), ("s8", "bf16")])
@pytest.mark.parametrize("m", [1, 4, 13])
@pytest.mark.parametrize("k,n", [(128, 128), (64, 48), (256, 36)])
def test_w4a8_decode_matmul_sweep(m, k, n, act, out, rng):
    """Decode-shaped entry with the pack-time ``col_sums`` and traced
    (f32 0-d) activation scale and zero point, as the serving path has."""
    q, x, scale = _operands(rng, m, k, n, act)
    wp = np.asarray(jpack(jnp.asarray(q)))
    col_sums = q.sum(axis=0).astype(np.int32)
    s, zp = np.float32(0.0173), np.float32(97.0)
    y_jax = j_decode(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale),
                     jnp.asarray(col_sums), jnp.asarray(s), jnp.asarray(zp),
                     interpret=True, out_dtype=_OUT[out][1])
    y = w4a8_decode_matmul(_t(x), _t(wp), _t(scale), _t(col_sums), _t(s), _t(zp),
                           out_dtype=_OUT[out][0])
    _assert_out_equal(y, y_jax, out)


@pytest.mark.parametrize("tile", [32, 64, 128])
def test_tile_partials_bit_exact(tile, rng):
    q, x, _ = _operands(rng, 5, 256, 24)
    wp = np.asarray(jpack(jnp.asarray(q)))
    parts = w4a8_tile_partials_ref(_t(x), _t(wp), tile)
    assert parts.dtype == torch.int32
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(j_partials(jnp.asarray(x), jnp.asarray(wp), tile)))
    # the tiles sum to the full accumulator: the outer register holds their sum
    acc = _t(x).to(torch.int32) @ _t(q).to(torch.int32)
    np.testing.assert_array_equal(parts.sum(dim=1).numpy(), acc.numpy())


def test_matmul_ref_matches_reference_oracle(rng):
    q, x, scale = _operands(rng, 9, 128, 40)
    wp = np.asarray(jpack(jnp.asarray(q)))
    y = w4a8_matmul_ref(_t(x), _t(wp), _t(scale), 0.02, 131)
    y_jax = j_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale), 0.02, 131)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=1e-6, atol=0)


def test_assert_inner_certified_tiles(rng):
    """The P_I check runs over the certified tiles (``_fit_block(K, T)``),
    whatever the kernel's own K tiling: +-1 codes at T=64 stay under
    2^15 - 1; full-range codes overflow a 12-bit register."""
    k, n = 192, 32
    q = rng.choice([-1, 0, 1], size=(k, n))
    x = _t(rng.integers(0, 256, size=(2, k)).astype(np.uint8))
    wp = pack_int4(_t(q))
    assert _fit_block(k, 128) == 64  # K=192 is not a multiple of T=128
    y = w4a8_matmul(x, wp, torch.ones(n), 0.01, 131, block_k=128, p_inner=16,
                    assert_inner=True)
    assert check_inner(x, wp, 128, 16) <= 2 ** 15 - 1
    assert torch.equal(y, w4a8_matmul(x, wp, torch.ones(n), 0.01, 131))
    wide = pack_int4(_t(np.full((k, n), -8)))
    with pytest.raises(OverflowError, match="inner accumulator overflow"):
        w4a8_matmul(x, wide, torch.ones(n), 0.01, 131, p_inner=12, assert_inner=True)


@pytest.mark.parametrize("bad", ["act_dtype", "out_dtype", "shape", "weight_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, rng):
    q, x, scale = _operands(rng, 4, 64, 16)
    args = [_t(x), pack_int4(_t(q)), _t(scale), 0.02, 131]
    kw = {}
    if bad == "act_dtype":
        args[0] = args[0].to(torch.int32)
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif bad == "shape":
        args[0] = args[0][:, :32]
    else:
        args[1] = args[1].to(torch.int16)
    with pytest.raises((TypeError, ValueError)):
        w4a8_matmul(*args, **kw)


def test_plain_version_is_the_cpu_path(rng):
    """On CPU tensors the wrapper runs the plain version (no launch)."""
    q, x, scale = _operands(rng, 6, 64, 16)
    wp = pack_int4(_t(q))
    before = w4a8_matmul.launches
    y = w4a8_matmul(_t(x), wp, _t(scale), 0.5, 7.0)
    corr = _t(q).to(torch.int32).sum(0).float() * 7.0
    sw = _t(scale) * 0.5
    assert torch.equal(y, w4a8_matmul_plain(_t(x), wp, sw, corr))
    assert w4a8_matmul.launches == before


def test_kernel_entry_refuses_cpu_tensors(rng):
    """The kernel entry never runs on host memory and never falls back."""
    q, x, scale = _operands(rng, 4, 64, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        w4a8_matmul_kernel(_t(x), pack_int4(_t(q)), _t(scale), _t(scale))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Kernels build from the repository's sources at first use; with no
    nvcc the build raises instead of falling back."""
    assert "w4a8_mm" in _build.kernel_sources()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("w4a8_mm")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["u8", "s8"])
@pytest.mark.parametrize("m,k,n", [(4, 960, 960), (256, 2560, 960), (3, 64, 100)])
def test_cuda_kernel_bit_equal_to_plain(m, k, n, act, rng, cuda_device):
    q, x, scale = _operands(rng, m, k, n, act)
    args = (_t(x).to(cuda_device), pack_int4(_t(q)).to(cuda_device),
            _t(scale).to(cuda_device), 0.02, 131.0)
    for out in (torch.float32, torch.bfloat16):
        y = w4a8_matmul(*args, out_dtype=out)
        r = w4a8_matmul(*args, out_dtype=out, reference=True)
        torch.cuda.synchronize()
        assert torch.equal(y, r)
