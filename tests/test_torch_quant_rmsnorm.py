"""Port parity of the fused RMSNorm quantizer (kernel B6):
``repro_torch.kernels.ops.norm_and_quantize`` and
``repro_torch.kernels.ref.quant_rmsnorm_ref`` against the reference's
``norm_and_quantize`` (Pallas, interpret mode) and ``quant_rmsnorm_ref``, at
the shapes of ``tests/test_kernels.py:138`` and at the registry's widest
row (llama3-405b's d_model 16384), on the same numpy inputs.

Tolerance: the reference test's own bound, the codes exact or within one
code on under 1% of the elements. The kernel multiplies by 1/act_scale
while the ``*_ref`` oracles divide by act_scale, and the mean of squares
reduces in another order, so a value on a rounding boundary may take the
neighbouring code.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import norm_and_quantize as j_norm_and_quantize
from repro.kernels.ref import quant_rmsnorm_ref as j_ref
from repro_torch.kernels import quant_rmsnorm as B6
from repro_torch.kernels.ops import norm_and_quantize
from repro_torch.kernels.ref import quant_rmsnorm_ref


def _within_one_code(a, b):
    diff = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("m,d,bm", [(128, 64, 64), (256, 128, 128), (64, 32, 64),
                                    (8, 16384, 8)])
def test_norm_and_quantize_matches_reference(m, d, bm, rng):
    x = (rng.normal(size=(m, d)) * 2).astype(np.float32)
    g = (rng.normal(size=(d,)) * 0.1 + 1.0).astype(np.float32)
    out = norm_and_quantize(torch.from_numpy(x), torch.from_numpy(g), 0.02, 128, block_m=bm)
    assert out.dtype == torch.uint8 and out.shape == (m, d)
    jout = np.asarray(j_norm_and_quantize(jnp.asarray(x), jnp.asarray(g), 0.02, 128,
                                          interpret=True, block_m=bm))
    ref = quant_rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(g), 0.02, 128)
    jref = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(g), 0.02, 128))
    _within_one_code(out.numpy(), jout)
    _within_one_code(out.numpy(), jref)
    _within_one_code(ref.numpy(), jref)
    # bfloat16 input, as the reference takes it
    xb = jnp.asarray(x, jnp.bfloat16)
    outb = norm_and_quantize(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
                             torch.from_numpy(g), 0.02, 128, block_m=bm)
    _within_one_code(outb.numpy(), np.asarray(j_norm_and_quantize(
        xb, jnp.asarray(g), 0.02, 128, interpret=True, block_m=bm)))


def test_quantizer_constants_and_refusals(rng):
    """The wrapper forms 1/act_scale in f32 as the reference's wrapper does,
    keeps its block_m refusal, and launches nothing for CPU tensors."""
    qp = B6.quantizer_pair(0.02, 128, "cpu")
    assert qp.dtype == torch.float32
    assert float(qp[0]) == float(np.float32(1.0) / np.float32(0.02)) and float(qp[1]) == 128.0
    x = torch.from_numpy(rng.normal(size=(96, 32)).astype(np.float32))
    g = torch.ones(32)
    before = B6.quant_rmsnorm.launches
    codes = norm_and_quantize(x, g, 0.05, 3, block_m=32, bits=4)
    assert B6.quant_rmsnorm.launches == before
    assert int(codes.max()) <= 15
    with pytest.raises(ValueError, match="block_m"):
        norm_and_quantize(x, g, 0.02, 128)  # M = 96 is not a multiple of 256
    with pytest.raises(AssertionError):  # the reference refuses the same call
        j_norm_and_quantize(jnp.asarray(x.numpy()), jnp.ones(32), 0.02, 128, interpret=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        B6.quant_rmsnorm_kernel(x, g, 0.02, 128, eps=1e-6, qmax=255.0)
