"""Card tests of calibrated static KV page scales: the install quantizer
(``quantize_kv_pages_static``) and the decode append
(``_append_kv_page_static``) on CUDA tensors against the same code on CPU
tensors, kernel B3 over pages written under static scales against its
plain version, and a static-KV engine's captured decode step replayed
against its eager step. This file imports no JAX (the card's machine has
none); the CPU parity with the reference is ``tests/test_torch_search.py``.

Run on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kv_static_kernel.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import transformer as T
from repro_torch.models.layers import _append_kv_page_static
from repro_torch.quant.observe import observe_kv_ranges, search_kv_bits
from repro_torch.quant.serve_packed import pack_decode_params
from repro_torch.quant.spec import AttnDatapathSpec
from repro_torch.serving import PagedConfig, PagedEngine, Request, SamplerConfig
from test_torch_paged_kernel import assert_int8_agrees, random_case, to_dev

PAGED = dict(block_size=8, num_blocks=24, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)


@pytest.fixture
def cuda_device():
    """The card: the kernels and CUDA graphs have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs have no CPU mode")
    return torch.device("cuda")


def _static_scales(kp, vp):
    """Per-kv-head static scales from the pages' abs-max, shrunk so some
    codes clip, as out-of-calibration drift does."""
    k = kp.abs().amax(dim=(0, 1, 3)) / 127 * 0.8
    v = vp.abs().amax(dim=(0, 1, 3)) / 127
    return k.contiguous(), v.contiguous()


@pytest.mark.cuda
def test_static_install_and_append_match_cpu(cuda_device):
    """The install quantizer and the append give the CPU's codes and scale
    rows bit for bit on the card."""
    rng = np.random.default_rng(0)
    pages = torch.from_numpy((rng.standard_normal((6, 8, 3, 16)) * 2).astype(np.float32))
    scales = torch.from_numpy(np.asarray([0.01, 0.02, 0.015], np.float32))
    codes, stamp = PA.quantize_kv_pages_static(pages, scales[None])
    dcodes, dstamp = PA.quantize_kv_pages_static(pages.to(cuda_device),
                                                 scales.to(cuda_device)[None])
    assert torch.equal(dcodes.cpu(), codes) and torch.equal(dstamp.cpu(), stamp)
    assert int(codes.abs().max()) == 127

    pool = torch.from_numpy(rng.integers(-127, 128, size=(7, 8, 3, 16)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.01, 0.1, size=(7, 3)).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((4, 3, 16)) * 3).astype(np.float32))
    page = torch.tensor([1, 3, 6, 6])  # two idle rows on the sink page 6
    off = torch.tensor([0, 7, 2, 5])
    dpool, dsc = pool.to(cuda_device), sc.to(cuda_device)
    _append_kv_page_static(pool, sc, page, off, x, scales)
    _append_kv_page_static(dpool, dsc, page.to(cuda_device), off.to(cuda_device),
                           x.to(cuda_device), scales.to(cuda_device))
    assert torch.equal(dpool[:6].cpu(), pool[:6]) and torch.equal(dsc[:6].cpu(), sc[:6])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 2, 2, 16, 8, 4), (4, 5, 3, 64, 64, 3)])
def test_int8_kernel_over_static_pages(cuda_device, shape, dtype):
    """B3 over pages quantized under static scales (a constant stamp per
    kv head, some codes clipped at 127) agrees with its plain version as
    over dynamic pages, watermarks equal and within P_qk / P_pv."""
    rng = np.random.default_rng(2)
    B, nkv, g, hd, bs, P = shape
    q, kp, vp, tab, lens = to_dev(random_case(rng, *shape), cuda_device)
    q = q.to(dtype)
    k_s, v_s = _static_scales(kp, vp)
    kc, ks = PA.quantize_kv_pages_static(kp, k_s[None])
    vc, vs = PA.quantize_kv_pages_static(vp, v_s[None])
    ks, vs = ks.contiguous(), vs.contiguous()
    assert int(kc.abs().max()) == 127
    wm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    before = PA.paged_decode_attention.int8_launches
    out = PA.paged_decode_attention(q, kc, vc, tab, lens, k_scales=ks, v_scales=vs,
                                    watermarks=wm)
    assert PA.paged_decode_attention.int8_launches == before + 1
    wm_ref = torch.zeros(2, dtype=torch.int32)
    ref, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs, watermarks=wm_ref,
                                              return_ties=True, tie_eps=1e-4)
    torch.cuda.synchronize()
    assert_int8_agrees(out, ref, ties)
    assert wm.cpu().tolist() == wm_ref.tolist()
    spec = AttnDatapathSpec.for_cache(hd, bs)
    qk, pv = PA.check_bounds(wm, spec)
    assert 0 < qk <= spec.qk_worst_abs() and 0 < pv <= spec.pv_worst_abs()


@pytest.mark.cuda
def test_static_kv_decode_step_replays_equal_eager(cuda_device):
    """A static-KV engine's decode chunks, replays of its one captured step,
    give the eager chunk's streams, pools and watermarks; a replay launches
    B3 once a layer and the step holds fewer device operations than the
    dynamic engine's (the requantize-on-append is gone)."""
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    model = pack_decode_params(T.init_model(cfg, 0, device=cuda_device))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8)).astype(np.int32)
    kv = search_kv_bits(observe_kv_ranges(model, cfg, [{"tokens": prompts}]))

    def engine(**kw):
        return PagedEngine(model, cfg, PagedConfig(**PAGED, kv_dtype="int8"),
                           SamplerConfig(temperature=0.0), device=cuda_device,
                           assert_bounds=True, **kw)

    def reqs():
        return [Request(uid=u, prompt=p, max_new=9) for u, p in enumerate(prompts)]

    replayed, eager = engine(kv_scales=kv), engine(kv_scales=kv)
    chunk = eager._chunk
    eager._chunk = lambda k: chunk(k, eager=True)
    before = PA.paged_decode_attention.int8_launches
    got = replayed.serve(reqs())
    assert PA.paged_decode_attention.int8_launches - before == cfg.n_layers * replayed.decode_steps
    want = eager.serve(reqs())
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
    assert replayed.chunk_traces == 1 and replayed._program.replays > 0
    assert replayed.watermark_values == eager.watermark_values
    for a, b in zip(replayed.cache["pools"], eager.cache["pools"]):
        for leaf in a:  # the sink page, which idle rows write in any order, aside
            assert torch.equal(a[leaf][:PAGED["num_blocks"]], b[leaf][:PAGED["num_blocks"]]), leaf
    dynamic = engine()
    dynamic.serve(reqs())
    assert replayed._program.rise == dynamic._program.rise
    assert replayed._program.device_ops < dynamic._program.device_ops
