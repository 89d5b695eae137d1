"""Port parity of the registry's smoke configs through both engines: the
fixed-slot ``GenerationEngine`` and the paged ``PagedEngine`` (FIFO) of
the port against the reference's, greedy streams identical, on the same
f32 smoke weights (carried with ``interop.params_from_numpy``) for
stablelm-3b (LayerNorm, full MHA), phi4-mini-3.8b, llama3-405b (rope
theta 5e5, group 4), dbrx-132b (MoE) and musicgen-medium (LayerNorm +
GELU, codec tokens as plain tokens). internvl2-76b's vision stub needs
``pixel_embeds``, which neither package's engines feed: both refuse it.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as JT
from repro.serving import GenerationEngine as JEngine
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro_torch.configs import get_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.serving import (
    GenerationEngine,
    PagedConfig,
    PagedEngine,
    Request,
    SamplerConfig,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

MAX_NEW = 6
PAGED = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)
#: (uid, prompt length, new tokens) of the paged trace
TRACE = ((0, 5, 6), (1, 12, 4), (2, 9, 6), (3, 3, 5))


def _setup(arch):
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, size=(3, 8)).astype(np.int32)
    specs = [(u, rng.integers(0, cfg.vocab, size=n).astype(np.int32), k) for u, n, k in TRACE]
    return jcfg, cfg, jparams, model, prompts, specs


@pytest.mark.parametrize("arch", ["stablelm-3b", "phi4-mini-3.8b", "llama3-405b", "dbrx-132b",
                                  "musicgen-medium"])
def test_greedy_streams_match_reference_in_both_engines(arch):
    jcfg, cfg, jparams, model, prompts, specs = _setup(arch)
    want = JEngine(jparams, jcfg).generate(prompts, MAX_NEW)
    got = GenerationEngine(model, cfg, SamplerConfig(temperature=0.0),
                           device="cpu").generate(prompts, MAX_NEW)
    np.testing.assert_array_equal(got, np.asarray(want))

    jeng = JPagedEngine(jparams, jcfg, JPagedConfig(**PAGED, attn_impl="ref"),
                        JSampler(temperature=0.0))
    jout = jeng.serve([JRequest(uid=u, prompt=p, max_new=k) for u, p, k in specs])
    eng = PagedEngine(model, cfg, PagedConfig(**PAGED), SamplerConfig(temperature=0.0),
                      device="cpu")
    out = eng.serve([Request(uid=u, prompt=p, max_new=k) for u, p, k in specs])
    assert set(out) == set(jout)
    for u, p, k in specs:
        assert out[u].size == p.size + k
        np.testing.assert_array_equal(out[u], np.asarray(jout[u]))
    assert eng.pool_state.digest() == jeng.pool_state.digest()


def test_engines_refuse_the_vision_stub():
    """internvl2-76b: the reference's engines fail for want of pixel_embeds
    (their prefill reads batch["pixel_embeds"]); the port's refuse the
    config when built, with the reason."""
    jcfg, cfg, jparams, model, prompts, specs = _setup("internvl2-76b")
    with pytest.raises(KeyError, match="pixel_embeds"):
        JEngine(jparams, jcfg).generate(prompts, MAX_NEW)
    for build in (lambda: GenerationEngine(model, cfg, device="cpu"),
                  lambda: PagedEngine(model, cfg, PagedConfig(**PAGED), device="cpu")):
        with pytest.raises(NotImplementedError, match="pixel_embeds"):
            build()


def test_engines_refuse_a_model_with_gradients_on():
    """Serving keeps gradients off: a model built for training
    (``requires_grad_(True)``) is refused until they are turned off."""
    _, cfg, _, model, prompts, _ = _setup("stablelm-3b")
    model.requires_grad_(True)
    with pytest.raises(ValueError, match="gradients off"):
        GenerationEngine(model, cfg, device="cpu")
    with pytest.raises(ValueError, match="gradients off"):
        PagedEngine(model, cfg, PagedConfig(**PAGED), device="cpu")
    model.requires_grad_(False)
    assert GenerationEngine(model, cfg, device="cpu").generate(prompts, 2).shape == (3, 10)
