"""Port parity of fixed-slot serving: greedy token streams of the port's
``GenerationEngine`` against the reference's, identical token for token,
for (a) float weights, (b) RTN-packed weights and (c) a v2 AXE artifact
with static activation quantizers, loaded by both packages from one
directory. The reference runs its packed sites through the Pallas kernel in
interpret mode; the port through the kernel's plain version (``reference``
backend; on CPU tensors the ``kernel`` backend takes the same path).
Sampled generation is checked for determinism inside the port only:
``jax.random`` streams are not reproducible in PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree
from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.models.layers import use_packed_backend as j_backend
from repro.quant.serve_packed import load_flat_artifact as j_load
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.quant.serve_packed import packed_params_from_artifact as j_from_artifact
from repro.quant.spec import DatapathSpec as JSpec
from repro.serving import GenerationEngine as JEngine
from repro_torch.checkpoint import read_manifest
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.w4a8_mm import w4a8_matmul
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear
from repro_torch.quant.serve_packed import (
    load_flat_artifact,
    pack_decode_params,
    packed_params_from_artifact,
    upgrade_packed_params,
)
from repro_torch.quant.spec import DatapathMismatchError, DatapathSpec
from repro_torch.serving import GenerationEngine, SamplerConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ARCH = "tiny-lm-xs"
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=3,
                                      seed=0)).batch(0)["tokens"]
    return jcfg, cfg, jparams, model, prompts


def _jax_generate(params, cfg, prompts, backend="dequant"):
    with j_backend(backend):
        return JEngine(params, cfg).generate(prompts, MAX_NEW)


def _port_generate(model, prompts, backend="reference", **sampler):
    eng = GenerationEngine(model, sampler=SamplerConfig(**sampler), device="cpu",
                           backend=backend)
    return eng.generate(prompts, MAX_NEW)


def test_greedy_float_matches_reference(setup):
    jcfg, _, jparams, model, prompts = setup
    out = _port_generate(model, prompts)
    np.testing.assert_array_equal(out, _jax_generate(jparams, jcfg, prompts))
    assert out.dtype == np.int32 and out.shape == (3, 8 + MAX_NEW)


def test_greedy_rtn_packed_matches_reference(setup):
    jcfg, _, jparams, model, prompts = setup
    jout = _jax_generate(j_pack(jparams, jcfg), jcfg, prompts, "interpret")
    packed = pack_decode_params(model)
    np.testing.assert_array_equal(_port_generate(packed, prompts, "reference"), jout)
    # on CPU tensors the kernel backend takes the plain version: same tokens
    np.testing.assert_array_equal(_port_generate(packed, prompts, "kernel"), jout)


def _write_artifact(cfg, directory, rng):
    """A flat v2 artifact as ``repro.launch.quantize --out`` writes it:
    raw int8 codes in [-7, 7], f32 scales, corrected output biases, per-site
    spec vectors with static activation quantizers (unsigned for the input
    projections, signed for ``wd``), and equalized norms."""
    from repro.quant.families import get_adapter

    flat = {}
    for i in range(cfg.n_layers):
        for kind, fam in (("mixer", "attn"), ("ffn", "mlp")):
            for site in get_adapter(kind, fam).enumerate_sites(cfg):
                name = f"layer{i}/{kind}.{site.name}"
                flat[f"{name}/q"] = rng.integers(-7, 8, size=(site.k, site.c)).astype(np.int8)
                flat[f"{name}/scale"] = rng.uniform(0.01, 0.03, size=(1, site.c)).astype(np.float32)
                if site.use_bias:
                    flat[f"{name}/bias"] = rng.normal(0, 0.01, size=(site.c,)).astype(np.float32)
                signed = site.name == "wd"
                spec = JSpec(p_inner=20, p_outer=24, act_signed=signed).with_act(
                    0.03 if signed else 0.05, 0 if signed else 120)
                flat[f"{name}/spec"] = spec.to_array()
        for norm_name in ("norm1", "norm2"):
            flat[f"layer{i}/{norm_name}/w"] = rng.uniform(0.8, 1.2, size=(cfg.d_model,)).astype(
                np.float32)
    meta = {"artifact_version": 2, "arch": cfg.name, "n_layers": cfg.n_layers,
            "mixed_precision": False, "datapath": "test"}
    save_pytree(flat, str(directory), extra_meta=meta)


def test_greedy_artifact_matches_reference(setup, tmp_path):
    jcfg, cfg, jparams, model, prompts = setup
    _write_artifact(jcfg, tmp_path / "art", np.random.default_rng(5))
    jflat, jmeta = j_load(str(tmp_path / "art"))
    jout = _jax_generate(j_from_artifact(jflat, jparams, jcfg, meta=jmeta), jcfg, prompts,
                         "interpret")
    flat, meta = load_flat_artifact(str(tmp_path / "art"))
    served = packed_params_from_artifact(flat, model, cfg, meta=meta)
    wd = served.layers[0].ffn.wd
    assert isinstance(wd, PackedLinear) and wd.spec.static_act and wd.spec.act_signed
    assert wd.bias is not None and wd.act_zp.item() == 0.0
    assert torch.equal(served.layers[1].norm1.w, torch.from_numpy(flat["layer1/norm1/w"]))
    np.testing.assert_array_equal(_port_generate(served, prompts, "reference"), jout)


def test_artifact_refusals(setup, tmp_path):
    _, cfg, _, model, _ = setup
    _write_artifact(j_get_config(ARCH), tmp_path / "art", np.random.default_rng(6))
    flat, meta = load_flat_artifact(str(tmp_path / "art"))
    with pytest.raises(DatapathMismatchError, match="schema version"):
        packed_params_from_artifact(flat, model, cfg, meta={**meta, "artifact_version": 1})
    with pytest.raises(DatapathMismatchError, match="arch"):
        packed_params_from_artifact(flat, model, cfg, meta={**meta, "arch": "tiny-lm-s"})
    partial = {k: v for k, v in flat.items() if not k.startswith("layer3/mixer.wq")}
    with pytest.raises(DatapathMismatchError, match="does not cover"):
        packed_params_from_artifact(partial, model, cfg, meta=meta)
    with pytest.raises(DatapathMismatchError, match="does not enumerate"):
        packed_params_from_artifact({**flat, "layer0/mixer.wz/q": flat["layer0/mixer.wq/q"]},
                                    model, cfg, meta=meta)


@pytest.mark.parametrize("loop", ["generate", "generate_host_loop"])
def test_sampled_generation_is_deterministic(setup, loop):
    _, _, _, model, prompts = setup
    packed = pack_decode_params(model)

    def run(seed):
        eng = GenerationEngine(packed, sampler=SamplerConfig(temperature=1.0, seed=seed),
                               device="cpu")
        return getattr(eng, loop)(prompts, MAX_NEW)

    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_eos_semantics_device_loop_vs_host_loop(setup, temperature):
    """EOS masking, post-EOS padding and all-done early exit agree between
    the device loop and the host loop."""
    _, _, _, model, prompts = setup
    greedy = _port_generate(model, prompts)
    eos = int(greedy[0, prompts.shape[1] + 1])
    eng = GenerationEngine(model, sampler=SamplerConfig(temperature=temperature, eos_id=eos,
                                                        seed=3), device="cpu")
    out = eng.generate(prompts, MAX_NEW)
    np.testing.assert_array_equal(out, eng.generate_host_loop(prompts, MAX_NEW))
    for row in out[:, prompts.shape[1]:]:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all()


def test_engine_defaults_to_the_card(setup):
    _, cfg, _, model, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        GenerationEngine(model, cfg)


def test_engine_validates_the_requested_datapath(setup):
    _, cfg, _, model, _ = setup
    packed = pack_decode_params(model)
    GenerationEngine(packed, cfg, datapath=DatapathSpec(), device="cpu")
    with pytest.raises(DatapathMismatchError):
        GenerationEngine(packed, cfg, datapath=DatapathSpec(p_inner=12), device="cpu")
    with pytest.raises(ValueError, match="does not describe"):
        GenerationEngine(packed, get_config("tiny-lm-s"), device="cpu")


def test_legacy_packed_sites_upgrade(setup):
    """Sites without ``col_sums``/spec (pre-v1 artifacts) are filled once at
    engine construction and serve identically."""
    _, _, _, model, prompts = setup
    fresh = pack_decode_params(model)
    legacy = pack_decode_params(model)
    for m in legacy.modules():
        if isinstance(m, PackedLinear):
            m.col_sums, m.spec, m.spec_arr = None, None, None
    upgrade_packed_params(legacy)
    site = legacy.layers[0].mixer.wq
    assert site.spec.version == 0 and site.col_sums is not None
    assert torch.equal(site.col_sums, fresh.layers[0].mixer.wq.col_sums)
    np.testing.assert_array_equal(_port_generate(legacy, prompts),
                                  _port_generate(fresh, prompts))


def test_checkpoint_reader_reads_reference_files(tmp_path):
    tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16),
            "c": jnp.asarray([7, -8], jnp.int8)}
    save_pytree(tree, str(tmp_path / "ck"), extra_meta={"step": 3})
    flat, meta = read_manifest(str(tmp_path / "ck"))
    assert meta == {"step": 3}
    np.testing.assert_array_equal(flat["['b']"], np.asarray([1.5, -2.25, 3.0], np.float32))
    assert flat["['c']"].dtype == np.int8
    np.testing.assert_array_equal(flat["['a']"], np.asarray(tree["a"]))


def test_serve_launcher_cpu(capsys):
    out = serve.main(["--arch", "smollm-360m", "--smoke", "--packed", "--batch", "2",
                      "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    assert out.shape == (2, 12)
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not yet ported"):
        serve.main(["--arch", ARCH, "--paged", "--device", "cpu"])


def test_kernel_launch_counter_counts_only_launches(setup):
    """A CPU run goes through the plain version and launches nothing."""
    _, _, _, model, prompts = setup
    before = w4a8_matmul.launches
    _port_generate(pack_decode_params(model), prompts, "kernel")
    assert w4a8_matmul.launches == before


def test_init_model_shapes_and_seed():
    cfg = get_config(ARCH)
    a, b = T.init_model(cfg, 1, device="cpu"), T.init_model(cfg, 1, device="cpu")
    assert torch.equal(a.layers[2].ffn.wd.w, b.layers[2].ffn.wd.w)
    assert a.embedding.embed.shape == (cfg.vocab_padded, cfg.d_model)
    assert a.layers[0].mixer.wk.w.shape == (cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
    std = a.layers[0].mixer.wq.w.std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.02
