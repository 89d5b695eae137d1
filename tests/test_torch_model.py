"""Port parity of the dense model, the packing and the records: the port's
``repro_torch`` against ``repro`` on weights carried across by
``repro_torch.interop.params_from_numpy``.

Float logits and losses are held within atol 1e-4 (f32 on the CPU; XLA and
PyTorch sum matmuls in different orders, so a few ulps differ). Packing is
integer and exact: codes, bf16 scales, ``col_sums`` and ``spec_arr`` equal
the reference's. The module-import check walks the AST of every file of the
port and of ``chip_smoke.py``.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import TokenBatcher as JTokenBatcher
from repro.models import transformer as JT
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.quant.spec import DatapathSpec as JSpec
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear
from repro_torch.quant.serve_packed import pack_decode_params, packed_weight_bytes
from repro_torch.quant.spec import (
    DatapathMismatchError,
    DatapathSpec,
    tree_datapath_fingerprint,
    validate_datapath,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def xs():
    jcfg = j_get_config("tiny-lm-xs")
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(_numpy_tree(jparams), get_config("tiny-lm-xs"), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 12)).astype(np.int32)
    return jcfg, jparams, model, tokens


@pytest.mark.parametrize("arch", ["tiny-lm-xs", "tiny-lm-s", "tiny-lm-m", "tiny-lm-l",
                                  "smollm-360m"])
def test_configs_match_reference(arch):
    ported = dataclasses.asdict(get_config(arch))
    ref = dataclasses.asdict(j_get_config(arch))
    assert ported == ref
    if arch == "smollm-360m":
        assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(j_get_smoke(arch))


def test_token_batcher_matches_reference():
    port = TokenBatcher(DataConfig(vocab=49152, seq_len=64, global_batch=4, seed=3))
    ref = JTokenBatcher(JDataConfig(vocab=49152, seq_len=64, global_batch=4, seed=3))
    for i in (0, 7):
        np.testing.assert_array_equal(port.batch(i)["tokens"], ref.batch(i)["tokens"])


@torch.inference_mode()
def test_forward_and_loss_match_reference(xs):
    jcfg, jparams, model, tokens = xs
    jlogits, _ = JT.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    logits, aux = T.forward(model, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == jlogits.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    jloss, jm = JT.loss_fn(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    loss, m = T.loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4, rtol=0)
    np.testing.assert_allclose(m["ppl"].item(), float(jm["ppl"]), rtol=1e-4)


@torch.inference_mode()
def test_chunked_attention_matches_reference():
    """Online-softmax chunked attention (S above the threshold), with a
    ragged tail chunk and GQA."""
    jcfg = j_get_smoke("smollm-360m").scaled(attn_chunk_threshold=4, attn_chunk=4)
    cfg = get_smoke("smollm-360m").scaled(attn_chunk_threshold=4, attn_chunk=4)
    jparams = JT.init_model(jax.random.key(1), jcfg)
    model = params_from_numpy(_numpy_tree(jparams), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 10)).astype(np.int32)
    jlogits, _ = JT.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    logits, _ = T.forward(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)


@torch.inference_mode()
def test_prefill_and_decode_match_reference(xs):
    jcfg, jparams, model, tokens = xs
    max_len = tokens.shape[1] + 3
    jl, jcache = JT.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, max_len)
    logits, caches = T.prefill(model, {"tokens": torch.from_numpy(tokens)}, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    step = np.array([[5], [9]], np.int32)
    jd, _ = JT.decode_step(jparams, jnp.asarray(step), jcache, jnp.int32(tokens.shape[1]), jcfg)
    d, caches = T.decode_step(model, torch.from_numpy(step), caches, tokens.shape[1])
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4, rtol=0)
    # the caches were written in place at the decoded position
    assert caches[0]["k"][:, tokens.shape[1]].abs().sum() > 0
    assert caches[0]["k"][:, tokens.shape[1] + 1:].abs().sum() == 0


def test_pack_decode_params_bit_exact(xs):
    jcfg, jparams, model, _ = xs
    jpacked = _numpy_tree(j_pack(jparams, jcfg))
    packed = pack_decode_params(model)
    n_sites = 0
    for i, block in enumerate(packed.layers):
        r, s = divmod(i, jcfg.period)
        for kind in ("mixer", "ffn"):
            for name, site in getattr(block, kind).named_children():
                ref = jpacked["layers"][s][kind][name]
                assert isinstance(site, PackedLinear)
                np.testing.assert_array_equal(site.packed.numpy(), ref["packed"][r])
                assert site.scale.dtype == torch.bfloat16
                np.testing.assert_array_equal(site.scale.float().numpy(),
                                              ref["scale"][r].astype(np.float32))
                np.testing.assert_array_equal(site.col_sums.numpy(), ref["col_sums"][r])
                np.testing.assert_array_equal(site.spec_arr.numpy(), ref["spec_arr"][r])
                assert site.spec == DatapathSpec.from_array(ref["spec_arr"][r])
                n_sites += 1
    assert n_sites == 7 * jcfg.n_layers
    # the float model is untouched and shares its embedding with the packed one
    assert packed.embedding is model.embedding
    assert not isinstance(model.layers[0].mixer.wq, PackedLinear)


def test_packed_weight_bytes_match_reference():
    from repro.quant.serve_packed import packed_weight_bytes as j_bytes

    for arch in ("tiny-lm-xs", "smollm-360m"):
        assert packed_weight_bytes(get_config(arch)) == j_bytes(j_get_config(arch))
    # smollm-360m: 157 MB of packed codes per decode step
    assert packed_weight_bytes(get_config("smollm-360m"))["packed_code_bytes"] == 157_286_400


@pytest.mark.parametrize("spec", [
    JSpec(),
    JSpec(tile=None, p_inner=20, p_outer=24),
    JSpec(act_signed=True, static_act=True, act_scale=0.0125, act_zp=0, tile=64),
])
def test_datapath_spec_encoding_matches_reference(spec):
    port = DatapathSpec(**dataclasses.asdict(spec))
    np.testing.assert_array_equal(port.to_array(), spec.to_array())
    assert DatapathSpec.from_array(spec.to_array()) == port
    assert port.describe() == spec.describe()
    assert port.spec_hash() == spec.spec_hash()
    assert port.block_k() == spec.block_k()
    # the 10-slot pre-sparsity encoding loads as dense
    assert DatapathSpec.from_array(spec.to_array()[:10]).sparsity is None


def test_validate_datapath_and_fingerprint(xs):
    _, _, model, _ = xs
    packed = pack_decode_params(model)
    assert validate_datapath(packed, DatapathSpec()) == 7 * model.cfg.n_layers
    with pytest.raises(DatapathMismatchError):
        validate_datapath(packed, DatapathSpec(p_inner=12))
    per_site = {f"slot0/{k}.{n}": DatapathSpec()
                for k, names in (("mixer", "wq wk wv wo"), ("ffn", "wg wu wd"))
                for n in names.split()}
    assert validate_datapath(packed, per_site) == 7 * model.cfg.n_layers
    with pytest.raises(DatapathMismatchError):
        validate_datapath(packed, {**per_site, "slot1/mixer.wq": DatapathSpec()})
    assert tree_datapath_fingerprint(packed) != tree_datapath_fingerprint(
        pack_decode_params(model, ptq=DatapathSpec(p_inner=20)))


def test_entry_points_default_to_the_card():
    """No silent CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config("tiny-lm-xs")
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_cache(cfg, 1, 4)


def test_non_dense_patterns_raise():
    cfg = get_config("tiny-lm-xs")
    moe = cfg.scaled(pattern=(dataclasses.replace(cfg.pattern[0], ffn="moe"),))
    with pytest.raises(NotImplementedError, match="family slice"):
        T.init_model(moe, device="cpu")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax"):
                    offenders.append(f"{path.relative_to(ROOT)}: {mod}")
    assert len(_port_files()) > 20
    assert not offenders, offenders
