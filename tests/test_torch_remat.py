"""Recomputation by period (``cfg.remat == "block"``): the port's
``forward`` runs each period of ``cfg.pattern`` under a non-reentrant
checkpoint while grad is enabled, the reference's ``jax.checkpoint`` of its
scan body.

On one device and the CPU: for tiny-lm-xs, tiny-moe, tiny-xlstm (one
period of two layers), tiny-hybrid at two such periods and the 2-layer
smollm smoke, the loss and every gradient at ``"block"`` equal those at
``"none"`` bit for bit, and match the reference's ``jax.value_and_grad``
of ``loss_fn`` at ``"block"`` on the same weights (carried with
``interop.params_from_numpy``) and batch within the tolerances of
``tests/test_torch_training.py`` (rel 1e-5 on the loss, atol 1e-5 on the
gradients); the checkpoints a forward takes number the reference's scan
length, and none is taken under ``torch.no_grad()`` or at ``"none"``; under
a batch split (the mesh step's) the MoE recompute routes with the whole
batch's group size and capacity and appends its statistics once a unit.
"""

from contextlib import contextmanager
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import params_from_numpy, reference_tree
from repro_torch.models import transformer as T

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: name: (arch, smoke, layers or None)
CONFIGS = {
    "tiny-lm-xs": ("tiny-lm-xs", False, None),
    "tiny-moe": ("tiny-moe", False, None),
    "tiny-xlstm": ("tiny-xlstm", False, None),
    "tiny-hybrid": ("tiny-hybrid", False, 4),
    "smollm-smoke": ("smollm-360m", True, 2),
}
B, S = 2, 16


def _configs(name: str, remat: str):
    """(reference config, port config) of ``name`` at ``remat``, vocab 64."""
    arch, smoke, layers = CONFIGS[name]
    extra = {"n_layers": layers} if layers else {}
    gets = (j_get_smoke, get_smoke) if smoke else (j_get_config, get_config)
    return tuple(get(arch).scaled(vocab=64, remat=remat, **extra) for get in gets)


def _case(name: str, remat: str, seed: int = 0):
    """The reference's weights (numpy) and a batch of tokens (numpy)."""
    jcfg, cfg = _configs(name, remat)
    params = jax.tree.map(np.asarray, JT.init_model(jax.random.key(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return jcfg, cfg, params, tokens


def _loss_and_grads(cfg, params, tokens, split=None):
    """The port's loss and every parameter's gradient, by name."""
    model = params_from_numpy(params, cfg, device="cpu").requires_grad_(True)
    total, metrics = T.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, split)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()))
    return total.detach(), metrics, dict(zip(named, grads)), model


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_block_equals_none_bit_for_bit(name):
    """The same weights and batch at ``"block"`` and at ``"none"``: the
    loss, its metrics and every gradient bit for bit."""
    _, cfg, params, tokens = _case(name, "block")
    got = _loss_and_grads(cfg, params, tokens)
    want = _loss_and_grads(cfg.scaled(remat="none"), params, tokens)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    assert got[2].keys() == want[2].keys()
    for n, g in want[2].items():
        assert torch.equal(got[2][n], g), n


@pytest.mark.parametrize("name", list(CONFIGS))
def test_block_matches_reference(name):
    """The loss and every gradient at ``"block"`` against the reference's
    ``jax.value_and_grad(loss_fn)`` at ``"block"``: the loss within rel
    1e-5, each gradient leaf within atol 1e-5."""
    jcfg, cfg, params, tokens = _case(name, "block")
    (loss, _), jgrads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(tokens)}, jcfg)
    total, _, grads, model = _loss_and_grads(cfg, params, tokens)
    assert float(total) == pytest.approx(float(loss), rel=1e-5)
    got = jax.tree_util.tree_flatten_with_path(reference_tree(model, grads))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (path, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _scan_lengths(jaxpr) -> list[int]:
    """The length of every outermost scan in ``jaxpr`` (the recurrent
    mixers' scans over time lie inside the layer scan)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            out.append(eqn.params["length"])
            continue
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += _scan_lengths(sub)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_units_number_the_reference_scan(name, monkeypatch):
    """A forward with grad at ``"block"`` takes one checkpoint a period,
    as many as the reference's layer scan is long; none under
    ``torch.no_grad()`` or at ``"none"``; the units of ``model_units`` are
    the embedding, the periods and the head, every parameter in one."""
    jcfg, cfg, params, tokens = _case(name, "block")
    jaxpr = jax.make_jaxpr(lambda p: JT.forward(p, {"tokens": jnp.asarray(tokens)}, jcfg))(
        jax.tree.map(jnp.asarray, params))
    assert _scan_lengths(jaxpr.jaxpr) == [jcfg.repeats]
    taken = []
    real = T.checkpoint

    def counting(fn, *args, **kwargs):
        taken.append(kwargs.get("use_reentrant"))
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(T, "checkpoint", counting)
    _loss_and_grads(cfg, params, tokens)
    assert taken == [False] * jcfg.repeats
    model = params_from_numpy(params, cfg, device="cpu").requires_grad_(True)
    with torch.no_grad():
        T.forward(model, {"tokens": torch.from_numpy(tokens)})
    _loss_and_grads(cfg.scaled(remat="none"), params, tokens)
    assert len(taken) == jcfg.repeats
    units = T.model_units(model)
    assert [(u.kind, u.index) for u in units] == [("embed", 0)] + [
        ("period", r) for r in range(jcfg.repeats)] + [("head", 0)]
    names = [n for u in units for n in u.names]
    tied = 1 if model.embedding.head is None else 0
    assert sorted(names) == sorted([n for n, _ in model.named_parameters()]
                                   + ["embedding.embed"] * tied)


def test_moe_recompute_routes_as_the_split(monkeypatch):
    """tiny-moe with routing groups of 48 tokens, this rank's rows 2-3 of
    a 4-row batch: the whole batch's group (gcd(64, 48) = 16 tokens) is not
    the rank's own (32), so a recompute outside the split would route
    otherwise. At ``"block"`` the loss and every gradient equal ``"none"``
    bit for bit, and the split's statistics hold one entry an MoE block
    after the backward (the recompute appends none)."""
    lists = []
    real = T.split_routing

    @contextmanager
    def recording(rows, row0):
        with real(rows, row0) as stats:
            lists.append(stats)
            yield stats

    monkeypatch.setattr(T, "split_routing", recording)
    jcfg, cfg, params, _ = _case("tiny-moe", "block")
    cfg = cfg.scaled(moe=replace(cfg.moe, group_size=48))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(4, S)).astype(np.int32)
    split = T.BatchSplit(4, 2, lambda v: v)
    got = _loss_and_grads(cfg, params, tokens[2:], split)
    want = _loss_and_grads(cfg.scaled(remat="none"), params, tokens[2:], split)
    n_moe = sum(cfg.layer_spec(i).ffn == "moe" for i in range(cfg.n_layers))
    assert n_moe > 0 and [len(s) for s in lists] == [n_moe, n_moe]
    assert torch.equal(got[0], want[0])
    for n, g in want[2].items():
        assert torch.equal(got[2][n], g), n
