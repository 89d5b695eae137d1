"""Port parity of the architecture registry: all ten architectures of the
reference (``repro.configs.ARCH_IDS``) against the port's.

Configs and smoke configs field by field, ``ARCH_IDS`` in the reference's
order, ``param_count``; on every smoke config the forward logits, the loss
and its gradients (``jax.value_and_grad`` against autograd) on the same
weights (carried with ``interop.params_from_numpy``) and the same batch
built with numpy, internvl2-76b with its ``pixel_embeds`` prefix; and the
reference's decode-against-forward check (``tests/test_models.py``) on the
port for dbrx-132b, internvl2-76b, stablelm-3b and musicgen-medium.
The recurrent smokes' forward and gradients (the slowest to run in JAX)
are in ``tests/test_torch_registry_recurrent.py``, the engines' streams
on the smokes in ``tests/test_torch_registry_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as JT
from repro.models.config import param_count as j_param_count
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.interop import params_from_numpy, reference_tree
from repro_torch.models import transformer as T
from repro_torch.models.config import param_count

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: forward, loss and gradient tolerance (f32 smokes)
ATOL = 1e-4
#: xlstm-350m's smoke (8 layers, 7 mLSTM) is ill-conditioned at its random
#: init: the reference's own f32 forward differs from its f64 forward by
#: 3.4e-4 in the logits and by 2.4e-2 in the gradients (of largest
#: magnitude 254), so f32 rounding alone moves it past 1e-4. It is held at
#: (logits atol, gradient tolerance per leaf): 1e-3 on the logits (its loss
#: at ATOL), and each leaf's gradient within a relative L2 error of 1.5e-3,
#: ||got - want|| <= 1.5e-3 ||want||. The reference's own f32 gradients
#: are up to 4.4e-4 from its f64 ones in that measure on a leaf, and the
#: port's up to 7.5e-4 from the reference's f32 ones.
ILL_CONDITIONED = {"xlstm-350m": (1e-3, 1.5e-3)}
#: held in tests/test_torch_registry_recurrent.py
RECURRENT = ("xlstm-350m", "jamba-1.5-large-398b")
B, S = 2, 16


def _batch(cfg, seed=0):
    """Tokens (and, for the vision stub, pixel_embeds) from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub" and cfg.frontend_tokens:
        batch["pixel_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def reference_case(arch) -> dict:
    """The reference's smoke weights as numpy, the batch, and its forward
    logits, loss, metrics and gradients."""
    jcfg = j_get_smoke(arch)
    params = JT.init_model(jax.random.key(0), jcfg)
    batch = _batch(jcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    logits, aux = JT.forward(params, jb, jcfg)
    (loss, metrics), grads = jax.value_and_grad(JT.loss_fn, has_aux=True)(params, jb, jcfg)
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "logits": np.asarray(logits), "aux": float(aux), "loss": float(loss),
            "ce": float(metrics["ce"]), "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def reference():
    """:func:`reference_case` per architecture, computed once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = reference_case(arch)
        return cache[arch]

    return get


def test_arch_ids_in_reference_order():
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_match_reference(arch):
    for port, ref in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        got, want = dataclasses.asdict(port(arch)), dataclasses.asdict(ref(arch))
        assert got == want, {k: (got[k], want[k]) for k in want if got[k] != want[k]}


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_param_count_matches_reference(arch):
    for port, ref in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        pc = param_count(port(arch))
        assert pc == j_param_count(ref(arch))
        assert 0 < pc["active"] <= pc["total"]


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_init_model_builds_the_reference_tree(arch):
    """The port's seeded init of every smoke config builds, and lays out as
    the reference's ``init_model`` tree: the same leaves (a LayerNorm's
    bias, the final norm's included), shapes and dtypes."""
    model = T.init_model(get_smoke(arch), device="cpu")
    got = jax.tree_util.tree_flatten_with_path(reference_tree(model, spec=True))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: JT.init_model(k, j_get_smoke(arch)), jax.random.key(0)))[0]
    assert [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got] == [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
                                 for k, v in want]


@pytest.mark.parametrize("arch", [a for a in J_ARCH_IDS if a not in RECURRENT])
def test_forward_loss_and_grads_match_reference(arch, reference):
    """The smoke config's forward logits (over the frontend prefix too),
    the masked loss and every parameter's gradient within 1e-4 of the
    reference's on the same weights and batch."""
    check_forward_and_grads(arch, reference(arch))


def check_forward_and_grads(arch, ref):
    """The port against :func:`reference_case`'s ``ref`` (xlstm-350m: see
    ILL_CONDITIONED)."""
    atol, grad_rtol = ILL_CONDITIONED.get(arch, (ATOL, None))
    cfg = get_smoke(arch)
    model = params_from_numpy(ref["params"], cfg, device="cpu").requires_grad_(True)
    batch = _tensors(ref["batch"])
    with torch.no_grad():
        logits, aux = T.forward(model, batch)
    p = T.frontend_prefix(cfg)
    assert logits.shape == (B, p + S, cfg.vocab_padded)
    np.testing.assert_allclose(logits[..., :cfg.vocab].numpy(), ref["logits"][..., :cfg.vocab],
                               atol=atol, rtol=0)
    assert float(aux) == pytest.approx(ref["aux"], abs=ATOL)
    total, metrics = T.loss_fn(model, batch)
    assert float(total.detach()) == pytest.approx(ref["loss"], abs=ATOL)
    assert float(metrics["ce"].detach()) == pytest.approx(ref["ce"], abs=ATOL)
    total.backward()
    grads = reference_tree(model, {n: q.grad for n, q in model.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    flat_got = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_got] == [
        jax.tree_util.keystr(k) for k, _ in flat_ref]
    for (path, want), (_, got) in zip(flat_ref, flat_got):
        if grad_rtol is None:
            np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))
        else:
            err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
            assert err <= grad_rtol, (jax.tree_util.keystr(path), err)
    assert any(np.abs(g).sum() > 0 for _, g in flat_ref)


def test_vision_stub_loss_masks_the_prefix(reference):
    """internvl2-76b: the loss reads the text positions only, so changing
    the prefix's logits' targets cannot change it, and pixel_embeds move
    the text logits through attention."""
    ref = reference("internvl2-76b")
    cfg = get_smoke("internvl2-76b")
    model = params_from_numpy(ref["params"], cfg, device="cpu")
    batch = _tensors(ref["batch"])
    p = cfg.frontend_tokens
    with torch.no_grad():
        logits, _ = T.forward(model, batch)
        total, _ = T.loss_fn(model, batch)
        text = logits[:, p:, :cfg.vocab].float()
        labels = batch["tokens"][:, 1:].long()
        nll = torch.logsumexp(text[:, :-1], -1) - torch.gather(text[:, :-1], -1,
                                                                 labels[..., None])[..., 0]
        assert float(total) == pytest.approx(float(nll.mean()), abs=1e-5)
        other = dict(batch, pixel_embeds=batch["pixel_embeds"] * 2.0)
        assert not torch.allclose(T.forward(model, other)[0][:, p:], logits[:, p:])


@pytest.mark.parametrize("arch", ["dbrx-132b", "internvl2-76b", "stablelm-3b",
                                  "musicgen-medium"])
def test_decode_matches_forward(arch, reference):
    """Prefill(S-1) + one decode step == the full forward at position S-1
    (after the vision prefix), atol/rtol 2e-3, as the reference's test; an
    MoE config with capacity 8 (no capacity drop between layouts)."""
    ref = reference(arch)
    cfg = get_smoke(arch)
    if cfg.moe is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = params_from_numpy(ref["params"], cfg, device="cpu")
    batch = _tensors(ref["batch"])
    p = T.frontend_prefix(cfg)
    with torch.no_grad():
        lf, _ = T.forward(model, batch)
        pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
        _, caches = T.prefill(model, pre, max_len=32 + p)
        ld, _ = T.decode_step(model, batch["tokens"][:, S - 1:S], caches, S - 1 + p)
    np.testing.assert_allclose(ld[:, 0].numpy(), lf[:, S - 1 + p].numpy(), atol=2e-3,
                               rtol=2e-3)
