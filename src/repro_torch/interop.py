"""Carry the JAX package's parameters into the port.

:func:`params_from_numpy` takes a parameter tree of the JAX package
(``repro.models.transformer.init_model``, ``pack_decode_params`` or
``packed_params_from_artifact``) with its arrays converted to numpy, and
builds the port's :class:`~repro_torch.models.transformer.Transformer`
computing the same function. The reference stacks each pattern slot's
leaves over repeats, ``(R, ...)``; layer ``r * period + s`` of the port
takes slice ``r`` of slot ``s``. Packed leaves become
:class:`~repro_torch.models.layers.PackedLinear` modules whose
:class:`~repro_torch.quant.spec.DatapathSpec` is rebuilt from ``spec_arr``
(the reference's static ``spec`` node is not an array and is ignored).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Attention,
    Embedding,
    Linear,
    Norm,
    PackedLinear,
)
from repro_torch.models.transformer import Block, Transformer
from repro_torch.quant.spec import DatapathSpec


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _site(leaf, r: int, device) -> torch.nn.Module:
    if isinstance(leaf, dict) and "packed" in leaf:
        if "meta" in leaf:
            raise NotImplementedError("2:4 sparse sites arrive with the 2:4 slice of the port")
        arrays = {k: to_tensor(np.asarray(v)[r], device)
                  for k, v in leaf.items() if k != "spec"}
        spec = DatapathSpec.from_array(arrays["spec_arr"].reshape(-1).cpu().numpy()).leaf_spec()
        return PackedLinear(
            packed=arrays["packed"], scale=arrays["scale"],
            col_sums=arrays.get("col_sums"), spec=spec, spec_arr=arrays["spec_arr"],
            act_scale=arrays.get("act_scale"), act_zp=arrays.get("act_zp"),
            bias=arrays.get("bias"))
    if isinstance(leaf, dict):  # high-precision site of a calibrated artifact
        bias = leaf.get("bias")
        return Linear(to_tensor(np.asarray(leaf["w"])[r], device),
                      None if bias is None else to_tensor(np.asarray(bias)[r], device))
    return Linear(to_tensor(np.asarray(leaf)[r], device))


def _norm(p: dict, r: int | None, device) -> Norm:
    def get(k):
        a = np.asarray(p[k])
        return to_tensor(a if r is None else a[r], device)

    return Norm(get("w"), get("b") if "b" in p else None)


def params_from_numpy(tree: dict, cfg: ModelConfig, *, device="cuda") -> Transformer:
    """The port's model for a JAX parameter tree of numpy arrays."""
    dev = resolve_device(device)
    emb = tree["embedding"]
    embedding = Embedding(to_tensor(emb["embed"], dev),
                          to_tensor(emb["head"], dev) if "head" in emb else None)
    layers = []
    for i in range(cfg.n_layers):
        r, s = divmod(i, cfg.period)
        slot = tree["layers"][s]
        block = Block(cfg.layer_spec(i), norm1=_norm(slot["norm1"], r, dev))
        if "mixer" in slot:
            block.mixer = Attention(**{n: _site(slot["mixer"][n], r, dev)
                                       for n in ("wq", "wk", "wv", "wo")})
        if "ffn" in slot:
            block.norm2 = _norm(slot["norm2"], r, dev)
            block.ffn = MLP(**{n: _site(v, r, dev) for n, v in slot["ffn"].items()})
        layers.append(block)
    return Transformer(cfg, embedding, layers, _norm(tree["final_norm"], None, dev))
