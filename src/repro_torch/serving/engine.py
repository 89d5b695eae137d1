"""Batched fixed-slot generation (port of ``repro/serving/engine.py``).

:meth:`GenerationEngine.generate` runs one prefill and then the decode
loop with every per-token decision on the device: sampling, EOS masking
and the token writes into a preallocated (B, max_new) matrix. The host
reads the finished matrix once at the end. Eager PyTorch has no
``while_loop``, so early exit when every row has hit EOS costs a scalar
host read: one per decode step when ``eos_id`` is set, none otherwise.
With packed sites and the ``kernel`` backend, every quantized matmul of
the loop launches the W4A8 CUDA kernel.

:meth:`GenerationEngine.generate_host_loop` is the per-token reference
loop (tokens collected in a Python list and stacked at the end).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import _PACKED_BACKENDS, use_packed_backend
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.quant.serve_packed import upgrade_packed_params
from repro_torch.quant.spec import validate_datapath


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    eos_id: int | None = None
    seed: int = 0


def _sample(logits, temperature: float, generator: torch.Generator):
    """Greedy argmax, or a categorical draw from softmax(logits / T)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class GenerationEngine:
    """Serves a :class:`~repro_torch.models.transformer.Transformer` (float
    or packed) on ``device``; the model is moved there. ``cfg``, when
    given, must be the model's. ``datapath`` is a requested
    :class:`~repro_torch.quant.spec.DatapathSpec` (or per-site map) every
    packed site must match. ``backend`` is the packed-matmul backend
    ("kernel", "reference" or "dequant")."""

    def __init__(self, model, cfg=None, sampler: SamplerConfig = SamplerConfig(),
                 datapath=None, *, device="cuda", backend: str = "kernel"):
        self.device = resolve_device(device)
        if backend not in _PACKED_BACKENDS:
            raise ValueError(f"packed backend {backend!r} not in {_PACKED_BACKENDS}")
        # legacy packed artifacts are upgraded once here (col_sums + spec)
        if cfg is not None and cfg != model.cfg:
            raise ValueError(f"config {cfg.name} does not describe the model ({model.cfg.name})")
        self.model = upgrade_packed_params(model.to(self.device))
        if datapath is not None:
            validate_datapath(self.model, datapath)
        self.sampler = sampler
        self.backend = backend

    def _prompts(self, prompts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """prompts: (B, S0) int. Returns (B, S0 + max_new_tokens) int32."""
        temperature, eos = self.sampler.temperature, self.sampler.eos_id
        p = self._prompts(prompts)
        B, S0 = p.shape
        gen = torch.Generator(device=self.device).manual_seed(self.sampler.seed)
        with use_packed_backend(self.backend):
            logits, caches = prefill(self.model, {"tokens": p}, S0 + max_new_tokens)
            nxt = _sample(logits[:, -1], temperature, gen)
            # unwritten tail positions (early exit) read as post-EOS padding
            toks = torch.full((B, max_new_tokens), 0 if eos is None else eos,
                              dtype=torch.int32, device=self.device)
            toks[:, 0] = nxt
            done = nxt == eos if eos is not None else None
            for t in range(1, max_new_tokens):
                if done is not None and bool(done.all()):  # the per-step host read
                    break
                logits, caches = decode_step(self.model, nxt[:, None], caches, S0 + t - 1)
                nxt = _sample(logits[:, -1], temperature, gen)
                if done is not None:
                    nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                    done = done | (nxt == eos)
                toks[:, t] = nxt
        return torch.cat([p, toks], dim=1).cpu().numpy()

    @torch.inference_mode()
    def generate_host_loop(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """Per-token loop, semantics-identical to :meth:`generate`."""
        temperature, eos = self.sampler.temperature, self.sampler.eos_id
        p = self._prompts(prompts)
        B, S0 = p.shape
        gen = torch.Generator(device=self.device).manual_seed(self.sampler.seed)
        with use_packed_backend(self.backend):
            logits, caches = prefill(self.model, {"tokens": p}, S0 + max_new_tokens)
            nxt = _sample(logits[:, -1], temperature, gen)
            done = (nxt == eos) if eos is not None else None
            out = [nxt]
            for t in range(1, max_new_tokens):
                if done is not None and bool(done.all()):
                    out.extend([torch.full_like(nxt, eos)] * (max_new_tokens - t))
                    break
                logits, caches = decode_step(self.model, nxt[:, None], caches, S0 + t - 1)
                nxt = _sample(logits[:, -1], temperature, gen)
                if done is not None:
                    nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                    done = done | (nxt == eos)
                out.append(nxt)
        return torch.cat([p, torch.stack(out, dim=1)], dim=1).cpu().numpy()
