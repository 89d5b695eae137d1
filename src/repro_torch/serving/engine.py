"""Batched fixed-slot generation (port of ``repro/serving/engine.py``).

:meth:`GenerationEngine.generate` runs one prefill and then the decode
loop as one captured program, as the reference runs prefill plus a
``lax.while_loop`` in one jitted program. Each (batch, max_len) bucket
owns static buffers: the KV caches (a recurrent layer's dense state in
their place), the current token, the device position, the done mask and
the (B, max_len) token matrix. The prefill writes the prompt's KV, and
each recurrent layer's end-of-prompt state, into the bucket's caches;
the decode step updates them in place. The
decode step (decode at the device position, sample, mask by ``done``,
write the token at the next column, advance) is captured once per bucket
as a CUDA graph (:class:`~repro_torch.serving.graphs.StepProgram`) and
replayed ``max_new - 1`` times. Without ``eos_id`` the host reads nothing
until the finished matrix, the one read of a generate; with it, the
all-done test runs on the device and the host reads its flag once every
:data:`EOS_CHECK_EVERY` steps, stopping when every row is done (steps run
past the last EOS write EOS where the matrix already holds it). On the CPU
the same static-buffer step runs eagerly. ``gen_traces`` counts the
buckets built, each captured once. An engine holds its
:data:`MAX_BUCKETS` most recently used buckets and frees the others' caches
and graphs, so callers whose shapes vary do not grow device memory without
bound (a bucket used again after it was freed is built and captured
again). With packed sites and the ``kernel``
backend, every quantized matmul of the loop launches the W4A8 CUDA kernel.

Sampling is a Gumbel-max draw whose noise is a counter hash of (seed, row,
column) (:func:`sample_rows`), so a captured step samples without a host
generator and a sampled stream is the same from call to call and engine to
engine. ``jax.random``'s streams are not reproduced.

:meth:`GenerationEngine.generate_host_loop` is the per-token eager
reference loop (tokens collected in a Python list and stacked at the end,
one scalar host read per step when ``eos_id`` is set).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import _PACKED_BACKENDS, use_packed_backend
from repro_torch.models.transformer import check_servable, decode_step, init_cache, prefill
from repro_torch.quant.serve_packed import upgrade_packed_params
from repro_torch.quant.spec import validate_datapath
from repro_torch.serving.graphs import StepProgram

_MASK32 = 0xFFFFFFFF
#: decode steps between two host reads of the all-done flag when
#: ``eos_id`` is set
EOS_CHECK_EVERY = 8
#: buckets an engine keeps, the most recently used
MAX_BUCKETS = 2


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    eos_id: int | None = None
    seed: int = 0


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mix on int64 tensors holding uint32 values; the
    multipliers stay below 2^31, so no product leaves int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x6C8E9CF5) & _MASK32
    return h ^ (h >> 16)


def _uniforms(seed: int, uids: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 uniforms in (0, 1), a function of (seed, uid, step,
    column) alone: a request's draws do not depend on its batch."""
    h = _fmix32(torch.full_like(uids, seed & _MASK32, dtype=torch.int64) ^ 0x3C6EF372)
    h = _fmix32(h ^ (uids.to(torch.int64) & _MASK32))
    h = _fmix32(h ^ (steps.to(torch.int64) & _MASK32))
    cols = torch.arange(n, dtype=torch.int64, device=uids.device)
    bits = _fmix32(h[:, None] ^ ((cols * 0x2545F491) & _MASK32)[None, :]) >> 8
    return ((bits.to(torch.float64) + 0.5) / 2.0**24).to(torch.float32)


def sample_rows(logits, temperature: float, seed: int, uids, steps) -> torch.Tensor:
    """Per-row sampling, request-deterministic: greedy argmax, or a
    Gumbel-max draw from softmax(logits / T) with the noise of
    :func:`_uniforms`. Returns (B,) int32 on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    gumbel = -torch.log(-torch.log(_uniforms(seed, uids, steps, logits.shape[-1])))
    return torch.argmax(logits.to(torch.float32) / temperature + gumbel, dim=-1).to(torch.int32)


class _Bucket:
    """One bucket's static buffers and its captured step. ``pos`` (0-d
    int32) is the position of the token ``nxt`` being fed, so the step
    writes its sample at column ``pos + 1`` of ``toks``; ``pos_host`` is
    the host's count of the same, which keeps a run inside ``toks``."""

    def __init__(self, cfg, batch: int, max_len: int, eos, device):
        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.caches = init_cache(cfg, batch, max_len, device=device)
        self.toks = zeros(batch, max_len)
        self.nxt = zeros(batch)
        self.pos = zeros()
        self.rows = torch.arange(batch, dtype=torch.int32, device=device)
        self.done = None if eos is None else zeros(batch, dtype=torch.bool)
        self.pos_host = 0
        self.program = None


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
        check_servable(model)
        self.model = upgrade_packed_params(model.to(self.device))
        if datapath is not None:
            validate_datapath(self.model, datapath)
        self.sampler = sampler
        self.backend = backend
        #: buckets built (each captured once on CUDA): repeated same-shape
        #: calls keep this at 1, as the reference's trace count
        self.gen_traces = 0
        self._buckets: OrderedDict[tuple[int, int], _Bucket] = OrderedDict()

    def _prompts(self, prompts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(self.device)

    def _sample(self, logits, rows, cols) -> torch.Tensor:
        s = self.sampler
        return sample_rows(logits, s.temperature, s.seed, rows, cols)

    def _bucket(self, batch: int, max_len: int) -> _Bucket:
        key = (batch, max_len)
        b = self._buckets.get(key)
        if b is not None:
            self._buckets.move_to_end(key)
            return b
        while len(self._buckets) >= MAX_BUCKETS:
            self._buckets.popitem(last=False)[1].program.close()
        self.gen_traces += 1
        b = self._buckets[key] = _Bucket(self.model.cfg, batch, max_len,
                                         self.sampler.eos_id, self.device)
        b.program = StepProgram(self._step_fn(b), self.device)
        return b

    def _step_fn(self, b: _Bucket):
        """The bucket's decode step, on its static buffers alone."""
        model, samp = self.model, self.sampler
        eos = samp.eos_id

        def step():
            logits, _ = decode_step(model, b.nxt[:, None], b.caches, b.pos)
            col = b.pos + 1
            new = sample_rows(logits[:, -1], samp.temperature, samp.seed, b.rows,
                              col.expand_as(b.rows))
            if eos is not None:
                new = new.masked_fill(b.done, eos)
                b.done.logical_or_(new == eos)
            b.nxt.copy_(new)
            b.toks.index_copy_(1, col.reshape(1).long(), new[:, None])
            b.pos.add_(1)

        return step

    def _start(self, b: _Bucket, p: torch.Tensor) -> None:
        """Prefill ``p`` into the bucket's caches and sample the first token
        (column S0); stale KV past the prompt stays masked in decode."""
        eos = self.sampler.eos_id
        s0 = p.shape[1]
        logits, _ = prefill(self.model, {"tokens": p}, b.toks.shape[1], caches=b.caches)
        # unwritten tail positions (early exit) read as post-EOS padding
        b.toks.fill_(0 if eos is None else eos)
        b.toks[:, :s0] = p
        b.pos.fill_(s0)
        first = self._sample(logits[:, -1], b.rows, b.pos.expand_as(b.rows))
        b.nxt.copy_(first)
        b.toks[:, s0] = first
        if eos is not None:
            torch.eq(first, eos, out=b.done)
        b.pos_host = s0

    def _decode(self, b: _Bucket, n: int) -> None:
        """``n`` decode steps, replays of the bucket's captured step (the
        step itself on the CPU). Without ``eos_id`` nothing is read to the
        host; with it, the all-done flag once every EOS_CHECK_EVERY steps."""
        if b.pos_host + n >= b.toks.shape[1]:
            raise ValueError(f"{n} decode steps from position {b.pos_host} overrun the "
                             f"bucket's {b.toks.shape[1]} columns")
        eos = self.sampler.eos_id
        while n > 0:
            k = n if eos is None else min(EOS_CHECK_EVERY, n)
            b.program.run(k)
            b.pos_host += k
            n -= k
            if eos is not None and n > 0 and bool(b.done.all()):
                break

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """prompts: (B, S0) int. Returns (B, S0 + max_new_tokens) int32."""
        p = self._prompts(prompts)
        B, S0 = p.shape
        b = self._bucket(B, S0 + max_new_tokens)
        with use_packed_backend(self.backend):
            self._start(b, p)
            self._decode(b, max_new_tokens - 1)
        # the one host read of the token matrix, a copy: the bucket's
        # matrix is overwritten by its next generate
        return b.toks.to("cpu", copy=True).numpy()

    @torch.inference_mode()
    def generate_host_loop(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """Per-token eager loop, semantics-identical to :meth:`generate`."""
        eos = self.sampler.eos_id
        p = self._prompts(prompts)
        B, S0 = p.shape
        rows = torch.arange(B, dtype=torch.int32, device=self.device)
        with use_packed_backend(self.backend):
            logits, caches = prefill(self.model, {"tokens": p}, S0 + max_new_tokens)
            nxt = self._sample(logits[:, -1], rows, torch.full_like(rows, S0))
            done = (nxt == eos) if eos is not None else None
            out = [nxt]
            for t in range(1, max_new_tokens):
                if done is not None and bool(done.all()):
                    out.extend([torch.full_like(nxt, eos)] * (max_new_tokens - t))
                    break
                logits, caches = decode_step(self.model, nxt[:, None], caches, S0 + t - 1)
                nxt = self._sample(logits[:, -1], rows, torch.full_like(rows, S0 + t))
                if done is not None:
                    nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                    done = done | (nxt == eos)
                out.append(nxt)
        return torch.cat([p, torch.stack(out, dim=1)], dim=1).cpu().numpy()
