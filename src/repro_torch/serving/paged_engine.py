"""Continuous-batching generation engine over a paged KV cache (port of
``repro/serving/paged_engine.py``).

Where :class:`~repro_torch.serving.engine.GenerationEngine` is fixed-slot,
this engine runs an open system: requests queue in a host-side
:class:`~repro_torch.serving.scheduler.Scheduler`, are admitted into
whichever engine slot is free, decode together whatever their phase, and
free their KV pages the moment they finish. The cache
(:func:`~repro_torch.models.transformer.init_paged_cache`) holds one page
pool per attention layer, and one lane a slot of each recurrent layer's
dense state (Mamba, mLSTM, sLSTM).

Programs, each a method that updates the cache tensors in place (where the
reference's jitted programs take the cache donated and return a new one):

* **admit**: install the slot's block-table row, prefill the prompt (B=1),
  scatter its KV into the fresh pages (quantize-on-scatter for int8 pools),
  copy each recurrent layer's end-of-prompt state into the slot's lane, in
  place, and sample the first token (one host read per admission);
* **suffix admit** (prefix cache): the row starts with cached prefix pages;
  only the uncached suffix prefills, attending over the prefix KV gathered
  (and dequantized) from the shared pages;
* **cached admit** (prefix cache, fully cached prompt): no prefill and no
  model at all; the last cached page is copied into a private page
  (copy-on-write, codes and scales) and the first token is deferred to the
  next decode chunk, which samples it with the same stream;
* **decode chunk**: ``k`` decode steps, every live slot at its own length,
  sampling on the device into a static (slots, chunk_max) token buffer at
  a device column, which the host reads once per chunk. The step is
  captured once per engine as a CUDA graph
  (:class:`~repro_torch.serving.graphs.StepProgram`) and replayed ``k``
  times: one capture serves every ``k``, as the reference's dynamic trip
  count serves every chunk length with one trace (``chunk_traces``). On
  the CPU the same step runs eagerly; ``_chunk(k, eager=True)`` runs it
  eagerly on the card too (the reference loop, kept for timing);
* **release**: clear the slot's active bit (a release with no slot, the
  prefix cache's evictions, only copies the allocator).

Any non-default :class:`SchedulerPolicy` runs the reference's throughput
loop (:meth:`PagedEngine._serve_throughput`) and its programs, eager as
the admits:

* **batched admit**: co-admit ``n`` cold prompts in one padded
  ``(n, P * block_size)`` prefill, ``P`` the longest prompt in pages; K/V
  past each row's prompt is zeroed before the page scatter (pad tokens
  are id 0, whose K/V would raise an int8 page's scale), and each row
  samples its first token at its own last prompt position (one host read
  for the group);
* **stub admit**: claim a slot and its page row for a chunked prefill,
  no model, the slot inactive;
* **prefill chunk**: one page-aligned chunk of a stub's prompt against the
  KV of its earlier pages (gathered, dequantized for int8 pools); the
  final chunk samples the first token and makes the slot live;
* **grow**: rewrite a decoding slot's block-table row with the pages
  watermark growth added.

The page allocator lives on the host (:class:`PoolState`, in lockstep with
the scheduler and the prefix cache, which hand physical pages around); the
programs take their pages from it and copy its free stack, top and
refcounts into the cache's ``free_list``/``free_top``/``page_refcounts``
leaves, so the device mirrors the host as in the reference.

Sampling is per-request deterministic: a row's step-t draw is a Gumbel-max
over a counter hash of (seed, uid, t), so co-batching cannot change a
sampled stream. Greedy decode takes the argmax, as the fixed-slot engine.

Static KV page scales from a mixed-precision plan (``kv_scales``: a
plan's ``kv`` section, or its tensors from
:func:`~repro_torch.quant.observe.plan_kv_scales`) make an int8 engine
quantize against calibrated constants: every install scatter (cold,
suffix and batched admits, prefill chunks) through
:func:`~repro_torch.kernels.paged_attention.quantize_kv_pages_static`,
with no per-page max reduction, and every decode append through
:func:`~repro_torch.models.layers._append_kv_page_static`, with no
requantize-on-append. The scales are device tensors made once, before the
decode step is captured, and never rebound, so the captured step reads
them at fixed addresses.

``observe=True`` attaches the serving observer
(:class:`~repro_torch.quant.observe.SaturationCounters`) around both
loops: the decode step's taps count each packed site's static-quantizer
clips and code extrema into a device counter block, allocated here,
before the step is captured, and never rebound, so the taps live inside
the captured graph and a chunk keeps its one host read. The block is
folded into the host counters once at the end of each :meth:`serve` and
in :meth:`saturation_report`; counts accumulate across serves until the
observer's ``reset()``. :meth:`assert_observation_transparent` holds the
observer off the plain step, structurally.

``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`, one process a rank)
serves tensor-parallel over ``torch.distributed``, the multi-controller
design of the reference's ``docs/multihost.md``: every rank runs the same
host scheduler, allocator and prefix cache on the same requests, and holds
its slice of the model and the cache, placed by
:func:`~repro_torch.runtime.sharding.paged_engine_shardings` under
``shard_rules`` (default ``SERVING_QUANT_RULES``): pools shard kv heads
over ``model``, admin leaves are whole on every rank, and the logits are
gathered before sampling, so every rank samples the same tokens and a chunk
still makes one host read of replicated tokens. Batched-admit prompt rows
are placed by ``rows_sharding`` and gathered. Under NCCL the decode step is
captured with its collectives inside; under gloo (CPU ranks, or ranks
sharing one card) it steps eagerly (``step_mode``). As in the reference a
mesh refuses the paged attention kernels (``attn_impl`` resolving to
them), ``observe=True`` and ``arrivals=`` with more than one process.

MoE patterns serve with their expert stacks placed as the specs say:
expert-parallel where the ``expert`` axis shards E (a rank runs its
experts and gathers their outputs before the combine), tensor-parallel
inside the experts otherwise (:func:`~repro_torch.models.moe.moe`).
Recurrent patterns (Mamba, mLSTM, sLSTM) hold their dense slot lanes as
``cache_shardings`` specifies: the slot axis over ``batch`` = (``pod``,
``data``) where the slot count divides it, the channels or heads over
the rest. The slot axis stays whole in the computation: every rank's
mixers step every slot (the matmul sites take all of a step's rows, and
their weights are sharded over the same axes as the slots), on the
channels or heads of the rank's parameters. A decode step moves each
state from its lanes into that compute layout and back, in place
(:meth:`~repro_torch.runtime.sharding.MixerShard.lanes_in` /
``lanes_out``: views where the layouts agree, as on a (1, tp) mesh,
gathers over ``data`` where the slots are sharded: each step then moves
every slot's whole state, and the slot sharding saves storage between
steps but not the step's peak), and an admit writes
a prompt's end state, relaid to the lanes' channels, into the slot's lane
on the ranks that hold it (:meth:`PagedEngine._install_states`).
``state_bytes`` is the recurrent state a rank holds, beside
``state_bytes_one_device``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.paged_attention import (
    check_bounds,
    quantize_kv_pages,
    quantize_kv_pages_static,
)
from repro_torch.models.layers import (
    _PACKED_BACKENDS,
    attach_observer,
    resolve_paged_attn_impl,
    use_packed_backend,
)
from repro_torch.models.transformer import (
    check_servable,
    decode_step_paged,
    init_paged_cache,
    is_kv_pool,
    prefill,
    recurrent_state_shapes,
)
from repro_torch.quant.observe.saturation import SaturationCounters, observed_labels
from repro_torch.quant.serve_packed import upgrade_packed_params
from repro_torch.quant.spec import (
    AttnDatapathSpec,
    tree_datapath_fingerprint,
    validate_attn_datapath,
    validate_datapath,
)
from repro_torch.runtime import sharding as shardlib
from repro_torch.runtime.collectives import all_reduce_sum, gather_dim, relayout
from repro_torch.serving.engine import SamplerConfig, _uniforms, sample_rows
from repro_torch.serving.graphs import ProgramText, StepProgram, count_kernels, record_step
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import PoolState, Request, Scheduler, SchedulerPolicy


@dataclass(frozen=True)
class PagedConfig:
    """Paged-cache and continuous-batching knobs, as in the reference.

    ``num_blocks`` sizes the KV pool, ``block_size`` is the page size,
    ``max_pages_per_seq`` caps a block-table row (default
    ``ceil(max_seq_len / block_size)``), ``chunk_max`` bounds the decode
    steps per host read. ``kv_dtype="int8"`` stores quantized pages
    (attention runs kernel B3); ``"act"`` keeps ``cfg.act_dtype`` pages
    (kernel B2). ``attn_impl`` is ``auto``, ``reference`` or ``kernel``
    (:func:`~repro_torch.models.layers.resolve_paged_attn_impl`).
    ``prefix_cache`` shares full prompt blocks across requests.
    ``sched`` is the admission policy: the default runs the FIFO loop, any
    other the throughput loop (windowed and batched admission, chunked
    prefill, watermark growth and preemption)."""

    block_size: int = 64
    num_blocks: int = 256
    max_concurrency: int = 8
    max_pages_per_seq: int | None = None
    chunk_max: int = 32
    attn_impl: str = "auto"
    kv_dtype: str = "act"
    prefix_cache: bool = False
    sched: SchedulerPolicy = SchedulerPolicy()


def _check_policy(cfg, paged: PagedConfig) -> None:
    """The reference's policy gates: the prefix cache and batched or
    chunked admission need an attention-only, MoE-free pattern (recurrent
    mixers keep dense per-slot state and step it through pad tokens, and
    co-batched rows compete for expert capacity); chunks scatter whole
    pages; the high watermark must be reachable."""
    recurrent = sorted({s.mixer for s in cfg.pattern if s.mixer not in ("attn", "none")})
    if paged.prefix_cache and recurrent:
        raise ValueError(f"prefix_cache=True needs an attention-only pattern: {recurrent} "
                         f"mixers keep dense per-slot state that is not paged and cannot be "
                         f"shared across requests")
    pol = paged.sched
    if pol.batch_max > 1 or pol.prefill_chunk is not None:
        has_moe = any(s.ffn == "moe" for s in cfg.pattern)
        if recurrent or has_moe:
            what = "batched admission" if pol.batch_max > 1 else "chunked prefill"
            raise ValueError(
                f"{what} needs an attention-only, MoE-free pattern (recurrent mixers "
                f"{recurrent or 'none'}, moe ffn {has_moe}): padded multi-row / chunked "
                f"prefill would change routing or stepwise state and break greedy "
                f"bit-identity with the FIFO engine")
    if pol.prefill_chunk is not None and pol.prefill_chunk % paged.block_size != 0:
        raise ValueError(f"prefill_chunk {pol.prefill_chunk} must be a multiple of block_size "
                         f"{paged.block_size} (chunks scatter whole pages)")
    if pol.watermark is not None and pol.watermark[1] > paged.num_blocks:
        raise ValueError(f"watermark high {pol.watermark[1]} > num_blocks {paged.num_blocks} "
                         f"— admission could never resume")


class PagedEngine:
    """Serves a :class:`~repro_torch.models.transformer.Transformer` (float
    or packed) through the paged cache on ``device`` (default ``"cuda"``).
    ``datapath``/``attn_datapath`` are requests validated against the packed
    sites and against the pool's :class:`AttnDatapathSpec` (a float-KV pool
    has none, so any attention request raises). ``backend`` is the packed
    matmul backend. ``assert_bounds`` (int8 pools) accumulates the B3
    register watermarks on the device and checks them against P_qk and
    P_pv after every :meth:`serve` (one host read). ``kv_scales`` holds
    calibrated static KV page scales (a plan's ``kv`` section, or
    ``{slot: {"k": (R, nkv), "v": (R, nkv)}}``); they need an int8 pool and
    name attention slots only. ``observe`` attaches the serving saturation
    counters (:meth:`saturation_report`). ``mesh``/``shard_rules`` serve
    tensor-parallel (module docstring); ``device`` is then the rank's."""

    def __init__(self, model, cfg=None, paged: PagedConfig = PagedConfig(),
                 sampler: SamplerConfig = SamplerConfig(), datapath=None,
                 attn_datapath=None, *, device="cuda", backend: str = "kernel",
                 assert_bounds: bool = False, observe: bool = False, kv_scales=None,
                 mesh=None, shard_rules=None):
        if backend not in _PACKED_BACKENDS:
            raise ValueError(f"packed backend {backend!r} not in {_PACKED_BACKENDS}")
        if paged.kv_dtype not in ("act", "int8"):
            raise ValueError(f"kv_dtype {paged.kv_dtype!r} not in ('act', 'int8')")
        if cfg is not None and cfg != model.cfg:
            raise ValueError(f"config {cfg.name} does not describe the model ({model.cfg.name})")
        check_servable(model)
        self.device = resolve_device(device)
        if mesh is not None:
            _check_mesh(paged, self.device, observe)
        resolve_paged_attn_impl(paged.attn_impl, self.device)
        self.model = upgrade_packed_params(model.to(self.device))
        self.cfg = cfg = self.model.cfg
        if datapath is not None:
            validate_datapath(self.model, datapath)
        self.datapath_fingerprint = tree_datapath_fingerprint(self.model)
        #: pattern-aligned static KV page scales (attention slots {"k", "v"}
        #: (R, nkv) f32 on the device, others {}), or None: dynamic scales
        self._kv_scales_seq = self._static_kv_scales(kv_scales, cfg, paged.kv_dtype)
        #: the serving observer, its device block made here, before any
        #: capture, one row per label the decode step can report; None
        #: (the default) leaves the step tap-free
        self.observer = None
        if observe:
            self.observer = SaturationCounters()
            self.observer.allocate(observed_labels(self.model), self.device)
            self.datapath_fingerprint += "+obs"
        if self._kv_scales_seq is not None:
            self.datapath_fingerprint += "+kv-static"
        self.sampler = sampler
        self.backend = backend
        max_pages = paged.max_pages_per_seq or -(-cfg.max_seq_len // paged.block_size)
        self.paged = paged = PagedConfig(
            block_size=paged.block_size, num_blocks=paged.num_blocks,
            max_concurrency=paged.max_concurrency, max_pages_per_seq=max_pages,
            chunk_max=paged.chunk_max, attn_impl=paged.attn_impl,
            kv_dtype=paged.kv_dtype, prefix_cache=paged.prefix_cache, sched=paged.sched)
        _check_policy(cfg, paged)
        self.prefix_cache = (PrefixCache(paged.num_blocks, paged.block_size)
                             if paged.prefix_cache else None)
        #: the host page allocator; persists across serve() calls (cached
        #: pages stay out of the free stack)
        self.pool_state = PoolState.fresh(paged.num_blocks)
        #: the attention accumulator record the int8 kernel serves (None
        #: for float KV)
        self.attn_spec = (AttnDatapathSpec.for_cache(cfg.head_dim, paged.block_size)
                          if paged.kv_dtype == "int8" else None)
        if attn_datapath is not None:
            validate_attn_datapath(self.attn_spec, attn_datapath)
        self.assert_bounds = assert_bounds and self.attn_spec is not None
        #: B3's (|QK^T|, |PV|) watermarks since construction
        self.watermarks = (torch.zeros(2, dtype=torch.int32, device=self.device)
                           if self.assert_bounds else None)
        #: the mesh, the (param, cache) specs the engine placed its model and
        #: cache by, and how its decode step runs: "captured" (a CUDA graph,
        #: NCCL's collectives inside), "eager" (the CPU) or "eager (gloo)"
        self.mesh = mesh
        self.shardings = None
        self.step_mode = "captured" if self.device.type == "cuda" else "eager"
        if mesh is not None:
            self._place(mesh, shard_rules)
        self.cache = self._new_cache()
        #: program runs since construction
        self.admits = self.suffix_admits = self.cached_admits = 0
        self.chunks = self.releases = self.decode_steps = 0
        self.batch_admits = self.stub_admits = self.prefill_chunks = self.grows = 0
        #: requests preempted (released and requeued) since construction
        self.preemptions = 0
        self._uid_gen = 0
        #: the decode step's static token buffer and its device column; the
        #: step reads and writes the cache leaves in place, and nothing
        #: rebinds a leaf, so the captured step always sees the live cache
        self._buf = torch.zeros((paged.max_concurrency, paged.chunk_max), dtype=torch.int32,
                                device=self.device)
        self._col = torch.zeros((), dtype=torch.int64, device=self.device)
        #: decode-step captures (step builds on the CPU): one per engine
        self.chunk_traces = 0
        self._program = None

    def _new_cache(self, device=None) -> dict:
        """A zeroed paged cache of this engine's shapes on its device (under
        a mesh, this rank's slice of it)."""
        paged = self.paged
        cache = init_paged_cache(
            self.cfg, paged.max_concurrency, paged.num_blocks, paged.block_size,
            paged.max_pages_per_seq, kv_dtype="int8" if paged.kv_dtype == "int8" else None,
            device=device or self.device)
        if self.mesh is not None and device is None:
            cache = shardlib.host_to_global(cache, self.shardings[1], self.mesh)
        return cache

    def _place(self, mesh, rules) -> None:
        """Place the model by the engine's shardings (every rank holds the
        same full model; each keeps its slice), slice the static KV scales
        to the rank's kv heads and warm the communicator."""
        self.shardings = shardlib.paged_engine_shardings(
            self.model, self._new_cache("meta"), self.cfg, mesh, rules)
        pools = [sp for sp in self.shardings[1]["pools"] if "k_pages" in sp]
        kv_axes = shardlib.spec_axes(pools[0]["k_pages"][2]) if pools else ()
        self.model = shardlib.shard_model(self.model, mesh, rules, kv_axes=kv_axes)
        if self._kv_scales_seq is not None:
            lo, n = mesh.index(kv_axes), self.cfg.n_kv_heads // mesh.axes_size(kv_axes)
            self._kv_scales_seq = tuple(
                {side: t[:, lo * n:(lo + 1) * n].contiguous() for side, t in sec.items()}
                for sec in self._kv_scales_seq)
        for block, specs in zip(self.model.layers, self.shardings[1]["pools"]):
            sh = getattr(block.mixer, "_shard", None)
            if isinstance(sh, shardlib.MixerShard):  # where the slot lanes are held
                block.mixer._shard = replace(sh, store=specs)
        if self.device.type == "cuda" and not mesh.captures_collectives:
            self.step_mode = "eager (gloo)"
        # the first collective sets the communicator up, before any capture
        all_reduce_sum(torch.zeros(1, device=self.device), mesh, mesh.axis_names)

    def _static_kv_scales(self, kv_scales, cfg, kv_dtype: str):
        """The engine's static KV scales, one entry per pattern slot, as f32
        tensors on its device, made once here; None without ``kv_scales``."""
        from repro_torch.quant.observe.kv import plan_kv_scales

        if kv_scales is not None and "slots" in kv_scales:
            kv_scales = plan_kv_scales(kv_scales, device=self.device)
        if not kv_scales:
            return None
        if kv_dtype != "int8":
            raise ValueError("static kv_scales need kv_dtype='int8' (float pools carry no "
                             "scale leaves)")
        shape = (cfg.repeats, cfg.n_kv_heads)
        for slot, sec in kv_scales.items():
            if not (0 <= slot < len(cfg.pattern) and cfg.pattern[slot].mixer == "attn"):
                raise ValueError(f"kv_scales names slot {slot}, which is not an attention "
                                 f"slot of the {len(cfg.pattern)}-slot pattern")
            for side in ("k", "v"):
                if tuple(sec[side].shape) != shape:
                    raise ValueError(f"kv_scales slot {slot} {side}: shape "
                                     f"{tuple(sec[side].shape)}, expected {shape}")
        return tuple(
            {side: torch.as_tensor(kv_scales[i][side], dtype=torch.float32)
             .to(self.device).contiguous() for side in ("k", "v")}
            if i in kv_scales else {}
            for i in range(len(cfg.pattern)))

    # ------------------------------------------------------------------
    # Programs
    # ------------------------------------------------------------------
    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _sync_allocator(self) -> None:
        """Copy the host allocator into the cache's mirror leaves."""
        pool, cache = self.pool_state, self.cache
        cache["free_list"].copy_(self._dev(pool.free_list))
        cache["free_top"].fill_(pool.free_top)
        cache["page_refcounts"].copy_(self._dev(pool.page_rc))

    def _set_row(self, slot: int, row) -> None:
        """Write a slot's block-table row in place, sentinel-padded."""
        table = np.full(self.paged.max_pages_per_seq, self.paged.num_blocks, np.int32)
        table[:len(row)] = row
        self.cache["block_table"][slot] = self._dev(table)

    def _install(self, slot: int, row, *, s0: int, uid: int, steps: int, last_tok,
                 active: bool = True) -> None:
        """Install a slot's block-table row and its per-slot leaves."""
        cache = self.cache
        self._set_row(slot, row)
        cache["seq_lens"][slot] = s0
        cache["active"][slot] = active
        cache["uids"][slot] = uid
        cache["steps"][slot] = steps
        cache["last_tok"][slot] = last_tok
        self._sync_allocator()

    def _gather_prefix_kv(self, pages) -> list:
        """The KV held in ``pages``, dequantized for int8 pools (codes times
        the page's scale), as per-layer (1, L, nkv, hd) prefix tensors."""
        idx = self._dev(pages, torch.long)
        out = []
        for pool in self.cache["pools"]:
            if not is_kv_pool(pool):
                out.append({})
                continue
            kv = {}
            for name in ("k", "v"):
                g = pool[f"{name}_pages"][idx]  # (n, bs, nkv, hd)
                if "k_scales" in pool:
                    g = g.to(torch.float32) * pool[f"{name}_scales"][idx][:, None, :, None]
                kv[name] = g.reshape(1, -1, *g.shape[2:])
            out.append(kv)
        return out

    def _scatter_dense_pages(self, dense, pages, keep=None) -> None:
        """Scatter a prefill's dense KV, its rows cut into pages in row
        order, into ``pages``: every page of a B=1 prefill, or those that
        ``keep`` indexes (a batched prefill's rows hold different page
        counts). Int8 pools quantize on scatter, codes and per-(page, head)
        scales together; padded tail positions are zeros and cannot raise
        a page's max. With static KV scales the codes quantize against the
        layer's calibrated row and the scales are its stamp (no per-page
        max reduction)."""
        idx = self._dev(pages, torch.long)
        sel = None if keep is None else self._dev(keep, torch.long)
        bs, period = self.paged.block_size, self.cfg.period
        for i, (pool, d) in enumerate(zip(self.cache["pools"], dense)):
            if not is_kv_pool(pool):
                continue
            r, s = divmod(i, period)
            static = self._kv_scales_seq[s] if self._kv_scales_seq else None
            for name in ("k", "v"):
                x = d[name].reshape(-1, bs, *d[name].shape[2:])
                if sel is not None:
                    x = x[sel]
                if static:
                    codes, scales = quantize_kv_pages_static(x, static[name][r][None, :])
                    pool[f"{name}_pages"][idx] = codes
                    pool[f"{name}_scales"][idx] = scales
                elif "k_scales" in pool:
                    codes, scales = quantize_kv_pages(x)
                    pool[f"{name}_pages"][idx] = codes
                    pool[f"{name}_scales"][idx] = scales
                else:
                    pool[f"{name}_pages"][idx] = x.to(pool[f"{name}_pages"].dtype)

    def _install_states(self, slot: int, dense) -> None:
        """Copy a B=1 prefill's recurrent end states into ``slot``'s lane of
        each recurrent layer, in place (the reference splices them into the
        (R, num_slots, ...) batch); attention layers are skipped. Under a
        mesh the state, in its compute layout, is relaid to the lanes'
        channels (every rank: the relayout may gather) and written by the
        ranks that hold the slot's lane."""
        for block, pool, d in zip(self.model.layers, self.cache["pools"], dense):
            if is_kv_pool(pool):
                continue
            sh = getattr(block.mixer, "_shard", None)
            for name, lane in pool.items():
                if sh is None:
                    lane[slot].copy_(d[name][0])
                    continue
                state = sh.to_store(name, d[name])
                lo, hi = sh.slots(name, self.paged.max_concurrency)
                if lo <= slot < hi:
                    lane[slot - lo].copy_(state[0])

    @property
    def state_bytes(self) -> int:
        """The bytes of the recurrent slot lanes this engine (under a mesh,
        this rank) holds."""
        return sum(t.numel() * t.element_size() for pool in self.cache["pools"]
                   if not is_kv_pool(pool) for t in pool.values())

    @property
    def state_bytes_one_device(self) -> int:
        """The bytes of the same lanes on one device."""
        return sum(math.prod(shape) * dt.itemsize
                   for i in range(self.cfg.n_layers)
                   for shape, dt in recurrent_state_shapes(
                       self.cfg.layer_spec(i), self.cfg, self.paged.max_concurrency).values())

    def _first_token(self, logits, uid: int) -> torch.Tensor:
        return sample_rows(logits[:, -1], self.sampler.temperature, self.sampler.seed,
                           self._dev([uid]), self._dev([0]))[0]

    def _admit(self, adm) -> int:
        """Cold admit: prefill the whole prompt into fresh pages."""
        self.admits += 1
        req, bs = adm.req, self.paged.block_size
        n_prompt_pages = -(-req.prompt.size // bs)
        logits, dense = prefill(self.model, {"tokens": self._dev(req.prompt[None])},
                                n_prompt_pages * bs)
        self._scatter_dense_pages(dense, adm.row[:n_prompt_pages])
        self._install_states(adm.slot, dense)
        tok0 = self._first_token(logits, req.uid)
        self._install(adm.slot, adm.row, s0=req.prompt.size, uid=req.uid, steps=1,
                      last_tok=tok0)
        return int(tok0)

    def _admit_suffix(self, adm) -> int:
        """Shared-prefix admit: the row's first ``n_shared`` pages are cached
        prefix blocks; only the suffix prefills, against their KV."""
        self.suffix_admits += 1
        req, bs = adm.req, self.paged.block_size
        prefix_len = adm.n_shared * bs
        suffix = req.prompt[prefix_len:]
        n_suffix_pages = -(-suffix.size // bs)
        logits, dense = prefill(self.model, {"tokens": self._dev(suffix[None])},
                                n_suffix_pages * bs,
                                prefix_kv=self._gather_prefix_kv(adm.shared_pages),
                                pos_offset=prefix_len)
        self._scatter_dense_pages(dense, adm.row[adm.n_shared:adm.n_shared + n_suffix_pages])
        tok0 = self._first_token(logits, req.uid)
        self._install(adm.slot, adm.row, s0=req.prompt.size, uid=req.uid, steps=1,
                      last_tok=tok0)
        return int(tok0)

    def _admit_cached(self, adm) -> None:
        """Fully cached admit: no prefill and no model. The last cached page
        (``cow_src``) is copied, codes and scales, into the first fresh page
        (decode appends rewrite position s0 - 1 and may grow the page scale,
        which must never touch a shared page). The first token is deferred:
        ``seq_lens = s0 - 1``, ``steps = 0`` and ``last_tok = prompt[-1]``
        hand the last prompt token to the next decode chunk."""
        self.cached_admits += 1
        dest = int(adm.row[adm.n_shared])
        for pool in self.cache["pools"]:  # attention only: the gate refuses recurrent ones
            for leaf in pool.values():
                leaf[dest] = leaf[adm.cow_src]
        req = adm.req
        self._install(adm.slot, adm.row, s0=req.prompt.size - 1, uid=req.uid, steps=0,
                      last_tok=int(req.prompt[-1]))

    def _admit_batch(self, group) -> np.ndarray:
        """Co-admit ``n`` cold requests in one padded (n, P * bs) prefill,
        P the group's longest prompt in pages. K/V at each row's positions
        ``>= S0`` is zeroed before the scatter, so every page, codes and
        int8 scales, is the one a B=1 admit writes; each row samples its
        first token at its own last prompt position with (uid, 0). Returns
        the group's first tokens (one host read)."""
        self.batch_admits += 1
        bs, n = self.paged.block_size, len(group)
        s0s = np.asarray([a.req.prompt.size for a in group], np.int64)
        n_pages = -(-s0s // bs)
        P = int(n_pages.max())
        tokens = np.zeros((n, P * bs), np.int32)
        for j, a in enumerate(group):
            tokens[j, :s0s[j]] = a.req.prompt
        tokens = self._dev(tokens)
        if self.mesh is not None:
            # the prompt block placed by rows over the data axis (where the
            # group size divides it), then gathered for the replicated stream
            rows = shardlib.spec_axes(shardlib.rows_sharding(tokens.shape, self.mesh)[0])
            tokens = shardlib.local_slice(tokens, (rows or None, None), self.mesh)
            tokens = relayout(tokens.contiguous(), 0, rows, (), self.mesh)
        logits, dense = prefill(self.model, {"tokens": tokens}, P * bs)
        s0_dev = self._dev(s0s, torch.long)
        pos = torch.arange(P * bs, device=self.device)
        pad = (pos[None, :] >= s0_dev[:, None])[..., None, None]  # (n, L, 1, 1)
        for d in dense:
            for x in d.values():
                x.masked_fill_(pad, 0)
        keep = [j * P + i for j in range(n) for i in range(n_pages[j])]
        pages = np.concatenate([a.row[:n_pages[j]] for j, a in enumerate(group)])
        self._scatter_dense_pages(dense, pages, keep)
        last = logits[torch.arange(n, device=self.device), s0_dev - 1]
        uids = self._dev([a.req.uid for a in group])
        toks = sample_rows(last, self.sampler.temperature, self.sampler.seed, uids,
                           torch.zeros_like(uids))
        for j, a in enumerate(group):
            self._install(a.slot, a.row, s0=int(s0s[j]), uid=a.req.uid, steps=1,
                          last_tok=toks[j])
        return toks.cpu().numpy()

    def _admit_stub(self, adm) -> None:
        """Claim a slot and its full page row for a chunked prefill, no
        model: the slot stays inactive (decode steps write its K/V to the
        sink page) with ``seq_lens = steps = last_tok = 0``."""
        self.stub_admits += 1
        self._install(adm.slot, adm.row, s0=0, uid=adm.req.uid, steps=0, last_tok=0,
                      active=False)

    def _grow(self, slot: int, row) -> None:
        """Watermark growth: the slot's row, extended by the host, written
        in place (the captured step reads the table at its address)."""
        self.grows += 1
        self._set_row(slot, row)
        self._sync_allocator()

    def _prefill_chunk(self, slot: int, sched: Scheduler) -> int | None:
        """Advance a stub's prefill by one page-aligned chunk: its tokens
        prefill at ``n_prior * bs`` against the KV of the row's first
        ``n_prior`` pages and scatter into the next pages. The final chunk
        samples the first token with (uid, 0) and makes the slot live
        (``seq_lens = S0``, ``steps = 1``); it returns that token, an
        earlier chunk None."""
        self.prefill_chunks += 1
        tokens, n_prior, final, _ = sched.take_prefill_chunk(slot)
        st, bs = sched.active[slot], self.paged.block_size
        n_chunk_pages = -(-tokens.size // bs)
        logits, dense = prefill(
            self.model, {"tokens": self._dev(tokens[None])}, n_chunk_pages * bs,
            prefix_kv=self._gather_prefix_kv(st.row[:n_prior]) if n_prior else None,
            pos_offset=n_prior * bs)
        self._scatter_dense_pages(dense, st.row[n_prior:n_prior + n_chunk_pages])
        if not final:
            return None
        req = st.req
        tok0 = self._first_token(logits, req.uid)
        # the prefix cache's deferred refcounts are in the host allocator
        self._install(slot, st.row, s0=req.prompt.size, uid=req.uid, steps=1, last_tok=tok0)
        return int(tok0)

    def _decode_step(self) -> None:
        """One decode step on the cache and the static buffers alone."""
        cache, samp = self.cache, self.sampler
        logits, _ = decode_step_paged(
            self.model, cache["last_tok"][:, None], cache, attn_impl=self.paged.attn_impl,
            attn_spec=self.attn_spec, watermarks=self.watermarks,
            kv_scales=self._kv_scales_seq)
        nxt = sample_rows(logits[:, -1], samp.temperature, samp.seed, cache["uids"],
                          cache["steps"])
        active = cache["active"]
        cache["last_tok"].copy_(torch.where(active, nxt, cache["last_tok"]))
        cache["steps"].add_(active.to(torch.int32))
        self._buf.index_copy_(1, self._col.reshape(1), nxt[:, None])
        self._col.add_(1)

    def _chunk(self, k: int, *, eager: bool = False) -> np.ndarray:
        """``k`` decode steps, replays of the captured step (``eager``: the
        step run eagerly); returns the (slots, chunk_max) token buffer, read
        to the host once."""
        self.chunks += 1
        if self._program is None:
            self.chunk_traces += 1
            self._program = StepProgram(self._decode_step, self.device)
        self._buf.zero_()
        self._col.zero_()
        if eager or self.step_mode == "eager (gloo)":
            for _ in range(k):
                self._decode_step()
        else:
            self._program.run(k)
        self.decode_steps += k
        return self._buf.to("cpu", copy=True).numpy()  # the next chunk zeroes _buf

    def _release(self, slot: int | None) -> None:
        """Clear ``slot``'s active bit and copy the allocator; with no slot
        (prefix-cache evictions) only the copy runs."""
        if slot is not None:
            self.releases += 1
            self.cache["active"][slot] = False
        self._sync_allocator()

    # ------------------------------------------------------------------
    # Host loop
    # ------------------------------------------------------------------
    def _make_scheduler(self) -> Scheduler:
        paged = self.paged
        return Scheduler(paged.max_concurrency, paged.num_blocks, paged.block_size,
                         paged.max_pages_per_seq, prefix_cache=self.prefix_cache,
                         pool_state=self.pool_state, policy=paged.sched)

    def _do_admit(self, adm) -> int | None:
        """Run one admission's programs (its evictions, then the admit).
        Returns the request's first sampled token, or None for a fully
        cached prompt (deferred to the chunk) or a chunked stub."""
        if adm.evict_pages is not None and adm.evict_pages.size:
            self._release(None)
        if adm.chunked:
            self._admit_stub(adm)
            return None
        if adm.cow_src is not None:
            self._admit_cached(adm)
            return None
        if adm.n_shared:
            return self._admit_suffix(adm)
        return self._admit(adm)

    @staticmethod
    def _arrival_feed(requests, arrivals):
        """Sort an arrival-time trace into a (time, request) deque, or None
        when everything is submitted up front."""
        if arrivals is None:
            return None
        if len(arrivals) != len(requests):
            raise ValueError(f"arrivals has {len(arrivals)} entries for {len(requests)} "
                             f"requests")
        order = sorted(range(len(requests)), key=lambda i: (float(arrivals[i]), i))
        return deque((float(arrivals[i]), requests[i]) for i in order)

    @torch.inference_mode()
    def serve(self, requests, *, arrivals=None, metrics=None, _probe=None,
              _late=None) -> dict[int, np.ndarray]:
        """Run a request list to completion under continuous batching.
        Returns {uid: (S0 + n_generated,) int32}, trimmed at the first EOS
        when the sampler sets one. The default policy runs the reference's
        FIFO loop, any other its throughput loop; both give the same
        streams.

        ``arrivals`` (seconds, aligned with ``requests``) paces submission
        on the wall clock; ``metrics`` (a
        :class:`~repro_torch.serving.metrics.ServeMetrics`) collects TTFT
        and inter-token times. ``_probe(engine, sched)`` runs after every
        admit, chunk and release (the throughput loop probes an admission
        pass once, after all its programs ran); ``_late(sched, pass_idx)``
        once per scheduler pass, and may submit mid-flight arrivals."""
        if arrivals is not None and self.mesh is not None and _processes() > 1:
            # wall-clock pacing is single-controller: two processes would
            # see different clocks, submit in different orders and issue
            # diverging programs
            raise ValueError("arrivals= is wall-clock-paced and single-controller; "
                             "multi-process serving needs deterministic submission "
                             "(submit everything up front or use the _late hook)")
        run = _Run(self, requests, arrivals, metrics, _probe)
        observing = (attach_observer(self.observer) if self.observer is not None
                     else nullcontext())
        with use_packed_backend(self.backend), observing:
            if self.paged.sched.is_legacy:
                self._serve_legacy(run, _late)
            else:
                self._serve_throughput(run, _late)
        if self.assert_bounds:
            self.watermark_values = check_bounds(self.watermarks, self.attn_spec)
        if self.observer is not None:
            self.observer.fold()  # the serve's one read of the counter block
        return run.results

    def _serve_legacy(self, run: "_Run", _late) -> None:
        sched = run.sched
        chunk_idx = 0
        while run.waiting():
            adm = sched.try_admit()
            while adm is not None:
                tok0 = self._do_admit(adm)
                if tok0 is not None:
                    run.note(adm.slot, [tok0])
                run.probe()
                run.maybe_finish(adm.slot)
                adm = sched.try_admit()
            if sched.active:
                k = min(self.paged.chunk_max, sched.min_remaining())
                buf = self._chunk(k)  # the chunk's one host read
                run.probe()
                for slot in list(sched.active):
                    run.note(slot, run.trim(buf[slot, :k].tolist(), slot))
                    run.maybe_finish(slot)
            elif sched.queue:  # cannot happen: submit() validates fit
                raise RuntimeError("queued requests can never be admitted")
            if _late is not None:
                _late(sched, chunk_idx)
            chunk_idx += 1

    def _serve_throughput(self, run: "_Run", _late) -> None:
        """The reference's throughput loop. One pass: (1) one prefill chunk
        for each slot already prefilling (older than anything queued, so a
        burst of admits cannot starve a final chunk); (2) an admission pass
        (windowed, priority-ordered; a group of one runs its admit, a
        larger group one batched admit), probed once after all its
        programs ran, since the host committed the whole pass up front;
        (3) the first chunk of each slot stubbed in (2); (4) the planned
        decode chunk: victims preempted and released, cache evictions,
        growth, then ``plan.k`` replays of the captured step."""
        sched = run.sched
        pass_idx = 0
        while run.waiting():
            progressed = False

            def take_chunk(slot):
                tok0 = self._prefill_chunk(slot, sched)
                run.probe()
                if tok0 is not None:
                    run.note(slot, [tok0])
                    run.maybe_finish(slot)

            chunked_first = sched.prefilling_slots()
            for slot in chunked_first:
                progressed = True
                take_chunk(slot)
            admitted = []
            for group in sched.admit_pass():
                progressed = True
                if len(group) == 1:
                    tok0 = self._do_admit(group[0])
                    if tok0 is not None:
                        run.note(group[0].slot, [tok0])
                else:
                    for adm, tok in zip(group, self._admit_batch(group)):
                        run.note(adm.slot, [int(tok)])
                admitted.extend(group)
            if admitted:
                run.probe()
                for adm in admitted:
                    run.maybe_finish(adm.slot)
            for slot in sched.prefilling_slots():
                if slot not in chunked_first:  # one chunk per slot per pass
                    progressed = True
                    take_chunk(slot)
            plan = sched.plan_chunk(self.paged.chunk_max)
            if plan is not None:
                for v in plan.victims:
                    progressed = True  # freed pages: replanned next pass
                    st = sched.preempt(v)
                    self.preemptions += 1
                    self._release(v)
                    if run.metrics is not None:
                        run.metrics.preempted(st.req.uid)
                    run.probe()
                if plan.evict_nodes:
                    sched._commit_evict(plan.evict_nodes)
                    self._release(None)
                    run.probe()
                for slot, n_new in plan.grow:
                    sched.commit_grow(slot, n_new)
                    self._grow(slot, sched.active[slot].row)
                    run.probe()
                if plan.slots:
                    progressed = True
                    buf = self._chunk(plan.k)  # the chunk's one host read
                    sched.advance_decode(plan.k)
                    run.probe()
                    for slot in plan.slots:
                        run.note(slot, run.trim(buf[slot, :plan.k].tolist(), slot))
                        run.maybe_finish(slot)
            if not progressed and not sched.active and sched.queue and not run.pending:
                raise RuntimeError("queued requests can never be admitted")
            if _late is not None:
                _late(sched, pass_idx)
            pass_idx += 1

    # ------------------------------------------------------------------
    # Observation: the saturation report and structural transparency
    # ------------------------------------------------------------------
    def saturation_report(self) -> dict:
        """The serving observer's report (``repro_torch.quant.observe.
        saturation``), the device block folded in first: per site the
        static-quantizer clip counts, code extrema and accumulator
        watermarks against the packed codes; per KV head of an int8 pool
        the attention watermarks. Requires ``observe=True``."""
        if self.observer is None:
            raise ValueError("engine was built with observe=False — no counters to report; "
                             "rebuild with PagedEngine(..., observe=True)")
        self.observer.fold()
        return self.observer.report(params=self.model, pools=self.cache["pools"],
                                    attn_spec=self.attn_spec)

    @contextmanager
    def _scratch_state(self):
        """Swap in a fresh cache, token buffer, column and watermarks (the
        state a decode step writes) for the enclosed calls, so a step run
        to build its program moves nothing of the engine's."""
        kept = self.cache, self._buf, self._col, self.watermarks
        self.cache = self._new_cache()
        self._buf, self._col = torch.zeros_like(self._buf), torch.zeros_like(self._col)
        if self.watermarks is not None:
            self.watermarks = torch.zeros_like(self.watermarks)
        try:
            yield
        finally:
            self.cache, self._buf, self._col, self.watermarks = kept

    @torch.inference_mode()
    def decode_step_program(self, observer=None) -> ProgramText:
        """The program of one decode step, built fresh on scratch state
        (the engine's cache, buffers, counters and counter block do not
        move; the port's ``decode_chunk_jaxpr``): on CUDA the kernel nodes
        of a throwaway capture (its warm-up a real step on the scratch
        state, whose kernel launches count), read and freed; on the CPU
        the aten ops of one eager step. Both record each op's written
        storages. Default: no observer attached, the plain serving step.
        ``observer`` (a :class:`SaturationCounters`; one without a device
        block gets one for this engine's labels) builds the observing
        step."""
        if observer is not None and observer.block is None:
            observer.allocate(observed_labels(self.model), self.device)
        observing = attach_observer(observer) if observer is not None else nullcontext()
        with self._scratch_state(), use_packed_backend(self.backend), observing:
            return record_step(self._decode_step, self.device)

    def assert_observation_transparent(self) -> None:
        """Observation is free when off, and reads only when on:

        * the plain step (no observer attached) of this engine is, op for
          op and on CUDA kernel node for kernel node, that of an
          ``observe=False`` engine on the same model;
        * no op of the plain step writes the counter block;
        * with an observer attached to a model with packed sites, the
          step writes the observer's block, and without the taps' ops it
          is the plain step, launching the same B1/B3 (every counted)
          kernels.

        A write to the block is recognised by storage: an op whose schema
        marks an argument written, that argument's storage the block's
        (:class:`~repro_torch.serving.graphs.ProgramRecorder`). Raises
        AssertionError otherwise."""
        bare = self.decode_step_program()
        if self.observer is not None:
            twin = PagedEngine(
                self.model, None, self.paged, self.sampler, device=self.device,
                backend=self.backend, assert_bounds=self.assert_bounds,
                kv_scales=None if self._kv_scales_seq is None else
                {i: sec for i, sec in enumerate(self._kv_scales_seq) if sec})
            plain = twin.decode_step_program()
            if bare.op_names != plain.op_names or bare.nodes != plain.nodes:
                raise AssertionError("the plain decode step of an observe=True engine "
                                     "differs from an observe=False engine's")
            if bare.writes(self.observer.block.buf.untyped_storage().data_ptr()):
                raise AssertionError("the plain decode step writes the counter block")
        if bare.taps():
            raise AssertionError(f"the plain decode step holds {bare.taps()} tap ops "
                                 "with no observer attached")
        if self.observer is None or not self.observer.block.labels:
            return
        probe = SaturationCounters()
        probe.allocate(self.observer.block.labels, self.device)
        tapped = self.decode_step_program(probe)
        if not tapped.writes(probe.block.buf.untyped_storage().data_ptr()):
            raise AssertionError("observer attached but the decode step writes nothing "
                                 "into its counter block")
        if tapped.untapped() != bare.untapped():
            raise AssertionError("the observing decode step, without its taps, differs "
                                 "from the plain step")
        if tapped.nodes is not None and count_kernels(tapped.nodes) != count_kernels(
                bare.nodes):
            raise AssertionError(f"the observing step launches {count_kernels(tapped.nodes)} "
                                 f"counted kernels, the plain step "
                                 f"{count_kernels(bare.nodes)}")

    @torch.inference_mode()
    def assert_sampling_keys_collective_safe(self) -> None:
        """The per-request sampling stream must be identical on every rank:
        the noise of :func:`~repro_torch.serving.engine._uniforms` for the
        live (uids, steps), computed on each rank from the replicated admin
        leaves, is gathered over every rank and held equal across ranks and
        to an eager one-rank computation on the host. Mesh engines only;
        raises AssertionError on any divergence."""
        if self.mesh is None:
            raise ValueError("engine has no mesh — the single-controller sampling stream is "
                             "trivially host-consistent")
        uids, steps = self.cache["uids"], self.cache["steps"]
        n = self.cfg.vocab_padded
        mine = _uniforms(self.sampler.seed, uids, steps, n)
        axes = self.mesh.axis_names
        every = gather_dim(mine[None], 0, self.mesh, axes).cpu()
        want = _uniforms(self.sampler.seed, uids.cpu(), steps.cpu(), n)
        for r in range(every.shape[0]):
            if not torch.equal(every[r], want):
                raise AssertionError(f"rank {r}'s sampling noise diverges from the one-rank "
                                     f"stream — per-request determinism is broken")

    def generate(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """Fixed-slot-compatible entry: prompts (B, S0) -> (B, S0 + max_new),
        post-EOS positions EOS-padded as :meth:`GenerationEngine.generate`."""
        prompts = np.asarray(prompts, np.int32)
        reqs = []
        for row in prompts:
            reqs.append(Request(uid=self._uid_gen, prompt=row, max_new=max_new_tokens))
            self._uid_gen += 1
        results = self.serve(reqs)
        eos = self.sampler.eos_id
        out = np.full((len(reqs), prompts.shape[1] + max_new_tokens),
                      0 if eos is None else eos, np.int32)
        for i, r in enumerate(reqs):
            seq = results[r.uid]
            out[i, :seq.size] = seq
        return out


def _processes() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _check_mesh(paged: PagedConfig, device, observe: bool) -> None:
    """What a mesh refuses, as the reference does: the paged attention
    kernels (only the reference attention runs on local heads) and
    observation with more than one process. MoE and recurrent patterns
    serve (the throughput policies and the prefix cache refuse them on any
    engine: :func:`_check_policy`)."""
    impl = paged.attn_impl
    if impl == "kernel" or (impl == "auto" and device.type == "cuda"):
        raise ValueError(f"mesh-native serving requires the reference attention impl "
                         f"(attn_impl {impl!r} resolves to the paged attention kernels on "
                         f"{device.type}): B2/B3 are single-device programs (ROADMAP item 4)")
    if observe and _processes() > 1:
        raise ValueError("observe=True is single-controller: the saturation counters would "
                         "count per process on partial shards — run observation on a "
                         "one-process mesh")


class _Run:
    """One :meth:`PagedEngine.serve` call's host state, shared by both
    loops: the scheduler, the arrival feed, the results and the hooks."""

    def __init__(self, engine: PagedEngine, requests, arrivals, metrics, probe):
        self.engine, self.metrics, self._probe = engine, metrics, probe
        self.sched = engine._make_scheduler()
        self.pending = engine._arrival_feed(requests, arrivals)
        self.eos = engine.sampler.eos_id
        self.results: dict[int, np.ndarray] = {}
        if self.pending is None:
            for r in requests:
                self.sched.submit(r)
                if metrics is not None:
                    metrics.submitted(r.uid, r.priority, 0.0)
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def waiting(self) -> bool:
        """Submit the arrivals that are due; True while work remains (with
        nothing to run, sleep until the next arrival)."""
        sched, pending = self.sched, self.pending
        while sched.has_work or pending:
            if not pending:
                return True
            while pending and pending[0][0] <= self.now():
                t, r = pending.popleft()
                sched.submit(r)
                if self.metrics is not None:
                    self.metrics.submitted(r.uid, r.priority, t)
            if sched.has_work:
                return True
            time.sleep(max(0.0, pending[0][0] - self.now()))
        return False

    def probe(self) -> None:
        if self._probe is not None:
            self._probe(self.engine, self.sched)

    def trim(self, toks: list, slot: int) -> list:
        """A chunk's tokens for ``slot``, cut at its budget and its EOS."""
        toks = toks[: self.sched.remaining(slot)]
        if self.eos is not None and self.eos in toks:
            toks = toks[: toks.index(self.eos) + 1]
        return toks

    def note(self, slot: int, toks) -> None:
        self.sched.record(slot, toks)
        if self.metrics is not None and toks:
            self.metrics.tokens(self.sched.active[slot].req.uid, len(toks), self.now())

    def finish(self, slot: int) -> None:
        st = self.sched.finish(slot)
        self.engine._release(slot)
        self.results[st.req.uid] = np.concatenate(
            [st.req.prompt, np.asarray(st.tokens, np.int32)])
        self.probe()

    def maybe_finish(self, slot: int) -> None:
        """Finish ``slot`` if its request is done: budget spent or EOS."""
        st = self.sched.active.get(slot)
        if st is None or st.prefilling:
            return
        if self.sched.remaining(slot) == 0 or (
                self.eos is not None and st.tokens and st.tokens[-1] == self.eos):
            self.finish(slot)


__all__ = ["PagedConfig", "PagedEngine", "sample_rows"]
