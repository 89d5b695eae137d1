"""Host-side continuous-batching scheduler for the paged decode engine.
(port of ``repro/serving/scheduler.py``: a copy, pure numpy; the
only change is that ``kv_page_bytes`` takes the act dtype's width from
a table, since ``np.dtype("bfloat16")`` needs ml_dtypes)

The scheduler is deliberately device-free (pure Python + numpy): it owns
the *accounting* — which requests are queued, which engine slot and how
many KV pages each active request holds — while the actual page indices
live on device in the cache pytree's ``free_list`` stack (popped/pushed
inside the engine's jitted admit/release programs). The two stay
consistent because every admit/release goes through both in lockstep.

Two admission policies share the accounting (:class:`SchedulerPolicy`):

* **Legacy FIFO** (the default, bit-compatible with every prior release):
  head-of-line, one request at a time, worst-case page reservation —
  ``ceil((S0 + max_new - 1) / block_size)`` pages up front, so exhaustion
  only ever surfaces as a stalled admission, never as a mid-decode
  allocation failure.
* **Throughput mode** (any non-default policy field): :meth:`
  Scheduler.admit_pass` scans an ``admit_window`` of the queue in
  priority order (FIFO within a class), co-admits compatible cold
  arrivals into batched-prefill groups of up to ``batch_max`` rows,
  admits long prompts as *chunked-prefill* stubs, and — with a
  ``watermark`` — replaces the worst-case reservation with an initial
  prompt-sized allocation plus on-demand page growth before each decode
  chunk. Pool pressure is resolved by LRU cache eviction first, then by
  preempting the lowest-priority youngest victim (:meth:`plan_chunk`);
  a preempted request requeues at the front and is *protected* from
  re-victimization until it has produced a token (no-livelock guard:
  its initial allocation always affords one decode step).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


#: bytes per element of the act dtypes a config may name
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


# ---------------------------------------------------------------------------
# Pool HBM accounting (the docs/serving_scheduler.md formula)
# ---------------------------------------------------------------------------
def kv_page_bytes(cfg, block_size: int, kv_dtype: str = "act") -> int:
    """Bytes one KV page costs across every attention layer of the stack
    (K and V, codes plus — for ``kv_dtype="int8"`` — the per-(page,
    kv-head) f32 scale leaves). This is the unit the admission reservation
    multiplies: a request's worst case is ``pages_for(S0, max_new)`` of
    these."""
    n_attn = sum(1 for s in cfg.pattern if s.mixer == "attn") * cfg.repeats
    itemsize = 1 if kv_dtype == "int8" else _ITEMSIZE[cfg.act_dtype]
    per_page = 2 * block_size * cfg.n_kv_heads * cfg.head_dim * itemsize
    if kv_dtype == "int8":
        per_page += 2 * cfg.n_kv_heads * 4  # k_scales + v_scales, f32
    return n_attn * per_page


def kv_pool_bytes(cfg, num_blocks: int, block_size: int,
                  kv_dtype: str = "act") -> int:
    """Total KV pool HBM for a ``num_blocks``-page pool — int8 pages cost
    about half the bf16 pool (exactly half plus the scale leaves)."""
    return num_blocks * kv_page_bytes(cfg, block_size, kv_dtype)


def blocks_for_budget(budget_bytes: int, cfg, block_size: int,
                      kv_dtype: str = "act") -> int:
    """Largest page pool an HBM budget affords. Because int8 pages cost
    ~half the bf16 bytes, the same budget holds ~2x the pages — and since
    admission reserves the worst case in *pages*, the scheduler admits
    ~2x the sequences before stalling (asserted in tests/test_scheduler.py).

    A budget smaller than one page raises (a zero-page pool can never
    admit anything — ``--kv-hbm-mb`` misconfiguration should fail at
    launch, not as an unexplained admission stall).
    """
    per_page = kv_page_bytes(cfg, block_size, kv_dtype)
    n = budget_bytes // per_page
    if n < 1:
        raise ValueError(
            f"KV HBM budget {budget_bytes} B is below one page: a single "
            f"block_size={block_size} {kv_dtype} page costs {per_page} B "
            f"across the stack's attention layers — raise the budget or "
            f"shrink block_size"
        )
    return n


@dataclass(frozen=True)
class SchedulerPolicy:
    """Admission/decode policy knobs. The default is *legacy FIFO* —
    head-of-line admission, B=1 prefill, worst-case reservation — and is
    bit-compatible with the pre-policy engine (the serving benches use it
    as the baseline). Any non-default field switches the engine's serve
    loop into throughput mode.

    ``admit_window``: how many queued requests one admission pass may
    examine (head-only when 1). ``batch_max``: max rows co-admitted into
    one padded multi-row prefill program (cold prompts only — cache-hit
    admits keep their specialized n=1 variants). ``prefill_chunk``: when
    set, cold prompts longer than this prefill in page-aligned chunks of
    at most this many tokens, interleaved with decode chunks (must be a
    multiple of the engine block size). ``watermark``: ``(low, high)``
    free-page watermarks — admission keeps a ``low``-page reserve for
    decode growth instead of reserving each request's worst case, and
    after a preemption new arrivals wait until ``high`` pages are free
    (hysteresis; preempted requeues are exempt so they can resume)."""

    admit_window: int = 1
    batch_max: int = 1
    prefill_chunk: int | None = None
    watermark: tuple[int, int] | None = None

    def __post_init__(self):
        if self.admit_window < 1:
            raise ValueError("admit_window must be >= 1")
        if self.batch_max < 1:
            raise ValueError("batch_max must be >= 1")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")
        if self.watermark is not None:
            low, high = self.watermark
            if not (0 <= low <= high):
                raise ValueError(
                    f"watermark must satisfy 0 <= low <= high, got "
                    f"({low}, {high})")

    @property
    def is_legacy(self) -> bool:
        """True for the default policy: the engine then runs the original
        FIFO serve loop (admission drains fully before every decode chunk,
        one admit trace per request — several tests pin that shape)."""
        return (self.admit_window == 1 and self.batch_max == 1
                and self.prefill_chunk is None and self.watermark is None)


@dataclass(frozen=True)
class Request:
    """One generation request: ``uid`` must be unique per engine lifetime
    (it seeds the request's sampling key stream, making sampled output
    deterministic per request regardless of co-batched traffic —
    including across a preempt-and-requeue restart). ``priority`` is the
    scheduling class, 0 = most urgent; admission prefers lower values and
    preemption victimizes higher ones."""

    uid: int
    prompt: np.ndarray  # (S0,) int32
    max_new: int
    priority: int = 0

    def __post_init__(self):
        prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        object.__setattr__(self, "prompt", prompt)
        if prompt.size < 1:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.uid}: max_new must be >= 1")


@dataclass
class _Active:
    req: Request
    n_pages: int  # pages currently held (== row.size; grows under watermark)
    target_pages: int  # worst-case need — n_pages never exceeds this
    produced: int = 0  # tokens generated so far (admission token included)
    tokens: list = field(default_factory=list)
    row: np.ndarray | None = None  # (n_pages,) physical pages, row order
    nodes: list = field(default_factory=list)  # prefix-cache nodes held
    seq: int = 0  # host mirror of the device seq_lens entry
    prefilling: bool = False  # chunked prefill still in progress
    prefill_pos: int = 0  # tokens prefilled so far (page-aligned)
    protected: bool = False  # preempted-and-readmitted, no token yet
    admit_tick: int = 0  # admission order (victim selection: youngest)


@dataclass
class PoolState:
    """Host mirror of the device page allocator: the ``free_list`` stack
    (free region = ``free_list[free_top:]``), ``free_top``, and the
    per-page refcounts. The device admit/release programs and this mirror
    perform the identical pops/pushes in the identical order, so the host
    always knows which physical pages a request holds without a device
    readback — which is what lets the prefix cache hand *physical* page
    indices to a later admission. Owned by the engine (it must persist
    across ``serve()`` calls: cached pages stay out of the free stack
    between traces), shared with each ``Scheduler``.

    Under a multi-process mesh every process runs this mirror
    independently: it is pure seeded numpy driven only by the (identical)
    request trace and the (replicated) device token reads, so the replay
    is byte-identical on every host by construction — the multi-process
    battery (scripts/run_multiprocess.py) allgathers :meth:`digest` and
    asserts exactly that.
    """

    free_list: np.ndarray
    free_top: int
    page_rc: np.ndarray

    @classmethod
    def fresh(cls, num_blocks: int) -> "PoolState":
        return cls(free_list=np.arange(num_blocks, dtype=np.int32),
                   free_top=0,
                   page_rc=np.zeros(num_blocks, np.int32))

    @property
    def free_pages(self) -> int:
        return self.free_list.size - self.free_top

    def pop(self, n: int) -> np.ndarray:
        pages = self.free_list[self.free_top:self.free_top + n].copy()
        self.free_top += n
        self.page_rc[pages] += 1
        return pages

    def push(self, pages) -> None:
        """Push freed pages (rc already at 0) — same order as the device
        subset-push: ``free_list[top - n + j] = pages[j]``."""
        n = len(pages)
        if not n:
            return
        self.free_top -= n
        self.free_list[self.free_top:self.free_top + n] = pages

    def digest(self) -> str:
        """Stable byte-level digest of the allocator state (free stack,
        top, refcounts) — what the multi-process determinism battery
        compares across hosts and against the device's replicated
        ``free_list``/``page_refcounts`` leaves."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray(self.free_list, np.int32).tobytes())
        h.update(np.int64(self.free_top).tobytes())
        h.update(np.asarray(self.page_rc, np.int32).tobytes())
        return h.hexdigest()


@dataclass(frozen=True)
class Admission:
    """One admission decision, host side. ``row`` is the request's full
    physical block-table row: ``n_shared`` leading pages borrowed from the
    prefix cache (refcount bumped, never written), then ``n_pop`` freshly
    popped pages (``cow_src`` is copied into the first of them on a fully
    cached prompt — the copy-on-write tail). ``evict_pages`` must be
    pushed back on device *before* the admit pops. ``chunked`` marks a
    chunked-prefill stub: pages are allocated and the block table row is
    installed, but no prefill runs at admit — the engine drives it
    forward via :meth:`Scheduler.take_prefill_chunk`. Under a watermark
    policy ``n_pages`` is the *initial* allocation (prompt pages plus one
    decode page), not the worst case — ``target_pages`` is the cap the
    slot may grow to."""

    slot: int
    req: Request
    n_pages: int
    target_pages: int
    n_shared: int = 0
    cow_src: int | None = None
    row: np.ndarray | None = None
    evict_pages: np.ndarray | None = None
    incs: np.ndarray | None = None
    chunked: bool = False

    @property
    def n_pop(self) -> int:
        return self.n_pages - self.n_shared

    @property
    def shared_pages(self) -> np.ndarray:
        return self.row[:self.n_shared]


@dataclass
class _Plan:
    """A pure (no-mutation) admission plan for one request — the stall
    test ran against the current pool/cache state; :meth:`Scheduler._commit`
    turns it into an :class:`Admission`."""

    req: Request
    n_pages: int
    target_pages: int
    n_shared: int
    matched: list
    cow_node: object | None
    evict_plan: list
    chunked: bool


@dataclass
class ChunkPlan:
    """One decode chunk's resource decisions (:meth:`Scheduler.plan_chunk`),
    computed atomically against the host mirror but not yet committed.
    The engine applies it in order: preempt ``victims`` (device release +
    requeue), evict ``evict_nodes`` (cache pages pushed), grow ``grow``
    slots (pages popped, block-table rows extended), then run ``k`` fused
    decode steps over ``slots``."""

    k: int
    slots: list[int]  # decoding (non-prefilling) slots the chunk advances
    victims: list[int] = field(default_factory=list)
    evict_nodes: list = field(default_factory=list)
    grow: list[tuple[int, int]] = field(default_factory=list)  # (slot, n_new)


class Scheduler:
    def __init__(self, max_concurrency: int, num_blocks: int, block_size: int,
                 max_pages_per_seq: int, prefix_cache=None,
                 pool_state: PoolState | None = None,
                 policy: SchedulerPolicy = SchedulerPolicy()):
        self.max_concurrency = max_concurrency
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_pages_per_seq = max_pages_per_seq
        self.policy = policy
        self.queue: deque[Request] = deque()
        self.free_slots: list[int] = sorted(range(max_concurrency), reverse=True)
        self.active: dict[int, _Active] = {}
        self.prefix_cache = prefix_cache
        self.pool = pool_state if pool_state is not None else PoolState.fresh(
            num_blocks)
        if prefix_cache is not None and prefix_cache.block_size != block_size:
            raise ValueError("prefix cache block_size != scheduler block_size")
        if policy.prefill_chunk is not None and (
                policy.prefill_chunk % block_size != 0):
            raise ValueError(
                f"prefill_chunk {policy.prefill_chunk} must be a multiple of "
                f"block_size {block_size} (chunks scatter whole pages)")
        if policy.watermark is not None and policy.watermark[1] > num_blocks:
            raise ValueError(
                f"watermark high {policy.watermark[1]} > pool size "
                f"{num_blocks} — admission could never resume")
        self._inflight: set[int] = set()
        #: uids preempted and awaiting re-admission — they bypass the
        #: post-preemption hysteresis gate and readmit *protected*
        self._preempted: set[int] = set()
        self._cooldown = False  # watermark hysteresis after a preemption
        self._tick = 0  # admission order clock (victim selection)
        self.preemptions = 0

    @property
    def free_pages(self) -> int:
        """Pages poppable right now (the device free stack's depth) —
        excludes pages the prefix cache holds at refcount 1, which are
        reclaimable only through eviction."""
        return self.pool.free_pages

    # ------------------------------------------------------------------
    # Accounting
    # ------------------------------------------------------------------
    def pages_for(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page need: a sequence writes KV for positions
        ``0 .. S0 + max_new - 2`` (the final sampled token is returned but
        never fed back, so its KV is never written — same as the dense
        engine's cache sizing)."""
        return -(-(prompt_len + max_new - 1) // self.block_size)

    def submit(self, req: Request) -> None:
        need = self.pages_for(req.prompt.size, req.max_new)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request {req.uid}: needs {need} pages > block table width "
                f"{self.max_pages_per_seq} (prompt {req.prompt.size} + "
                f"max_new {req.max_new}, block_size {self.block_size})"
            )
        # Pool-size rejection runs against the *post-prefix-match*
        # requirement: a long prompt whose leading blocks are already
        # resident only ever pops the uncached remainder, so the
        # worst-case bound would spuriously reject it. The match is
        # advisory (cache contents move before admission) — admit-time
        # planning remains the authority and a request that still cannot
        # fit stalls there (surfacing as the serve loop's loud
        # "can never be admitted" error, never a silent hang).
        n_cached = (len(self.prefix_cache.match(req.prompt))
                    if self.prefix_cache is not None else 0)
        if need - n_cached > self.num_blocks:
            raise ValueError(
                f"request {req.uid}: needs {need - n_cached} fresh pages "
                f"(worst case {need} minus {n_cached} cached prefix blocks) "
                f"> pool size {self.num_blocks} — can never be admitted"
            )
        if req.uid in self._inflight:
            # serve() keys its results dict by uid: a duplicate would
            # silently clobber one request's output — fail loudly instead
            raise ValueError(
                f"request uid {req.uid} is already in flight (queued or "
                f"active); uids must be unique until the request finishes"
            )
        self._inflight.add(req.uid)
        self.queue.append(req)

    # ------------------------------------------------------------------
    # Admission planning (pure) and commit
    # ------------------------------------------------------------------
    def _plan(self, req: Request) -> _Plan | None:
        """Plan one admission against the current state — returns None on
        a stall and mutates nothing (pool, cache and queue untouched)."""
        target = self.pages_for(req.prompt.size, req.max_new)
        s0, bs = req.prompt.size, self.block_size
        wm = self.policy.watermark

        matched, cow_node = [], None
        if self.prefix_cache is not None:
            matched = self.prefix_cache.match(req.prompt)
            if matched and len(matched) * bs == s0:
                # fully cached prompt: the last cached block doubles as
                # the decode tail (position s0-1 onward) — share all but
                # that block, and copy-on-write its page at admit
                cow_node = matched[-1]
                matched = matched[:-1]
        n_shared = len(matched)

        chunked = (self.policy.prefill_chunk is not None and n_shared == 0
                   and cow_node is None and s0 > self.policy.prefill_chunk)
        if wm is None:
            n_pages = target
        else:
            # initial allocation: the prompt's pages plus the page holding
            # position s0 — so a freshly (re-)admitted slot always affords
            # one decode step without growth (the no-livelock guarantee
            # preemption protection relies on)
            n_pages = min(target, s0 // bs + 1)
            n_pages = max(n_pages,
                          n_shared + (1 if cow_node is not None else 0))
            if self._cooldown and req.uid not in self._preempted:
                # post-preemption hysteresis: fresh arrivals wait for the
                # pool to recover to the high watermark; the preempted
                # request itself is exempt so it can resume
                return None
        n_pop = n_pages - n_shared

        reserve = wm[0] if (wm is not None and self.active) else 0
        evict_plan: list = []
        shortage = n_pop + reserve - self.pool.free_pages
        if shortage > 0:
            if self.prefix_cache is None:
                return None  # stall: wait for a running sequence to free
            protect = {n.key for n in matched}
            if cow_node is not None:
                protect.add(cow_node.key)
            evict_plan = self.prefix_cache.plan_evict(shortage, protect)
            if evict_plan is None:
                return None  # shortage not coverable — stall, no mutation
        return _Plan(req=req, n_pages=n_pages, target_pages=target,
                     n_shared=n_shared, matched=matched, cow_node=cow_node,
                     evict_plan=evict_plan, chunked=chunked)

    def _commit_evict(self, plan: list) -> np.ndarray:
        """Drop an eviction plan from the cache and the host pool mirror
        (returns the pages — the engine pairs this with a device release
        at the sentinel slot)."""
        pages = np.asarray([n.page for n in plan], np.int32)
        if len(plan):
            self.prefix_cache.evict(plan)
            self.pool.page_rc[pages] -= 1
            assert (self.pool.page_rc[pages] == 0).all()
            self.pool.push(pages)
        return pages

    def _commit(self, plan: _Plan) -> Admission:
        """Commit a plan: dequeue, allocate, register cache refs."""
        req = plan.req
        s0, bs = req.prompt.size, self.block_size
        self.queue.remove(req)
        slot = self.free_slots.pop()
        evict_pages = self._commit_evict(plan.evict_plan)
        matched, cow_node = plan.matched, plan.cow_node
        n_pages, n_shared = plan.n_pages, plan.n_shared
        shared = np.asarray([n.page for n in matched], np.int32)
        popped = self.pool.pop(plan.n_pages - n_shared)  # rc 0 -> 1
        row = np.concatenate([shared, popped])
        incs = np.zeros(self.max_pages_per_seq, np.int32)
        incs[:n_pages] = 1  # every row entry is one reader
        nodes = list(matched)
        if self.prefix_cache is not None:
            n_full = s0 // bs
            self.pool.page_rc[shared] += 1
            self.prefix_cache.acquire(matched, n_full)
            if cow_node is not None:
                self.prefix_cache.touch(cow_node)
            elif not plan.chunked:
                # freshly prefilled full blocks join the cache: +1 cache
                # ref on top of the row ref (a chunked stub defers this to
                # its final prefill chunk — blocks must not be matchable
                # before their KV is actually written)
                new_nodes = self.prefix_cache.insert(req.prompt, row,
                                                     start_block=n_shared)
                nodes += new_nodes
                for j, node in enumerate(new_nodes):
                    # inserted block i sits at row index n_shared + i
                    self.pool.page_rc[node.page] += 1
                    incs[n_shared + j] += 1
        self._tick += 1
        st = _Active(req=req, n_pages=n_pages, target_pages=plan.target_pages,
                     row=row, nodes=nodes, admit_tick=self._tick)
        if plan.chunked:
            st.prefilling = True
            st.seq = 0
        else:
            st.seq = s0 - 1 if cow_node is not None else s0
        if req.uid in self._preempted:
            self._preempted.discard(req.uid)
            st.protected = True
        self.active[slot] = st
        return Admission(
            slot=slot, req=req, n_pages=n_pages,
            target_pages=plan.target_pages, n_shared=n_shared,
            cow_src=None if cow_node is None else cow_node.page,
            row=row, evict_pages=evict_pages, incs=incs,
            chunked=plan.chunked,
        )

    def try_admit(self) -> Admission | None:
        """Pop the queue head into a free slot if slot + pages allow;
        returns an :class:`Admission` or None — a stalled admission leaves
        scheduler, pool mirror and prefix cache untouched.

        With a prefix cache attached, the head's worst-case reservation
        *subtracts* its cached prefix: only ``n_pages - n_shared`` pages
        must be popped, and a shortage may additionally be covered by
        evicting cold cache entries (all-or-nothing, LRU leaf-first)."""
        if not self.queue or not self.free_slots:
            return None
        plan = self._plan(self.queue[0])
        if plan is None:
            return None
        return self._commit(plan)

    def admit_pass(self) -> list[list[Admission]]:
        """One throughput-mode admission pass: repeatedly scan the first
        ``admit_window`` queued requests in (priority, FIFO) order and
        commit the first plannable one, until no slot or no candidate
        fits. Consecutive *cold* admissions (no cache hit, no eviction,
        not chunked) group into batched-prefill lists of up to
        ``batch_max`` rows; everything else is its own singleton group.
        Returns the groups in commit order — device pops must replay in
        exactly this order."""
        pol = self.policy
        wm = pol.watermark
        if self._cooldown and wm is not None and (
                not self.active or self.pool.free_pages >= wm[1]):
            self._cooldown = False
        groups: list[list[Admission]] = []
        cur: list[Admission] = []

        def flush():
            nonlocal cur
            if cur:
                groups.append(cur)
                cur = []

        while self.free_slots and self.queue:
            window = [self.queue[i]
                      for i in range(min(pol.admit_window, len(self.queue)))]
            window.sort(key=lambda r: r.priority)  # stable: FIFO in class
            committed = None
            for req in window:
                plan = self._plan(req)
                if plan is not None:
                    committed = self._commit(plan)
                    break
            if committed is None:
                break
            adm = committed
            groupable = (pol.batch_max > 1 and not adm.chunked
                         and adm.n_shared == 0 and adm.cow_src is None
                         and adm.evict_pages.size == 0)
            if groupable and len(cur) < pol.batch_max:
                cur.append(adm)
            else:
                flush()
                if groupable:
                    cur = [adm]
                else:
                    groups.append([adm])
        flush()
        return groups

    # ------------------------------------------------------------------
    # Chunked prefill
    # ------------------------------------------------------------------
    def prefilling_slots(self) -> list[int]:
        return sorted(s for s, st in self.active.items() if st.prefilling)

    def take_prefill_chunk(self, slot: int):
        """Advance a chunked-prefill slot by one chunk. Returns
        ``(tokens, n_prior_pages, final, incs)``: the chunk's tokens, the
        page count already written (the device program gathers their KV as
        the attention prefix), whether this chunk completes the prompt,
        and — on the final chunk — the per-row-position refcount bumps for
        blocks the prefix cache registers (the deferred insert happens
        here, once the KV is actually about to exist)."""
        st = self.active[slot]
        assert st.prefilling
        s0, bs = st.req.prompt.size, self.block_size
        start = st.prefill_pos
        end = min(s0, start + self.policy.prefill_chunk)
        final = end == s0
        tokens = st.req.prompt[start:end]
        n_prior = start // bs  # chunks are page-aligned by construction
        incs = np.zeros(self.max_pages_per_seq, np.int32)
        st.prefill_pos = end
        if final:
            st.prefilling = False
            st.seq = s0
            if self.prefix_cache is not None:
                # deferred insert: skip blocks a concurrent request cached
                # meanwhile (this row keeps private duplicates for those)
                new_nodes = self.prefix_cache.insert(
                    st.req.prompt, st.row, start_block=0, skip_existing=True)
                st.nodes += new_nodes
                for node in new_nodes:
                    self.pool.page_rc[node.page] += 1
                    j = int(np.where(st.row == node.page)[0][0])
                    incs[j] += 1
        return tokens, n_prior, final, incs

    # ------------------------------------------------------------------
    # Decode-chunk planning: growth, eviction, preemption
    # ------------------------------------------------------------------
    def plan_chunk(self, chunk_max: int) -> ChunkPlan | None:
        """Plan the next fused decode chunk: pick the trip count ``k``
        (min over decoding slots' remaining budgets, so no slot overruns
        its worst case) and the page growth each slot needs to write ``k``
        more positions. A shortage is covered in escalating order: LRU
        cache eviction (all-or-nothing), then preemption of the lowest-
        priority youngest unprotected victim (repeat), then shrinking the
        chunk to one step — at which point the remaining (all-protected)
        slots need no growth by the initial-allocation invariant, so the
        plan always terminates with a runnable chunk or no slots at all.

        Pure: commits happen via :meth:`preempt` / :meth:`_commit_evict` /
        :meth:`commit_grow` in the order the plan lists them."""
        decoding = [s for s, st in self.active.items() if not st.prefilling]
        if not decoding:
            return None
        bs = self.block_size
        victims: list[int] = []
        evict_nodes: list = []
        free = self.pool.free_pages
        sim_rc = None  # lazily copied refcounts for victim-free simulation
        cap = chunk_max
        while True:
            k = min(cap, min(self.remaining(s) for s in decoding))
            need = {}
            for s in decoding:
                st = self.active[s]
                need[s] = max(0, -(-(st.seq + k) // bs) - st.n_pages)
            total = sum(need.values())
            if total <= free:
                break
            if self.prefix_cache is not None:
                plan = self.prefix_cache.plan_evict(total - free, set())
                if plan is not None:
                    evict_nodes = plan
                    break
            cand = [s for s in decoding if not self.active[s].protected]
            if cand:
                # lowest priority class (max value), then youngest
                v = max(cand, key=lambda s: (self.active[s].req.priority,
                                             self.active[s].admit_tick))
                victims.append(v)
                decoding.remove(v)
                if not decoding:
                    break
                if sim_rc is None:
                    sim_rc = self.pool.page_rc.copy()
                vrow = self.active[v].row
                sim_rc[vrow] -= 1
                free += int((sim_rc[vrow] == 0).sum())
                continue
            if k == 1:  # cannot happen: protected slots need no growth
                raise RuntimeError(
                    "unresolvable page pressure at chunk size 1 — "
                    "initial-allocation invariant violated")
            cap = 1
        if not decoding:
            return ChunkPlan(k=0, slots=[], victims=victims)
        grow = [(s, need[s]) for s in sorted(decoding) if need[s] > 0]
        return ChunkPlan(k=k, slots=sorted(decoding), victims=victims,
                         evict_nodes=evict_nodes, grow=grow)

    def preempt(self, slot: int) -> _Active:
        """Abort a running request and requeue it at the queue front: its
        pages release exactly like :meth:`finish` (the engine pairs this
        with the device release program) and its produced tokens are
        discarded — on re-admission the per-request ``fold_in(uid, step)``
        sampling stream replays from step 0, so the restart is
        bit-identical to an uninterrupted run. The uid joins the
        protected set: it bypasses admission hysteresis and is never
        re-victimized before producing a token."""
        st = self.active.pop(slot)
        if self.prefix_cache is not None:
            self.prefix_cache.release(st.nodes)
        self.pool.page_rc[st.row] -= 1
        assert (self.pool.page_rc[st.row] >= 0).all()
        self.pool.push([p for p in st.row if self.pool.page_rc[p] == 0])
        self.free_slots.append(slot)
        self.free_slots.sort(reverse=True)
        self._preempted.add(st.req.uid)
        self._cooldown = self.policy.watermark is not None
        self.queue.appendleft(st.req)
        self.preemptions += 1
        return st

    def commit_grow(self, slot: int, n_new: int) -> tuple[np.ndarray, int]:
        """Pop ``n_new`` pages for a decoding slot's growth; returns the
        pages and the slot's previous page count (the device program
        appends at that row offset)."""
        st = self.active[slot]
        held = st.n_pages
        pages = self.pool.pop(n_new)
        st.row = np.concatenate([st.row, pages])
        st.n_pages += n_new
        assert st.n_pages <= st.target_pages
        return pages, held

    def advance_decode(self, k: int) -> None:
        """Mirror a completed k-step decode chunk: every decoding slot's
        device ``seq_lens`` advanced by ``k``."""
        for st in self.active.values():
            if not st.prefilling:
                st.seq += k

    # ------------------------------------------------------------------
    def record(self, slot: int, tokens) -> None:
        st = self.active[slot]
        st.tokens.extend(int(t) for t in tokens)
        st.produced += len(tokens)
        if tokens:
            st.protected = False  # livelock guard satisfied: a token landed

    def finish(self, slot: int) -> _Active:
        """Release the slot and the row's refcounts; pages whose count
        drops to zero return to the free stack (in row order — matching
        the device subset-push program). Returns the record."""
        st = self.active.pop(slot)
        self._inflight.discard(st.req.uid)
        if self.prefix_cache is not None:
            self.prefix_cache.release(st.nodes)
        self.pool.page_rc[st.row] -= 1
        assert (self.pool.page_rc[st.row] >= 0).all()
        self.pool.push([p for p in st.row if self.pool.page_rc[p] == 0])
        self.free_slots.append(slot)
        self.free_slots.sort(reverse=True)
        return st

    # ------------------------------------------------------------------
    # Loop predicates
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active)

    def remaining(self, slot: int) -> int:
        st = self.active[slot]
        return st.req.max_new - st.produced

    def min_remaining(self) -> int:
        return min(self.remaining(s) for s in self.active)
