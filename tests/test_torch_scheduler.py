"""Port parity of the serving host side: the port's copies of
``serving/scheduler.py``, ``serving/prefix_cache.py`` and
``serving/metrics.py`` against the reference's, driven through the same
randomized admit / decode / release / evict traces. Decisions must be the
same and ``PoolState.digest()`` equal after every step."""

import random

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.serving import metrics as JM
from repro.serving import prefix_cache as JPC
from repro.serving import scheduler as JS
from repro_torch.configs import get_config, get_smoke
from repro_torch.serving import metrics as M
from repro_torch.serving import prefix_cache as PC
from repro_torch.serving import scheduler as S

ADMISSION_FIELDS = ("slot", "n_pages", "target_pages", "n_shared", "cow_src", "chunked")


def _same_admission(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for f in ADMISSION_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert a.req.uid == b.req.uid
    for f in ("row", "evict_pages", "incs"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def _pair(mod_j, mod_p, *, prefix: bool, **kw):
    caches = ((JPC.PrefixCache(kw["num_blocks"], kw["block_size"]),
               PC.PrefixCache(kw["num_blocks"], kw["block_size"])) if prefix else (None, None))
    return (mod_j.Scheduler(prefix_cache=caches[0], **kw),
            mod_p.Scheduler(prefix_cache=caches[1], **kw))


def _check_state(js, ps):
    assert js.pool.digest() == ps.pool.digest()
    assert js.free_slots == ps.free_slots
    assert [r.uid for r in js.queue] == [r.uid for r in ps.queue]
    assert sorted(js.active) == sorted(ps.active)
    for slot in js.active:
        np.testing.assert_array_equal(js.active[slot].row, ps.active[slot].row)
        assert js.active[slot].seq == ps.active[slot].seq
    if js.prefix_cache is not None:
        assert js.prefix_cache.stats() == ps.prefix_cache.stats()
        assert sorted((n.page, n.readers) for n in js.prefix_cache.nodes.values()) == \
            sorted((n.page, n.readers) for n in ps.prefix_cache.nodes.values())


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_randomized_trace_same_decisions_and_digest(seed, prefix):
    """Random arrivals over a few shared prompt blocks, tiny pools (stalls,
    evictions, CoW admits), random early finishes: every admission, every
    release and the allocator state agree step by step."""
    r = random.Random(seed)
    bs = 4
    kw = dict(max_concurrency=3, num_blocks=10, block_size=bs, max_pages_per_seq=5)
    js, ps = _pair(JS, S, prefix=prefix, **kw)
    blocks = [np.asarray(r.choices(range(50), k=bs), np.int32) for _ in range(3)]
    uid = 0
    for _ in range(40):
        op = r.random()
        if op < 0.4:
            body = [blocks[i] for i in r.choices(range(3), k=r.choice([1, 2]))]
            tail = np.asarray(r.choices(range(50), k=r.choice([0, 1, 3])), np.int32)
            prompt = np.concatenate(body + [tail])
            max_new = r.choice([1, 2, 5, 8])
            for sched in (js, ps):
                sched.submit(sched_req(sched, uid, prompt, max_new))
            uid += 1
        elif op < 0.75:
            while True:
                a, b = js.try_admit(), ps.try_admit()
                _same_admission(a, b)
                if a is None:
                    break
                for sched in (js, ps):
                    sched.record(a.slot, [7])
        elif js.active:
            slot = r.choice(sorted(js.active))
            n = r.randint(0, js.remaining(slot))
            for sched in (js, ps):
                sched.record(slot, [1] * n)
                sched.advance_decode(n)
            if js.remaining(slot) == 0 or r.random() < 0.3:
                a, b = js.finish(slot), ps.finish(slot)
                assert a.req.uid == b.req.uid and a.tokens == b.tokens
        _check_state(js, ps)
        assert js.has_work == ps.has_work
        if js.active:
            assert js.min_remaining() == ps.min_remaining()


def sched_req(sched, uid, prompt, max_new):
    mod = JS if isinstance(sched, JS.Scheduler) else S
    return mod.Request(uid=uid, prompt=prompt.copy(), max_new=max_new)


def test_submit_refusals_match():
    kw = dict(max_concurrency=2, num_blocks=4, block_size=4, max_pages_per_seq=3)
    for mod in (JS, S):
        sched = mod.Scheduler(**kw)
        with pytest.raises(ValueError, match="block table width"):
            sched.submit(mod.Request(uid=0, prompt=np.zeros(12, np.int32), max_new=2))
        sched.submit(mod.Request(uid=1, prompt=np.zeros(4, np.int32), max_new=2))
        with pytest.raises(ValueError, match="already in flight"):
            sched.submit(mod.Request(uid=1, prompt=np.zeros(4, np.int32), max_new=2))
        with pytest.raises(ValueError, match="max_new"):
            mod.Request(uid=2, prompt=np.zeros(4, np.int32), max_new=0)


@pytest.mark.parametrize("arch", ["smollm-360m", "smollm-360m-smoke", "tiny-lm-xs"])
@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_pool_byte_accounting_matches(arch, kv_dtype):
    if arch.endswith("-smoke"):
        jcfg, cfg = j_get_smoke("smollm-360m"), get_smoke("smollm-360m")
    else:
        jcfg, cfg = j_get_config(arch), get_config(arch)
    for bs in (8, 64):
        assert S.kv_page_bytes(cfg, bs, kv_dtype) == JS.kv_page_bytes(jcfg, bs, kv_dtype)
        assert S.kv_pool_bytes(cfg, 64, bs, kv_dtype) == JS.kv_pool_bytes(jcfg, 64, bs, kv_dtype)
        budget = 3 * 2**20 + 12345
        assert S.blocks_for_budget(budget, cfg, bs, kv_dtype) == \
            JS.blocks_for_budget(budget, jcfg, bs, kv_dtype)
    if arch == "smollm-360m":  # one 64-token page of all 32 layers
        assert S.kv_page_bytes(cfg, 64, kv_dtype) == \
            {"act": 2_621_440, "int8": 1_312_000}[kv_dtype]


def test_block_digests_and_policy_match():
    prompt = np.arange(37, dtype=np.int32) % 11
    assert PC.block_digests(prompt, 8) == JPC.block_digests(prompt, 8)
    assert S.SchedulerPolicy().is_legacy and JS.SchedulerPolicy().is_legacy
    assert not S.SchedulerPolicy(batch_max=2).is_legacy
    with pytest.raises(ValueError):
        S.SchedulerPolicy(watermark=(3, 1))


def test_serve_metrics_summary_matches():
    r = random.Random(0)
    jm, pm = JM.ServeMetrics(), M.ServeMetrics()
    t = 0.0
    for uid in range(12):
        prio = uid % 3
        for m in (jm, pm):
            m.submitted(uid, prio, t)
        for _ in range(r.randint(1, 4)):
            t += r.random() * 0.01
            n = r.randint(1, 5)
            for m in (jm, pm):
                m.tokens(uid, n, t)
        if uid % 5 == 0:
            for m in (jm, pm):
                m.preempted(uid)
    assert pm.summary() == jm.summary()


def _same_groups(jg, pg):
    assert [len(g) for g in jg] == [len(g) for g in pg]
    for a_group, b_group in zip(jg, pg):
        for a, b in zip(a_group, b_group):
            _same_admission(a, b)


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_throughput_policy_same_decisions_and_digest(seed, prefix):
    """The throughput loop's host side in lockstep: random policies
    (window, batch, chunk, watermark) over arrivals that drip in a few a
    pass, each pass driving ``take_prefill_chunk``, ``admit_pass``,
    ``plan_chunk``, ``preempt``, ``_commit_evict`` and ``commit_grow`` in
    the engine's order on the reference and the port: every group, chunk,
    victim, eviction, growth and the allocator agree after every step, and
    every request ends with its ``max_new`` tokens."""
    r = random.Random(seed)
    bs = 4
    nb = r.randint(8, 14)
    pol = dict(admit_window=r.randint(2, 4), batch_max=r.randint(2, 3),
               prefill_chunk=bs if seed % 2 == 0 else None,
               watermark=(1, min(4, nb)) if seed < 3 else None)
    kw = dict(max_concurrency=r.randint(2, 4), num_blocks=nb, block_size=bs,
              max_pages_per_seq=6)
    js, ps = (JS.Scheduler(prefix_cache=JPC.PrefixCache(nb, bs) if prefix else None,
                           policy=JS.SchedulerPolicy(**pol), **kw),
              S.Scheduler(prefix_cache=PC.PrefixCache(nb, bs) if prefix else None,
                          policy=S.SchedulerPolicy(**pol), **kw))
    blocks = [np.asarray(r.choices(range(50), k=bs), np.int32) for _ in range(2)]
    feed = []
    for uid in range(10):
        body = [blocks[i] for i in r.choices(range(2), k=r.choice([0, 1, 2]))]
        tail = np.asarray(r.choices(range(50), k=r.choice([1, 3, 6])), np.int32)
        feed.append((uid, np.concatenate(body + [tail]), r.choice([2, 5, 9]),
                     r.choice([0, 1])))
    want = {uid: n for uid, _, n, _ in feed}
    done, preempted = {}, 0

    def finish(slot):
        a, b = js.finish(slot), ps.finish(slot)
        assert a.req.uid == b.req.uid and a.tokens == b.tokens
        done[a.req.uid] = len(a.tokens)

    for _ in range(300):
        if not (feed or js.has_work):
            break
        for _ in range(min(len(feed), r.randint(1, 2))):
            uid, prompt, max_new, prio = feed.pop(0)
            for sched, mod in ((js, JS), (ps, S)):
                sched.submit(mod.Request(uid=uid, prompt=prompt.copy(), max_new=max_new,
                                         priority=prio))
        assert js.prefilling_slots() == ps.prefilling_slots()
        for slot in js.prefilling_slots():
            a, b = js.take_prefill_chunk(slot), ps.take_prefill_chunk(slot)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:3] == b[1:3]
            np.testing.assert_array_equal(a[3], b[3])
            if a[2]:
                for sched in (js, ps):
                    sched.record(slot, [1])
            _check_state(js, ps)
        jg, pg = js.admit_pass(), ps.admit_pass()
        _same_groups(jg, pg)
        for adm in (a for g in jg for a in g):
            if not adm.chunked:
                for sched in (js, ps):
                    sched.record(adm.slot, [1])
                if js.remaining(adm.slot) == 0:
                    finish(adm.slot)
        _check_state(js, ps)
        cmax = r.choice([1, 2, 4])
        jp, pp = js.plan_chunk(cmax), ps.plan_chunk(cmax)
        if jp is None:
            assert pp is None
            continue
        assert (jp.k, jp.slots, jp.victims, jp.grow) == (pp.k, pp.slots, pp.victims, pp.grow)
        assert [n.key for n in jp.evict_nodes] == [n.key for n in pp.evict_nodes]
        for v in jp.victims:
            a, b = js.preempt(v), ps.preempt(v)
            assert a.req.uid == b.req.uid
            preempted += 1
            _check_state(js, ps)
        if jp.evict_nodes:
            np.testing.assert_array_equal(js._commit_evict(jp.evict_nodes),
                                          ps._commit_evict(pp.evict_nodes))
            _check_state(js, ps)
        for slot, n_new in jp.grow:
            a, b = js.commit_grow(slot, n_new), ps.commit_grow(slot, n_new)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
            _check_state(js, ps)
        if jp.slots:
            for sched in (js, ps):
                sched.advance_decode(jp.k)
            for slot in jp.slots:
                for sched in (js, ps):
                    sched.record(slot, [1] * jp.k)
                if js.remaining(slot) == 0:
                    finish(slot)
            _check_state(js, ps)
    assert not feed and not js.has_work and not ps.has_work, "the loop did not drain"
    assert done == want
    assert js.preemptions == ps.preemptions == preempted
    assert js.pool.digest() == ps.pool.digest()
    held = 0 if js.prefix_cache is None else len(js.prefix_cache.nodes)
    assert js.free_pages == ps.free_pages == nb - held
