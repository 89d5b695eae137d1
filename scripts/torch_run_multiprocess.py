#!/usr/bin/env python3
"""Multi-process CPU-mesh determinism battery for the port's paged engine
(the port's counterpart of ``scripts/run_multiprocess.py``).

    PYTHONPATH=src python scripts/torch_run_multiprocess.py --procs 2

The parent spawns ``--procs`` copies of this script, each an OS process
with one torch thread, joined in a gloo process group through a
``file://`` rendezvous (``--rdv DIR``, default a fresh temporary
directory), on a (procs // 2, 2) (data, model) mesh (``(procs,)`` when odd).
Each worker runs the battery:

1. serve a mixed trace (mid-flight admission through the ``_late`` hook,
   keyed on the pass index, never the wall clock) through a one-device
   engine and through the mesh engine;
2. hold every stream equal between the two;
3. hold the mesh engine's ``free_list``/``page_refcounts`` equal to the
   one-device engine's and to its host ``PoolState`` mirror;
4. gather a blake2b digest of (streams, free state, allocator) over every
   rank and hold all equal;
5. repeat on the int8-KV + prefix-cache engine, and on a tight pool whose
   watermark growth forces preempt-and-requeue (against a roomy FIFO pool).

Exit code 0 (and a last line ``... PASS``) only when every worker passes.
Workers import no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parent(args) -> int:
    rdv = args.rdv or tempfile.mkdtemp(prefix="torch_mp_")
    procs = []
    for rank in range(args.procs):
        env = dict(os.environ, REPRO_MP_ROLE="worker", REPRO_MP_RANK=str(rank),
                   REPRO_MP_NPROCS=str(args.procs),
                   REPRO_MP_INIT=f"file://{os.path.join(rdv, 'rendezvous')}")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
        procs.append(subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    rc = 0
    try:
        for rank, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                p.returncode = p.returncode or 124
            status = "ok" if p.returncode == 0 else f"FAILED rc={p.returncode}"
            print(f"[torch_run_multiprocess] worker {rank}: {status}")
            if p.returncode != 0 or args.verbose:
                print("\n".join(f"  [{rank}] {line}" for line in out.splitlines()[-40:]))
            rc = rc or p.returncode
    finally:
        for p in procs:
            p.kill()
    print(f"[torch_run_multiprocess] {'PASS' if rc == 0 else 'FAIL'}: {args.procs} processes "
          f"(gloo)")
    return rc


def worker() -> int:
    import hashlib

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_model
    from repro_torch.runtime import sharding as shardlib
    from repro_torch.runtime.collectives import gather_dim
    from repro_torch.serving import (
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
        SchedulerPolicy,
    )

    torch.set_num_threads(1)
    n = int(os.environ["REPRO_MP_NPROCS"])
    mesh = make_mesh((n // 2, 2) if n % 2 == 0 else (n,), device="cpu",
                     init_method=os.environ["REPRO_MP_INIT"],
                     rank=int(os.environ["REPRO_MP_RANK"]), world_size=n, timeout=120)
    rank = mesh.rank
    print(f"worker {rank}: mesh {mesh.shape}, coords {mesh.coords}")

    cfg = get_config("tiny-lm-xs").scaled(n_layers=2, vocab=128)
    model = init_model(cfg, 0, device="cpu")
    greedy = SamplerConfig(temperature=0.0)
    rng = np.random.default_rng(11)
    lens = [(8, 8, 0), (8, 6, 1), (16, 8, 0), (8, 12, 1), (24, 4, 0)]
    reqs = [Request(uid=u, prompt=rng.integers(0, 128, size=s).astype(np.int32), max_new=m,
                    priority=p) for u, (s, m, p) in enumerate(lens)]
    late = Request(uid=99, prompt=rng.integers(0, 128, size=8).astype(np.int32), max_new=6)

    def battery(tag: str, reqs=reqs, ref_pc=None, min_preempt=0, **pc_extra):
        pc = dict(block_size=8, num_blocks=18, max_concurrency=3, max_pages_per_seq=4,
                  chunk_max=4, attn_impl="auto")
        pc.update(pc_extra)

        def trace(engine):
            injected = []

            def _late(sched, pass_idx):
                if pass_idx == 1 and not injected:
                    sched.submit(Request(late.uid, late.prompt.copy(), late.max_new))
                    injected.append(True)

            return engine.serve([Request(r.uid, r.prompt.copy(), r.max_new, r.priority)
                                 for r in reqs], _late=_late)

        ref = PagedEngine(model, None, PagedConfig(**(ref_pc or pc)), greedy, device="cpu")
        want = trace(ref)
        eng = PagedEngine(model, None, PagedConfig(**pc), greedy, device="cpu", mesh=mesh)
        got = trace(eng)
        if ref_pc is None:
            assert eng.preemptions == ref.preemptions
        assert eng.preemptions >= min_preempt, \
            f"{tag}: wanted >= {min_preempt} preemptions, saw {eng.preemptions}"
        assert set(got) == set(want)
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid])
        h = hashlib.blake2b(digest_size=16)
        for uid in sorted(got):
            h.update(np.asarray(got[uid], np.int32).tobytes())
        for leaf in ("free_list", "page_refcounts"):
            dev = shardlib.host_read(eng.cache[leaf]).astype(np.int32)
            if ref_pc is None:  # same pool shape: equal free state
                np.testing.assert_array_equal(dev, shardlib.host_read(ref.cache[leaf]))
            h.update(dev.tobytes())
        np.testing.assert_array_equal(shardlib.host_read(eng.cache["free_list"]),
                                      eng.pool_state.free_list)
        h.update(eng.pool_state.digest().encode())
        eng.assert_sampling_keys_collective_safe()
        local = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)
        every = gather_dim(local[None], 0, mesh, mesh.axis_names)
        for other in range(every.shape[0]):
            assert torch.equal(every[other], every[0]), f"{tag}: rank {other} diverged"
        print(f"worker {rank}: {tag} ok (digest {h.hexdigest()}, "
              f"preemptions={eng.preemptions}, step {eng.step_mode})")

    battery("float+throughput",
            sched=SchedulerPolicy(admit_window=4, batch_max=2, prefill_chunk=8,
                                  watermark=(3, 6)))
    battery("int8+prefix", kv_dtype="int8", prefix_cache=True)
    grow = [Request(uid=50 + u, prompt=rng.integers(0, 128, size=8).astype(np.int32),
                    max_new=24, priority=p) for u, p in enumerate([0, 1, 1])]
    battery("watermark-preempt", reqs=grow, min_preempt=1,
            ref_pc=dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4,
                        chunk_max=4, attn_impl="auto"),
            num_blocks=6, sched=SchedulerPolicy(admit_window=2, watermark=(1, 4)))
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"worker {rank}: PASS")
    return 0


def main(argv=None) -> int:
    if os.environ.get("REPRO_MP_ROLE") == "worker":
        return worker()
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--rdv", type=str, default=None,
                    help="directory for the file:// rendezvous (default: a fresh temp dir)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.procs < 2:
        raise SystemExit("--procs must be >= 2 (that is the point)")
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
