"""Training launcher with fault tolerance (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm-xs \
        --steps 80 --batch 8 --seq 64 --ckpt-dir /tmp/run1 --device cpu

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch tiny-lm-xs --steps 80 --batch 8 --seq 64 --ckpt-dir /tmp/run1 --device cpu

Under a distributed environment (``torchrun``: ``WORLD_SIZE`` > 1, or a
default process group of more than one rank already made) the ranks train
on ``make_host_mesh()``, every rank on the data axis, as the reference's
launcher trains on its host mesh: the train state is placed by
``train_state_shardings`` (each rank holding its slice of the parameters
and moments), each rank draws its rows of the global batch
(``TokenBatcher(host_index, host_count)``), and the loss is the global
batch's. Rank 0 alone prints the loss lines; a straggler line names its
rank. Without one it is the one-device loop. As in the reference:
  * periodic async checkpoints (``--ckpt-every``) and an emergency
    checkpoint on SIGTERM/SIGINT (on a mesh the ranks agree on the stop
    each step, a MAX all-reduce of the flag, so they stop at one step);
  * resume from the latest checkpoint under ``--ckpt-dir`` (the data
    pipeline's batch ``i`` is a pure function of ``i``, so a resumed run
    continues the interrupted one), on any mesh;
  * a straggler watermark: a step slower than ``factor`` x the running
    median is logged.
The summary line ends, on CUDA, with rank 0's peak device memory
(``torch.cuda.max_memory_allocated``) in the training loop, and while the
state was built, placed and restored before it. The
config decides ``remat``, as in the reference: smollm-360m's ``"block"``
recomputes each layer in the backward.

Checkpoints hold the reference's train-state tree (``params``, ``opt.m``,
``opt.v``, ``opt.step``) under its leaf names, whole leaves on a mesh too
(gathered; rank 0 writes, then the ranks meet at a barrier), so either
package's trainer resumes from the other's on any number of ranks and
``--ckpt-dir`` of either package's ``quantize``, ``search`` and
``serve`` restores the trained ``params``.
``--float32`` trains an f32 copy of a bfloat16 configuration (the form
calibration takes). On CUDA the loop runs with deterministic algorithms,
so a resumed run repeats the uninterrupted one bit for bit (the
embedding's backward may otherwise sum a row's contributions in a
varying order). ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import os
import signal
import statistics
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import load_train_state_, train_state_tree
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime import (
    TrainRunConfig,
    init_train_state,
    make_train_step,
    place_train_state,
)


class StragglerMonitor:
    def __init__(self, factor: float = 2.0, window: int = 50, rank: int = 0):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.flagged = 0
        self.rank = rank

    def record(self, dt: float, step: int) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            med = statistics.median(hist)
            if dt > self.factor * med:
                self.flagged += 1
                print(f"[straggler] step {step}: {dt*1e3:.0f}ms vs median "
                      f"{med*1e3:.0f}ms (proc {self.rank})")
                return True
        return False


class _deterministic:
    """Deterministic algorithms for the enclosed loop on CUDA (cuBLAS
    needs a fixed workspace for them), the previous setting restored."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"

    def __enter__(self):
        if self.on:
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            self.prev = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        if self.on:
            torch.use_deterministic_algorithms(self.prev)
        return False


def _distributed() -> bool:
    """Whether this process is one of several ranks."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def main(argv=None, *, monitor: StragglerMonitor | None = None):
    """Train; returns (state, losses). ``monitor`` (default: a new one)
    records each step's host-clock time. On a mesh the state is this
    rank's placed one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--float32", action="store_true",
                    help="train an f32 copy of the configuration")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.float32:
        from repro_torch.launch.search import f32_config

        cfg = f32_config(cfg)
    cfg = cfg.scaled(max_seq_len=max(cfg.max_seq_len, args.seq))
    run = TrainRunConfig(
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps),
        num_microbatches=args.microbatches,
    )
    mesh = None
    if _distributed():
        from repro_torch.launch.mesh import make_host_mesh

        # a bare "cuda" leaves each rank its own card (cuda:LOCAL_RANK)
        mesh = make_host_mesh(device=None if device == torch.device("cuda") else device)
        device = mesh.device
    rank, world = (mesh.rank, mesh.size) if mesh else (0, 1)
    say = print if rank == 0 else (lambda *a, **k: None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    say(f"[train] arch={cfg.name} device={device} batch={args.batch}x{args.seq}"
        + (f" mesh={mesh.shape} ({mesh.backend})" if mesh else ""))

    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.batch, seed=args.seed),
                        host_index=rank, host_count=world)
    state = init_train_state(cfg, run, args.seed, device=device)
    if mesh:
        state = place_train_state(state, mesh)
    step_fn = make_train_step(cfg, run, mesh)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        restored = ckpt.restore_latest(train_state_tree(state, spec=True), device=device)
        if restored is not None:
            start_step, tree, _ = restored
            load_train_state_(state, tree)
            say(f"[train] resumed from step {start_step}")

    def save(step: int, loss, blocking: bool = False) -> None:
        tree = train_state_tree(state)  # on a mesh a gather every rank joins
        if rank == 0:
            ckpt.save(step, tree, {"loss": loss}, blocking=blocking)
        if mesh:
            import torch.distributed as dist

            dist.barrier()

    # preemption safety: emergency checkpoint on SIGTERM/SIGINT
    stop = {"now": False}

    def _sig(_s, _f):
        stop["now"] = True

    old_term = signal.signal(signal.SIGTERM, _sig)
    old_int = signal.signal(signal.SIGINT, _sig)

    def stopping() -> bool:
        """The stop flag, on a mesh agreed by every rank."""
        if not mesh:
            return stop["now"]
        from repro_torch.runtime.collectives import all_reduce_max

        flag = torch.tensor([int(stop["now"])], dtype=torch.int32, device=device)
        stop["now"] = bool(all_reduce_max(flag, mesh, mesh.axis_names).item())
        return stop["now"]

    monitor = monitor if monitor is not None else StragglerMonitor(rank=rank)
    losses = []
    if device.type == "cuda":  # the loop's peak from here; the state's build before
        built_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    try:
        with _deterministic(device):
            for step in range(start_step, args.steps):
                batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                         for k, v in data.batch(step).items()}
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])  # a host read: also the step timer
                dt = time.perf_counter() - t0
                monitor.record(dt, step)
                losses.append(loss)
                if step % args.log_every == 0:
                    say(f"[train] step {step} loss {loss:.4f} "
                        f"ppl {float(metrics['ppl']):.2f} "
                        f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
                if ckpt and (step + 1) % args.ckpt_every == 0:
                    save(step + 1, loss)
                if stopping():
                    say(f"[train] signal received: emergency checkpoint @ {step+1}")
                    if ckpt:
                        save(step + 1, loss, blocking=True)
                    break
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        if ckpt:
            if not stop["now"]:
                save(args.steps, losses[-1] if losses else None, blocking=True)
            ckpt.wait()

    if losses:
        k = max(len(losses) // 10, 1)
        peak = (f"; peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} "
                f"MiB on rank {rank} in the loop ({built_peak / 2**20:.1f} MiB building and "
                f"placing the state)" if device.type == "cuda" else "")
        say(f"[train] first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
            f"last-{k} mean {np.mean(losses[-k:]):.4f}{peak}")
    return state, losses


if __name__ == "__main__":
    main()
