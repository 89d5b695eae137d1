"""Training launcher with fault tolerance (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm-xs \
        --steps 80 --batch 8 --seq 64 --ckpt-dir /tmp/run1 --device cpu

One device. As in the reference:
  * periodic async checkpoints (``--ckpt-every``) and an emergency
    checkpoint on SIGTERM/SIGINT;
  * resume from the latest checkpoint under ``--ckpt-dir`` (the data
    pipeline's batch ``i`` is a pure function of ``i``, so a resumed run
    continues the interrupted one);
  * a straggler watermark: a step slower than ``factor`` x the running
    median is logged.

Checkpoints hold the reference's train-state tree (``params``, ``opt.m``,
``opt.v``, ``opt.step``) under its leaf names, so either package's
trainer resumes from the other's and ``--ckpt-dir`` of either package's
``quantize``, ``search`` and ``serve`` restores the trained ``params``.
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
from repro_torch.runtime import TrainRunConfig, init_train_state, make_train_step


class StragglerMonitor:
    def __init__(self, factor: float = 2.0, window: int = 50):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.flagged = 0

    def record(self, dt: float, step: int) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            med = statistics.median(hist)
            if dt > self.factor * med:
                self.flagged += 1
                print(f"[straggler] step {step}: {dt*1e3:.0f}ms vs median "
                      f"{med*1e3:.0f}ms (proc 0)")
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


def main(argv=None, *, monitor: StragglerMonitor | None = None):
    """Train; returns (state, losses). ``monitor`` (default: a new one)
    records each step's host-clock time."""
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
    print(f"[train] arch={cfg.name} device={device} batch={args.batch}x{args.seq}")

    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.batch, seed=args.seed))
    state = init_train_state(cfg, run, args.seed, device=device)
    step_fn = make_train_step(cfg, run)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        restored = ckpt.restore_latest(train_state_tree(state, spec=True), device=device)
        if restored is not None:
            start_step, tree, _ = restored
            load_train_state_(state, tree)
            print(f"[train] resumed from step {start_step}")

    # preemption safety: emergency checkpoint on SIGTERM/SIGINT
    stop = {"now": False}

    def _sig(_s, _f):
        stop["now"] = True

    old_term = signal.signal(signal.SIGTERM, _sig)
    old_int = signal.signal(signal.SIGINT, _sig)

    monitor = monitor if monitor is not None else StragglerMonitor()
    losses = []
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
                    print(f"[train] step {step} loss {loss:.4f} "
                          f"ppl {float(metrics['ppl']):.2f} "
                          f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
                if ckpt and (step + 1) % args.ckpt_every == 0:
                    ckpt.save(step + 1, train_state_tree(state), {"loss": loss})
                if stop["now"]:
                    print(f"[train] signal received: emergency checkpoint @ {step+1}")
                    if ckpt:
                        ckpt.save(step + 1, train_state_tree(state), {"loss": loss},
                                  blocking=True)
                    break
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        if ckpt:
            if not stop["now"]:
                ckpt.save(args.steps, train_state_tree(state),
                          {"loss": losses[-1] if losses else None}, blocking=True)
            ckpt.wait()

    if losses:
        k = max(len(losses) // 10, 1)
        print(f"[train] first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
              f"last-{k} mean {np.mean(losses[-k:]):.4f}")
    return state, losses


if __name__ == "__main__":
    main()
