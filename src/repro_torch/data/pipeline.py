"""Deterministic, checkpointable data pipeline (port of
``repro/data/pipeline.py``).

Pure numpy, so the port keeps an exact copy: the port and the JAX package
draw identical prompts and batches from the same seed.

Two sources:
  * :class:`SyntheticMarkovSource` — a fixed random Markov-chain "teacher"
    over the vocabulary (low-entropy, learnable structure). A model trained
    on it shows genuine loss decrease and meaningful perplexity, which is
    what the paper-reproduction benchmarks need in an offline container.
  * :class:`FileTokenSource` — memory-mapped binary token file (uint16/32),
    the production path.

:class:`TokenBatcher` handles per-host sharding (each host materializes only
its slice of the global batch) and O(1) skip-ahead on restart: batch index i
is a pure function of (seed, i), so resuming from a checkpointed step never
replays or skips data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | file
    path: str | None = None
    branching: int = 4  # synthetic: candidate successors per state (lower = easier)


class SyntheticMarkovSource:
    """Order-1 Markov teacher: each token has ``branching`` plausible
    successors with Zipf-ish probabilities, derived deterministically from
    the seed. Entropy ~ log(branching) nats < log(vocab): learnable."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        probs = 1.0 / np.arange(1, branching + 1)
        self.probs = probs / probs.sum()

    def sample(self, n_seqs: int, seq_len: int, rng: np.random.Generator) -> np.ndarray:
        toks = np.empty((n_seqs, seq_len), np.int32)
        state = rng.integers(0, self.vocab, size=n_seqs)
        toks[:, 0] = state
        for t in range(1, seq_len):
            choice = rng.choice(len(self.probs), size=n_seqs, p=self.probs)
            state = self.succ[state, choice]
            toks[:, t] = state
        return toks


class FileTokenSource:
    """Memory-mapped flat token file; random crops per batch index."""

    def __init__(self, path: str, vocab: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab

    def sample(self, n_seqs: int, seq_len: int, rng: np.random.Generator) -> np.ndarray:
        hi = len(self.tokens) - seq_len - 1
        starts = rng.integers(0, hi, size=n_seqs)
        return np.stack(
            [self.tokens[s : s + seq_len].astype(np.int32) for s in starts]
        )


def make_source(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticMarkovSource(cfg.vocab, cfg.seed, cfg.branching)
    if cfg.source == "file":
        return FileTokenSource(cfg.path, cfg.vocab)
    raise ValueError(f"unknown source {cfg.source!r}")


class TokenBatcher:
    """Stateless-per-index batcher: ``batch(i)`` is a pure function of
    (seed, i, host slice) — restart-safe and elastically reshardable (a
    restart on a different host count slices the same global batch
    differently but identically in content)."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1):
        self.cfg = cfg
        self.source = make_source(cfg)
        if cfg.global_batch % host_count:
            raise ValueError("global batch must divide host count")
        self.per_host = cfg.global_batch // host_count
        self.host_index = host_index

    def batch(self, index: int) -> dict:
        rng = np.random.default_rng((self.cfg.seed, index))
        full = self.source.sample(self.cfg.global_batch, self.cfg.seq_len, rng)
        lo = self.host_index * self.per_host
        return {"tokens": full[lo : lo + self.per_host]}

    def eval_batches(self, n: int, offset: int = 1_000_000):
        for i in range(n):
            yield self.batch(offset + i)
