"""Deterministic, shardable synthetic LM data pipeline: the port's own copy
of ``repro.data.pipeline`` (numpy only; the port imports nothing of the
JAX package). ``batch_at`` and ``DataLoader`` give the reference's tokens
bit for bit.

Design goals of a production pipeline kept intact at miniature scale:
  * deterministic per (seed, step) — restart-safe batch replay (fault
    tolerance: a restarted trainer regenerates the exact batch stream);
  * host-shardable — each data-parallel host materializes only its slice;
  * prefetchable — an iterator with a bounded lookahead buffer.

The token source is a mixture of (i) a repeating Zipf-distributed unigram
stream and (ii) short arithmetic "documents" (so a ~100M model visibly
learns structure within a few hundred steps).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _batch_tokens(cfg: DataConfig, step: int, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of the global batch for `step`. Deterministic."""
    rows = []
    for r in range(lo, hi):
        rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % 2**31
                                    ^ (r * 2_654_435_761 % 2**31))
        # zipf unigrams, clipped into vocab
        toks = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1)
        toks = np.clip(toks, 1, cfg.vocab_size - 1)
        # splice in arithmetic spans: "a b a+b" patterns over small ids
        n_spans = cfg.seq_len // 64
        for _ in range(n_spans):
            p = rng.randint(0, cfg.seq_len - 3)
            a, b = rng.randint(2, 50, size=2)
            toks[p:p + 3] = [a, b, (a + b) % cfg.vocab_size]
        rows.append(toks)
    return np.stack(rows).astype(np.int32)


class DataLoader:
    """Iterator of {'tokens': (local_batch, seq+1)} with prefetch."""

    def __init__(self, cfg: DataConfig, *, host_index: int = 0,
                 host_count: int = 1, start_step: int = 0,
                 prefetch: int = 2, extra_specs: Optional[Dict] = None):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.local = cfg.global_batch // host_count
        self.lo = host_index * self.local
        self.step = start_step
        self.extra_specs = extra_specs or {}
        self._q: Queue = Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        batch = {"tokens": _batch_tokens(self.cfg, step, self.lo,
                                         self.lo + self.local)}
        for name, (shape, dtype) in self.extra_specs.items():
            rng = np.random.RandomState(step % 2**31)
            batch[name] = rng.randn(self.local, *shape).astype(dtype)
        return batch

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.5)
                step += 1
            except Exception:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Whole global batch for a step (tests / single-host)."""
    return {"tokens": _batch_tokens(cfg, step, 0, cfg.global_batch)}
