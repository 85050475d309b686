"""Training data pipeline (port of ``repro.train.data``): deterministic
sharded token streams and a prefetcher.

Numpy, as the reference's; the port keeps its own copy so that it imports
nothing of ``repro``. Batches are bit-equal to the reference's for the same
(seed, host_id, step).

  * ``SyntheticLM`` — a deterministic PRNG token stream (a noisy copy /
    induction pattern, so the loss can go down), seeded per (step, host) so
    every data-parallel worker reads a disjoint slice without coordination.
  * ``MemmapLM``   — a flat uint16 / uint32 token file, strided per host.

``Prefetcher`` overlaps host batch assembly with device compute (one
background thread, a bounded queue).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Induction-pattern synthetic LM data: predictable continuation."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0):
        assert global_batch % num_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, step]))
        b, s = self.local_batch, self.seq
        period = 8
        motif = rng.integers(0, self.vocab, (b, period))
        reps = -(-(s + 1) // period)
        toks = np.tile(motif, (1, reps))[:, : s + 1]
        noise = rng.random((b, s + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, self.vocab, (b, s + 1)), toks)
        return dict(tokens=toks[:, :-1].astype(np.int32),
                    labels=toks[:, 1:].astype(np.int32))

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """Flat token-file reader; hosts stride disjointly."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 dtype=np.uint16, num_hosts: int = 1, host_id: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.tokens_per_step = global_batch * (seq_len + 1)

    def batch_at(self, step: int) -> dict:
        n = self.data.shape[0]
        start = (step * self.tokens_per_step
                 + self.host_id * self.local_batch * (self.seq + 1)) % max(
                     n - self.local_batch * (self.seq + 1), 1)
        flat = np.asarray(self.data[start: start + self.local_batch
                                    * (self.seq + 1)]).astype(np.int32)
        toks = flat.reshape(self.local_batch, self.seq + 1)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch; .close() joins the worker."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2)
