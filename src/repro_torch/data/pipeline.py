"""Deterministic synthetic token pipeline.

Requirements it satisfies (the ones a real pipeline must):
  * deterministic & stateless-by-step: batch(step) is a pure function of
    (seed, step, shard) — restart/elastic-rescale resume needs no data
    state in the checkpoint beyond the step counter;
  * shardable: each data shard materializes only its slice;
  * prefetched: a background thread keeps ``prefetch`` batches ahead so
    host input never serializes with device steps (compute/IO overlap).

The token distribution is a Zipf-ish categorical over the vocab with a
deterministic per-(step, shard) PCG64 stream; labels are next-token.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    def __init__(self, cfg: DataConfig, *, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide across shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.PCG64(
            [cfg.seed, step, self.shard, 0xD1CE]))
        # zipf over vocab, clipped
        toks = rng.zipf(cfg.zipf_a, size=(self.local_batch, cfg.seq_len + 1))
        toks = (toks - 1) % cfg.vocab_size
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of ``source.batch(step)``."""

    def __init__(self, source: SyntheticLM, *, start_step: int = 0, prefetch: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
