"""Host-side data pipelines (counterpart of ``repro/data/pipeline.py``).

* ``TokenPipeline`` — deterministic synthetic LM token stream with
  **seek-to-step** (after a checkpoint restore the pipeline resumes at
  exactly ``step × global_batch`` sequences, no replay or skip) and
  per-host sharding.  A copy of the reference's numpy generator, so both
  packages give the same batches element for element.
* ``PrefetchReader`` — a background-thread block prefetcher over a vector
  file or array, so the partitioner's single disk pass (§V-A) overlaps I/O
  with assignment work.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    """Synthetic LM stream: per-sequence PRNG keyed by (seed, global index)
    so any (step, host) slice is reproducible without global state."""

    def __init__(self, cfg: TokenPipelineConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.per_host = cfg.global_batch // cfg.n_hosts
        self._step = 0

    @property
    def step(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        self._step = int(step)

    def _sequence(self, global_idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, global_idx))
        # Zipf-ish marginals + short-range structure: enough signal that a
        # model trained a few hundred steps visibly drops its loss.
        base = rng.zipf(1.3, self.cfg.seq_len + 1)
        tok = np.minimum(base, self.cfg.vocab_size - 1).astype(np.int32)
        rep = rng.random(self.cfg.seq_len + 1) < 0.3
        tok[1:][rep[1:]] = tok[:-1][rep[1:]]  # 30% copy-previous
        return tok

    def next_batch(self) -> dict:
        s = self._step
        start = s * self.cfg.global_batch + self.cfg.host_id * self.per_host
        seqs = np.stack(
            [self._sequence(start + i) for i in range(self.per_host)]
        )
        self._step += 1
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class PrefetchReader:
    """Iterate [block_size, D] blocks with a background prefetch thread."""

    def __init__(self, data: np.ndarray, block_size: int, depth: int = 2):
        self.data = data
        self.block_size = block_size
        self.depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        n = len(self.data)

        def worker():
            for s in range(0, n, self.block_size):
                q.put(np.asarray(self.data[s : s + self.block_size]))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            block = q.get()
            if block is None:
                break
            yield block
        t.join()
