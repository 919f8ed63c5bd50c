"""Host-side data pipelines (counterpart of ``repro/data/pipeline.py``).

``PrefetchReader`` — a background-thread block prefetcher over a vector
file or array, so the partitioner's single disk pass (§V-A) overlaps I/O
with assignment work.  The reference's ``TokenPipeline`` comes with the
training slice.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


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
