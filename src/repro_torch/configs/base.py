"""ScaleGANN index-build config (counterpart of ``repro/configs/base.py``'s
``IndexConfig``; the paper's own knobs, §IV–V)."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Paper knobs. Defaults follow §VI (R=64, L=128, ε=1.2, ω=2)."""

    n_clusters: int = 16
    degree: int = 64  # R — final graph degree
    build_degree: int = 128  # L — intermediate kNN-graph degree
    epsilon: float = 1.2  # ε — selective-replication pruning strength
    omega: int = 2  # ω — max clusters a vector may appear in
    tau0: float = 2.0  # τ schedule: tau0 → 1.0 as blocks are processed
    theta: float = 0.35  # base replica-space fraction per cluster
    block_size: int = 8192  # disk-block size (vectors per block)
    kmeans_iters: int = 12
    kmeans_sample: int = 65536  # centroids trained on a sample (DiskANN-style)
    capacity_slack: float = 1.25  # cluster capacity = slack * N / k
    nn_descent_iters: int = 8
    metric: str = "l2"  # l2 | ip
    seed: int = 0

    def tau(self, block_idx: int, n_blocks: int) -> float:
        """Dynamic radius correction: large early, →1.0 by the last block."""
        if not math.isfinite(self.tau0):  # selective=False: pruning disabled
            return self.tau0
        if n_blocks <= 1:
            return 1.0
        frac = block_idx / (n_blocks - 1)
        return float(self.tau0 + (1.0 - self.tau0) * frac)
