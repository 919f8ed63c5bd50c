"""Sampled Lloyd's k-means for shard centroids (counterpart of
``repro/core/kmeans.py``; paper §IV step 1).

The sample and the initial centroids are drawn with numpy from the seed
exactly as the reference draws them; each Lloyd step's assignment tile is
:func:`repro_torch.kernels.ops.pairwise_distance` (K1 on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def _lloyd(x: torch.Tensor, init: torch.Tensor, k: int, iters: int):
    centroids = init
    assign = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
    for _ in range(iters):
        d = ops.pairwise_distance(x, centroids, "l2")
        assign = torch.argmin(d, dim=1)
        # the one-hot product keeps the sums in a fixed order, where
        # index_add_'s atomics on the card would reorder them run to run
        one_hot = F.one_hot(assign, k).to(x.dtype)  # [N, k]
        sums = one_hot.T @ x  # [k, D]
        counts = one_hot.sum(dim=0)[:, None]  # [k, 1]
        new = sums / counts.clamp_min(1.0)
        # empty clusters: re-seed at the point farthest from its centroid
        far = torch.argmax(d.min(dim=1).values)
        empty = counts[:, 0] < 0.5
        centroids = torch.where(empty[:, None], x[far][None, :], new)
    return centroids, assign


def train_centroids(
    data: np.ndarray, k: int, *, iters: int = 12, sample: int = 65536,
    seed: int = 0, device=None,
) -> np.ndarray:
    """Train k centroids on a uniform sample of `data` ([N, D] float-like)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    if n > sample:
        idx = rng.choice(n, size=sample, replace=False)
        x = np.asarray(data[np.sort(idx)], dtype=np.float32)
    else:
        x = np.array(data, dtype=np.float32)  # a copy: data may be a memmap
    if x.shape[0] < k:
        raise ValueError(f"need at least k={k} points, got {x.shape[0]}")
    init = x[rng.choice(x.shape[0], size=k, replace=False)]
    centroids, _ = _lloyd(torch.from_numpy(np.ascontiguousarray(x)).to(dev),
                          torch.from_numpy(init).to(dev), k, iters)
    return centroids.cpu().numpy()


def kmeans_cost(data: np.ndarray, centroids: np.ndarray, *,
                device=None) -> float:
    """Mean squared distance of every point to its nearest centroid (the
    [N, k] tile is K1 on the card)."""
    dev = resolve_device(device)
    d = ops.pairwise_distance(
        torch.tensor(np.asarray(data, np.float32), device=dev),
        torch.tensor(np.asarray(centroids, np.float32), device=dev), "l2")
    return float(d.min(dim=1).values.mean())
