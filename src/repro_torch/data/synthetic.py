"""Synthetic clustered vector datasets (counterpart of
``repro/data/synthetic.py``).

The vectors are drawn with numpy from the seed exactly as the reference
draws them, so both packages see the same data; the exact ground truth
runs through :func:`repro_torch.kernels.ops.knn` on the chosen device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    data: np.ndarray  # [N, D]
    queries: np.ndarray  # [Q, D]
    gt: np.ndarray  # [Q, k] exact nearest ids (ascending distance)
    metric: str = "l2"


def make_clustered(
    n: int,
    d: int,
    *,
    n_queries: int = 100,
    gt_k: int = 10,
    n_true_clusters: int = 24,
    dtype: str = "float32",
    spread: float = 0.35,
    seed: int = 0,
    metric: str = "l2",
    name: str | None = None,
    device=None,
) -> Dataset:
    """Mixture-of-Gaussians dataset + held-out queries + exact ground truth
    (computed on ``device``: the card unless ``"cpu"`` is given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_true_clusters, d)).astype(np.float32)
    weights = rng.pareto(1.5, n_true_clusters) + 0.2
    weights /= weights.sum()
    assign = rng.choice(n_true_clusters, size=n, p=weights)
    data = centers[assign] + spread * rng.normal(size=(n, d)).astype(np.float32)
    q_assign = rng.choice(n_true_clusters, size=n_queries, p=weights)
    queries = centers[q_assign] + spread * rng.normal(
        size=(n_queries, d)
    ).astype(np.float32)
    if dtype == "uint8":
        lo, hi = data.min(), data.max()
        data = np.clip(np.round((data - lo) / (hi - lo) * 255),
                       0, 255).astype(np.uint8)
        queries = np.clip(np.round((queries - lo) / (hi - lo) * 255),
                          0, 255).astype(np.uint8)
    gt = exact_ground_truth(data, queries, gt_k, metric, device=dev)
    return Dataset(
        name=name or f"synthetic_{n}x{d}_{dtype}",
        data=data,
        queries=queries,
        gt=gt,
        metric=metric,
    )


def exact_ground_truth(
    data: np.ndarray, queries: np.ndarray, k: int, metric: str = "l2",
    block: int = 4096, *, device=None,
) -> np.ndarray:
    """Exact kNN ids per query (row-blocked to bound memory)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev)
    out = []
    for s in range(0, len(queries), block):
        q = torch.from_numpy(
            np.ascontiguousarray(queries[s: s + block], np.float32)).to(dev)
        _, idx = ops.knn(q, x, k, metric)
        out.append(idx.cpu().numpy())
    if not out:
        return np.empty((0, k), np.int64)
    return np.concatenate(out).astype(np.int64)


def recall_at(found_ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """recall@k: |found ∩ gt| / k averaged over queries (bigann definition)."""
    hits = 0
    for f, g in zip(found_ids[:, :k], gt[:, :k]):
        hits += len(set(f.tolist()) & set(g.tolist()))
    return hits / (len(gt) * k)


def near_tie_breaks(queries, data, got, want, *, rtol: float,
                    atol: float = 0.0, metric: str = "l2") -> torch.Tensor:
    """Where two id lists of one search disagree by more than a near-tie:
    a bool tensor shaped like ``got``, True at each position whose ids
    differ and either one is -1 (a missing result) or their exact float64
    distances to the row's query differ by more than ``atol + rtol ·
    |d(want)|``.  A summation order may flip a near-tie, so lists that
    differ at no True position answer the queries alike.  Tensors (on the
    device of ``got``) or numpy arrays."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    dev = got.device
    q = torch.as_tensor(queries).to(dev)
    x = torch.as_tensor(data).to(dev)
    want = want.to(dev)
    out = torch.zeros(got.shape, dtype=torch.bool, device=dev)
    rows, cols = torch.nonzero(got != want, as_tuple=True)
    if rows.numel() == 0:
        return out
    a, b = got[rows, cols].long(), want[rows, cols].long()
    missing = (a < 0) | (b < 0)
    xa, xb = x[a.clamp_min(0)].double(), x[b.clamp_min(0)].double()
    qd = q[rows].double()
    if metric == "ip":
        da, db = -(xa * qd).sum(dim=1), -(xb * qd).sum(dim=1)
    else:
        da, db = ((xa - qd) ** 2).sum(dim=1), ((xb - qd) ** 2).sum(dim=1)
    out[rows, cols] = missing | ((da - db).abs() > atol + rtol * db.abs())
    return out


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    dim: int
    dtype: str

    @property
    def bytes_total(self) -> int:
        return self.n * self.dim * np.dtype(self.dtype).itemsize


PAPER_DATASETS = {
    "sift100m": DatasetSpec("sift100m", 100_000_000, 128, "uint8"),
    "deep100m": DatasetSpec("deep100m", 100_000_000, 96, "float32"),
    "msturing100m": DatasetSpec("msturing100m", 100_000_000, 100, "float32"),
    "laion100m": DatasetSpec("laion100m", 100_000_000, 768, "float32"),
    "sift1b": DatasetSpec("sift1b", 1_000_000_000, 128, "uint8"),
}
