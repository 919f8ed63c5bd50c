"""Exact k nearest neighbours and the numbers an answer list is judged by.

A query's exact neighbours are taken in two steps: candidates by the L2
expansion ``|q|^2 + |x|^2 - 2 q.x`` as a float32 matrix product (TF32 off),
then those candidates re-ranked by float64 distances computed directly, so
the float32 expansion's rounding decides nothing.  ``tf32=True`` is the
control: the same search computed in TF32, the precision just below the
float32 that the configurations state, with no float64 re-rank.  TF32 is
taken as the tensor cores take it: each float32 input of the product
rounded to 10 mantissa bits (:func:`round_tf32`), products summed in
float32, so the control reads the same on the CPU as on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for float32 matrix products while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest and
    ties away from zero, as the tensor cores read their inputs."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def knn_tf32(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2"):
    """The control of a build: exact kNN with its product in TF32,
    ``([M, k] squared L2 distances, [M, k] ids)`` ascending, the form of
    the program's kNN kernel, to put in that kernel's place."""
    if metric != "l2":
        raise ValueError(f"the control is of L2 builds, not {metric!r}")
    q, x = q.float(), x.float()
    with matmul_precision(True):
        d = ((q * q).sum(dim=1)[:, None] + (x * x).sum(dim=1)[None, :]
             - 2.0 * (round_tf32(q) @ round_tf32(x).T)).clamp_min(0.0)
    return torch.topk(d, k, dim=1, largest=False, sorted=True)


def exact_knn(data: np.ndarray, queries: np.ndarray, k: int, *, device,
              block: int = 2048, extra: int = 22,
              tf32: bool = False) -> np.ndarray:
    """``[Q, k]`` int64 ids of each query's exact L2 neighbours, ascending
    by distance (ties by id)."""
    dev = torch.device(device)
    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev)
    xn = (x * x).sum(dim=1)
    xt = round_tf32(x) if tf32 else x
    m = min(k + (0 if tf32 else extra), len(data))
    out = []
    with matmul_precision(tf32):
        for s in range(0, len(queries), block):
            q = torch.from_numpy(np.ascontiguousarray(
                queries[s:s + block], np.float32)).to(dev)
            qx = (round_tf32(q) if tf32 else q) @ xt.T
            d = (q * q).sum(dim=1)[:, None] + xn[None, :] - 2.0 * qx
            cand = torch.topk(d, m, dim=1, largest=False, sorted=True).indices
            if not tf32:
                exact = distances64(x, q, cand)
                cand = cand.gather(1, _order(exact, cand))
            out.append(cand[:, :k].cpu())
    if not out:
        return np.empty((0, k), np.int64)
    return torch.cat(out).numpy().astype(np.int64)


def distances64(x: torch.Tensor, q: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """float64 squared L2 distance of each query to each of its ids."""
    diff = x[ids].double() - q.double()[:, None, :]
    return (diff * diff).sum(dim=2)


def _order(dist: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per row, the order that sorts by (distance, id)."""
    o1 = torch.argsort(ids, dim=1, stable=True)
    o2 = torch.argsort(dist.gather(1, o1), dim=1, stable=True)
    return o1.gather(1, o2)


def recall(found: np.ndarray, truth: np.ndarray, k: int) -> float:
    """recall@k: the share of each query's k true neighbours found in its
    first k answers, averaged over queries (the BIGANN definition)."""
    if len(truth) == 0:
        return 0.0
    f, t = found[:, :k], truth[:, :k]
    hits = (t[:, :, None] == f[:, None, :]).any(axis=2)
    return float(hits.sum() / (len(t) * k))


def invalid_ids(ids: np.ndarray, n: int) -> int:
    """Answer slots that name no point (-1, out of range) or repeat an id
    already in their row."""
    ids = np.asarray(ids)
    bad = int(((ids < 0) | (ids >= n)).sum())
    srt = np.sort(ids, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    return bad + int(dup.sum())


def order_gap(data: np.ndarray, queries: np.ndarray, ids: np.ndarray, *,
              device, block: int = 4096) -> float:
    """The widest inversion in the answers' order: over every pair of
    neighbouring answers of a row, how far the earlier one's exact distance
    lies above the later one's, as a share of the later one's.  An answer
    list that comes sorted by exact float32 distances reads its rounding."""
    dev = torch.device(device)
    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev)
    worst = 0.0
    n = len(data)
    for s in range(0, len(queries), block):
        i = torch.from_numpy(np.asarray(ids[s:s + block], np.int64)).to(dev)
        ok = (i >= 0) & (i < n)
        q = torch.from_numpy(np.ascontiguousarray(
            queries[s:s + block], np.float32)).to(dev)
        d = distances64(x, q, i.clamp(0, n - 1))
        pair = ok[:, 1:] & ok[:, :-1]
        gap = (d[:, :-1] - d[:, 1:]) / d[:, 1:].clamp_min(1e-30)
        gap = torch.where(pair, gap, torch.zeros_like(gap))
        if gap.numel():
            worst = max(worst, float(gap.max()))
    return worst
