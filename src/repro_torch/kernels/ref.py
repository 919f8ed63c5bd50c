"""Plain PyTorch versions of the hand-written kernels (counterpart of
``repro/kernels/ref.py``).

They are the CPU execution path, and the card compares each CUDA kernel
with them.  Every function works on CPU and CUDA tensors alike and keeps
the reference's arithmetic: f32 accumulation (no TF32), integer-exact
uint8 code products, and ``lax.top_k``'s (value, index) tie rule through a
stable sort.
"""

from __future__ import annotations

import torch


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances. q: [M, D], x: [N, D] -> [M, N] (float32)."""
    q = q.float()
    x = x.float()
    qn = (q * q).sum(dim=-1, keepdim=True)
    xn = (x * x).sum(dim=-1)[None, :]
    return (qn + xn - 2.0 * (q @ x.T)).clamp_min(0.0)


def pairwise_ip(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negative inner product (so that smaller == closer). -> [M, N]."""
    return -(q.float() @ x.float().T)


def pairwise_distance(q, x, metric: str = "l2") -> torch.Tensor:
    if metric == "l2":
        return pairwise_l2(q, x)
    if metric == "ip":
        return pairwise_ip(q, x)
    raise ValueError(f"unknown metric {metric!r}")


def code_dots(cq: torch.Tensor, cx: torch.Tensor) -> torch.Tensor:
    """Exact integer dot products of uint8 code rows, [M, N] int64.  Every
    product and partial sum is an integer below 2^53, so the float64 matmul
    is exact in any summation order, on the CPU and on the card."""
    return (cq.double() @ cx.double().T).round().long()


def pairwise_l2_u8(cq: torch.Tensor, cx: torch.Tensor, scale) -> torch.Tensor:
    """Squared L2 from shared-spec uint8 codes: ``scale² · ‖cq − cx‖²``."""
    qi = cq.long()
    xi = cx.long()
    qn = (qi * qi).sum(dim=-1, keepdim=True)
    xn = (xi * xi).sum(dim=-1)[None, :]
    d_codes = qn + xn - 2 * code_dots(cq, cx)
    s = torch.tensor(scale, dtype=torch.float32, device=cq.device)
    return d_codes.float().clamp_min(0.0) * (s * s)


def pairwise_ip_u8(cq, cx, scale, zero_point, d_real: int) -> torch.Tensor:
    """Negative inner product from shared-spec uint8 codes (absolute score:
    ``s²·cq·cx + s·zp·(Σcq + Σcx) + D·zp²``)."""
    s = torch.tensor(scale, dtype=torch.float32, device=cq.device)
    zp = torch.tensor(zero_point, dtype=torch.float32, device=cq.device)
    dots = code_dots(cq, cx).float()
    sq = cq.long().sum(dim=-1, keepdim=True).float()
    sx = cx.long().sum(dim=-1)[None, :].float()
    return -(s * s * dots + s * zp * (sq + sx) + d_real * zp * zp)


def pairwise_distance_u8(cq, cx, scale, zero_point, metric: str = "l2",
                         d_real: int | None = None) -> torch.Tensor:
    if metric == "l2":
        return pairwise_l2_u8(cq, cx, scale)
    if metric == "ip":
        return pairwise_ip_u8(cq, cx, scale, zero_point,
                              cq.shape[-1] if d_real is None else d_real)
    raise ValueError(f"unknown metric {metric!r}")


def topk_smallest(dists: torch.Tensor, k: int):
    """(values, indices) of the k smallest along the last axis, ascending,
    ties by index; pads with (inf, -1) when the axis is shorter than k."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    short = k - vals.shape[-1]
    if short > 0:
        pad = (*vals.shape[:-1], short)
        vals = torch.cat([vals, vals.new_full(pad, float("inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_full(pad, -1)], dim=-1)
    return vals, idx


def knn(q, x, k: int, metric: str = "l2"):
    """Exact k nearest neighbours of each q row among x rows."""
    return topk_smallest(pairwise_distance(q, x, metric), k)


def assign_nearest(x, centroids, metric: str = "l2"):
    """(nearest_centroid_idx [N], distance [N]) for each row of x."""
    d = pairwise_distance(x, centroids, metric)
    idx = torch.argmin(d, dim=1)
    return idx, d.gather(1, idx[:, None])[:, 0]
