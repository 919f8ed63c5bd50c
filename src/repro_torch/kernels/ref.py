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


# ---------------------------------------------------------------------------
# Attention (plain versions of K5 and K6)
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the TPU kernels' mask value


def _masked_softmax_av(logits, valid, vf):
    """Dense softmax over the last axis of f32 ``logits`` with invalid
    entries set to -1e30 and dropped from the sum, the denominator clamped
    at 1e-30 (a row with no valid key gives 0), then the product with f32
    ``vf``.  ``valid`` broadcasts against ``logits``."""
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (p / denom) @ vf


def mha_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Multi-head attention, the plain version of K5.

    q: [B, H, S, Dh], k/v: [B, Hkv, T, Dh] with H % Hkv == 0 (GQA: head h
    reads KV head h // (H / Hkv)).  Query i attends keys <= i + (T - S) when
    causal.  q is scaled in f32 before the product, scores and probabilities
    stay f32 (V is upcast), and the result is cast to q.dtype.
    """
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else dh**-0.5
    qf = (q.float() * scale).reshape(b, hkv, group, s, dh)
    logits = qf @ k.float()[:, :, None].transpose(-1, -2)  # [b,hkv,g,s,t]
    if causal:
        pos_q = torch.arange(s, device=q.device)[:, None] + (t - s)
        valid = pos_q >= torch.arange(t, device=q.device)[None, :]
    else:
        valid = torch.ones((1, t), dtype=torch.bool, device=q.device)
    out = _masked_softmax_av(logits, valid, v.float()[:, :, None])
    return out.reshape(b, h, s, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len=None, scale=None):
    """One-token attention against a KV cache, the plain version of K6.

    q: [B, H, Dh]; k_cache/v_cache: [B, Hkv, T, Dh]; cache_len: [B] valid
    lengths (None -> all T valid; 0 gives a zero row).  Returns [B, H, Dh]
    in q.dtype, computed in f32.
    """
    b, h, dh = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    scale = scale if scale is not None else dh**-0.5
    qf = (q.float() * scale).reshape(b, hkv, group, 1, dh)
    logits = qf @ k_cache.float()[:, :, None].transpose(-1, -2)  # [b,hkv,g,1,t]
    if cache_len is None:
        valid = torch.ones((1, t), dtype=torch.bool, device=q.device)
    else:
        lens = torch.as_tensor(cache_len, device=q.device)
        valid = (torch.arange(t, device=q.device)[None, :]
                 < lens[:, None]).reshape(b, 1, 1, 1, t)
    out = _masked_softmax_av(logits, valid, v_cache.float()[:, :, None])
    return out.reshape(b, h, dh).to(q.dtype)
