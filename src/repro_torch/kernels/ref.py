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


LANES = 32


def lane_sum(terms: torch.Tensor, vec: int = 1) -> torch.Tensor:
    """Sum f32 ``terms`` over the last axis in a warp's fixed order, in
    elementwise ops only, so that every step rounds once on any device: the
    axis is cut into units of ``vec`` neighbouring terms (one load of a
    lane), lane ``l`` takes units ``l, l + 32, ...`` in turn and adds each
    unit's terms in order (zero padding adds +0.0), then an xor butterfly
    over offsets 16, 8, 4, 2, 1 (``acc + acc[l ^ off]``; IEEE addition
    commutes, so every lane ends with the same sum).  K3's re-rank sums with
    ``vec=1``, the merge kernel with ``vec=4`` (float4 loads)."""
    pad = -terms.shape[-1] % (LANES * vec)
    if pad:
        terms = torch.nn.functional.pad(terms, (0, pad))
    units = terms.reshape(*terms.shape[:-1], -1, LANES, vec)
    acc = torch.zeros_like(units[..., 0, :, 0])
    for u in range(units.shape[-3]):
        for c in range(vec):
            acc = acc + units[..., u, :, c]
    idx = torch.arange(LANES, device=terms.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ off]
    return acc[..., 0]


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


def merge_rows_plain(x, nbr, row_ptr, row_of, degree: int):
    """Plain version of the merge kernel (``csrc/merge.cu``): each global
    id's merged row from its shard rows.

    ``nbr`` [S, W] int32 holds every shard row's neighbours in global ids
    (-1 pads), ``row_of[row_ptr[g]:row_ptr[g + 1]]`` (int32) the rows of id
    ``g`` in shard order, ``x`` [N, D] f32 the points or None.  Row ``g``'s
    candidates are its rows' slots in that order with -1 and ``g`` left
    out; a repeated id keeps its first occurrence; the unique candidates
    are ranked by (squared L2 to ``x[g]``, first-seen position), or by
    position alone without ``x``, and the first ``degree`` are kept, -1
    after them.  Distances are summed as the kernel sums them
    (:func:`lane_sum` with ``vec=4``; NaN ranks as +inf).  Returns
    (graph [N, degree] int32, unique candidates a row [N] int32).  Rows go
    in blocks of at most 2^24 gathered f32 elements."""
    n = row_ptr.shape[0] - 1
    w = nbr.shape[1]
    dev = nbr.device
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    cap = int(counts.max()) * w if n else 0
    graph = torch.full((n, degree), -1, dtype=torch.int32, device=dev)
    n_unique = torch.zeros(n, dtype=torch.int32, device=dev)
    if cap == 0:
        return graph, n_unique
    slot = torch.arange(cap, device=dev)
    per_block = max(1, (1 << 24) // (cap * (1 if x is None
                                            else x.shape[1])))
    for s in range(0, n, per_block):
        g = torch.arange(s, min(s + per_block, n), device=dev)
        entry = slot // w
        rows = row_ptr[g].long()[:, None] + entry
        live = entry < counts[g][:, None]
        cand = nbr[row_of[rows.clamp_max(len(row_of) - 1)].long(), slot % w]
        cand = torch.where(live & (cand != g[:, None]), cand, -1)
        srt, order = torch.sort(cand, dim=1, stable=True)
        first = torch.ones_like(srt, dtype=torch.bool)
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
        keep = torch.zeros_like(first).scatter(1, order, first) & (cand >= 0)
        n_unique[g] = keep.sum(dim=1, dtype=torch.int32)
        if x is None:
            rank = torch.arange(cap, device=dev).expand_as(cand)
        else:
            diff = x[cand.clamp_min(0).long()] - x[g][:, None]
            d = lane_sum(diff * diff, vec=4)
            d = torch.where(torch.isnan(d), torch.inf, d)
            rank = torch.sort(d, dim=1, stable=True).indices
        # kept candidates first, each group in rank order
        rank = rank.gather(1, torch.sort((~keep).gather(1, rank).to(
            torch.uint8), dim=1, stable=True).indices)[:, :degree]
        got = torch.where(keep.gather(1, rank), cand.gather(1, rank), -1)
        graph[g, :got.shape[1]] = got.int()
    return graph, n_unique


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


def _mha_logits(q, k, causal: bool, scale):
    """Scaled f32 scores [B, Hkv, G, S, T] and their validity mask."""
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    scale = scale if scale is not None else dh**-0.5
    qf = (q.float() * scale).reshape(b, hkv, h // hkv, s, dh)
    logits = qf @ k.float()[:, :, None].transpose(-1, -2)  # [b,hkv,g,s,t]
    if causal:
        pos_q = torch.arange(s, device=q.device)[:, None] + (t - s)
        valid = pos_q >= torch.arange(t, device=q.device)[None, :]
    else:
        valid = torch.ones((1, t), dtype=torch.bool, device=q.device)
    return logits, valid


def mha_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Multi-head attention, the plain version of K5.

    q: [B, H, S, Dh], k/v: [B, Hkv, T, Dh] with H % Hkv == 0 (GQA: head h
    reads KV head h // (H / Hkv)).  Query i attends keys <= i + (T - S) when
    causal.  q is scaled in f32 before the product, scores and probabilities
    stay f32 (V is upcast), and the result is cast to q.dtype.
    """
    logits, valid = _mha_logits(q, k, causal, scale)
    out = _masked_softmax_av(logits, valid, v.float()[:, :, None])
    return out.reshape(q.shape).to(q.dtype)


def mha_attention_lse(q, k, v, *, causal: bool = True,
                      scale: float | None = None):
    """:func:`mha_attention` and each row's log-sum-exp of its scaled
    scores, ``(out, lse [B, H, S] f32)``, the plain version of K5 with its
    ``lse`` output (masked scores are -1e30, as in the kernel)."""
    logits, valid = _mha_logits(q, k, causal, scale)
    out = _masked_softmax_av(logits, valid, v.float()[:, :, None])
    lse = torch.logsumexp(torch.where(valid, logits, NEG_INF), dim=-1)
    return out.reshape(q.shape).to(q.dtype), lse.reshape(q.shape[:3])


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
