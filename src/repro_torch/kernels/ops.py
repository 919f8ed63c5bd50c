"""Public kernel surface with device dispatch (counterpart of
``repro/kernels/ops.py``).

Dispatch: a CPU tensor takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, and a kernel that fails to build
or launch raises — nothing falls back.  The CUDA kernels mask their own
ragged edges, so no operand is padded here.  On ``meta`` tensors (the
dry-run's step count, :mod:`repro_torch.launch.step_cost`) the attention
wrappers compute nothing: they report the work a call needs to
:data:`WORK_LISTENERS` and return empty outputs of the right shape.

:func:`flash_attention_chunked` is the reference's differentiable
``flash_attention_jnp`` in torch ops (autograd differentiates it); the
models' training path goes through K5 and the FA2 backward instead
(``models/attention.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import distance as _distance
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import topk as _topk


# Listeners of the work an attention call on ``meta`` tensors stands for:
# ``fn(name, flops, bytes)`` (launch/step_cost.py counts a step with them)
WORK_LISTENERS: list = []


def attention_pairs(s: int, t: int, causal: bool) -> int:
    """(query, key) pairs one head attends: S·T, or causally (query ``i``
    sees keys ``[0, i + T - S]``) the lower triangle with its diagonal."""
    if not causal:
        return s * t
    seen = np.clip(np.arange(s, dtype=np.int64) + (t - s + 1), 0, t)
    return int(seen.sum())


def nbytes(*tensors) -> int:
    """Bytes of the tensors (``None`` entries skipped)."""
    return sum(math.prod(t.shape) * t.element_size() for t in tensors
               if t is not None)


def report_work(name: str, flops: int, n_bytes: int) -> None:
    """Tell the listeners what a call needs: its flops, and the bytes of
    its operands read once and its outputs written once."""
    for fn in WORK_LISTENERS:
        fn(name, flops, n_bytes)


def _meta_attention(name: str, q, k, v, causal: bool, lse: bool):
    """K5's work on meta tensors: 4·Dh flops a (head, query, key) pair."""
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    row_lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if lse else None)
    report_work(name, 4 * dh * b * h * attention_pairs(s, k.shape[2], causal),
                nbytes(q, k, v, out, row_lse))
    return out, row_lse


def _refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """K5's serving call and K6 have no backward: under grad mode with an
    input that requires grad they raise, rather than return an output the
    gradient silently stops at."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} has no backward; differentiate attention through "
            "repro_torch.kernels.flash_vjp.flash_attention_fa2, or run "
            "under torch.no_grad() / torch.inference_mode()")


def _on_cuda(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    return a.device.type == "cuda"


def pairwise_distance(q: torch.Tensor, x: torch.Tensor,
                      metric: str = "l2") -> torch.Tensor:
    """[M,D] × [N,D] f32/bf16 → [M,N] float32."""
    if _on_cuda(q, x):
        return _distance.pairwise_distance_cuda(q.contiguous(),
                                                x.contiguous(), metric)
    return ref.pairwise_distance(q, x, metric)


def pairwise_distance_u8(cq: torch.Tensor, cx: torch.Tensor, scale: float,
                         zero_point: float, metric: str = "l2"
                         ) -> torch.Tensor:
    """[M,D] × [N,D] uint8 codes of one affine spec → [M,N] float32."""
    if _on_cuda(cq, cx):
        return _distance.pairwise_distance_u8_cuda(
            cq.contiguous(), cx.contiguous(), scale, zero_point, metric)
    return ref.pairwise_distance_u8(cq, cx, scale, zero_point, metric)


def knn(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2"):
    """Exact kNN (ascending): [M,D] × [N,D] → ([M,k] dists, [M,k] idx)."""
    if _on_cuda(q, x):
        d, i = _topk.knn_cuda(q.float().contiguous(), x.float().contiguous(),
                              k, metric)
        return d, i.long()
    return ref.knn(q.float(), x.float(), k, metric)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Serving-path attention (K5): q [B,H,S,Dh], k/v [B,Hkv,T,Dh] ->
    [B,H,S,Dh] in q's dtype, f32 inside.  Raises under grad (see
    :func:`flash_attention_lse` for the training path)."""
    _refuse_grad("flash_attention", q, k, v)
    if q.device.type == "meta":
        return _meta_attention("flash_attention", q, k, v, causal, False)[0]
    if _on_cuda(q, k):
        return _flash.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            scale=scale)
    return ref.mha_attention(q, k, v, causal=causal, scale=scale)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None):
    """K5 with each row's log-sum-exp: ``(out [B,H,S,Dh], lse [B,H,S]
    f32)``, the forward of the training path
    (:mod:`repro_torch.kernels.flash_vjp`, whose autograd function calls
    it with grad off)."""
    if q.device.type == "meta":
        return _meta_attention("flash_attention_lse", q, k, v, causal, True)
    if _on_cuda(q, k):
        return _flash.flash_attention_lse_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            scale=scale)
    return ref.mha_attention_lse(q, k, v, causal=causal, scale=scale)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            scale: float | None = None, q_chunk: int = 512,
                            kv_chunk: int = 1024) -> torch.Tensor:
    """The reference's ``flash_attention_jnp`` in torch ops: chunked
    online-softmax attention, f32 inside, differentiated by autograd.
    q [B,H,S,Dh], k/v [B,Hkv,T,Dh] → [B,H,S,Dh] in q's dtype.

    Query rows go ``q_chunk`` at a time against ``kv_chunk`` keys at a
    time, with the causal offset ``T − S``; unlike the reference, S and T
    need not be multiples of the chunks (the last chunk is ragged).  A KV
    chunk wholly above the causal diagonal is skipped where the reference
    computes it masked: when every query row sees a key (S ≤ T) its
    probabilities are all exp(−1e30 − m) = 0 there, so the output and the
    gradient are the same."""
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else dh**-0.5
    offset = t - s
    qf = q.float().reshape(b, hkv, g, s, dh) * scale
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    outs = []
    for q0 in range(0, s, q_chunk):
        q1 = min(q0 + q_chunk, s)
        qc = qf[:, :, :, q0:q1]
        m = qc.new_full((*qc.shape[:-1], 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qc)
        for k0 in range(0, t, kv_chunk):
            if causal and k0 > q1 - 1 + offset:
                break  # this chunk and every later one lie above the diagonal
            k1 = min(k0 + kv_chunk, t)
            sij = qc @ kf[:, :, :, k0:k1].transpose(-1, -2)
            if causal and k1 - 1 > q0 + offset:  # crosses the diagonal
                qpos = torch.arange(q0, q1, device=q.device)[:, None] + offset
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                sij = sij.masked_fill(qpos < kpos, -1e30)
            m_new = torch.maximum(m, sij.amax(dim=-1, keepdim=True))
            p = torch.exp(sij - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, :, k0:k1]
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, h, s, dh)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 scale: float | None = None) -> torch.Tensor:
    """One-token decode attention (K6). q: [B,H,Dh], cache: [B,Hkv,T,Dh],
    cache_len: [B] valid positions per row.  Raises under grad."""
    _refuse_grad("flash_decode", q, k_cache, v_cache)
    if q.device.type == "meta":
        return _meta_decode(q, k_cache, v_cache, cache_len)
    if _on_cuda(q, k_cache):
        return _flash.flash_decode_cuda(
            q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
            cache_len, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, cache_len, scale)


def _meta_decode(q, k_cache, v_cache, cache_len):
    """K6's work on meta tensors: 4·Dh flops for each head and key a row
    attends (``cache_len`` keys, clamped to [0, T]; every key of the cache
    when ``cache_len`` is itself on meta and holds no values), reading
    those keys' K and V rows once."""
    b, h, dh = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    lens = torch.as_tensor(cache_len)
    keys = (b * t if lens.device.type == "meta"
            else int(lens.clamp(0, t).sum()))
    out = torch.empty_like(q)
    kv_rows = k_cache.element_size() * 2 * hkv * keys * dh
    report_work("flash_decode", 4 * dh * h * keys,
                nbytes(q, out, lens) + kv_rows)
    return out


def rerank_exact(
    data: np.ndarray,  # [N, D] full-precision vectors
    cand_ids: np.ndarray,  # [Q, C] candidate ids into data (-1 = pad)
    queries: np.ndarray,  # [Q, D] f32
    k: int,
    metric: str = "l2",
) -> tuple[np.ndarray, np.ndarray, int]:
    """The shared f32 re-rank epilogue of the quantized distance stages,
    on the host in numpy as in the reference: the k best candidates per
    query by exact (distance, id).  Returns ``(ids [Q, k] int64 -1-padded,
    dists [Q, k] f32 inf-padded, n_scored)``."""
    cand_ids = np.asarray(cand_ids, np.int64)
    qf = np.asarray(queries, np.float32)
    nq, c = cand_ids.shape
    valid = cand_ids >= 0
    rows = np.asarray(
        data[np.maximum(cand_ids, 0).reshape(-1)], np.float32
    ).reshape(nq, c, -1)
    if metric == "ip":
        d = -np.einsum("qcd,qd->qc", rows, qf)
    else:
        diff = rows - qf[:, None, :]
        d = np.einsum("qcd,qcd->qc", diff, diff)
    pad = np.iinfo(np.int64).max
    ids_key = np.where(valid, cand_ids, pad)
    d_key = np.where(valid, d, np.inf).astype(np.float32)
    order = np.lexsort((ids_key, d_key), axis=1)[:, :k]
    top_ids = np.take_along_axis(ids_key, order, axis=1)
    top_d = np.take_along_axis(d_key, order, axis=1)
    out_ids = np.full((nq, k), -1, np.int64)
    out_d = np.full((nq, k), np.inf, np.float32)
    out_ids[:, : order.shape[1]] = np.where(top_ids == pad, -1, top_ids)
    out_d[:, : order.shape[1]] = np.where(top_ids == pad, np.inf, top_d)
    return out_ids, out_d, int(valid.sum())
