"""Public kernel surface with device dispatch (counterpart of
``repro/kernels/ops.py``).

Dispatch: a CPU tensor takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, and a kernel that fails to build
or launch raises — nothing falls back.  The CUDA kernels mask their own
ragged edges, so no operand is padded here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import distance as _distance
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import topk as _topk


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
    if _on_cuda(q, k):
        return _flash.flash_attention_lse_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            scale=scale)
    return ref.mha_attention_lse(q, k, v, causal=causal, scale=scale)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 scale: float | None = None) -> torch.Tensor:
    """One-token decode attention (K6). q: [B,H,Dh], cache: [B,Hkv,T,Dh],
    cache_len: [B] valid positions per row.  Raises under grad."""
    _refuse_grad("flash_decode", q, k_cache, v_cache)
    if _on_cuda(q, k_cache):
        return _flash.flash_decode_cuda(
            q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
            cache_len, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, cache_len, scale)


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
