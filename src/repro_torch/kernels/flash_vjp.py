"""Flash attention with a FlashAttention-2 backward (counterpart of
``repro/kernels/flash_vjp.py``): the training path's attention.

The forward is K5 (``ops.flash_attention_lse``: the CUDA kernel on the
card, ``ref.mha_attention_lse`` on the CPU), which also writes each row's
log-sum-exp.  Autograd saves only (q, k, v, out, lse [B, H, S] f32), and
the backward recomputes each block's probabilities from ``lse``, in f32
torch ops, chunked as the reference's ``_bwd_impl`` is (outer loop over
KV chunks, inner over query chunks):

    p   = exp(q·kᵀ·scale − lse)
    dv += pᵀ·do
    ds  = p ⊙ (do·vᵀ − Δ),   Δ = rowsum(do ⊙ out)
    dq += ds·k·scale,   dk += dsᵀ·q·scale

with the causal offset ``T − S`` (query i sees keys ≤ i + T − S).  GQA
sums dk and dv over each KV head's group of query heads.  Chunks wholly
above the causal diagonal are skipped: every p there is exp(−1e30 − lse)
= 0, so skipping them changes no sum.

On ``meta`` tensors (a step count) the backward computes nothing and
reports its work, 10·Dh flops a (head, query, key) pair the causal mask
keeps (:mod:`repro_torch.launch.step_cost`).

The reference's module holds no ``pallas_call``: its backward is jnp, and
so is this one's torch.  A hand-written backward kernel is later work on
K5 (ROADMAP.md, queue B).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

_NEG = -1e30


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool,
                        scale: float, q_chunk: int = 512,
                        kv_chunk: int = 1024):
    """(dq, dk, dv) in the dtypes of (q, k, v), computed in f32.  q/out/
    dout [B, H, S, Dh], k/v [B, Hkv, T, Dh], lse [B, H, S]."""
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if q.device.type == "meta":  # a step count: the work, no computation
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))
        ops.report_work(
            "flash_attention_bwd",
            10 * dh * b * h * ops.attention_pairs(s, t, causal),
            ops.nbytes(q, k, v, out, lse, dout, *grads))
        return grads
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, s, dh) * scale
    dof = dout.float().reshape(b, hkv, g, s, dh)
    lsef = lse.float().reshape(b, hkv, g, s, 1)
    delta = (dof * out.float().reshape(b, hkv, g, s, dh)).sum(-1,
                                                              keepdim=True)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]  # [b,hkv,1,t,dh]
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hkv, t, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    offset = t - s
    for k0 in range(0, t, kv_chunk):
        k1 = min(k0 + kv_chunk, t)
        kc, vc = kf[:, :, :, k0:k1], vf[:, :, :, k0:k1]
        for q0 in range(0, s, q_chunk):
            q1 = min(q0 + q_chunk, s)
            if causal and k0 > q1 - 1 + offset:
                continue  # above the diagonal: p = 0 everywhere
            qc, doc = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
            p = qc @ kc.transpose(-1, -2)  # [b, hkv, g, qc, kc]
            if causal and k1 - 1 > q0 + offset:  # crosses the diagonal
                qpos = torch.arange(q0, q1, device=q.device)[:, None]
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                p.masked_fill_(qpos + offset < kpos, _NEG)
            p.sub_(lsef[:, :, :, q0:q1]).exp_()  # recomputed, never saved
            dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
            ds = doc @ vc.transpose(-1, -2)
            ds.sub_(delta[:, :, :, q0:q1]).mul_(p)
            dq[:, :, :, q0:q1] += ds @ kc
            dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
    dq = (dq * scale).reshape(b, h, s, dh).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFA2(torch.autograd.Function):
    """K5 forward with its log-sum-exp, FA2 recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, q_chunk: int,
                kv_chunk: int):
        out, lse = ops.flash_attention_lse(q, k, v, causal=causal,
                                           scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_chunk, kv_chunk = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal, scale=scale,
            q_chunk=q_chunk, kv_chunk=kv_chunk)
        return dq, dk, dv, None, None, None, None


def flash_attention_fa2(q, k, v, *, causal: bool = True, scale=None,
                        q_chunk: int = 512, kv_chunk: int = 1024):
    """Differentiable attention with O(S) residuals: q [B,H,S,Dh], k/v
    [B,Hkv,T,Dh] → [B,H,S,Dh] in q's dtype.  Unlike the reference, S and
    T need not be multiples of the chunks (the last chunk is ragged)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttentionFA2.apply(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, float(scale),
                                   q_chunk, kv_chunk)
