"""int8 gradient compression with error feedback (counterpart of
``repro/train/compression.py``; 1-bit-Adam style).

A cross-pod gradient reduction moves the most bytes at multi-pod scale;
quantizing the reduced tensor to int8 cuts them 4× (f32) or 2× (bf16).
This module holds the numerics: per-tensor absmax scaling, deterministic
rounding (``torch.round``, like ``jnp.round``, rounds half to even), and
an **error-feedback buffer** that carries the quantization error into the
next step instead of dropping it (Karimireddy et al. 2019).  On one card
there is no collective: the train step applies the quantize → dequantize
pair to the gradient tree before clipping, as the reference's does.
"""

from __future__ import annotations

import torch

from repro_torch.common import params as par


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization → (q int8, scale f32)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params):
    return par.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        params)


def compress_with_feedback(grads, error_state):
    """(compressed grads, new error state): g' = Q(g + e); e' = (g+e) − g'."""

    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), corrected - deq

    out = [one(g, e) for g, e in zip(par.leaves(grads),
                                     par.leaves(error_state))]
    return (par.unflatten(grads, [o[0] for o in out]),
            par.unflatten(grads, [o[1] for o in out]))
