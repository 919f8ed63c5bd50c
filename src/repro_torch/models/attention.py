"""GQA attention with RoPE, prefill and decode paths (counterpart of
``repro/models/attention.py``).

Both paths go through :mod:`repro_torch.kernels.ops`: prefill through
``flash_attention`` (K5 on the card), decode through ``flash_decode`` (K6).
Layouts are the reference's: activations [B, S, D], heads [B, H, S, Dh],
weights [in, out].  The training path and whisper's projection biases and
cross-attention are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.params import P
from repro_torch.kernels import ops
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float  # 0.0 → no RoPE (learned positions upstream)


def attn_p(dims: AttnDims) -> dict:
    h = dims.n_heads * dims.head_dim
    kv = dims.n_kv_heads * dims.head_dim
    return {
        "wq": P(shape=(dims.d_model, h), axes=("embed", "heads")),
        "wk": P(shape=(dims.d_model, kv), axes=("embed", "kv")),
        "wv": P(shape=(dims.d_model, kv), axes=("embed", "kv")),
        "wo": P(shape=(h, dims.d_model), axes=("heads", "embed")),
    }


def _project_qkv(x: torch.Tensor, p, dims: AttnDims):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    q = q.reshape(b, s, dims.n_heads, dims.head_dim).transpose(1, 2)
    k = k.reshape(b, s, dims.n_kv_heads, dims.head_dim).transpose(1, 2)
    v = v.reshape(b, s, dims.n_kv_heads, dims.head_dim).transpose(1, 2)
    return q, k, v


def _merge_heads(o: torch.Tensor, p, dims: AttnDims) -> torch.Tensor:
    b, h, s, dh = o.shape
    return o.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]


def attn_prefill(x: torch.Tensor, p, dims: AttnDims, rope, *,
                 causal: bool = True) -> tuple[torch.Tensor, dict]:
    """Prefill: full attention + the KV cache {k, v: [B,Hkv,S,Dh]}.

    ``rope`` is (cos, sin) for positions ``arange(S)`` (the same for every
    row, so left padding is attended like any token, as in the reference),
    or None when ``dims.rope_theta`` is 0."""
    q, k, v = _project_qkv(x, p, dims)
    if rope is not None:
        q = layers.rope_rotate(q, *rope)
        k = layers.rope_rotate(k, *rope)
    k, v = k.contiguous(), v.contiguous()
    o = ops.flash_attention(q, k, v, causal=causal)
    return _merge_heads(o, p, dims), {"k": k, "v": v}


def init_kv_cache(batch: int, max_len: int, dims: AttnDims, dtype,
                  device=None) -> dict:
    shape = (batch, dims.n_kv_heads, max_len, dims.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(x: torch.Tensor, p, cache: dict, pos: int, dims: AttnDims,
                rope, lens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: [B, D]; cache k/v: [B, Hkv, T, Dh].

    ``rope`` is (cos, sin) [1, Dh/2] for position ``pos`` (None without
    RoPE) and ``lens`` is ``pos + 1`` for every row, both made once per
    step by the caller.  Writes this token's K/V at position ``pos`` of the
    cache **in place** (the reference returns a new cache) and attends to
    positions [0, pos] of every row.  Returns (out [B, D], the same cache
    dict)."""
    b, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    q = q.reshape(b, dims.n_heads, dims.head_dim)
    k = k.reshape(b, dims.n_kv_heads, 1, dims.head_dim)
    v = v.reshape(b, dims.n_kv_heads, 1, dims.head_dim)
    if rope is not None:
        q = layers.rope_rotate(q, *rope)
        k = layers.rope_rotate(k, *rope)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, :, pos:pos + 1] = k.to(k_cache.dtype)
    v_cache[:, :, pos:pos + 1] = v.to(v_cache.dtype)
    o = ops.flash_decode(q, k_cache, v_cache, lens)  # [B, H, Dh]
    return o.reshape(b, -1) @ p["wo"], cache
