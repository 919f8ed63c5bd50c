"""GQA attention with RoPE or learned positions: full-sequence, prefill,
decode and cross-attention paths (counterpart of
``repro/models/attention.py``).

Every path runs K5 or K6.  ``attn_forward``, ``attn_prefill`` and
``cross_attn_forward`` go through ``ops.flash_attention`` (K5 on the
card) when no gradient is wanted, and through
:func:`repro_torch.kernels.flash_vjp.flash_attention_fa2` (K5 with its
log-sum-exp, FA2 recompute backward) when grad mode is on and an input
requires grad.  The reference's two training implementations compute the
same function and the same gradient: ``attn_impl="scan"`` (its default,
``flash_attention_jnp`` differentiated by JAX; the port's counterpart is
``ops.flash_attention_chunked``, which the tests hold to it) and
``"fa2"`` (its custom-VJP flash attention).  Both map to the FA2 path, so
the port reads no ``attn_impl``: mapping ``"scan"`` to the chunked torch
ops would take K5 off the training path.  ``attn_decode`` and
``cross_attn_decode`` go through ``ops.flash_decode`` (K6), which has no
backward and raises under grad.  Layouts are the reference's: activations
[B, S, D], heads [B, H, S, Dh], weights [in, out].  Whisper's projections
carry biases on q, v and the output (``AttnDims.bias``); ``rope_theta ==
0`` means no RoPE.  With ``seq_shard`` (``cfg.attn_seq_shard``) prefill
and the full-sequence forward constrain q, k and v by the reference's
logical axes (q's sequence over ``seq_attn``, context parallelism):
identities on one card, checked against the shapes under a mesh context
(:func:`repro_torch.distributed.sharding.constrain`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.params import P
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_vjp import flash_attention_fa2
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float  # 0.0 → no RoPE (learned positions upstream)
    bias: bool = False  # whisper-style projection biases
    seq_shard: bool = False  # context-parallel q-seq constraints


def attn_p(dims: AttnDims) -> dict:
    h = dims.n_heads * dims.head_dim
    kv = dims.n_kv_heads * dims.head_dim
    p = {
        "wq": P(shape=(dims.d_model, h), axes=("embed", "heads")),
        "wk": P(shape=(dims.d_model, kv), axes=("embed", "kv")),
        "wv": P(shape=(dims.d_model, kv), axes=("embed", "kv")),
        "wo": P(shape=(h, dims.d_model), axes=("heads", "embed")),
    }
    if dims.bias:
        p.update(
            bq=P(shape=(h,), axes=("heads",), init="zeros"),
            bv=P(shape=(kv,), axes=("kv",), init="zeros"),
            bo=P(shape=(dims.d_model,), axes=("embed",), init="zeros"),
        )
    return p


def _heads(a: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """[B, S, n * Dh] → [B, n, S, Dh]."""
    b, s, _ = a.shape
    return a.reshape(b, s, n, dh).transpose(1, 2)


def _q(x: torch.Tensor, p, dims: AttnDims) -> torch.Tensor:
    q = x @ p["wq"]
    return q + p["bq"] if dims.bias else q


def _kv(x: torch.Tensor, p, dims: AttnDims):
    k = x @ p["wk"]
    v = x @ p["wv"]
    return k, (v + p["bv"] if dims.bias else v)


def _project_qkv(x: torch.Tensor, p, dims: AttnDims):
    k, v = _kv(x, p, dims)
    return (_heads(_q(x, p, dims), dims.n_heads, dims.head_dim),
            _heads(k, dims.n_kv_heads, dims.head_dim),
            _heads(v, dims.n_kv_heads, dims.head_dim))


def _out(o: torch.Tensor, p, dims: AttnDims) -> torch.Tensor:
    """[..., H * Dh] → [..., D] through wo (and bo)."""
    out = o @ p["wo"]
    return out + p["bo"] if dims.bias else out


def _merge_heads(o: torch.Tensor, p, dims: AttnDims) -> torch.Tensor:
    b, h, s, dh = o.shape
    return _out(o.transpose(1, 2).reshape(b, s, h * dh), p, dims)


def _attend(q, k, v, *, causal: bool) -> torch.Tensor:
    """K5: through the autograd function when a gradient is wanted."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_fa2(q, k, v, causal=causal)
    return ops.flash_attention(q, k, v, causal=causal)


def attn_forward(x: torch.Tensor, p, dims: AttnDims, rope, *,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. x: [B, S, D] → [B, S, D].  ``rope`` is as
    for :func:`attn_prefill`."""
    return attn_prefill(x, p, dims, rope, causal=causal)[0]


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
    if dims.seq_shard:
        q = shd.constrain(q, "batch", "act_heads", "seq_attn", None)
        k = shd.constrain(k, "batch", "act_kv", None, None)
        v = shd.constrain(v, "batch", "act_kv", None, None)
    k, v = k.contiguous(), v.contiguous()
    o = _attend(q, k, v, causal=causal)
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
    q = _q(x, p, dims).reshape(b, dims.n_heads, dims.head_dim)
    k, v = _kv(x, p, dims)
    k = k.reshape(b, dims.n_kv_heads, 1, dims.head_dim)
    v = v.reshape(b, dims.n_kv_heads, 1, dims.head_dim)
    if rope is not None:
        q = layers.rope_rotate(q, *rope)
        k = layers.rope_rotate(k, *rope)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, :, pos:pos + 1] = k.to(k_cache.dtype)
    v_cache[:, :, pos:pos + 1] = v.to(v_cache.dtype)
    o = ops.flash_decode(q, k_cache, v_cache, lens)  # [B, H, Dh]
    return _out(o.reshape(b, -1), p, dims), cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder): query from x, KV from encoder memory.
# ---------------------------------------------------------------------------


def cross_attn_kv(memory: torch.Tensor, p, dims: AttnDims) -> dict:
    """The cross-attention KV cache {k, v: [B, Hkv, F, Dh]} (contiguous)
    from the encoder's output [B, F, D], made once per request."""
    k, v = _kv(memory, p, dims)
    return {"k": _heads(k, dims.n_kv_heads, dims.head_dim).contiguous(),
            "v": _heads(v, dims.n_kv_heads, dims.head_dim).contiguous()}


def cross_attn_forward(x: torch.Tensor, p, kv: dict,
                       dims: AttnDims) -> torch.Tensor:
    """x: [B, S, D] queries over fixed memory KV ([B, Hkv, F, Dh]),
    non-causal (K5 at S ≠ F on the card)."""
    q = _heads(_q(x, p, dims), dims.n_heads, dims.head_dim)
    o = _attend(q, kv["k"], kv["v"], causal=False)
    return _merge_heads(o, p, dims)


def cross_attn_decode(x: torch.Tensor, p, kv: dict, dims: AttnDims,
                      lens: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention. x: [B, D] over memory KV [B, Hkv, F,
    Dh]; ``lens`` is F for every row (K6), made once per step by the
    caller."""
    b, _ = x.shape
    q = _q(x, p, dims).reshape(b, dims.n_heads, dims.head_dim)
    o = ops.flash_decode(q, kv["k"], kv["v"], lens)
    return _out(o.reshape(b, -1), p, dims)
