"""RWKV-6 ("Finch") block: time-mix with data-dependent decay + channel-mix
(counterpart of ``repro/models/rwkv6.py``; arXiv:2404.05892).

Per head h with state S ∈ R^{dk×dv}:

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t          (w_t ∈ (0,1), data-dependent)
    y_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)

Prefill uses the reference's **chunked** evaluation: within a chunk every
pairwise decay factor is exp(logcw_{t-1} − logcw_s) with s < t, so every
exponent is ≤ 0, and the [B, H, dk, dv] state is carried from chunk to
chunk.  The chunk is the largest divisor of T no larger than the model's
(64 at most), so any prompt length works; a chunk's pairwise term is
[B, H, Q, Q, dh] f32.  Decode is the same function at T = 1 against the
carried state.  As in the reference, the time-mix gate's GroupNorm is a
per-head RMS norm.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.common.params import P

N_MIX = 5  # w, k, v, r, g


@dataclasses.dataclass(frozen=True)
class RWKVDims:
    d_model: int
    n_heads: int
    head_dim: int
    chunk: int
    lora_rank: int = 64
    decay_lora_rank: int = 64

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.head_dim


def time_mix_p(dims: RWKVDims) -> dict:
    d, da = dims.d_model, dims.d_attn
    r, rw = dims.lora_rank, dims.decay_lora_rank
    return {
        "mu_base": P(shape=(d,), axes=("embed",), init="normal", scale=0.02),
        "mu": P(shape=(N_MIX, d), axes=(None, "embed"), init="normal",
                scale=0.02),
        "lora_a": P(shape=(d, N_MIX * r), axes=("embed", None)),
        "lora_b": P(shape=(N_MIX, r, d), axes=(None, None, "embed"),
                    init="zeros"),
        "w0": P(shape=(da,), axes=("heads",), init="normal", scale=0.5),
        "w_lora_a": P(shape=(d, rw), axes=("embed", None)),
        "w_lora_b": P(shape=(rw, da), axes=(None, "heads"), init="zeros"),
        "wr": P(shape=(d, da), axes=("embed", "heads")),
        "wk": P(shape=(d, da), axes=("embed", "heads")),
        "wv": P(shape=(d, da), axes=("embed", "heads")),
        "wg": P(shape=(d, da), axes=("embed", "heads")),
        "u": P(shape=(da,), axes=("heads",), init="normal", scale=0.5),
        "ln_scale": P(shape=(da,), axes=("heads",), init="ones"),
        "wo": P(shape=(da, d), axes=("heads", "embed")),
    }


def channel_mix_p(dims: RWKVDims, d_ff: int) -> dict:
    d = dims.d_model
    return {
        "mu_k": P(shape=(d,), axes=("embed",), init="normal", scale=0.02),
        "mu_r": P(shape=(d,), axes=("embed",), init="normal", scale=0.02),
        "wk": P(shape=(d, d_ff), axes=("embed", "mlp")),
        "wv": P(shape=(d_ff, d), axes=("mlp", "embed")),
        "wr": P(shape=(d, d), axes=("embed", "embed2")),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """x_{t-1} along time; ``prev`` ([B, D]) supplies the value at t=0."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(x, xs, p):
    """v6 data-dependent token-shift: 5 mixes from one low-rank projection."""
    dxs = xs - x
    base = x + dxs * p["mu_base"]
    lo = base @ p["lora_a"]
    lo = lo.reshape(*lo.shape[:-1], N_MIX, -1)  # [B, T, 5, r]
    dyn = torch.einsum("btmr,mrd->btmd", torch.tanh(lo), p["lora_b"])
    mixes = p["mu"] + dyn  # [B, T, 5, D]
    return x[:, :, None, :] + dxs[:, :, None, :] * mixes  # [B, T, 5, D]


def _head_rms(y: torch.Tensor, scale: torch.Tensor, nh: int,
              eps: float = 1e-5) -> torch.Tensor:
    b, t, da = y.shape
    yh = y.reshape(b, t, nh, da // nh).float()
    var = (yh * yh).mean(dim=-1, keepdim=True)
    yh = yh * torch.rsqrt(var + eps)
    return (yh.reshape(b, t, da) * scale.float()).to(y.dtype)


def _wkv_chunk(r, k, v, logw, u, s0):
    """One chunk of the WKV recurrence, in f32.

    r/k/v: [B, H, Q, dh]; logw: [B, H, Q, dh] (≤ 0); u: [H, dh] per-head
    bonus; s0: [B, H, dh, dh] carry.  Returns (y [B, H, Q, dh], s1).
    """
    q = r.shape[2]
    logcw = torch.cumsum(logw, dim=2)  # inclusive ∏ decay up to t
    # state term: r_t ⊙ exp(logcw_{t-1}) · S0
    logcw_prev = logcw - logw  # exclusive cumsum (up to t-1)
    y_state = (r * torch.exp(logcw_prev)) @ s0
    # intra-chunk: A[t,s] = Σ_i r_ti k_si exp(logcw_{t-1,i} − logcw_{s,i}), s<t
    diff = logcw_prev[:, :, :, None, :] - logcw[:, :, None, :, :]
    mask = (torch.arange(q, device=r.device)[:, None]
            > torch.arange(q, device=r.device)[None, :])[None, None, :, :, None]
    decay = torch.exp(diff.masked_fill_(~mask, float("-inf")))
    amat = (r[:, :, :, None, :] * k[:, :, None, :, :] * decay).sum(dim=-1)
    del diff, decay
    y_intra = amat @ v
    # u-bonus diagonal: (r_t · diag(u_h) k_t) v_t
    bonus = torch.einsum("bhqk,hk->bhq", r * k, u)
    y = y_state + y_intra + bonus[..., None] * v
    # chunk-final state: S1 = diag(cwQ)·S0 + Σ_s diag(cwQ/cw_s) k_s ⊗ v_s
    end = logcw[:, :, -1:, :]  # [B, H, 1, dh]
    k_dec = k * torch.exp(end - logcw)
    s1 = torch.exp(end[:, :, 0, :, None]) * s0 + k_dec.transpose(-1, -2) @ v
    return y, s1


def wkv6(r, k, v, logw, u, *, chunk: int, s0=None):
    """Chunked WKV6. r/k/v/logw: [B, H, T, dh] (logw ≤ 0). → (y in r's
    dtype, final state f32)."""
    b, h, t, dh = r.shape
    q = min(chunk, t)
    while t % q:  # largest divisor of T ≤ chunk (ragged prompt lengths)
        q -= 1
    s = (torch.zeros(b, h, dh, dh, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = u.float()
    ys = []
    for c0 in range(0, t, q):
        y, s = _wkv_chunk(*(a[:, :, c0:c0 + q].float()
                            for a in (r, k, v, logw)), uf, s)
        ys.append(y)
    return torch.cat(ys, dim=2).to(r.dtype), s


def time_mix_forward(x: torch.Tensor, p, dims: RWKVDims, *, prev_x=None,
                     s0=None, return_state: bool = False):
    """x: [B, T, D] → [B, T, D] (optionally also (last_x, state))."""
    b, t, d = x.shape
    nh, dh = dims.n_heads, dims.head_dim
    xs = _shift(x, prev_x)
    mixed = _ddlerp(x, xs, p)  # [B, T, 5, D]
    xw, xk, xv, xr, xg = (mixed[:, :, i] for i in range(N_MIX))
    # data-dependent decay (per channel of the attention dim)
    wdyn = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp(p["w0"] + wdyn.float(), -8.0, 6.0))  # ≤ 0
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = xg @ p["wg"]

    def heads(a):
        return a.reshape(b, t, nh, dh).transpose(1, 2)

    y, s_fin = wkv6(heads(r), heads(k), heads(v), heads(logw.to(r.dtype)),
                    p["u"].reshape(nh, dh), chunk=dims.chunk, s0=s0)
    y = y.transpose(1, 2).reshape(b, t, nh * dh)
    y = _head_rms(y, p["ln_scale"], nh)
    y = y * F.silu(g.float()).to(y.dtype)
    out = y @ p["wo"]
    if return_state:
        return out, x[:, -1], s_fin
    return out


def channel_mix_forward(x: torch.Tensor, p, *, prev_x=None) -> torch.Tensor:
    xs = _shift(x, prev_x)
    xk = x + (xs - x) * p["mu_k"]
    xr = x + (xs - x) * p["mu_r"]
    k = torch.square(F.relu((xk @ p["wk"]).float())).to(x.dtype)
    r = torch.sigmoid((xr @ p["wr"]).float()).to(x.dtype)
    return r * (k @ p["wv"])


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def init_rwkv_cache(batch: int, dims: RWKVDims, d_model: int, dtype,
                    device=None) -> dict:
    return {
        "tm_x": torch.zeros(batch, d_model, dtype=dtype, device=device),
        "cm_x": torch.zeros(batch, d_model, dtype=dtype, device=device),
        "s": torch.zeros(batch, dims.n_heads, dims.head_dim, dims.head_dim,
                         dtype=torch.float32, device=device),
    }


def time_mix_decode(x: torch.Tensor, p, cache: dict, dims: RWKVDims):
    """Single-token recurrence. x: [B, D] → ([B, D], {tm_x, s})."""
    out, last_x, s = time_mix_forward(
        x[:, None, :], p, dataclasses.replace(dims, chunk=1),
        prev_x=cache["tm_x"], s0=cache["s"], return_state=True,
    )
    return out[:, 0], {"tm_x": last_x, "s": s}


def channel_mix_decode(x: torch.Tensor, p, cache_x: torch.Tensor):
    out = channel_mix_forward(x[:, None, :], p, prev_x=cache_x)
    return out[:, 0], x
