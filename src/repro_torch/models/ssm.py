"""Mamba selective-SSM mixer, Jamba's sequence layer (counterpart of
``repro/models/ssm.py``; arXiv:2312.00752 / 2403.19887).

Prefill is the reference's **chunked selective scan**: the sequence is cut
into ``chunk``-length pieces, and within a chunk the linear recurrence

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + Δ_t ⊙ (B_t ⊗ x_t)
    y_t = C_t · h_t + D ⊙ x_t

is solved over the chunk's decay and input terms ([B, Q, dI, dS] f32, one
chunk at a time) by an associative scan, with the [B, dI, dS] state carried
from chunk to chunk.  :func:`_associative_scan` combines the elements in
``jax.lax.associative_scan``'s order (pairs, recursion on the pair sums,
then the even elements), so both packages round the same products in the
same order: log2(Q) levels of whole-tensor operations.  T must be a
multiple of the chunk, or at most one chunk, as in the reference.  Decode
is the O(1) single-step recurrence over (conv buffer, ssm state).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.common.params import P


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int
    d_conv: int
    expand: int
    dt_rank: int
    chunk: int

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def _a_init(gen, shape, dtype, device):
    # S4D-real init: A = -(1..d_state), stored as log(-A), broadcast over
    # any leading (stacked) axes
    d_state = shape[-1]
    a = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                               device=device))
    return a.expand(shape).to(dtype).contiguous()


def _dt_bias_init(gen, shape, dtype, device):
    # the step size's bias: softplus⁻¹ of a log-uniform draw in [1e-3, 0.1]
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
    return torch.log(torch.expm1(dt)).to(dtype)


def ssm_p(dims: SSMDims) -> dict:
    di, ds, dr = dims.d_inner, dims.d_state, dims.resolved_dt_rank
    return {
        "w_in": P(shape=(dims.d_model, 2 * di), axes=("embed", "mlp")),
        "conv_w": P(shape=(dims.d_conv, di), axes=(None, "mlp"),
                    init="normal", scale=0.5),
        "conv_b": P(shape=(di,), axes=("mlp",), init="zeros"),
        "w_x": P(shape=(di, dr + 2 * ds), axes=("mlp", None)),
        "w_dt": P(shape=(dr, di), axes=(None, "mlp")),
        "b_dt": P(shape=(di,), axes=("mlp",), init=_dt_bias_init),
        "a_log": P(shape=(di, ds), axes=("mlp", None), init=_a_init,
                   dtype=torch.float32),
        "d_skip": P(shape=(di,), axes=("mlp",), init="ones",
                    dtype=torch.float32),
        "w_out": P(shape=(di, dims.d_model), axes=("mlp", "embed")),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in x's dtype. x: [B, T, dI]; w: [K, dI]."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _combine(left, right):
    """Two consecutive pieces of the recurrence h ↦ a·h + b, left first."""
    (al, bl), (ar, br) = left, right
    return al * ar, bl * ar + br


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) along dim 1 under :func:`_combine`, in
    ``jax.lax.associative_scan``'s order: combine adjacent pairs, scan the
    pair sums (the odd outputs), then combine each odd output with the next
    even element (the even outputs; the first is the first element)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                               (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_prev = (odd_a[:, :-1], odd_b[:, :-1])
    else:
        odd_prev = (odd_a, odd_b)
    even_a, even_b = _combine(odd_prev, (a[:, 2::2], b[:, 2::2]))
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2], out_b[:, 2::2] = even_a, even_b
    out_a[:, 1::2], out_b[:, 1::2] = odd_a, odd_b
    return out_a, out_b


def _ssm_scan_chunked(u, dt, bmat, cmat, a_log, chunk: int, h0=None):
    """u, dt: [B, T, dI]; bmat, cmat: [B, T, dS]; a_log: [dI, dS].
    Returns (y [B, T, dI] in u's dtype, final state [B, dI, dS] f32)."""
    b, t, di = u.shape
    ds = bmat.shape[-1]
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"seq len {t} must divide chunk {q}")
    a = -torch.exp(a_log.float())  # [dI, dS], negative
    h = (torch.zeros(b, di, ds, dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, t, q):
        u_q, dt_q, b_q, c_q = (z[:, c0:c0 + q].float()
                               for z in (u, dt, bmat, cmat))
        decay = torch.exp(dt_q[..., None] * a)  # [B, Q, dI, dS]
        inc = (dt_q * u_q)[..., None] * b_q[:, :, None, :]
        acc_a, acc_b = _associative_scan(decay, inc)
        del decay, inc
        hs = acc_a * h[:, None] + acc_b  # [B, Q, dI, dS]
        del acc_a, acc_b
        h = hs[:, -1]
        ys.append(torch.einsum("bqds,bqs->bqd", hs, c_q))
        del hs
    return torch.cat(ys, dim=1).to(u.dtype), h


def _project(x: torch.Tensor, p):
    u, z = (x @ p["w_in"]).chunk(2, dim=-1)
    return u, z


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference writes it (``logaddexp(x, 0)``), each
    operation rounded to x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(u_act: torch.Tensor, p, dims: SSMDims):
    proj = u_act @ p["w_x"]
    dr = dims.resolved_dt_rank
    dt_low, bmat, cmat = proj.split([dr, dims.d_state, dims.d_state], dim=-1)
    dt = _softplus(dt_low @ p["w_dt"] + p["b_dt"])
    return dt, bmat, cmat


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def ssm_prefill(x: torch.Tensor, p, dims: SSMDims
                ) -> tuple[torch.Tensor, dict]:
    """Full-sequence mixer. x: [B, T, D] → ([B, T, D], the decode cache:
    the last d_conv - 1 pre-conv inputs and the final state)."""
    u, z = _project(x, p)
    u_act = _silu(_conv_causal(u, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _ssm_inputs(u_act, p, dims)
    y, h = _ssm_scan_chunked(u_act, dt, bmat, cmat, p["a_log"], dims.chunk)
    y = y + u_act * p["d_skip"].to(y.dtype)
    y = y * _silu(z)
    out = y @ p["w_out"]
    return out, {"conv": u[:, -(dims.d_conv - 1):, :].contiguous(), "h": h}


def ssm_forward(x: torch.Tensor, p, dims: SSMDims) -> torch.Tensor:
    """Full-sequence mixer. x: [B, T, D] → [B, T, D]."""
    return ssm_prefill(x, p, dims)[0]


# ---------------------------------------------------------------------------
# Decode path: O(1) state
# ---------------------------------------------------------------------------


def init_ssm_cache(batch: int, dims: SSMDims, dtype, device=None) -> dict:
    return {
        "conv": torch.zeros(batch, dims.d_conv - 1, dims.d_inner,
                            dtype=dtype, device=device),
        "h": torch.zeros(batch, dims.d_inner, dims.d_state,
                         dtype=torch.float32, device=device),
    }


def ssm_decode(x: torch.Tensor, p, cache: dict, dims: SSMDims
               ) -> tuple[torch.Tensor, dict]:
    """One token. x: [B, D] → ([B, D], new cache)."""
    u, z = _project(x, p)
    window = torch.cat([cache["conv"], u[:, None, :]], dim=1)
    conv = torch.einsum("bki,ki->bi", window.float(), p["conv_w"].float()) \
        + p["conv_b"]
    u_act = F.silu(conv).to(x.dtype)
    dt, bmat, cmat = (a[:, 0] for a in _ssm_inputs(u_act[:, None, :], p,
                                                   dims))
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt.float()[..., None] * a)  # [B, dI, dS]
    inc = (dt * u_act.float())[..., None] * bmat[:, None, :]
    h = decay * cache["h"] + inc
    y = torch.einsum("bds,bs->bd", h, cmat.float())
    y = y + u_act.float() * p["d_skip"]
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["w_out"]
    return out, {"conv": window[:, 1:].contiguous(), "h": h}
