"""Shared layer primitives (counterpart of ``repro/models/layers.py``):
norms, RoPE, the SwiGLU MLP, embeddings.

Functions over parameter dicts declared with :class:`P`; ``-1`` in a
declared shape is resolved by :func:`sized` from an axis-name → size map.
Norms, SiLU and RoPE compute in f32 and round back to the input's dtype,
as the reference does.  Matrix products run in the input's dtype
(``torch.matmul``; no TF32 for f32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.params import P, tree_map


def sized(tree, **dims):
    """Resolve -1 placeholders in P shapes using the axis-name → size map."""

    def fix(p: P):
        shape = tuple(
            dims[ax] if s == -1 else s for s, ax in zip(p.shape, p.axes)
        )
        return P(shape=shape, axes=p.axes, init=p.init, dtype=p.dtype,
                 scale=p.scale, fan_in_axes=p.fan_in_axes)

    return tree_map(fix, tree)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, f32 [..., Dh/2] for positions
    [...]; computed once and shared by every layer that rotates them."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x's last dim (not interleaved pairs) by
    angles whose cos/sin broadcast against x [..., Dh/2]; f32 inside."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, Dh] (heads batched in leading dims), positions: [..., S].
    Rotates the two halves of Dh (not interleaved pairs)."""
    cos, sin = rope_cos_sin(positions.to(x.device), x.shape[-1], theta)
    return rope_rotate(x, cos, sin)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_p() -> dict:
    """Gated MLP (llama/phi3 family): gate and up, then down."""
    return {
        "w_gate": P(shape=(-1, -1), axes=("embed", "mlp")),
        "w_up": P(shape=(-1, -1), axes=("embed", "mlp")),
        "w_down": P(shape=(-1, -1), axes=("mlp", "embed")),
    }


def swiglu(x: torch.Tensor, p) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_p() -> dict:
    return {"table": P(shape=(-1, -1), axes=("vocab", "embed"), init="embed")}


def embed(tokens: torch.Tensor, p, dtype) -> torch.Tensor:
    return p["table"][tokens].to(dtype)


def unembed_p(tied: bool) -> dict:
    if tied:
        return {}
    return {"w": P(shape=(-1, -1), axes=("embed", "vocab"))}


def unembed(x: torch.Tensor, p, embed_params) -> torch.Tensor:
    if "w" in p:
        return x @ p["w"]
    return x @ embed_params["table"].T
