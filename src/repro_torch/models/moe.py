"""Mixture-of-Experts layer: top-k router + capacity-based scatter dispatch
(counterpart of ``repro/models/moe.py``).

Dispatch is the reference's *sort-free scatter*: a token's position in its
expert comes from a cumulative sum over the flat (token, choice) stream,
tokens scatter into an [E, C, D] buffer, the experts run as one batched
product per weight, and the outputs gather back weighted by the router's
renormalised top-k probabilities.  Choices past an expert's capacity C are
dropped: they scatter into an overflow slot C that is sliced off (the
reference's ``.at[].set(mode="drop")``).  Tokens are cut into
``n_dispatch_groups`` groups when that divides them, each with its own
capacity and cumulative sum.  The router computes in f32 (its leaf is
declared f32).

The combine sums each token's k weighted expert outputs over the choice
axis: the reference scatter-adds them into the token rows
(``.at[gidx, flat_tok].add``), and its (token, choice) stream is
token-major, so the two are the same sum; a sum over an axis is also
deterministic on the card, where an atomic scatter-add is not.

Under a mesh context the dispatch carries the reference's three
constraints (the token groups over ``dispatch``, the [G, E, C, D] buffer
and the experts' outputs over ``dispatch`` and ``act_experts``):
identities on one card, checked against the shapes
(:func:`repro_torch.distributed.sharding.constrain`).

Losses: switch-style load balance, router z-loss and the dropped fraction,
returned as f32 scalars the way the reference computes them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.common.params import P
from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float
    n_shared_experts: int = 0
    n_dispatch_groups: int = 1


def moe_p(dims: MoEDims) -> dict:
    p = {
        "router": P(
            shape=(dims.d_model, dims.n_experts), axes=("embed", "experts"),
            dtype=torch.float32,
        ),
        "w_gate": P(
            shape=(dims.n_experts, dims.d_model, dims.d_ff),
            axes=("experts", "embed", "mlp"), fan_in_axes=(1,),
        ),
        "w_up": P(
            shape=(dims.n_experts, dims.d_model, dims.d_ff),
            axes=("experts", "embed", "mlp"), fan_in_axes=(1,),
        ),
        "w_down": P(
            shape=(dims.n_experts, dims.d_ff, dims.d_model),
            axes=("experts", "mlp", "embed"), fan_in_axes=(1,),
        ),
    }
    if dims.n_shared_experts:
        ff = dims.d_ff * dims.n_shared_experts
        p["shared"] = {
            "w_gate": P(shape=(dims.d_model, ff), axes=("embed", "mlp")),
            "w_up": P(shape=(dims.d_model, ff), axes=("embed", "mlp")),
            "w_down": P(shape=(ff, dims.d_model), axes=("mlp", "embed")),
        }
    return p


def capacity(n_tokens: int, dims: MoEDims) -> int:
    c = int(n_tokens * dims.top_k * dims.capacity_factor / dims.n_experts)
    return max(c, dims.top_k)


def _swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    h = F.silu((x @ w_gate).float()).to(x.dtype) * (x @ w_up)
    return h @ w_down


def moe_forward(x: torch.Tensor, p, dims: MoEDims
                ) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D] (or [T, D]) → (out, aux losses)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    flat = x.reshape(-1, d)  # [T_total, D]
    t_total = flat.shape[0]
    e, k = dims.n_experts, dims.top_k
    ng = dims.n_dispatch_groups
    if ng <= 1 or t_total % ng:
        ng = 1
    xt = flat.reshape(ng, t_total // ng, d)  # [G, T, D]
    xt = shd.constrain(xt, "dispatch", None, None)
    t = xt.shape[1]
    c = capacity(t, dims)

    logits = xt.float() @ p["router"]  # [G, T, E] f32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # [G, T, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, choice) in its expert: a per-group cumsum
    # over the token-major stream
    flat_e = top_e.reshape(ng, t * k)
    onehot = F.one_hot(flat_e, e).to(torch.int32)  # [G, T*k, E]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    flat_pos = (pos * onehot).sum(dim=2)  # [G, T*k]
    del onehot, pos
    keep = flat_pos < c
    safe_pos = torch.where(keep, flat_pos, c)  # c: the overflow slot
    gidx = torch.arange(ng, device=x.device)[:, None]
    slot = (gidx * e + flat_e) * (c + 1) + safe_pos  # into [G, E, C+1]
    xe = xt.new_zeros(ng * e * (c + 1), d)
    xe[slot.reshape(-1)] = xt.repeat_interleave(k, dim=1).reshape(-1, d)
    xe = xe.view(ng, e, c + 1, d)[:, :, :c]  # drop the overflow slot
    xe = shd.constrain(xe, "dispatch", "act_experts", None, None)

    # the experts: one batched product per weight, [G*E] batches
    xe = xe.transpose(0, 1).reshape(e, ng * c, d)
    ye = _swiglu(xe, p["w_gate"], p["w_up"], p["w_down"])  # [E, G*C, D]
    ye = ye.view(e, ng, c, d).transpose(0, 1)  # [G, E, C, D]
    ye = shd.constrain(ye, "dispatch", "act_experts", None, None)

    # gather back + combine weighted by router prob
    flat_out = ye[gidx, flat_e, flat_pos.clamp_max(c - 1)]  # [G, T*k, D]
    w = (top_p.reshape(ng, -1) * keep.float()).to(xt.dtype)
    out = (flat_out * w[..., None]).view(ng, t, k, d).sum(dim=2)
    out = out.reshape(t_total, d)

    if dims.n_shared_experts:
        sp = p["shared"]
        out = out + _swiglu(flat, sp["w_gate"], sp["w_up"], sp["w_down"])

    # aux losses (switch transformer)
    me = probs.reshape(-1, e).mean(dim=0)  # mean router prob per expert
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e.reshape(-1), keep.reshape(-1).float()) / max(t_total, 1)
    load_balance = e * (me * ce).sum() / k
    z = torch.logsumexp(logits, dim=-1)
    aux = {
        "load_balance": load_balance,
        "router_z": (z * z).mean(),
        "dropped_fraction": 1.0 - keep.float().mean(),
    }
    return out.reshape(orig_shape), aux
