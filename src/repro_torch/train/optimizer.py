"""Optimizers on parameter trees (counterpart of
``repro/train/optimizer.py``; no optimizer library).

* **AdamW** — the default for the ≤14B configs.
* **Adafactor** — factored second moments for the 480B / 1T MoE configs:
  AdamW's f32 state for 1T parameters is ~12 TB, the factored statistics
  are O(d_in + d_out) per matrix.

A tree is nested dicts and lists of tensors (the port's
:func:`repro_torch.models.model.param_tree`).  ``update(grads, state,
params, lr)`` returns new parameters and state and leaves its arguments
as they are; every update runs in f32 and casts back to the parameter's
dtype, as the reference's does.  Each optimizer's ``state_spec(param_spec)``
is the reference's: a ``P`` declaration tree of its state, so the FSDP
sharding rules apply to optimizer state exactly as they do to parameters
(ZeRO-style); given the stacked spec it gives the reference's layout,
given a per-layer spec the layout of the state ``init`` makes.
:func:`optimizer_state_bytes` counts its bytes from the parameter spec.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.common import params as par
from repro_torch.common.params import P


def tree_zeros_like_spec(spec_tree):
    return par.tree_map_p(
        lambda p: P(shape=p.shape, axes=p.axes, init="zeros",
                    dtype=torch.float32),
        spec_tree,
    )


def _count_spec() -> P:
    return P(shape=(), axes=(), init="zeros", dtype=torch.int32)


def _f32_zeros(tree):
    return par.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        tree)


def _count(tree) -> torch.Tensor:
    """The step count, int32, on the parameters' device."""
    leaves = par.leaves(tree)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in par.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return par.tree_map(lambda x: x * scale.to(x.dtype), tree), norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple]  # (grads, state, params, lr) -> (params, state)
    state_spec: Callable[[Any], Any]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(
    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        z = _f32_zeros(params)
        return {"mu": z, "nu": par.tree_map(torch.clone, z),
                "count": _count(params)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        cf = count.float()
        c1 = 1.0 - torch.tensor(b1, device=cf.device) ** cf
        c2 = 1.0 - torch.tensor(b2, device=cf.device) ** cf

        def one(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype), m, v

        out = [one(*a) for a in zip(par.leaves(grads),
                                    par.leaves(state["mu"]),
                                    par.leaves(state["nu"]),
                                    par.leaves(params))]
        new_p, new_m, new_v = (par.unflatten(params, [o[i] for o in out])
                               for i in range(3))
        return new_p, {"mu": new_m, "nu": new_v, "count": count}

    def state_spec(param_spec):
        return {
            "mu": tree_zeros_like_spec(param_spec),
            "nu": tree_zeros_like_spec(param_spec),
            "count": _count_spec(),
        }

    return Optimizer("adamw", init, update, state_spec)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, Shazeer & Stern 2018)
# ---------------------------------------------------------------------------

_FACTOR_MIN = 2  # factor last two dims when both ≥ this


def _factored(shape) -> bool:
    return (
        len(shape) >= 2
        and shape[-1] >= _FACTOR_MIN
        and shape[-2] >= _FACTOR_MIN
    )


def adafactor(
    decay: float = 0.99, eps: float = 1e-30, clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        def one(x):
            z = dict(dtype=torch.float32, device=x.device)
            if _factored(x.shape):
                return {
                    "vr": torch.zeros(x.shape[:-1], **z),
                    "vc": torch.zeros(x.shape[:-2] + x.shape[-1:], **z),
                }
            return {"v": torch.zeros(x.shape, **z)}

        return {"v": par.tree_map(one, params), "count": _count(params)}

    def update(grads, state, params, lr):
        count = state["count"] + 1

        def one(g, v, p):
            g = g.float()
            if _factored(g.shape):
                g2 = g * g + eps
                vr = decay * v["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * v["vc"] + (1 - decay) * g2.mean(dim=-2)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                     min=1e-30)
                upd = g / torch.sqrt(
                    torch.clamp(r[..., None] * vc[..., None, :], min=1e-30))
                nv = {"vr": vr, "vc": vc}
            else:
                nv_full = decay * v["v"] + (1 - decay) * (g * g + eps)
                upd = g / torch.sqrt(torch.clamp(nv_full, min=1e-30))
                nv = {"v": nv_full}
            # RMS update clipping
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype), nv

        out = [one(g, v, p) for g, v, p in zip(
            par.leaves(grads), _per_leaf(state["v"], params),
            par.leaves(params))]
        return (par.unflatten(params, [o[0] for o in out]),
                {"v": par.unflatten(params, [o[1] for o in out]),
                 "count": count})

    def state_spec(param_spec):
        def one(p: P):
            if _factored(p.shape):
                return {
                    "vr": P(shape=p.shape[:-1], axes=p.axes[:-1],
                            init="zeros", dtype=torch.float32),
                    "vc": P(shape=p.shape[:-2] + p.shape[-1:],
                            axes=p.axes[:-2] + p.axes[-1:],
                            init="zeros", dtype=torch.float32),
                }
            return {"v": P(shape=p.shape, axes=p.axes, init="zeros",
                           dtype=torch.float32)}

        return {"v": par.tree_map_p(one, param_spec), "count": _count_spec()}

    return Optimizer("adafactor", init, update, state_spec)


def _per_leaf(vtree, params) -> list:
    """Adafactor's state cut at the parameter leaves: each parameter's
    ``{"vr", "vc"}`` or ``{"v"}`` dict, in the parameters' leaf order."""
    if isinstance(params, dict):
        return [d for k in params for d in _per_leaf(vtree[k], params[k])]
    if isinstance(params, (list, tuple)):
        return [d for v, p in zip(vtree, params) for d in _per_leaf(v, p)]
    return [vtree]


def for_config(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    raise ValueError(f"unknown optimizer {name!r}")


def optimizer_state_bytes(param_spec, name: str) -> int:
    """Analytic optimizer-state footprint: the bytes of the leaves of the
    optimizer's ``state_spec``."""
    spec = for_config(name).state_spec(param_spec)
    return int(sum(math.prod(p.shape) * (p.dtype or torch.float32).itemsize
                   for p in par.leaves(spec)))
