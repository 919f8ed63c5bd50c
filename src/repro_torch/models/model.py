"""Model assembly for serving (counterpart of ``repro/models/model.py``),
dense family only.

Parameters are declared once as a tree of :class:`P` leaves
(:func:`param_spec`), with the reference's stacked ``[n_layers, ...]``
block leaves, so shapes and counts compare one to one.  Concrete parameters
live in an ``nn.Module`` (:func:`params_module`): ``embed``,
``final_norm``, ``unembed`` and ``blocks``, an ``nn.ModuleList`` with one
entry per layer, which the forward passes walk in a Python loop where the
reference scans.  Parameters are frozen (serving only).

Entry points:
  * ``prefill(cfg, params, batch, max_len)`` → (last-position logits
    [B, Vpad], cache at ``max_len``)
  * ``decode_step(cfg, params, cache, tokens, pos)`` → (logits [B, Vpad],
    the same cache, written in place)
  * ``init_cache(cfg, batch, max_len)``

Both default to bf16 compute: float parameters are cast to the compute
dtype (a no-op once they are in it, so a caller may cast once up front);
norms, SiLU and RoPE run in f32 inside.  Vocab is padded to a multiple of
256.  Families other than dense raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.common import params as par
from repro_torch.common.params import P
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers

VOCAB_PAD = 256

_WAITS_FOR = {
    "moe": "the MoE slice (models/moe.py)",
    "hybrid": "the hybrid slice (models/ssm.py)",
    "ssm": "the RWKV slice (models/rwkv6.py)",
    "encdec": "the whisper slice (cross-attention, models/attention.py)",
    "vlm": "the VLM slice (projector frontend)",
}


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it waits "
            f"for {_WAITS_FOR.get(cfg.family, 'its own slice')}"
        )


# ---------------------------------------------------------------------------
# Layer plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    mixer: str  # attn
    mlp: str  # swiglu


def layer_plan(cfg: ModelConfig) -> list[LayerPlan]:
    """The repeating block pattern: one attention + SwiGLU layer."""
    _require_dense(cfg)
    return [LayerPlan("attn", "swiglu")]


def _dims(cfg: ModelConfig) -> attention.AttnDims:
    return attention.AttnDims(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
    )


# ---------------------------------------------------------------------------
# Parameter spec
# ---------------------------------------------------------------------------


def _norm_p(d: int) -> dict:
    return {"scale": P(shape=(d,), axes=("embed",), init="ones")}


def _layer_spec(cfg: ModelConfig, plan: LayerPlan) -> dict:
    d = cfg.d_model
    return {
        "ln1": _norm_p(d),
        "attn": attention.attn_p(_dims(cfg)),
        "ln2": _norm_p(d),
        "mlp": layers.sized(layers.swiglu_p(), embed=d, mlp=cfg.d_ff),
    }


def param_spec(cfg: ModelConfig, *, max_seq_len: int = 0) -> dict:
    """The declaration tree, shaped as the reference's (``blocks`` is a list
    of one period's layers, each leaf stacked ``[n_layers // period, ...]``).
    ``max_seq_len`` sizes learned positions, which the dense family lacks."""
    d = cfg.d_model
    pv = padded_vocab(cfg.vocab_size)
    plans = layer_plan(cfg)
    spec: dict[str, Any] = {
        "embed": layers.sized(layers.embed_p(), vocab=pv, embed=d),
        "final_norm": _norm_p(d),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = layers.sized(
            layers.unembed_p(tied=False), embed=d, vocab=pv
        )
    spec["blocks"] = par.stack(
        [_layer_spec(cfg, p) for p in plans], cfg.n_layers // len(plans)
    )
    return spec


def _frozen(tree) -> nn.Module:
    """Nested dicts/lists of tensors → ModuleDict / ModuleList /
    ParameterDict of frozen parameters (tensors are shared, not copied)."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([_frozen(t) for t in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        raise ValueError(f"mixed tensor/subtree node: {sorted(tree)}")
    return nn.ModuleDict({k: _frozen(v) for k, v in tree.items()})


def _tree(module: nn.Module):
    """The inverse of :func:`_frozen`: nested dicts/lists of tensors."""
    if isinstance(module, nn.ParameterDict):
        return {k: v for k, v in module.items()}
    if isinstance(module, nn.ModuleList):
        return [_tree(m) for m in module]
    return {k: _tree(m) for k, m in module.items()}


def params_module(cfg: ModelConfig, tree: dict) -> nn.Module:
    """Concrete parameters shaped like :func:`param_spec` (stacked blocks)
    → the serving module, with ``blocks`` unstacked into one entry per
    layer (views of the stacked tensors, no copy)."""
    period = len(layer_plan(cfg))
    stacked = tree["blocks"]
    blocks = [
        par.tree_map(lambda a, i=i: a[i // period], stacked[i % period])
        for i in range(cfg.n_layers)
    ]
    return _frozen({**{k: v for k, v in tree.items() if k != "blocks"},
                    "blocks": blocks})


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _apply_norm(x, p, cfg: ModelConfig):
    if "bias" in p:
        return layers.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return layers.rms_norm(x, p["scale"], cfg.norm_eps)


def cast_params(cfg: ModelConfig, params: nn.Module, dtype,
                device=None) -> nn.Module:
    """Cast float parameters to the compute dtype (the dense family
    declares no per-leaf dtype, so every float leaf casts), and move them
    to ``device`` when one is given.  Returns ``params`` itself when nothing
    changes; never modifies it.  A module this function made remembers its
    dtype, so casting it again to that dtype in place costs no walk over
    the parameters (the serving engine casts once, every step re-checks)."""
    if device is None and getattr(params, "compute_dtype", None) == dtype:
        return params
    device = torch.device(device) if device is not None else None

    def target(t: torch.Tensor):
        return dtype if t.is_floating_point() else t.dtype

    def moves(t: torch.Tensor) -> bool:
        return device is not None and (
            t.device.type != device.type
            or device.index not in (None, t.device.index))

    if not any(p.dtype != target(p) or moves(p) for p in params.parameters()):
        return params
    out = _frozen(par.tree_map(
        lambda t: t.to(device=device, dtype=target(t)), _tree(params)))
    out.compute_dtype = dtype
    return out


def _apply_mlp(x, lp, plan: LayerPlan):
    if plan.mlp == "swiglu":
        return layers.swiglu(x, lp["mlp"])
    raise ValueError(plan.mlp)


def _logits(cfg: ModelConfig, params, x):
    if "unembed" in params:
        return layers.unembed(x, params["unembed"], params["embed"])
    return layers.unembed(x, {}, params["embed"])


def _rope(dims: attention.AttnDims, positions: torch.Tensor):
    """RoPE's (cos, sin) at ``positions``, shared by every layer; None
    when the model has no RoPE."""
    if dims.rope_theta <= 0:
        return None
    return layers.rope_cos_sin(positions, dims.head_dim, dims.rope_theta)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed KV cache {"layers": [{k, v: [B, Hkv, max_len, Dh]}] * L}."""
    dims = _dims(cfg)
    device = resolve_device(device)
    return {"layers": [
        attention.init_kv_cache(batch, max_len, dims, dtype, device)
        for _ in range(cfg.n_layers)
    ]}


def decode_step(cfg: ModelConfig, params: nn.Module, cache: dict,
                tokens: torch.Tensor, pos: int, *, dtype=torch.bfloat16):
    """One token for every sequence. tokens: [B] ints; pos: this token's
    position, the same for every row.  Every layer's cache gets this
    token's K/V at ``pos`` in place, and attention covers [0, pos].

    Returns (logits [B, Vpad], cache)."""
    params = cast_params(cfg, params, dtype)
    plans = layer_plan(cfg)
    dims = _dims(cfg)
    x = layers.embed(tokens, params["embed"], dtype)
    # per-step inputs of every layer's attention, made once
    rope = _rope(dims, torch.full((1,), pos, device=x.device))
    lens = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                      device=x.device)
    for i, (lp, lc) in enumerate(zip(params["blocks"], cache["layers"])):
        h = _apply_norm(x, lp["ln1"], cfg)
        h, _ = attention.attn_decode(h, lp["attn"], lc, pos, dims, rope, lens)
        x = x + h
        h = _apply_norm(x, lp["ln2"], cfg)
        x = x + _apply_mlp(h, lp, plans[i % len(plans)])
    x = _apply_norm(x, params["final_norm"], cfg)
    return _logits(cfg, params, x), cache


def _pad_time(a: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, Hkv, S, Dh] → [B, Hkv, max_len, Dh]: zero-padded, or truncated
    when S > max_len."""
    pad = max_len - a.shape[2]
    if pad <= 0:
        return a[:, :, :max_len].contiguous()
    return torch.nn.functional.pad(a, (0, 0, 0, pad))


def prefill(cfg: ModelConfig, params: nn.Module, batch: dict, max_len: int,
            *, dtype=torch.bfloat16):
    """Process the prompt, return (last-position logits, cache at max_len).

    batch: {"tokens": [B, S] ints}.  Every position is attended causally,
    padding included (the caller left-pads with token 0, as the reference
    does)."""
    params = cast_params(cfg, params, dtype)
    plans = layer_plan(cfg)
    dims = _dims(cfg)
    table = params["embed"]["table"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    x = layers.embed(tokens, params["embed"], dtype)
    rope = _rope(dims, torch.arange(tokens.shape[1], device=x.device))
    caches = []
    for i, lp in enumerate(params["blocks"]):
        h = _apply_norm(x, lp["ln1"], cfg)
        h, kv = attention.attn_prefill(h, lp["attn"], dims, rope)
        caches.append({"k": _pad_time(kv["k"], max_len),
                       "v": _pad_time(kv["v"], max_len)})
        x = x + h
        h = _apply_norm(x, lp["ln2"], cfg)
        x = x + _apply_mlp(h, lp, plans[i % len(plans)])
    x = _apply_norm(x[:, -1], params["final_norm"], cfg)
    return _logits(cfg, params, x), {"layers": caches}


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    spec: dict
    prefill_fn: Callable
    decode_fn: Callable
    init_cache_fn: Callable

    def init(self, seed: int = 0, *, device=None,
             dtype=torch.float32) -> nn.Module:
        """Parameters drawn by the spec's init rules from a generator seeded
        with ``seed`` on ``device`` (the card unless the CPU is asked)."""
        tree = par.init_params(self.spec, seed, dtype=dtype,
                               device=resolve_device(device))
        return params_module(self.cfg, tree)

    @property
    def n_params(self) -> int:
        return par.param_count(self.spec)


def build_model(cfg: ModelConfig, *, max_seq_len: int = 0) -> Model:
    spec = param_spec(cfg, max_seq_len=max_seq_len)
    return Model(
        cfg=cfg,
        spec=spec,
        prefill_fn=functools.partial(prefill, cfg),
        decode_fn=functools.partial(decode_step, cfg),
        init_cache_fn=functools.partial(init_cache, cfg),
    )
