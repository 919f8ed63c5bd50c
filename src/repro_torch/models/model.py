"""Model assembly (counterpart of ``repro/models/model.py``): every
family the reference defines — dense, MoE (with Arctic's dense residual),
hybrid Mamba + MoE + attention (Jamba), RWKV6, the Whisper
encoder-decoder and the VLM backbone — with its full-sequence forward,
training loss, prefill and decode.

Parameters are declared once as a tree of :class:`P` leaves
(:func:`param_spec`), with the reference's stacked block leaves
(``blocks`` is a list of one period's layers, each leaf
``[n_layers // period, ...]``; Whisper's ``enc_blocks`` likewise), so
shapes and counts compare one to one.  Concrete parameters live in an
``nn.Module`` (:func:`params_module`) whose ``blocks`` (and
``enc_blocks``) hold one entry per layer, which the passes walk in a
Python loop where the reference scans.  Parameters are frozen for
serving and trainable on request (``requires_grad``); under grad the
full-sequence forward rematerialises each repeating block as
``cfg.remat`` says (:func:`_remat`).

Entry points:
  * ``forward(cfg, params, batch)`` → (logits [B, S_text, Vpad], aux)
  * ``loss_fn(cfg, params, batch)`` → (loss, metrics), for training
  * ``prefill(cfg, params, batch, max_len)`` → (last-position logits
    [B, Vpad], cache at ``max_len``)
  * ``decode_step(cfg, params, cache, tokens, pos)`` → (logits [B, Vpad],
    the same cache, updated in place)
  * ``init_cache(cfg, batch, max_len)``

``batch`` holds ``tokens`` [B, S], plus ``frames`` [B, F, D] (encdec:
the stubbed conv frontend's output) or ``patch_embeds`` [B, P, 3200]
(vlm: the stubbed ViT's output, projected and put before the tokens).
Caches hold one entry per layer: KV for attention, (conv buffer, state)
for Mamba, (token shifts, state) for RWKV; Whisper's adds each layer's
cross-attention KV.  Compute defaults to bf16: float parameters are cast
to the compute dtype except those whose spec fixes a dtype (the MoE
router, the SSM's ``a_log`` and ``d_skip`` stay f32); norms, activations
and RoPE run in f32 inside.  Vocab is padded to a multiple of 256.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.common import params as par
from repro_torch.common.params import P
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe, rwkv6, ssm

VOCAB_PAD = 256
RWKV_CHUNK = 64  # wkv6 materializes [B,H,Q,Q,dh]
VIT_D = 3200  # InternViT-6B hidden size (the VLM frontend's stub boundary)


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


# ---------------------------------------------------------------------------
# Layer plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    mixer: str  # attn | ssm | rwkv
    mlp: str  # swiglu | gelu | moe | moe_dense | rwkv_cm


def layer_plan(cfg: ModelConfig) -> list[LayerPlan]:
    """The repeating block pattern for this architecture."""
    if cfg.family == "ssm":
        return [LayerPlan("rwkv", "rwkv_cm")]
    period = 1
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.layer_period)
    if cfg.attn_period > 0:
        period = math.lcm(period, cfg.attn_period)
    plans = []
    for i in range(period):
        mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
        if cfg.is_moe_layer(i):
            mlp = "moe_dense" if cfg.dense_residual_ff else "moe"
        else:
            mlp = "gelu" if cfg.family == "encdec" else "swiglu"
        plans.append(LayerPlan(mixer, mlp))
    return plans


@dataclasses.dataclass(frozen=True)
class Dims:
    attn: attention.AttnDims
    ssm: ssm.SSMDims | None
    rwkv: rwkv6.RWKVDims | None
    moe: moe.MoEDims | None


def _dims(cfg: ModelConfig) -> Dims:
    attn_dims = attention.AttnDims(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        bias=cfg.family == "encdec",
        seq_shard=cfg.attn_seq_shard,
    )
    ssm_dims = None
    if cfg.ssm is not None and cfg.family == "hybrid":
        ssm_dims = ssm.SSMDims(
            d_model=cfg.d_model,
            d_state=cfg.ssm.d_state,
            d_conv=cfg.ssm.d_conv,
            expand=cfg.ssm.expand,
            dt_rank=cfg.ssm.dt_rank,
            chunk=cfg.mixer_chunk or cfg.ssm.chunk,
        )
    rwkv_dims = None
    if cfg.family == "ssm":
        default = min(cfg.ssm.chunk if cfg.ssm else RWKV_CHUNK, RWKV_CHUNK)
        rwkv_dims = rwkv6.RWKVDims(
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            head_dim=cfg.resolved_head_dim,
            chunk=cfg.mixer_chunk or default,
            lora_rank=max(32, cfg.d_model // 64),
            decay_lora_rank=max(32, cfg.d_model // 32),
        )
    moe_dims = None
    if cfg.moe is not None:
        moe_dims = moe.MoEDims(
            d_model=cfg.d_model,
            d_ff=cfg.moe.d_ff,
            n_experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor,
            n_shared_experts=cfg.moe.n_shared_experts,
            n_dispatch_groups=cfg.moe_dispatch_groups,
        )
    return Dims(attn_dims, ssm_dims, rwkv_dims, moe_dims)


# ---------------------------------------------------------------------------
# Parameter spec
# ---------------------------------------------------------------------------


def _norm_p(d: int) -> dict:
    return {"scale": P(shape=(d,), axes=("embed",), init="ones")}


def _ln_p(d: int) -> dict:
    return {
        "scale": P(shape=(d,), axes=("embed",), init="ones"),
        "bias": P(shape=(d,), axes=("embed",), init="zeros"),
    }


def _layer_spec(cfg: ModelConfig, plan: LayerPlan) -> dict:
    dims = _dims(cfg)
    d = cfg.d_model
    spec: dict[str, Any] = {}
    if plan.mixer == "attn":
        spec["ln1"] = _ln_p(d) if cfg.family == "encdec" else _norm_p(d)
        spec["attn"] = attention.attn_p(dims.attn)
    elif plan.mixer == "ssm":
        spec["ln1"] = _norm_p(d)
        spec["ssm"] = ssm.ssm_p(dims.ssm)
    elif plan.mixer == "rwkv":
        spec["ln1"] = _norm_p(d)
        spec["tm"] = rwkv6.time_mix_p(dims.rwkv)
    if plan.mlp in ("swiglu", "gelu"):
        spec["ln2"] = _ln_p(d) if cfg.family == "encdec" else _norm_p(d)
    if plan.mlp == "swiglu":
        spec["mlp"] = layers.sized(layers.swiglu_p(), embed=d, mlp=cfg.d_ff)
    elif plan.mlp == "gelu":
        spec["mlp"] = layers.sized(layers.gelu_mlp_p(), embed=d, mlp=cfg.d_ff)
    elif plan.mlp in ("moe", "moe_dense"):
        spec["ln2"] = _norm_p(d)
        spec["moe"] = moe.moe_p(dims.moe)
        if plan.mlp == "moe_dense":
            spec["dense_mlp"] = layers.sized(
                layers.swiglu_p(), embed=d, mlp=cfg.dense_residual_ff
            )
    elif plan.mlp == "rwkv_cm":
        spec["ln2"] = _norm_p(d)
        spec["cm"] = rwkv6.channel_mix_p(dims.rwkv, cfg.d_ff)
    return spec


def _encoder_layer_spec(cfg: ModelConfig) -> dict:
    return {
        "ln1": _ln_p(cfg.d_model),
        "attn": attention.attn_p(_dims(cfg).attn),
        "ln2": _ln_p(cfg.d_model),
        "mlp": layers.sized(
            layers.gelu_mlp_p(), embed=cfg.d_model, mlp=cfg.d_ff
        ),
    }


def _decoder_layer_spec(cfg: ModelConfig) -> dict:
    spec = _encoder_layer_spec(cfg)
    spec["ln_cross"] = _ln_p(cfg.d_model)
    spec["cross"] = attention.attn_p(_dims(cfg).attn)
    return spec


def param_spec(cfg: ModelConfig, *, max_seq_len: int = 0) -> dict:
    """The declaration tree, shaped as the reference's.  ``max_seq_len``
    sizes Whisper's learned decoder positions (at least 448)."""
    d = cfg.d_model
    pv = padded_vocab(cfg.vocab_size)
    spec: dict[str, Any] = {
        "embed": layers.sized(layers.embed_p(), vocab=pv, embed=d),
        "final_norm": _ln_p(d) if cfg.family == "encdec" else _norm_p(d),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = layers.sized(
            layers.unembed_p(tied=False), embed=d, vocab=pv
        )
    if cfg.family == "encdec":
        spec["enc_pos"] = P(
            shape=(cfg.n_audio_frames, d), axes=(None, "embed"),
            init="normal", scale=0.02,
        )
        spec["dec_pos"] = P(
            shape=(max(max_seq_len, 448), d), axes=(None, "embed"),
            init="normal", scale=0.02,
        )
        spec["enc_blocks"] = par.stack(
            [_encoder_layer_spec(cfg)], cfg.n_encoder_layers
        )
        spec["blocks"] = par.stack([_decoder_layer_spec(cfg)], cfg.n_layers)
        spec["enc_final_norm"] = _ln_p(d)
        return spec
    if cfg.family == "vlm":
        spec["projector"] = {
            "ln": _ln_p(VIT_D),
            "w1": P(shape=(VIT_D, d), axes=(None, "embed")),
            "b1": P(shape=(d,), axes=("embed",), init="zeros"),
            "w2": P(shape=(d, d), axes=("embed", "embed2")),
            "b2": P(shape=(d,), axes=("embed",), init="zeros"),
        }
    plans = layer_plan(cfg)
    if cfg.n_layers % len(plans):
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} not divisible by layer "
            f"period {len(plans)}"
        )
    spec["blocks"] = par.stack(
        [_layer_spec(cfg, p) for p in plans], cfg.n_layers // len(plans)
    )
    return spec


# ---------------------------------------------------------------------------
# Parameter modules
# ---------------------------------------------------------------------------

_STACKS = ("blocks", "enc_blocks")  # stacked block lists, one per layer kind


def _per_layer(cfg: ModelConfig, tree: dict, pick: Callable) -> dict:
    """A tree shaped like :func:`param_spec` with its stacked block lists
    replaced by one entry per layer: layer ``i`` of a stack with a period
    of ``n`` layers is ``pick(leaf, i // n)`` of position ``i % n``."""
    out = dict(tree)
    for key in _STACKS:
        if key not in tree:
            continue
        stacked = tree[key]
        n = len(stacked)
        depth = cfg.n_layers if key == "blocks" else cfg.n_encoder_layers
        out[key] = [par.tree_map(lambda a, j=i // n: pick(a, j), stacked[i % n])
                    for i in range(depth)]
    return out


class ParamNode(nn.Module):
    """One dict of a parameter tree: tensors as parameters (trainable when
    ``requires_grad``, frozen otherwise), subtrees as child modules, each
    read by its key (``node["wq"]``) in the spec's order.  A parameter
    given as one is kept as it is (shared); a tensor that requires grad
    without being a leaf (a differentiable cast of trainable leaves) is
    held as a buffer, so gradients flow through it to its leaves."""

    def __init__(self, tree: dict, requires_grad: bool = False):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, nn.Parameter):
                self.register_parameter(k, v)
            elif isinstance(v, torch.Tensor) and v.requires_grad:
                self.register_buffer(k, v, persistent=False)
            elif isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(
                    v, requires_grad=requires_grad and v.is_floating_point()))
            else:
                self.add_module(k, _node(v, requires_grad))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._buffers:
            return self._buffers[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def keys(self) -> list[str]:
        return list(self._keys)


def per_layer_spec(cfg: ModelConfig, spec: dict) -> dict:
    """:func:`param_spec`'s declarations in the module's per-layer layout
    (:func:`param_tree`'s): each stacked leaf without its leading
    ``layers`` axis, which never shards."""

    def unstack(p: P, j: int) -> P:
        return dataclasses.replace(
            p, shape=p.shape[1:], axes=p.axes[1:],
            fan_in_axes=tuple(a - 1 for a in p.fan_in_axes))

    return _per_layer(cfg, spec, unstack)


def _node(tree, requires_grad: bool = False) -> nn.Module:
    """Nested dicts/lists of tensors → ParamNode / ModuleList of parameters
    (tensors are shared, not copied)."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([_node(t, requires_grad) for t in tree])
    return ParamNode(tree, requires_grad)


def param_tree(module: nn.Module):
    """The inverse of :func:`_node`: the module's leaves as nested dicts
    and per-layer lists of tensors (the optimizers' and the train step's
    tree)."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m) for m in module]
    return {k: module[k] if isinstance(module[k], torch.Tensor)
            else param_tree(module[k]) for k in module.keys()}


def params_module(cfg: ModelConfig, tree: dict, *,
                  requires_grad: bool = False) -> nn.Module:
    """Concrete parameters shaped like :func:`param_spec` (stacked blocks)
    → the module, with ``blocks`` (and ``enc_blocks``) unstacked into one
    entry per layer (views of the stacked tensors, no copy).  Its float
    leaves are trainable with ``requires_grad`` (training), frozen
    otherwise (serving)."""
    return _node(_per_layer(cfg, tree, lambda a, j: a[j]), requires_grad)


def stacked_tree(cfg: ModelConfig, tree):
    """A per-layer tree (:func:`param_tree`'s layout, or gradients and
    optimizer moments shaped like it) → the reference's layout of
    :func:`param_spec`, each block position's layers stacked on a new
    leading axis (copies).  Checkpoints are written in this layout."""
    spec = param_spec(cfg)
    out = dict(tree)
    for key in _STACKS:
        if key not in tree:
            continue
        n = len(spec[key])
        out[key] = [par.tree_map(lambda *ls: torch.stack(ls),
                                 *tree[key][pos::n]) for pos in range(n)]
    return out


@functools.cache
def _kept_dtype_paths(cfg: ModelConfig) -> frozenset:
    """Paths, in the module's per-layer layout, of the leaves whose spec
    fixes their dtype: casts leave them as they are."""
    spec = _per_layer(cfg, param_spec(cfg), lambda p, j: p)
    return frozenset(path for path, p in par.leaves_with_paths(spec)
                     if p.dtype is not None)


def cast_params(cfg: ModelConfig, params: nn.Module, dtype,
                device=None) -> nn.Module:
    """Cast float parameters to the compute dtype, except the leaves whose
    spec declares a dtype (f32 routers and SSM decay logs stay f32), and
    move them to ``device`` when one is given.  Returns ``params`` itself
    when nothing changes; never modifies it.  Under grad the cast is
    differentiable: a trainable f32 leaf gets its gradient through its
    bf16 copy.  A module this function made
    remembers its dtype, so casting it again to that dtype in place costs
    no walk over the parameters (the serving engine casts once, every step
    re-checks)."""
    if device is None and getattr(params, "compute_dtype", None) == dtype:
        return params
    device = torch.device(device) if device is not None else None
    kept = _kept_dtype_paths(cfg)
    tree = param_tree(params)

    def target(path: str, t: torch.Tensor):
        if path in kept or not t.is_floating_point():
            return t.dtype
        return dtype

    def moves(t: torch.Tensor) -> bool:
        return device is not None and (
            t.device.type != device.type
            or device.index not in (None, t.device.index))

    if not any(t.dtype != target(path, t) or moves(t)
               for path, t in par.leaves_with_paths(tree)):
        return params
    out = _node(par.tree_map_with_paths(
        lambda path, t: t.to(device=device, dtype=target(path, t)), tree))
    out.compute_dtype = dtype
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _apply_norm(x, p, cfg: ModelConfig):
    if "bias" in p:
        return layers.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return layers.rms_norm(x, p["scale"], cfg.norm_eps)


def _apply_mlp(x, lp, plan: LayerPlan, dims: Dims):
    """The layer's MLP on normed x: (out, aux losses, {} unless MoE)."""
    if plan.mlp == "swiglu":
        return layers.swiglu(x, lp["mlp"]), {}
    if plan.mlp == "gelu":
        return layers.gelu_mlp(x, lp["mlp"]), {}
    if plan.mlp in ("moe", "moe_dense"):
        y, aux = moe.moe_forward(x, lp["moe"], dims.moe)
        if plan.mlp == "moe_dense":
            y = y + layers.swiglu(x, lp["dense_mlp"])
        return y, aux
    if plan.mlp == "rwkv_cm":
        return rwkv6.channel_mix_forward(x, lp["cm"]), {}
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


def _embed_inputs(cfg: ModelConfig, params, batch: dict, dtype):
    """Token (+ modality) embedding; returns (x [B, S, D], the number of
    positions before the text)."""
    table = params["embed"]["table"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    x = layers.embed(tokens, params["embed"], dtype)
    if cfg.family == "vlm":
        pp = params["projector"]
        patches = torch.as_tensor(batch["patch_embeds"], device=table.device)
        pe = layers.layer_norm(patches.to(dtype), pp["ln"]["scale"],
                               pp["ln"]["bias"], cfg.norm_eps)
        pe = layers.gelu(pe @ pp["w1"] + pp["b1"])
        pe = pe @ pp["w2"] + pp["b2"]
        return torch.cat([pe, x], dim=1), patches.shape[1]
    if cfg.family == "encdec":
        x = x + params["dec_pos"][:x.shape[1]].to(dtype)
    return x, 0


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy: keep the matrix products' outputs and
    recompute the rest (the reference's ``dots_with_no_batch_dims_
    saveable``; bmm is saved too)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, mode: str) -> Callable:
    """The reference's per-block rematerialisation: ``"none"`` keeps every
    activation, ``"full"`` saves only the block's inputs and recomputes
    the block in the backward, ``"dots"`` saves the matrix products'
    outputs besides (``torch.utils.checkpoint``, non-reentrant)."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots) if mode == "dots" else None)

    def rematted(*args):
        if context is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context)

    return rematted


def _whisper_encode(cfg: ModelConfig, params, frames: torch.Tensor,
                    remat: str = "none"):
    """frames: [B, F, D] (the stubbed conv frontend's output) → memory."""
    dims = _dims(cfg).attn

    def layer(x, lp):
        h = _apply_norm(x, lp["ln1"], cfg)
        x = x + attention.attn_forward(h, lp["attn"], dims, None,
                                       causal=False)
        h = _apply_norm(x, lp["ln2"], cfg)
        return x + layers.gelu_mlp(h, lp["mlp"])

    layer = _remat(layer, remat)
    x = frames + params["enc_pos"].to(frames.dtype)
    for lp in params["enc_blocks"]:
        x = layer(x, lp)
    return _apply_norm(x, params["enc_final_norm"], cfg)


def _frames(cfg: ModelConfig, params, batch: dict, dtype,
            remat: str = "none"):
    frames = torch.as_tensor(batch["frames"],
                             device=params["embed"]["table"].device)
    return _whisper_encode(cfg, params, frames.to(dtype), remat)


def _layer_forward(cfg: ModelConfig, dims: Dims, plan: LayerPlan, lp, x,
                   mixer: Callable, memory=None):
    """One decoder layer over a full sequence.  ``mixer(plan, lp, h)`` runs
    the sequence mixer on normed x and returns (out, the layer's cache or
    None).  Returns (x, cache, aux losses); Whisper's cache is (cache,
    cross-attention KV), an RWKV layer's gains the channel mix's last
    normed input (``cm_x``)."""
    h, cache = mixer(plan, lp, _apply_norm(x, lp["ln1"], cfg))
    x = x + h
    if memory is not None:
        hc = _apply_norm(x, lp["ln_cross"], cfg)
        kv = attention.cross_attn_kv(memory, lp["cross"], dims.attn)
        x = x + attention.cross_attn_forward(hc, lp["cross"], kv, dims.attn)
        cache = (cache, kv)
    h2 = _apply_norm(x, lp["ln2"], cfg)
    y, aux = _apply_mlp(h2, lp, plan, dims)
    if plan.mlp == "rwkv_cm" and cache is not None:
        cache = dict(cache, cm_x=h2[:, -1])
    return x + y, cache, aux


def _run_stack(cfg: ModelConfig, params, x, mixer: Callable, memory=None,
               remat: str = "none"):
    """The decoder stack over a full sequence, one repeating block (a
    period of layers) at a time, each block rematerialised by ``remat``.
    Returns (x, caches, aux summed within each block, then over
    blocks)."""
    plans = layer_plan(cfg)
    dims = _dims(cfg)
    n = len(plans)
    stack = params["blocks"]

    def block(x, j):
        caches, aux_b = [], {}
        for i in range(j, j + n):
            x, cache, aux = _layer_forward(cfg, dims, plans[i - j], stack[i],
                                           x, mixer, memory)
            for k, v in aux.items():
                aux_b[k] = aux_b.get(k, 0.0) + v
            caches.append(cache)
        return x, caches, aux_b

    block = _remat(block, remat)
    caches, aux_sum = [], {}
    for j in range(0, len(stack), n):
        x, cs, aux = block(x, j)
        for k, v in aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + v
        caches.extend(cs)
    return x, caches, aux_sum


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: nn.Module, batch: dict, *,
            dtype=torch.bfloat16):
    """Full-sequence logits (the train / prefill compute shape).

    Returns (logits [B, S_text, Vpad], aux).  aux holds the MoE losses
    averaged over repeating blocks (load_balance, router_z,
    dropped_fraction; 0 without MoE), and nothing for Whisper.  Under
    grad each block is rematerialised as ``cfg.remat`` says."""
    params = cast_params(cfg, params, dtype)
    dims = _dims(cfg)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    x, n_prefix = _embed_inputs(cfg, params, batch, dtype)
    rope = _rope(dims.attn, torch.arange(x.shape[1], device=x.device))
    memory = (_frames(cfg, params, batch, dtype, remat)
              if cfg.family == "encdec" else None)

    def mixer(plan, lp, h):
        if plan.mixer == "attn":
            return attention.attn_forward(h, lp["attn"], dims.attn,
                                          rope), None
        if plan.mixer == "ssm":
            return ssm.ssm_forward(h, lp["ssm"], dims.ssm), None
        return rwkv6.time_mix_forward(h, lp["tm"], dims.rwkv), None

    x, _, aux_sum = _run_stack(cfg, params, x, mixer, memory, remat)
    aux = {}
    if cfg.family != "encdec":
        n_blocks = cfg.n_layers // len(layer_plan(cfg))
        aux = {k: aux_sum.get(k, 0.0) / n_blocks
               for k in ("load_balance", "router_z", "dropped_fraction")}
    x = _apply_norm(x, params["final_norm"], cfg)
    if n_prefix:
        x = x[:, n_prefix:]
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: nn.Module, batch: dict, *,
            dtype=torch.bfloat16):
    """Next-token cross entropy (f32 softmax over the real vocab) + the MoE
    aux losses: ``(loss, metrics)`` as the reference's.  Labels below 0
    are masked out of the mean."""
    logits, aux = forward(cfg, params, batch, dtype=dtype)
    lg = logits.float()
    labels = torch.as_tensor(batch["labels"], device=lg.device).long()
    mask = (labels >= 0).float()
    real = torch.arange(lg.shape[-1], device=lg.device) < cfg.vocab_size
    lse = torch.logsumexp(torch.where(real, lg, -torch.inf), dim=-1)
    gold = lg.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = (lse - gold) * mask
    ntok = mask.sum().clamp_min(1.0)
    loss = nll.sum() / ntok
    metrics = {"nll": loss, "ntokens": ntok}
    if cfg.moe is not None:
        loss = loss + cfg.moe.load_balance_loss * aux["load_balance"]
        loss = loss + cfg.moe.router_z_loss * aux["router_z"]
        metrics.update(
            load_balance=aux["load_balance"],
            router_z=aux["router_z"],
            dropped_fraction=aux["dropped_fraction"],
        )
    metrics["loss"] = loss
    return loss, metrics


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

    Every position is attended causally, padding included (the caller
    left-pads with token 0, as the reference does); attention layers keep
    their KV (padded to ``max_len``), SSM and RWKV layers their final
    recurrent state, Whisper each layer's cross-attention KV."""
    params = cast_params(cfg, params, dtype)
    dims = _dims(cfg)
    x, _ = _embed_inputs(cfg, params, batch, dtype)
    rope = _rope(dims.attn, torch.arange(x.shape[1], device=x.device))
    memory = (_frames(cfg, params, batch, dtype)
              if cfg.family == "encdec" else None)

    def mixer(plan, lp, h):
        if plan.mixer == "attn":
            h, kv = attention.attn_prefill(h, lp["attn"], dims.attn, rope)
            return h, {"k": _pad_time(kv["k"], max_len),
                       "v": _pad_time(kv["v"], max_len)}
        if plan.mixer == "ssm":
            return ssm.ssm_prefill(h, lp["ssm"], dims.ssm)
        h, last_x, s = rwkv6.time_mix_forward(h, lp["tm"], dims.rwkv,
                                              return_state=True)
        return h, {"tm_x": last_x, "s": s}

    x, caches, _ = _run_stack(cfg, params, x, mixer, memory)
    cache: dict[str, Any] = {"layers": caches}
    if cfg.family == "encdec":
        cache = {"layers": [c for c, _ in caches],
                 "cross_kv": [kv for _, kv in caches]}
    x = _apply_norm(x[:, -1], params["final_norm"], cfg)
    return _logits(cfg, params, x), cache


def _layer_cache(cfg: ModelConfig, dims: Dims, plan: LayerPlan, batch: int,
                 max_len: int, dtype, device) -> dict:
    if plan.mixer == "attn":
        return attention.init_kv_cache(batch, max_len, dims.attn, dtype,
                                       device)
    if plan.mixer == "ssm":
        return ssm.init_ssm_cache(batch, dims.ssm, dtype, device)
    return rwkv6.init_rwkv_cache(batch, dims.rwkv, cfg.d_model, dtype,
                                 device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed cache: {"layers": [one entry per layer]} (+ "cross_kv" for
    Whisper, [B, Hkv, n_audio_frames, Dh] per layer)."""
    plans = layer_plan(cfg)
    dims = _dims(cfg)
    device = resolve_device(device)
    cache: dict[str, Any] = {"layers": [
        _layer_cache(cfg, dims, plans[i % len(plans)], batch, max_len, dtype,
                     device)
        for i in range(cfg.n_layers)]}
    if cfg.family == "encdec":
        cache["cross_kv"] = [
            attention.init_kv_cache(batch, cfg.n_audio_frames, dims.attn,
                                    dtype, device)
            for _ in range(cfg.n_layers)]
    return cache


def _layer_decode(cfg: ModelConfig, dims: Dims, plan: LayerPlan, lp, lc,
                  x, pos: int, rope, lens, cross=None):
    """One decoder layer for one token. x: [B, D]; ``lc`` the layer's
    cache (attention KV is written in place); ``cross`` is Whisper's
    (cross-attention KV, lens).  Returns (x, the layer's cache)."""
    h = _apply_norm(x, lp["ln1"], cfg)
    if plan.mixer == "attn":
        h, nc = attention.attn_decode(h, lp["attn"], lc, pos, dims.attn,
                                      rope, lens)
    elif plan.mixer == "ssm":
        h, nc = ssm.ssm_decode(h, lp["ssm"], lc, dims.ssm)
    else:
        h, nc = rwkv6.time_mix_decode(h, lp["tm"], lc, dims.rwkv)
    x = x + h
    if cross is not None:
        kv, cross_lens = cross
        h = _apply_norm(x, lp["ln_cross"], cfg)
        x = x + attention.cross_attn_decode(h, lp["cross"], kv, dims.attn,
                                            cross_lens)
    h = _apply_norm(x, lp["ln2"], cfg)
    if plan.mlp == "rwkv_cm":
        h, cm_x = rwkv6.channel_mix_decode(h, lp["cm"], lc["cm_x"])
        nc = dict(nc, cm_x=cm_x)
    else:
        h = _apply_mlp(h[:, None, :], lp, plan, dims)[0][:, 0]
    return x + h, nc


def decode_step(cfg: ModelConfig, params: nn.Module, cache: dict,
                tokens: torch.Tensor, pos: int, *, dtype=torch.bfloat16):
    """One token for every sequence. tokens: [B] ints; pos: this token's
    position, the same for every row.  Attention layers write this token's
    K/V at ``pos`` in place and attend to [0, pos]; SSM and RWKV layers
    replace their entry of ``cache["layers"]`` with the new state.

    Returns (logits [B, Vpad], cache)."""
    params = cast_params(cfg, params, dtype)
    plans = layer_plan(cfg)
    dims = _dims(cfg)
    x = layers.embed(tokens, params["embed"], dtype)
    b = x.shape[0]
    if cfg.family == "encdec":  # clamped, as a dynamic index is
        x = x + params["dec_pos"][min(pos, params["dec_pos"].shape[0] - 1)] \
            .to(dtype)
    # per-step inputs of every layer's attention, made once
    rope = _rope(dims.attn, torch.full((1,), pos, device=x.device))
    lens = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    cross_lens = (torch.full((b,), cfg.n_audio_frames, dtype=torch.int32,
                             device=x.device)
                  if cfg.family == "encdec" else None)
    layer_caches = cache["layers"]
    for i, lp in enumerate(params["blocks"]):
        cross = (None if cross_lens is None
                 else (cache["cross_kv"][i], cross_lens))
        x, layer_caches[i] = _layer_decode(
            cfg, dims, plans[i % len(plans)], lp, layer_caches[i], x, pos,
            rope, lens, cross)
    x = _apply_norm(x, params["final_norm"], cfg)
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    spec: dict
    loss_fn: Callable
    forward_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_cache_fn: Callable

    def init(self, seed: int = 0, *, device=None, dtype=torch.float32,
             requires_grad: bool = False) -> nn.Module:
        """Parameters drawn by the spec's init rules from a generator seeded
        with ``seed`` on ``device`` (the card unless the CPU is asked), in
        ``dtype`` except the leaves whose spec fixes theirs; trainable
        with ``requires_grad``, frozen for serving by default."""
        tree = par.init_params(self.spec, seed, dtype=dtype,
                               device=resolve_device(device))
        out = params_module(self.cfg, tree, requires_grad=requires_grad)
        out.compute_dtype = dtype
        return out

    def abstract_params(self, dtype=torch.float32) -> dict:
        """The spec as ``meta`` tensors in its stacked layout (nothing is
        allocated; :func:`params_module` makes the model's module of
        them)."""
        return par.abstract_params(self.spec, dtype)

    def logical_axes(self) -> dict:
        return par.logical_axes(self.spec)

    @property
    def n_params(self) -> int:
        return par.param_count(self.spec)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k of the expert pool)."""
        cfg = self.cfg
        if cfg.moe is None:
            return self.n_params
        total = 0
        for name, p in par.leaves_with_paths(self.spec):
            n = math.prod(p.shape)
            if ".moe.w_" in name or name.endswith(("moe.w_gate", "moe.w_up",
                                                   "moe.w_down")):
                n = n * cfg.moe.top_k // cfg.moe.n_experts
            total += n
        return total


def build_model(cfg: ModelConfig, *, max_seq_len: int = 0) -> Model:
    spec = param_spec(cfg, max_seq_len=max_seq_len)
    return Model(
        cfg=cfg,
        spec=spec,
        loss_fn=functools.partial(loss_fn, cfg),
        forward_fn=functools.partial(forward, cfg),
        prefill_fn=functools.partial(prefill, cfg),
        decode_fn=functools.partial(decode_step, cfg),
        init_cache_fn=functools.partial(init_cache, cfg),
    )
