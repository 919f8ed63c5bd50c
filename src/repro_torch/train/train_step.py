"""Training step: microbatched gradient accumulation + optional int8
compression + clipping + the optimizer (counterpart of
``repro/train/train_step.py``).

``make_train_step`` closes over the model and the optimizer and returns
``step(state, batch) -> (state, metrics)``.  The global batch is cut into
``[n_micro, microbatch, ...]`` and the microbatches' gradients are summed
in f32 and divided by their count; activation memory is one microbatch's
(the model's ``remat`` bounds each block's).  Unlike the reference's pure
function, the step writes the new parameters **in place** into
``state.params`` (the model's parameter module, whose leaves are
trainable): a second full copy of the weights is never held.  The
returned state shares that module.

:func:`state_spec` is the reference's ``TrainState`` of ``P``
declarations (its stacked layout) for sharding resolution.
:func:`sharded_train_step` resolves the state's and the batch's shardings
on a mesh and runs :func:`make_train_step` under the mesh's activation
rules; on one card it takes a mesh of one device only (a host mesh), since
a step that spans devices would need the collectives the port does not
issue: the production meshes (256 / 512 devices) raise
``NotImplementedError``, and the dry-run counts their steps on ``meta``
instead (:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.common import params as par
from repro_torch.common.params import P
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import Model, param_tree, per_layer_spec
from repro_torch.train import compression
from repro_torch.train.optimizer import (Optimizer, clip_by_global_norm,
                                         tree_zeros_like_spec)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    grad_clip: float = 1.0
    microbatch: int = 0  # 0 → no accumulation
    compress_grads: bool = False  # int8 + error feedback


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.learning_rate * warm


@par.register_node
@dataclasses.dataclass
class TrainState:
    params: nn.Module  # trainable leaves, updated in place by the step
    opt_state: Any
    step: torch.Tensor  # int32 scalar
    error_state: Optional[Any] = None  # compression feedback


def init_train_state(model: Model, opt: Optimizer, seed: int = 0,
                     tcfg: TrainConfig | None = None, *,
                     params: nn.Module | None = None, device=None,
                     dtype=torch.float32) -> TrainState:
    """A fresh state: ``params`` when given (trainable leaves, e.g. from
    ``convert.params_from_jax(..., requires_grad=True)``), else the model's
    init from ``seed`` on ``device`` (the card unless the CPU is asked) in
    ``dtype``."""
    if params is None:
        params = model.init(seed, device=device, dtype=dtype,
                            requires_grad=True)
    tree = param_tree(params)
    dev = par.leaves(tree)[0].device
    return TrainState(
        params=params,
        opt_state=opt.init(tree),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        error_state=(
            compression.init_error_state(tree)
            if tcfg and tcfg.compress_grads else None
        ),
    )


def _split_microbatches(batch: dict, microbatch: int) -> tuple[dict, int]:
    """Every entry [B, ...] → [n, microbatch, ...] (numpy or torch)."""
    b = batch["tokens"].shape[0]
    mb = microbatch or b
    if b % mb:
        raise ValueError(f"global batch {b} not divisible by microbatch {mb}")
    n = b // mb

    def reshape(x):
        x = x.reshape(n, mb, *x.shape[1:])
        return shd.constrain(x, None, "batch", *([None] * (len(x.shape) - 2)))

    return {k: reshape(v) for k, v in batch.items()}, n


def microbatch_grads(model: Model, params: nn.Module, leaves: list,
                     mb: dict) -> tuple[list, dict]:
    """One microbatch's gradients (one per leaf of ``leaves``, zeros for a
    leaf the loss does not reach) and its detached metrics."""
    loss, metrics = model.loss_fn(params, mb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return ([torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)],
            {k: torch.as_tensor(v).detach() for k, v in metrics.items()})


def make_train_step(model: Model, opt: Optimizer, tcfg: TrainConfig):
    """``step(state, batch) -> (state, metrics)``; each microbatch's
    gradients come from :func:`microbatch_grads`."""

    def train_step(state: TrainState, batch: dict):
        mbatches, n_micro = _split_microbatches(batch, tcfg.microbatch)
        params = state.params
        tree = param_tree(params)
        leaves = par.leaves(tree)

        def mb_grads(i):
            return microbatch_grads(model, params, leaves,
                                    {k: v[i] for k, v in mbatches.items()})

        if n_micro == 1:
            flat, metrics = mb_grads(0)
        else:
            flat = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            all_metrics = []
            for i in range(n_micro):
                g, m = mb_grads(i)
                for a, b in zip(flat, g):
                    a += b.float()
                all_metrics.append(m)
            flat = [g / n_micro for g in flat]
            metrics = {k: torch.stack([m[k] for m in all_metrics]).mean()
                       for k in all_metrics[0]}
        grads = par.unflatten(tree, flat)

        error_state = state.error_state
        if tcfg.compress_grads:
            grads, error_state = compression.compress_with_feedback(
                grads, error_state
            )
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = lr_schedule(tcfg, state.step)
        with torch.no_grad():
            new_tree, new_opt = opt.update(grads, state.opt_state, tree, lr)
            for p, new in zip(leaves, par.leaves(new_tree)):
                p.copy_(new)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return (
            TrainState(
                params=params,
                opt_state=new_opt,
                step=state.step + 1,
                error_state=error_state,
            ),
            metrics,
        )

    return train_step


# ---------------------------------------------------------------------------
# Shardings for a mesh
# ---------------------------------------------------------------------------


def _state_spec(spec, opt: Optimizer, tcfg: TrainConfig) -> TrainState:
    return TrainState(
        params=spec,
        opt_state=opt.state_spec(spec),
        step=P(shape=(), axes=(), init="zeros", dtype=torch.int32),
        error_state=(tree_zeros_like_spec(spec) if tcfg.compress_grads
                     else None),
    )


def state_spec(model: Model, opt: Optimizer, tcfg: TrainConfig) -> TrainState:
    """P-declaration tree mirroring TrainState (for sharding resolution),
    in the reference's stacked layout."""
    return _state_spec(model.spec, opt, tcfg)


def _state_leaves(state: TrainState) -> list:
    """The leaves of a state (or of its declarations), parameters first."""
    if isinstance(state.params, nn.Module):
        state = dataclasses.replace(state, params=param_tree(state.params))
    return par.leaves(state)


def sharded_train_step(model: Model, opt: Optimizer, tcfg: TrainConfig,
                       mesh, batch_spec: dict, rules=None):
    """:func:`make_train_step` with the state's and the batch's shardings
    resolved on ``mesh`` from the logical axes, run under the mesh's
    activation rules.  ``batch_spec``: name → tensor or array (meta tensors
    from ``launch.specs``), read only for its shapes.

    The returned step checks each call's state and batch against the
    resolved specs' shapes (the state in the module's per-layer layout:
    each stacked leaf without its ``layers`` axis) and carries the
    shardings as ``step.state_shardings`` (the reference's layout) and
    ``step.batch_shardings``.  A mesh of more than one device raises
    ``NotImplementedError``: one card runs a step on one device."""
    n_dev = len(mesh.devices) if mesh.devices is not None else mesh.size
    if mesh.devices is None or n_dev != 1:
        raise NotImplementedError(
            f"a train step over a mesh of {n_dev} devices "
            f"{dict(mesh.shape)}: the port runs on one card and issues no "
            "collectives; count such a step with repro_torch.launch.dryrun")
    state_sh = shd.param_shardings(state_spec(model, opt, tcfg), mesh, rules)
    batch_sh = {k: shd.batch_sharding(mesh, tuple(v.shape), rules)
                for k, v in batch_spec.items()}
    want = _state_leaves(_state_spec(per_layer_spec(model.cfg, model.spec),
                                     opt, tcfg))
    inner = make_train_step(model, opt, tcfg)

    def step(state: TrainState, batch: dict):
        got = _state_leaves(state)
        if len(got) != len(want) or any(
                tuple(g.shape) != tuple(w.shape) for g, w in zip(got, want)):
            raise ValueError("the train state does not match its spec")
        for k, v in batch.items():
            if tuple(v.shape) != tuple(batch_spec[k].shape):
                raise ValueError(f"batch {k!r} {tuple(v.shape)} does not "
                                 f"match {tuple(batch_spec[k].shape)}")
        with shd.use_mesh_rules(mesh, rules):
            return inner(state, batch)

    step.state_shardings = state_sh
    step.batch_shardings = batch_sh
    return step
