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

The reference's ``state_spec`` and ``sharded_train_step`` (shardings for
a mesh) wait for the mesh slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.common import params as par
from repro_torch.models.model import Model, param_tree
from repro_torch.train import compression
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm


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
    return {k: v.reshape(n, mb, *v.shape[1:]) for k, v in batch.items()}, n


def make_train_step(model: Model, opt: Optimizer, tcfg: TrainConfig):
    def train_step(state: TrainState, batch: dict):
        mbatches, n_micro = _split_microbatches(batch, tcfg.microbatch)
        params = state.params
        tree = param_tree(params)
        leaves = par.leaves(tree)

        def mb_grads(i):
            mb = {k: v[i] for k, v in mbatches.items()}
            loss, metrics = model.loss_fn(params, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return ([torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)],
                    {k: torch.as_tensor(v).detach() for k, v in
                     metrics.items()})

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
