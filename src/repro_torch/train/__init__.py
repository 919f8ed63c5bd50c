"""``repro_torch.train`` — the training substrate (counterpart of
``repro/train``): optimizers, microbatch accumulation, int8 gradient
compression and checkpoints, on the card through K5 and the FA2 backward
(:mod:`repro_torch.kernels.flash_vjp`)."""

from repro_torch.train import checkpoint, compression
from repro_torch.train.optimizer import (Optimizer, adafactor, adamw,
                                         clip_by_global_norm, for_config,
                                         global_norm, optimizer_state_bytes)
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          init_train_state, lr_schedule,
                                          make_train_step, sharded_train_step,
                                          state_spec)

__all__ = [
    "Optimizer", "TrainConfig", "TrainState", "adafactor", "adamw",
    "checkpoint", "clip_by_global_norm", "compression", "for_config",
    "global_norm", "init_train_state", "lr_schedule", "make_train_step",
    "optimizer_state_bytes", "sharded_train_step", "state_spec",
]
