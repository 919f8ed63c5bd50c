"""End-to-end LM training driver, on the port: train a ~100M-param model
for a few hundred steps, with checkpoint/restart fault tolerance.

The reference's ``examples/train_lm.py`` on ``repro_torch``: the step
(K5 in the forward, its FA2 backward) runs on the card and updates the
parameters in place; checkpoints are written in the reference's stacked
layout, so either package restores the other's.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --arch tinyllama_1_1b
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 6 --batch 2 --seq 64

The arch config is reduced to ~100M params (depth/width scaled, same
family); the data pipeline is the deterministic synthetic token stream with
seek-to-step, so killing and restarting this module resumes exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.common import params as par
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import (build_model, param_tree, params_module,
                                      stacked_tree)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import for_config
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          init_train_state, make_train_step)


def hundred_m_config(arch: str):
    """Scale the assigned arch down to ~100M params (same family); the
    reference script's function, copied."""
    cfg = get_arch(arch)
    return dataclasses.replace(
        cfg, n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=64, d_ff=1536,
        vocab_size=8192, remat="none",
        moe=None if cfg.moe is None else dataclasses.replace(
            cfg.moe, n_experts=8, d_ff=512
        ),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) /
                                "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cpu: their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = hundred_m_config(args.arch)
    model = build_model(cfg)
    print(f"{cfg.name}: {model.n_params/1e6:.1f}M params")
    opt = for_config(cfg.optimizer)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=50,
                       microbatch=args.batch // 2)
    state = init_train_state(model, opt, 0, tcfg, device=dev)
    step_fn = make_train_step(model, opt, tcfg)  # updates params in place

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch,
    ))

    # fault tolerance: resume from the newest checkpoint if one exists,
    # loaded into the parameters the step updates (the optimizer state
    # starts afresh, as in the reference)
    with torch.no_grad():
        like = stacked_tree(cfg, param_tree(state.params))
    resumed = ckpt.restore_latest(args.ckpt_dir, like)
    if resumed:
        step0, tree, _ = resumed
        with torch.no_grad():
            for p, saved in zip(par.leaves(param_tree(state.params)),
                                par.leaves(param_tree(
                                    params_module(cfg, tree)))):
                p.copy_(saved)
        state = TrainState(params=state.params,
                           opt_state=opt.init(param_tree(state.params)),
                           step=torch.tensor(step0, dtype=torch.int32,
                                             device=dev),
                           error_state=None)
        pipe.seek(step0)
        print(f"resumed from step {step0}")

    t0 = time.perf_counter()
    while int(state.step) < args.steps:
        state, metrics = step_fn(state, pipe.next_batch())
        s = int(state.step)
        if s % 20 == 0 or s == 1:
            tok_s = s * args.batch * args.seq / (time.perf_counter() - t0)
            print(f"step {s:4d}  loss {float(metrics['loss']):.4f}  "
                  f"grad-norm {float(metrics['grad_norm']):.2f}  "
                  f"{tok_s:,.0f} tok/s")
        if s % args.ckpt_every == 0:
            with torch.no_grad():
                tree = stacked_tree(cfg, param_tree(state.params))
            path = ckpt.save(args.ckpt_dir, s, tree,
                             metadata={"arch": cfg.name})
            print(f"checkpoint → {path}")
    print(f"done: final loss {float(metrics['loss']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
