"""The paper's pipeline on LM-produced vectors, on the port: train a small
LM, extract its token-embedding vectors, build a ScaleGANN index over them,
and serve nearest-neighbor queries (the embedding-retrieval use-case that
motivates vector databases).

The reference's ``examples/lm_embed_index.py`` on ``repro_torch``: the LM
trains on one card (K5 in the forward and its FA2 backward) and the index
is built and searched on the same card.  The reference's ``jax`` backend
is ``torch`` here.

    PYTHONPATH=src python -m repro_torch.examples.lm_embed_index               # the card
    PYTHONPATH=src python -m repro_torch.examples.lm_embed_index --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import IndexConfig, get_arch, smoke_config
from repro_torch.core.builder import build_scalegann
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.data.synthetic import exact_ground_truth, recall_at
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.search import search
from repro_torch.train.optimizer import for_config
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cpu: their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. train a small LM briefly so embeddings carry co-occurrence signal
    cfg = dataclasses.replace(
        smoke_config(get_arch("granite_3_2b")), vocab_size=4096,
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    )
    model = build_model(cfg)
    opt = for_config(cfg.optimizer)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, microbatch=4)
    state = init_train_state(model, opt, 0, tcfg, device=dev)
    step = make_train_step(model, opt, tcfg)  # updates state.params in place
    pipe = TokenPipeline(TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                             seq_len=128, global_batch=8))
    for _ in range(60):
        state, metrics = step(state, pipe.next_batch())
    print(f"LM trained 60 steps, loss {float(metrics['loss']):.3f}")

    # 2. the vector dataset = the LM's (tied) token embedding table
    with torch.no_grad():
        table = state.params["embed"]["table"].float().cpu().numpy()
    table = np.ascontiguousarray(table[: cfg.vocab_size])
    print(f"embedding table: {table.shape}")

    # 3. ScaleGANN over the embeddings, on the card that trained the LM
    icfg = IndexConfig(n_clusters=6, degree=16, build_degree=32,
                       block_size=1024)
    res = build_scalegann(table, icfg, n_workers=2, device=dev)
    print(f"index built: {res.overall_s:.2f}s, "
          f"replicas {res.stats['replica_proportion']:.1%}")

    # 4. serve: nearest tokens to perturbed embeddings
    rng = np.random.default_rng(0)
    probe_ids = rng.choice(cfg.vocab_size, 32, replace=False)
    queries = table[probe_ids] + 0.005 * rng.normal(
        size=(32, table.shape[1])
    ).astype(np.float32)
    gt = exact_ground_truth(table, queries, 10, device=dev)
    ids, stats = search(res.index, queries, 10, data=table,
                        backend="torch", width=96, device=dev)
    print(f"recall@10 = {recall_at(ids, gt, 10):.3f} "
          f"({stats.n_distance_computations/32:.0f} dists/query)")
    hit1 = np.mean([probe_ids[i] in ids[i] for i in range(32)])
    print(f"self-token found for {hit1:.0%} of probes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
