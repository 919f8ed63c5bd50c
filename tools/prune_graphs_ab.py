#!/usr/bin/env python3
"""Offline Vamana shard builds on one NVIDIA H100, the prune's chunks
replayed from CUDA graphs against the same chunks run eagerly, in one
process.

    python3 tools/prune_graphs_ab.py [--n 50000] [--out build/prune_graphs_ab.json]

One shard of ``make_clustered(n, 128, seed=1)`` is built with the
``IndexConfig`` defaults (R = 64, L = 128, rounds of 256 points, the
``fused`` beam) five times, in this order: eager; graphs from a fresh set
(its first-use captures inside the build); graphs from the now-warm set
(the steady state); eager; graphs, warm.  Eager means every chunk runs
``vamana._prune_rows``: the tool swaps ``vamana.thread_prune_graphs`` for a
stand-in that calls it, so both variants prune the same chunks.  Each
build reports its wall, its rounds' wall (from ``round_hook``: median,
mean, and the mean without the first round), its summed ``vamana.beam``
and ``vamana.prune`` stages, and whether its graph and distance count
equal the first build's; a graph build also the set's graphs, captures,
resets, card bytes (static buffers and pool) and pool bytes.  The card's
name and power limit come first.  Everything goes to ``--out`` and the
end of standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


class _Eager:
    """Stands in for a thread's graph set: every chunk runs the eager
    loop."""

    def __call__(self, p_ids, cand, cand_d, vecs, alpha, R):
        from repro_torch.core import vamana

        return vamana._prune_rows(p_ids, cand, cand_d, vecs, alpha, R)


def build_once(data, cfg, variant: str, first=None) -> tuple[dict, object]:
    import numpy as np
    import torch

    from repro_torch.core import vamana
    from repro_torch.telemetry import collect_stages

    real = vamana.thread_prune_graphs
    if variant == "eager":
        vamana.thread_prune_graphs = _Eager
    elif variant == "graphs, fresh set":
        vamana._THREAD.graphs = None
    stamps: list = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stamps.append(t0)
        with collect_stages() as stages:
            idx = vamana.build_shard_index_vamana(
                data, cfg, round_hook=lambda st: stamps.append(
                    time.perf_counter()))
        wall = time.perf_counter() - t0
    finally:
        vamana.thread_prune_graphs = real
    rounds = [b - a for a, b in zip(stamps, stamps[1:])]
    row = {
        "variant": variant, "build_s": wall, "rounds": len(rounds),
        "round_ms_median": 1e3 * statistics.median(rounds),
        "round_ms_mean": 1e3 * statistics.fmean(rounds),
        "round_ms_mean_after_first": 1e3 * statistics.fmean(rounds[1:]),
        "beam_s": stages.get("vamana.beam", 0.0),
        "prune_s": stages.get("vamana.prune", 0.0),
        "n_distance_computations": idx.n_distance_computations,
    }
    if first is not None:
        row["graph_equal_to_first"] = bool(np.array_equal(idx.graph,
                                                          first.graph))
        row["count_equal_to_first"] = (idx.n_distance_computations
                                       == first.n_distance_computations)
    if variant != "eager":
        gs = vamana.thread_prune_graphs()
        row["set"] = {"graphs": len(gs), "captures": gs.captures,
                      "resets": gs.resets, "card_bytes": gs.card_bytes(),
                      "pool_bytes": gs.pool_bytes(),
                      "keys": [list(k) for k in gs._graphs]}
    return row, idx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "prune_graphs_ab.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prune_graphs_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.environment(torch)
    from repro_torch.configs.base import IndexConfig
    from repro_torch.data.synthetic import make_clustered

    data = make_clustered(args.n, 128, seed=1).data
    cfg = IndexConfig()
    rows, first = [], None
    for variant in ("eager", "graphs, fresh set", "graphs, warm set",
                    "eager", "graphs, warm set"):
        row, idx = build_once(data, cfg, variant, first)
        first = first or idx
        rows.append(row)
        print("prune_graphs_ab " + json.dumps(row), flush=True)
    ok = all(r.get("graph_equal_to_first", True)
             and r.get("count_equal_to_first", True) for r in rows)
    out = {"card": card, "n": args.n, "builds": rows,
           "graphs_equal_eager": ok}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": card, "graphs_equal_eager": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
