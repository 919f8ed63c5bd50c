#!/usr/bin/env python3
"""Read, on the card, the numbers that set the limits of ``correct``.

    python3 annbench/calibrate.py --cells sift.build,sift.search \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 16

For the build kind, one process builds the cell's first job with the
program, then again with the control (the reference's kNN in TF32, the
precision just below the float32 the configurations state, in the place
of the program's kNN kernel), and reads :func:`graph.build_gap` on every
seed's sample of rows: the program's on ``--seeds``, the control's on
``--control-seeds``.  For the search kind, each seed runs the cell's
set-up and a window of ``--seconds`` and the reference's judgement, then
reads the same numbers for two stand-ins put in the program's place on
the same queries:

* ``control``: the reference's exact search computed in TF32;
* ``unchanged``: a beam search that never leaves its entry points (the
  best k of the index's search entries), a step that returns its state
  unchanged.

Search cells of one configuration share the seed's index.  One JSON line
per reading.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stand_ins(drv, device) -> dict:
    """The control's and the unchanged beam's numbers on the queries the
    reference judged for ``drv``."""
    import numpy as np
    import torch

    from annbench.reference import exact

    data, queries, _ = drv.judged
    k = drv.k
    truth = exact.exact_knn(data, queries, k, device=device)
    out = {}
    ctl = exact.exact_knn(data, queries, k, device=device, tf32=True)
    x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    ent = torch.as_tensor(np.asarray(drv.entries, np.int64), device=device)
    seeds = []
    for s in range(0, len(queries), 4096):
        q = torch.from_numpy(np.ascontiguousarray(queries[s:s + 4096]))
        q = q.to(device)
        ids = ent.expand(len(q), -1)
        d = exact.distances64(x, q, ids)
        seeds.append(ids.gather(1, d.argsort(dim=1)[:, :k]).cpu().numpy())
    unchanged = np.concatenate(seeds)
    for name, ids in (("control", ctl), ("unchanged", unchanged)):
        out[name] = {
            "invalid_ids": exact.invalid_ids(ids, len(data)),
            "order_gap": exact.order_gap(data, queries, ids, device=device),
            "recall_at_10": exact.recall(ids, truth, k),
        }
    return out


def build_readings(name, cfg, mix, seeds, control_seeds) -> None:
    """The program's and the control's build gaps on the first job."""
    import time

    from annbench import drivers, harness
    from annbench.reference import exact
    from repro_torch.kernels import ops
    from repro_torch.telemetry import NULL_TRACER

    plain = ops.knn
    for side, knn, on in (("program", plain, seeds),
                          ("control", exact.knn_tf32, control_seeds)):
        ops.knn = knn
        try:
            drv = drivers.BuildJobs(cfg, mix, on[0], "cuda")
            drv.setup(1.0, warm=False)
            t0 = time.perf_counter()
            drv.window(1.0, NULL_TRACER)  # one whole job
            wall = time.perf_counter() - t0
        finally:
            ops.knn = plain
        drv.release()
        for seed in on:
            t0 = time.perf_counter()
            gap = drv.build_gaps(seed)
            row = {"cell": name, "side": side, "seed": seed,
                   "build_s": wall, "check_s": time.perf_counter() - t0,
                   "build_gap": gap["differ"] / gap["slots"], **gap}
            print(json.dumps(harness.finite(row)), flush=True)
        del drv


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=16.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from annbench import drivers, harness
    from repro_torch.telemetry import NULL_TRACER

    if not torch.cuda.is_available():
        print("the calibration needs the card", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    shared: dict = {}
    for name in args.cells.split(","):
        cell = harness.workload(bench, name)
        cfg = harness.config(bench, cell["config"])
        mix = harness.traffic(cell["traffic"])
        if mix["kind"] == "build_jobs":
            build_readings(name, cfg, mix, seeds, control_seeds or seeds)
            continue
        for seed in seeds:
            drv = drivers.KINDS[mix["kind"]](cfg, mix, seed, "cuda")
            drv.setup(args.seconds, index=shared.get(cell["config"]))
            shared[cell["config"]] = (drv.data, drv.topo)
            window = drv.window(args.seconds, NULL_TRACER)
            drv.release()
            program = drv.judge()
            row = {"cell": name, "seed": seed, "attempted": drv.attempted,
                   "failed": drv.failed, "window": window,
                   "program": program, **stand_ins(drv, "cuda")}
            print(json.dumps(harness.finite(row)), flush=True)
            del drv
        shared.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
