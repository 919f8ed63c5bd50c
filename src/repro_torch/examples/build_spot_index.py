"""End-to-end driver: spot-instance index construction with preemptions.

The reference's ``examples/build_spot_index.py`` on ``repro_torch``: the
paper's full workflow (§IV Fig. 1) on the real fleet executor.  Calibrate
the runtime model on tiny real builds, then let ``build_scalegann_fleet``
partition the dataset and run actual per-shard Vamana builds (K3 rounds
on the card, each worker thread on its own stream) under a seeded
preemption injector — instances get notices and kills at batched-round
boundaries, in-flight builds checkpoint at round grain, preempted tasks
re-queue with backoff and resume bit-compatibly mid-build.  The run is
priced with the §VI-C cost model, and the same task list is replayed on
the virtual-clock ``Scheduler`` under both scheduling policies.

    PYTHONPATH=src python -m repro_torch.examples.build_spot_index               # the card
    PYTHONPATH=src python -m repro_torch.examples.build_spot_index --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import IndexConfig
from repro_torch.core.scheduler import (SCHEDULING_POLICIES, Scheduler,
                                        calibrate_runtime, make_spot_pool,
                                        make_tasks)
from repro_torch.data.synthetic import make_clustered, recall_at
from repro_torch.device import resolve_device
from repro_torch.fleet import (CheckpointStore, PreemptionInjector,
                               build_scalegann_fleet)
from repro_torch.search import search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cpu: their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_clustered(6000, 64, n_queries=40, spread=1.0, seed=3,
                        device=dev)
    cfg = IndexConfig(n_clusters=10, degree=16, build_degree=32,
                      block_size=1024)

    # --- §IV: fit the runtime model from tiny *real* vamana builds ------
    rt = calibrate_runtime(None, ds.data, sample_sizes=(256, 512, 1024),
                           cfg=cfg, device=dev)
    print(f"runtime model: {rt.seconds_per_vector*1e6:.1f} µs/vector "
          f"+ {rt.fixed_overhead_s:.2f}s overhead (fit on real builds)")

    # --- real fleet build under seeded preemptions ----------------------
    # mean_lifetime_rounds=6 is brutal on purpose: expect several kills
    injector = PreemptionInjector(seed=7, mean_lifetime_rounds=6.0,
                                  notice_rounds=2)
    store = CheckpointStore()
    out = build_scalegann_fleet(
        ds.data, cfg, n_workers=4, injector=injector, runtime_model=rt,
        checkpoint_store=store, batch_size=256, device=dev,
    )
    rep, res = out.report, out.build
    sizes = [len(s.ids) for s in res.shards]
    print(f"{rep.n_shards} shards, sizes {min(sizes)}–{max(sizes)}, "
          f"replicas {res.stats['replica_proportion']:.1%}")
    print(f"fleet build: {rep.n_preemptions} preemptions "
          f"({rep.n_notices} with notice), {rep.n_resumes} resumes, "
          f"{rep.n_requeues} re-queues, {rep.rounds_lost} of "
          f"{rep.rounds_completed} rounds lost, "
          f"{store.n_saves} checkpoint saves")
    print(f"wall {rep.makespan_s:.2f}s (partition {rep.partition_s:.2f}s "
          f"+ shards {rep.fleet_wall_s:.2f}s + merge {rep.merge_s:.2f}s), "
          f"accelerator-active {rep.accelerator_active_s:.2f}s")

    # --- per-shard event timelines (the telemetry satellite view) --------
    print("per-shard timelines (attempts, rounds, checkpoints, lifecycle):")
    for tl in rep.shard_timelines:
        # checkpoint events are dense (one per round) — compress them so
        # the lifecycle (kill/preempted/resume) stays readable
        steps, n_ckpt = [], 0
        for _t, kind, _w, _s, detail in tl.events:
            if kind == "checkpoint":
                n_ckpt += 1
                continue
            if n_ckpt:
                steps.append(f"ckpt x{n_ckpt}")
                n_ckpt = 0
            steps.append(f"{kind}({detail})")
        if n_ckpt:
            steps.append(f"ckpt x{n_ckpt}")
        print(f"  shard {tl.shard}: {tl.attempts} attempt(s), "
              f"{tl.rounds_completed} rounds, "
              f"{tl.checkpoints_saved} checkpoint(s)")
        print(f"    {' -> '.join(steps)}")

    # --- §VI-C cost model ------------------------------------------------
    cost = rep.cost
    print(f"cost at spot prices: ${cost.total:.4f} "
          f"(cpu ${cost.cpu_cost:.4f} + accel ${cost.accelerator_cost:.4f})")

    # --- the preempted build still serves --------------------------------
    ids, _ = search(res.index, ds.queries, 10, data=ds.data, width=96,
                    device=dev)
    print(f"recall@10 = {recall_at(ids, ds.gt, 10):.3f}")

    # --- replay the shard sizes on the virtual clock, both policies ------
    # (hour-scale what-if: the same §IV scheduler logic, simulated pool)
    scaled = [s * 1000 for s in sizes]  # pretend Laion-scale shards
    for name, policy_cls in SCHEDULING_POLICIES.items():
        sim = Scheduler(
            make_tasks(scaled), make_spot_pool(4, seed=1), rt,
            checkpoint_resume=True, checkpoint_interval_s=60.0,
            policy=policy_cls(),
        ).run()
        print(f"simulated [{name}]: makespan {sim.makespan_s:.0f}s, "
              f"{sim.n_preemptions} preemptions, "
              f"{sim.work_lost_s:.0f}s lost")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
