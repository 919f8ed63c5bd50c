"""Quickstart: build a ScaleGANN index and serve queries, on the port.

The reference's ``examples/quickstart.py`` on ``repro_torch``, section for
section: 1–3 build, 4 query backends, 5 routed split serving, 6 the
micro-batching server, 7 quantized distance stages (uint8/bf16 + f32
re-rank), 8 vectorized vs seed-loop build timing, 9 the fused beam engine
(``backend="fused"``, K3 on the card), 10 preemption-tolerant spot-fleet
builds (checkpoint/resume through an injected kill), traced end to end
(open the written trace at https://ui.perfetto.dev), 11 the live mutable
index (insert/delete/search under churn with epoch-swapped serving), 12
crash-consistent durability (WAL + atomic snapshots: kill mid-mutation,
recover, serve identical ids).  The reference's ``jax`` backend is
``torch`` here and its ``pallas`` backend ``fused``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import pathlib
import tempfile
import time

import numpy as np

from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.core.merge import connectivity_stats
from repro_torch.core.scheduler import RuntimeModel
from repro_torch.data.synthetic import (make_clustered, near_tie_breaks,
                                        recall_at)
from repro_torch.device import resolve_device
from repro_torch.durability import CrashInjector, SimulatedCrash
from repro_torch.fleet import PreemptionInjector, build_scalegann_fleet
from repro_torch.live import LiveConfig, LiveIndex
from repro_torch.search import search
from repro_torch.serving import AnnServer, ServerStats, ServingConfig
from repro_torch.telemetry import Tracer, check_fleet_trace

# the parity contract's distance tolerance (the reference suite's, for
# fused against jax): two ids at one rank whose exact distances to the
# query agree this closely are a near-tie, which summation order may flip
TIE_RTOL, TIE_ATOL = 1e-4, 2e-3


def near_tie_rows(data, queries, got, want) -> list[tuple[int, bool]]:
    """``(row, near_tie)`` for every row where two id lists differ: a row
    is a near-tie when at each rank where they differ both ids' exact
    float64 L2 distances to the row's query agree within the contract's
    tolerance."""
    breaks = near_tie_breaks(queries, data, got, want, rtol=TIE_RTOL,
                             atol=TIE_ATOL)
    return [(int(r), not bool(breaks[r].any()))
            for r in np.flatnonzero((got != want).any(axis=1))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cpu: their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a clustered vector dataset (stand-in for Sift/Laion embeddings)
    ds = make_clustered(5000, 64, n_queries=50, spread=1.0, seed=0,
                        device=dev)

    # 2. paper knobs: k-means shards, selective replication ε, degree R
    cfg = IndexConfig(n_clusters=8, degree=16, build_degree=32,
                      epsilon=1.2, block_size=1024)

    # 3. partition → parallel shard builds → merge (n_workers ≈ #GPUs)
    res = build_scalegann(ds.data, cfg, n_workers=4, device=dev)
    print(f"partition {res.partition_s:.2f}s | shard builds "
          f"{res.wall_build_s:.2f}s (Σ {res.build_only_s:.2f}s) | "
          f"merge {res.merge_s:.2f}s")
    print(f"replicated {res.stats['replica_proportion']:.1%} of vectors "
          f"(DiskANN uniform would be ~100%)")
    print("connectivity:", connectivity_stats(res.index))

    # 4. The same search call serves any topology with any backend:
    #    "numpy" is the latency-shaped host reference, "torch" the batched
    #    beam as torch ops (the reference's "jax").
    for backend in ("numpy", "torch"):
        ids, stats = search(res.index, ds.queries, k=10, data=ds.data,
                            backend=backend, width=96, device=dev)
        print(f"[{backend}] recall@10 = {recall_at(ids, ds.gt, 10):.3f}  "
              f"({stats.n_distance_computations / len(ds.queries):.0f} "
              f"distance computations / query)")

    # 5. Routed split serving: the partition's replicated shards can be
    #    served directly (no merge), routing each query to its nprobe
    #    nearest shard centroids instead of broadcasting to all of them.
    shard_topo = res.shard_topology(ds.data)
    for nprobe in (None, 2, "auto"):
        ids, stats = search(shard_topo, ds.queries, k=10, backend="torch",
                            width=96, nprobe=nprobe, device=dev)
        label = "scatter-all" if nprobe is None else f"nprobe={nprobe}"
        print(f"[shards/{label}] recall@10 = "
              f"{recall_at(ids, ds.gt, 10):.3f}  "
              f"({stats.n_distance_computations / len(ds.queries):.0f} "
              f"distance computations / query)")

    # 6. Serving: single-query traffic goes through repro_torch.serving,
    #    which micro-batches submit() calls into engine-sized search()
    #    batches (flush at max_batch or max_wait_ms, whichever first).  See
    #    repro_torch.examples.serve_ann for the open-loop load generator.
    async def serve_a_few():
        sc = ServingConfig(backend="torch", k=10, width=96, max_batch=32,
                           max_wait_ms=2.0)
        async with AnnServer(res.index, data=ds.data, config=sc,
                             device=dev) as srv:
            # first round absorbs the server's startup (the warm-up of its
            # batch shapes); then measure a steady round
            await asyncio.gather(*(srv.submit(q) for q in ds.queries))
            srv.stats = ServerStats()
            outs = await asyncio.gather(
                *(srv.submit(q) for q in ds.queries)
            )
        ids = np.stack([o.ids for o in outs])
        snap = srv.stats.snapshot()
        print(f"[served] recall@10 = {recall_at(ids, ds.gt, 10):.3f}  "
              f"p95 = {snap['latency_ms']['p95']:.1f} ms  "
              f"mean batch = {snap['batch_occupancy']['mean']:.1f}")

    asyncio.run(serve_a_few())

    # 7. Quantized distance stages: traverse the graph on cheap uint8 (or
    #    bf16) distances — 4× (2×) less memory traffic per scored pair —
    #    then re-rank the top rerank·k candidates exactly in f32.  Specs
    #    (scale/zero-point) are learned per shard from the partitioner's
    #    data pass; stats split the quantized vs re-rank work.
    for dt in ("f32", "bf16", "uint8"):
        ids, stats = search(shard_topo, ds.queries, k=10, backend="torch",
                            width=96, nprobe=2, dtype=dt, rerank=4,
                            device=dev)
        pq = stats.per_query()
        print(f"[dtype={dt:5s}] recall@10 = "
              f"{recall_at(ids, ds.gt, 10):.3f}  "
              f"({pq['distance_computations']:.0f} dist/q: "
              f"{pq['quantized_distance_computations']:.0f} quantized + "
              f"{pq['rerank_distance_computations']:.0f} f32 re-rank)")

    # 8. The build itself is vectorized: Vamana inserts in engine-backed
    #    batched rounds, CAGRA's prune and the merge run sort-based vector
    #    passes.  The seed-loop baselines survive behind reference=True
    #    (their shard builds run on the host) — compare them on a slice.
    sub = ds.data[:800]
    t0 = time.perf_counter()
    build_scalegann(sub, cfg, algo="vamana", reference=True, device=dev)
    t_ref = time.perf_counter() - t0
    # warm: the first vectorized build pays the one-off costs, on the card
    # the kernels' nvcc build at first use and the prune's CUDA-graph
    # captures (the reference's warm call paid its jit trace)
    build_scalegann(sub, cfg, algo="vamana", device=dev)
    t0 = time.perf_counter()
    build_scalegann(sub, cfg, algo="vamana", device=dev)
    t_vec = time.perf_counter() - t0
    print(f"[build] seed-loop vamana {t_ref:.2f}s -> vectorized "
          f"{t_vec:.2f}s ({t_ref / t_vec:.1f}x on this slice)")

    # 9. The fused beam engine: backend="fused" runs the whole search —
    #    seed scoring, beam traversal, top-k upkeep, and (for staged
    #    dtypes) the exact-f32 re-rank — as ONE kernel launch per batch
    #    on the card (K3; the CPU runs its plain version).  Its ids match
    #    the torch backend's but where an f32 summation order flips a
    #    near-tie, so it drops into any search()/AnnServer call site.
    jids, jstats = search(res.index, ds.queries, k=10, data=ds.data,
                          backend="torch", width=96, device=dev)
    pids, pstats = search(res.index, ds.queries, k=10, data=ds.data,
                          backend="fused", width=96, device=dev)
    same = bool(np.array_equal(pids, jids))
    differ = "" if same else "  rows differ: {}, near-ties: {}".format(
        *zip(*near_tie_rows(ds.data, ds.queries, pids, jids)))
    print(f"[fused] recall@10 = {recall_at(pids, ds.gt, 10):.3f}  "
          f"ids identical to torch: {same}{differ}  "
          f"({pstats.n_distance_computations / len(ds.queries):.0f} "
          f"distance computations / query)")
    ids, stats = search(shard_topo, ds.queries, k=10, backend="fused",
                        width=96, nprobe=2, dtype="uint8", rerank=4,
                        device=dev)
    uids, _ = search(shard_topo, ds.queries, k=10, backend="torch",
                     width=96, nprobe=2, dtype="uint8", rerank=4,
                     device=dev)
    pq = stats.per_query()
    print(f"[fused/uint8] recall@10 = {recall_at(ids, ds.gt, 10):.3f}  "
          f"ids identical to torch: {bool(np.array_equal(ids, uids))}  "
          f"({pq['quantized_distance_computations']:.0f} quantized + "
          f"{pq['rerank_distance_computations']:.0f} f32 re-rank dist/q, "
          f"traversal+re-rank fused on the merged path)")

    # 10. Spot-fleet builds survive preemptions: build_scalegann_fleet
    #     runs the same shard builds through a scheduler that checkpoints
    #     every batched round, so a killed instance costs only the rounds
    #     since the last save — the task re-queues, resumes mid-build, and
    #     the finished index is bit-identical to an uninterrupted one.
    #     Here we inject one kill on shard 0 at round 2 and watch it heal,
    #     with a Tracer recording the whole run: worker attempt spans,
    #     per-round vamana spans, the kill instant, the backoff window and
    #     the resume all land on one Perfetto timeline
    #     (repro_torch.examples.build_spot_index runs the full workflow).
    #     Two worker threads share the one card, each on its own stream.
    sub = ds.data[:2000]
    fcfg = IndexConfig(n_clusters=4, degree=16, build_degree=32,
                       block_size=1024)
    tracer = Tracer(process="quickstart")
    fleet = build_scalegann_fleet(
        sub, fcfg, n_workers=2,
        injector=PreemptionInjector(kill_shard_at={0: 2}),
        runtime_model=RuntimeModel(seconds_per_vector=1e-4),  # skip
        tracer=tracer,         # calibration here
        device=dev,
    )
    rep = fleet.report
    plain = build_scalegann(sub, fcfg, algo="vamana", device=dev)
    same = all(np.array_equal(a, b) for a, b in
               zip(fleet.build.shard_graphs, plain.shard_graphs))
    print(f"[fleet] {rep.n_preemptions} preemption -> {rep.n_resumes} "
          f"resume, {rep.rounds_lost} of {rep.rounds_completed} rounds "
          f"lost, graphs identical to uninterrupted build: {same}  "
          f"(${rep.cost.total:.4f} at spot prices)")
    trace_path = pathlib.Path(tempfile.gettempdir()) / \
        "quickstart_fleet_trace.json"
    tracer.write(trace_path)
    chk = check_fleet_trace(tracer.to_chrome())
    rounds = rep.metrics["fleet_rounds_total"]["series"][0]["value"]
    print(f"[trace]  {chk['n_attempt_spans']} attempt spans / "
          f"{rounds:.0f} round spans across {chk['n_worker_tracks']} "
          f"worker tracks; kill->backoff->resume on the timeline: "
          f"{chk['ok']} — open {trace_path} at https://ui.perfetto.dev")

    # 11. The live mutable index: insert_batch runs one batched Vamana
    #     round per touched shard, delete_batch tombstones ids (masked out
    #     of every result until consolidate() makes them physical), and
    #     snapshot() is a copy-on-write generation — untouched shards
    #     share arrays with the previous snapshot, so per-shard device
    #     caches stay warm.  AnnServer.swap_topology() flips a serving
    #     process to the new generation atomically, mid-traffic.
    li = LiveIndex.from_build(res, ds.data, cfg, LiveConfig(backend="torch"),
                              device=dev)
    rng = np.random.default_rng(7)             # fresh points: jittered
    fresh = (ds.data[rng.choice(len(ds.data), 32, replace=False)]
             + rng.normal(0, 0.05, (32, 64)).astype(np.float32))
    new_ids = li.insert_batch(fresh)           # routed to nearest shards
    victim = int(ds.gt[0, 0])                  # query 0's true top-1 ...
    li.delete_batch(np.array([victim]))        # ... tombstoned
    ids, _ = search(li.snapshot(), ds.queries, k=10, backend="torch",
                    width=96, device=dev)
    found = int(np.isin(new_ids, search(
        li.snapshot(), fresh[:8], k=1, backend="torch", width=96,
        device=dev,
    )[0].ravel()).sum())
    print(f"[live] gen {li.generation}: inserted {len(new_ids)} "
          f"(first 8 self-findable: {found}/8), deleted id {victim} "
          f"returned anywhere: {bool((ids == victim).any())}")
    rep = li.consolidate()                     # dead rows go physical
    print(f"[live] consolidate: re-pruned {rep['rows_repruned']} rows, "
          f"removed {rep['removed']} tombstones "
          f"({li.n_live} live of {li.n_vectors} ids)")

    async def swap_mid_traffic():
        sc = ServingConfig(backend="torch", k=10, width=96, max_batch=32,
                           max_wait_ms=2.0)
        async with AnnServer(li.snapshot(), config=sc, device=dev) as srv:
            wave = [srv.submit_nowait(q) for q in ds.queries[:16]]
            li.insert_batch(fresh[:16] + 0.1)
            gen = srv.swap_topology(li.snapshot())  # atomic epoch swap
            outs = await asyncio.gather(*wave)
            print(f"[live] epoch swap -> serving generation {gen}, "
                  f"{len(outs)}/16 in-flight futures resolved")

    asyncio.run(swap_mid_traffic())

    # 12. Crash-consistent durability: from the first save() on, every
    #     mutation appends a CRC32-framed WAL record *before* touching
    #     memory, and save() commits checksummed snapshot generations
    #     atomically (segments -> manifest -> CURRENT flip).  Kill the
    #     process at any byte boundary -- load() restores the committed
    #     generation, truncates a torn final WAL record, replays the
    #     tail, and the recovered index serves ids identical to one
    #     that never crashed.
    idx_dir = pathlib.Path(tempfile.mkdtemp(prefix="quickstart_idx_"))
    li.save(idx_dir)                       # snapshot + arms the WAL
    li.close()                             # detach: li continues purely
                                           # in memory as the uncrashed
                                           # reference for the disk copy
    ops = [("insert", fresh + 0.2), ("delete", new_ids[:4])]
    for op, arg in ops:                    # the uncrashed reference run
        (li.insert_batch if op == "insert" else li.delete_batch)(arg)
    ref_ids, _ = search(li.snapshot(), ds.queries, k=10, backend="torch",
                        width=96, device=dev)

    # same mutations against the on-disk copy, with a kill injected
    # mid-append on the second record (a torn half-frame lands on disk):
    rec = LiveIndex.load(idx_dir, cfg, LiveConfig(backend="torch"),
                         injector=CrashInjector(
                             crash_at={"wal.append.torn": 2}),
                         device=dev)
    seq0, pos = rec.wal_seq, 0
    while pos < len(ops):
        op, arg = ops[pos]
        try:
            (rec.insert_batch if op == "insert" else
             rec.delete_batch)(arg)
            pos += 1
        except SimulatedCrash as c:        # the "kill -9"
            print(f"[durability] crashed at {c.point}; recovering")
            rec = LiveIndex.load(idx_dir, cfg, LiveConfig(backend="torch"),
                                 device=dev)
            pos = rec.wal_seq - seq0       # replayed ops aren't re-run

    async def serve_recovered():
        sc = ServingConfig(backend="torch", k=10, width=96, max_batch=32,
                           max_wait_ms=2.0)
        async with AnnServer(li.snapshot(), config=sc, device=dev) as srv:
            srv.swap_topology(rec.snapshot(), reason="recovery")
            outs = await asyncio.gather(
                *(srv.submit(q) for q in ds.queries)
            )
        served = np.stack([o.ids for o in outs])
        print(f"[durability] recovered from kill: served ids identical "
              f"to the uncrashed run: "
              f"{bool(np.array_equal(served, ref_ids))}")

    asyncio.run(serve_recovered())
    rec.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
