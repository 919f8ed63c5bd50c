#!/usr/bin/env python3
"""Smoke run of ``repro_torch`` on one NVIDIA H100.

    python3 chip_smoke.py [--n 1000000] [--queries 10000] [--vamana-n 50000]
                          [--fleet-n 200000]

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the five CUDA sources (one ``nvcc`` per source, in
   parallel, into ``build/repro_torch_kernels``).
2. ANN main path, with every launch counter zeroed just before and read
   just after: ``make_clustered(n, 128, n_queries, seed=0)`` (SIFT1M/
   BIGANN-1M's shape, ground truth from K4), ``build_scalegann`` with the
   ``IndexConfig`` defaults (16 clusters, R=64, L=128, ε=1.2, ω=2), merged
   search at k=10, width=64 in f32, bf16 and uint8, and routed split search
   with nprobe=2 and "auto" in f32 and uint8.  K1–K4 and the merge
   kernel must have launched.
3. Each ANN kernel against its plain PyTorch version on the card, at the
   main path's shapes.  K1 at every operand shape the main path gave it
   (tallied during step 2 with the kernel each call took, which must be the
   skinny one): device time from a CUDA graph over operands rotated through
   more than the 50 MB L2, time a call with the host included, launches,
   bound and share of it, an empty kernel's graph time (the launch floor),
   cdist/mm; then at [4096,128]x[65536,128] (f32/bf16, L2/IP; the tiled
   kernel), which no caller runs.  K2 at the routing tile (L2 bit-exact),
   timed the same way.  Then K1 and K2 on the paths the main path does not
   take: element loads (a misaligned view, D = 100), the tiled kernel, and
   ragged N, M and D (uint8 L2 bit-exact in each).  K4 on integer points
   with duplicates (f32-exact distances, ids equal), at ragged N, k > N,
   k = 1, k = 256, IP and ground truth's last block (1808 x 1M, k=10), then
   at one shard's shape with k=129 beside cdist + topk (the resident
   64-row panel), then its streamed panel at GIST-960's shard shapes,
   [12500,960]^2 at k=129 (64 rows) and [4096,960]x[12500,960] at k=256
   (32 rows), against the plain version and beside the FP32 bound (the
   ``kernels`` row's ``streamed`` entries); the merge kernel
   on step 2's own row table against its plain version (graph and unique
   counts equal, and equal to the build's graph), timed; K3 on the built
   merged graph for 256 queries and for the merged search's own
   10,000-query launch, in f32, bf16 and uint8 (uint8 traversal and
   re-ranked ids, distances and counters bit-exact; bf16 re-ranked
   distances bit-equal wherever the ids agree), with its resident blocks
   per SM, then at every launch shape of the main path on that launch's
   own inputs (time and bound summed by range of Q).
4. A small index searched on the card and on the CPU's plain path: the
   same ids and stats (uint8 exact).
5. Serving phase over step 2's index (``ds``, ``merged``, ``split``),
   counters zeroed just before each trial's traffic and read just after:
   a batch-1 baseline of 1,000 blocking ``search()`` calls (merged, f32,
   k=10, width=64); ``AnnServer`` on the card over ``merged`` (max_batch
   64, max_wait_ms 2) under 10,000 open-loop Poisson requests at 4x the
   baseline's QPS, each backdated to its scheduled arrival, with
   ``swap_topology`` at the 5,000th; the same server with all 10,000
   submitted at once (capacity); and a traced server over ``split``
   (nprobe=2, uint8 one request in two, nprobe="auto" one in five) under
   2,000 Poisson requests at the merged trial's rate.  Each trial gates on
   no failed, rejected or shed request, no signature first seen after
   warm-up, no kernel build and no device-copy upload during traffic, and
   the stats' Prometheus round trip; served ids are held to one direct
   ``search()`` per option group (uint8 equal, f32 99.9% with near-ties
   only); the split trace must validate and cover each request's latency;
   K1, K2 and K3 must launch in the split trial.  Also the cost of a
   swap's uint8 view and ``BuildResult.feed_metrics``' phase gauges.
6. Live phase over step 2's build, counters zeroed just before and read
   just after: ``LiveIndex.from_build`` (``fused``, ``split_max`` between
   the two largest shards' sizes after the inserts) with uint8 views,
   served by an ``AnnServer`` (split, nprobe=2, uint8 one request in two,
   max_batch 64, max_wait_ms 2), first given 4,000 requests at once with
   no writer (its capacity), then open-loop Poisson traffic at 1,000
   QPS while a writer thread inserts 50,000 vectors of the index's
   distribution in 10 calls (one shard splits), deletes 5% of the ids
   uniformly and 30% of one shard's residents, searches the tombstoned
   snapshot (f32 and uint8, 10,000 queries, ground truth over the live
   ids from K4), consolidates and searches again, calling
   ``swap_topology`` after each mutation.  Gates: a split; no tombstoned
   id returned and recall@10 no more than 0.02 below the unchurned split
   index's; consolidation removes every resident dead id; no failed,
   rejected or shed request; no response holding an id deleted before
   the swap that preceded its submission; each swap's device uploads at
   most one f32 and one uint8 pair a touched shard; the writer thread's
   prune graphs replayed, and their static buffers and pool at most their
   budget and one capture (1 GiB) after the inserts.  Then a full-size
   ``save``, a logged tail (insert, delete, consolidate), a crash at
   ``wal.append.torn`` on the next insert, and ``LiveIndex.load`` on the
   card, which must equal the crashed index (ids, graphs, entries,
   centroids, tombstones, ``wal_seq``, search ids).  The phase's parts are
   timed (K3 by CUDA events), K3's bound computed at the insert and the
   served shapes, and K1/K2 timed at the routing tile against 16
   centroids (skinny) and the 17 after the split (tiled).
7. DiskANN path, counters zeroed just before and read just after:
   ``make_clustered(vamana_n, 128, n_queries=2000, seed=1)`` written to a
   BIGANN ``.fbin`` and memmapped back, ``build_diskann`` (uniform ω=2,
   Vamana R=64, L=128 per shard; every round one K3 launch at Q=256,
   width=k=n_iters=128, E=1, then the prune and reverse edges as torch
   ops on the card) with its phase times, rounds, K3 device time against
   the prune's, rounds a second and K3's occupancy at that shape; then the
   merged index at k=10, width=64, f32, on ``fused`` and ``torch`` (2000
   queries) and ``numpy`` (200): recall@10 against K4's ground truth and
   QPS, fused and torch agreeing on 99.9% of ids.  K1, K3, K4 must have
   launched.  Then ``torch`` on the card against the CPU (2000 queries;
   uint8 exact, f32 99.9% of ids), one Vamana round's prune and reverse
   edges on the card (prune chunks replayed from CUDA graphs, the overflow
   re-prune at bucketed shapes) against the CPU's eager loop on integer
   points (equal), and K3 at the build shape against its plain version
   (ids and counters on 99.9%).
8. Fleet phase, counters zeroed just before and read just after:
   ``make_clustered(fleet_n, 128, n_queries=2000, seed=2)`` (ground truth
   from K4), ``calibrate_runtime`` on real ``fused`` builds at 256, 512
   and 1024 rows, and ``build_scalegann_fleet`` on two workers (each on
   its own stream) with the calibrated model, ``fused`` Vamana builds
   (every round one K3 launch), an on-disk ``CheckpointStore`` every 128
   rounds and on notice, a ``Tracer`` and a seeded ``PreemptionInjector``
   (mean lifetime 300 rounds, notice 2 rounds, and a notice-less kill of
   the largest shard between two checkpoints); the merged index searched
   at k=10, width=64, f32.  Gates: preemptions, a notice, a resume and
   lost rounds; every preempted shard's graph and distance count equal to
   its uninterrupted build on the card; ``check_fleet_trace``; K3's
   launches during the build and ``fleet_rounds_total`` equal to the
   rounds completed; no checkpoint left behind.  Prints one ``fleet
   {...}`` line: phase times, rounds (two workers against alone),
   checkpoint saves and loads, the calibration's error against each
   shard that was not preempted, the cost at the paper's V100 rates (a
   model input, not a measurement), recall@10 and what a round's state
   costs at the largest shard (device clone against host copy).
9. LM main path, counters zeroed just before and read just after:
   TinyLlama-1.1B at full width (22 layers, d_model 2048, GQA 32/4) with
   seeded random weights in bf16, ``ServeEngine`` with 8 slots and
   max_len 2048 serving 12 greedy requests (prompts of 512–1024 tokens,
   64 new tokens each) in two waves.  K5 must launch once per layer and
   wave, K6 once per layer and decode step.  Then one prefill and three
   decode steps under torch.profiler: host wall time against device busy
   time, and the kernels that take it.
10. K5 against its plain version in bf16 (rtol=atol=8e-3) at each wave's
   shape of the LM path (ragged last tiles), at head dims 16, 32 and 128,
   non-causal, S < T and GQA groups 1 and 8 (with the share of outputs
   bit-equal to the plain version), then at q [8,32,1024,64], k/v
   [8,4,1024,64] in bf16 (also timed with a single bf16 P, to price the
   hi + lo split) and f32 (1e-5); K6 in f32 (1e-5) and bf16 (8e-3) at
   lengths on and around its chunk edges (0 included) at the LM shape,
   head dims 16/32/128 and GQA groups 1, 8 and 32, then at q [8,32,64]
   against a [8,4,2048,64] cache with the main path's longest length and
   with every row full, timed from CUDA graphs of 50 launches (a call's
   Python path takes longer than the kernel) and per call with the host
   included.  SDPA is timed as the yardstick.  K6's scratch, kept per
   stream: grown between launches back to back, used by a captured CUDA
   graph on new inputs, and refused when a capture would need more.
11. Every config's small version (TinyLlama's and, since the families
   phase, the nine others'), prefill and 4 decode steps on the card and
   on the CPU's plain path: f32 logits to 1e-4 with greedy tokens equal,
   bf16 logits to 2e-2 x max|logit| (Jamba's printed only: ROADMAP.md
   queue C).
12. LM families phase, counters zeroed just before each config's run
   and read just after: rwkv6-1.6B, jamba-v0.1 (8 of 32 layers: one
   period), kimi-k2 (1 of 61), arctic-480B (1 of 35), phi3-mini-3.8B,
   granite-3-2B, whisper-base and internvl2-76B (4 of 80), at full width
   with seeded random weights made straight in bf16 (routers and Mamba's
   decay logs stay f32), each cut printed on a ``CUT`` line and each
   model freed before the next.  The engine families serve one wave of 8
   requests (prompts of 512–1024 tokens, the longest 1,024; 32 greedy new
   tokens) and its repeat; Whisper (1,500 seeded frames, 64 prompt
   tokens) and the VLM (256 seeded patch embeddings, 512 prompt tokens)
   run ``prefill_fn`` and 32 ``decode_fn`` steps twice.  One ``LM family
   {...}`` line each: parameters, bytes, init seconds, peak memory,
   TTFT, decode tok/s and step ms per wave, MoE dropped fractions, and a
   profiled decode step's device busy time against the step's wall.
   Gates: finite logits, greedy tokens equal on the repeat, K5 launches =
   self-attention layers x 2 (+ Whisper's encoder and cross-attention
   layers), K6 = attention layers x decode steps x 2 (+ cross).
13. K5 and K6 against their plain versions (bf16, 8e-3) at the phase's
   new shapes: head dim 96 (phi3-mini), GQA group 7 (arctic), Whisper's
   non-causal encoder (S = T = 1,500) and cross-attention (S = 64, T =
   1,500), timed beside SDPA with their bounds.  At every K5 shape timed
   (here and in step 10) K5 also runs with its log-sum-exp output: the
   lse against the plain version's ``torch.logsumexp`` (f32, 1e-4), the
   output equal to the launch without it, both timed.
14. Retrieval-attention phase (after step 9's breakdown, on its engine),
   counters zeroed just before and read just after: one 1,042-token
   TinyLlama prompt prefilled and decoded a step; the last layer's K6
   call gives 32 query heads' q and 4 KV heads x 1,043 keys and values;
   ``build_key_indexes`` on the card (K1, K4), one
   ``retrieval_decode_attention`` step on ``fused`` (K3 at Q = 1) at the
   reference's defaults, held to K6's full attention.  Prints one
   ``retrieval {...}`` line (build s, decode ms, errors, distance counts
   against the exhaustive 32 x 1,043).  Gates: finite outputs; exact
   selection of every key equal to full attention to 1e-4 x max; the
   ``fused`` ids on the card equal to the CPU ``torch`` backend's (a
   differing id must be a near-tie); K1, K3 and K4 launched.
15. Training phase, counters zeroed just before the timed steps and
   read just after: the TinyLlama and kimi smoke configs' f32 gradients
   on the card against the CPU's (1e-4 x max|g| a leaf); TinyLlama-1.1B
   at full width, bf16 trainable parameters, ``remat="full"``, AdamW,
   ``TrainConfig(warmup_steps=2)`` (a ``CUT`` line) over
   ``TokenPipeline(32000, 1024, 8, seed=0)`` for 10 steps.  One batch's
   gradients through K5 + the FA2 backward against the plain attention's
   (5e-2 x max|g| a leaf, bf16) with the forward / backward split; then
   one ``train {...}`` line (losses, grad norms, step ms, tokens/s, a
   profiled step's busy ms and idle share, peak GB, K5 launches, the
   backward's share).  Gates: finite losses falling from the first step
   to the last, finite grad norms, K5 launched 22 times a forward and 22
   a recompute, a checkpoint saved on the card restoring equal.
16. Launch phase (last).  First the port's whole dry-run in-process
   (``repro_torch.launch.dryrun``, its cells counted in 6 processes on the
   host, on the meta device): 40 cells on both production meshes, one
   ``dryrun cell`` line per counted cell and one ``dryrun {...}`` line
   (ok / skipped / error rows, seconds); gates: 0 errors, 64 ok rows and
   8 skips, all ``long_500k`` of the full-attention families.  Then the
   dry-run's cells that fit one H100, at full width with seeded random
   weights in bf16, each cut on a ``CUT`` line and its device bytes
   reckoned before it runs: TinyLlama-1.1B x decode_32k (batch 64, K6 at
   T = 32,768), x prefill_32k (batch 8, K5 at S = T = 32,768) and x
   train_4k (global batch 32 in 4 microbatches of 8, remat=full, AdamW;
   1 warm step, 1 timed), rwkv6-1.6B x long_500k and jamba-v0.1 x
   long_500k (8 of 32 layers, K6 at T = 524,288).  Decode cells start
   from a cache of seeded random values (``seq_len - 1`` tokens held)
   and time ``serve_step_fn`` at ``pos = seq_len - 1``; prefill and decode
   cells time 5 calls after a warm one (the median).  One ``launch cell
   {...}`` line each: step ms, the ``step_cost`` count of the cut step
   (FLOPs and the eager program's op-level bytes), the bound max(FLOPs /
   989e12, least bytes / 3.35e12) with least bytes the weights, caches
   and state read once and the outputs written once, its share of the
   step, reckoned and peak GB, K5 / K6 launches.  Gates: finite logits
   and loss, K6 launched (attention layers) x (steps) in the decode
   cells, K5 (layers) x (calls) in prefill and 2 x (layers) x
   (microbatches) in the train step, every step >= 0.95 x its bound.  K6
   against its plain version at T = 32,768 and T = 524,288 over a whole
   call; K5 at the prefill cell's layer shape q [8,32,32768,64] on the
   last 512 query rows of every sequence; K5 with its lse at the train
   cell's q [8,32,4096,64] on every sequence, and the FA2 backward there
   on two sequences (5e-2 x max |g|).  The bf16 outputs are held both to
   8e-3 and to 8e-3 x their largest magnitude (they average thousands of
   random rows and are far below 1).  K5 and K6 are timed beside SDPA with
   their bounds.
17. Examples phase (after the launch phase), counters zeroed just before
   and read just after: the six entry points of ``repro_torch.examples``
   (``quickstart``, ``serve_ann``, ``build_spot_index``,
   ``lm_embed_index``, ``train_lm`` with its checkpoints under
   ``build/examples_ckpt``, ``serve_lm``), each ``main([...])`` called in
   process at the reference scripts' defaults, its lines logged with its
   wall time and launches; then the quickstart runs with ``--device cpu``
   in a subprocess, after the card's scripts so that it takes no host
   cores from their timed runs.  Gates: each exits 0 and prints its markers;
   the quickstart's checks hold (fleet graphs identical, the trace, the
   deleted id absent, the recovered ids identical, ``fused`` uint8 ids
   equal to ``torch``'s and f32 equal or differing at near-ties only);
   its lines equal the CPU run's in every counter and in the uint8 lines,
   f32/bf16 recall within 0.01; train_lm's final loss finite; K1–K6 all
   launched in the phase.  One ``examples {...}`` line (wall times,
   launches, the card).

Prints one ``{"kernels": [...]}`` line, then the card's line, then
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero on any
failure, and when CUDA is missing.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12     # outside the tensor cores (no TF32)
H100_INT8_OPS = 1979e12     # dense int8 tensor-core rate
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core rate
H100_HBM_BYTES = 3.35e12    # HBM3 bytes per second


ANN_KERNELS = ("pairwise_distance", "pairwise_distance_u8", "fused_beam", "knn")
# the build's merge of shard graphs: every build on the card launches it
BUILD_KERNELS = ("merge_rows",)
LIVE_INSERTS, LIVE_CALLS, LIVE_QPS = 50_000, 10, 1000.0  # the live phase
LIVE_CAPACITY_N = 4000  # requests at once before the writer starts
# rounds between the fleet's periodic checkpoints: at 64 the periodic saves
# took 20% of the fleet's wall on an H100 80GB HBM3 host at 700 W, at 128
# 5% (PERF.md §6); the target is ~10%
FLEET_CKPT_EVERY = 128
LM_KERNELS = ("flash_attention", "flash_decode")
LM_NEW_TOKENS = 64


class SmokeError(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def events_ms(torch, fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Device time of ``fn`` from a CUDA graph of ``reps`` calls, replayed
    twice after a warm-up on the capturing stream: the host's work per call
    drops out, so a kernel of a few microseconds is timed and not the
    Python path that launches it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * reps)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / H100_HBM_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build_all
    from repro_torch.telemetry import install_compile_listener

    install_compile_listener()  # nvcc runs feed kernel_builds_total
    t0 = time.perf_counter()
    logs = build_all()
    log(f"kernel build {time.perf_counter() - t0:.3f} s "
        f"({len(logs)} sources compiled)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    return card


@contextlib.contextmanager
def k1_tally():
    """Tally K1's operand shapes while the block runs, beside (not instead
    of) its launch counter."""
    from repro_torch.kernels import distance

    shapes: collections.Counter = collections.Counter()
    launch = distance.pairwise_distance_cuda

    def tallied(q, x, metric="l2"):
        shapes[(q.shape[0], x.shape[0], q.shape[1], str(q.dtype)[6:],
                metric, distance.plan_for(q, x).kernel)] += 1
        return launch(q, x, metric)

    distance.pairwise_distance_cuda = tallied
    try:
        yield shapes
    finally:
        distance.pairwise_distance_cuda = launch
    log(f"K1 main-path shapes (M, N, D, dtype, metric, kernel): launches "
        f"{dict(shapes.most_common())}")


def main_path(torch, args):
    """The README's quickstart at full size; returns what the checks need."""
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core.builder import build_scalegann
    from repro_torch.data.synthetic import make_clustered, recall_at
    from repro_torch.kernels import reset_counts
    from repro_torch.search import search

    reset_counts()
    t0 = time.perf_counter()
    ds = make_clustered(args.n, 128, n_queries=args.queries, seed=0)
    torch.cuda.synchronize()
    log(f"data n={args.n} d=128 queries={args.queries} (ground truth by K4) "
        f"{time.perf_counter() - t0:.3f} s")
    cfg = IndexConfig()
    res = build_scalegann(ds.data, cfg)
    log(f"build partition_s={res.partition_s:.3f} "
        f"build_only_s={res.build_only_s:.3f} merge_s={res.merge_s:.3f} "
        f"overall_s={res.overall_s:.3f} replicas="
        f"{res.stats['replica_proportion']:.4f} shards={len(res.shards)} "
        f"max_shard={res.stats['max_shard']}")
    merged = res.topology(ds.data)
    split = res.shard_topology(ds.data)
    results = {}
    runs = [("merged", merged, None, dt) for dt in ("f32", "bf16", "uint8")]
    runs += [("split", split, npb, dt) for npb in (2, "auto")
             for dt in ("f32", "uint8")]
    for kind, topo, nprobe, dtype in runs:
        kw = dict(k=10, width=64, dtype=dtype, nprobe=nprobe)
        search(topo, ds.queries[:256], **kw)  # device residency + warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, stats = search(topo, ds.queries, **kw)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        rec = recall_at(ids, ds.gt, 10)
        pq = stats.per_query()
        log(f"search {kind} nprobe={nprobe} dtype={dtype} recall@10={rec:.4f} "
            f"qps={len(ds.queries) / dt_s:.1f} wall_s={dt_s:.4f} "
            f"dist/q={pq['distance_computations']:.1f} "
            f"hops/q={pq['hops']:.1f}")
        need(ids.shape == (len(ds.queries), 10), "search output shape")
        results[(kind, nprobe, dtype)] = rec
    launches = ann_counts()
    log(f"main-path launches {json.dumps(launches)}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} was not launched on the main path")
    # a sanity floor only: agreement with the plain path is checked below
    need(results[("merged", None, "f32")] >= 0.3,
         f"merged f32 recall@10 {results[('merged', None, 'f32')]:.4f} "
         "below 0.3")
    return ds, res, merged, split, launches, results


def cold_graph_ms(torch, fn, inputs, reps: int = 50) -> float:
    """Device time of ``fn(inp)`` from a CUDA graph of at least ``reps``
    launches that cycles through ``inputs``: with more than 50 MB of them
    the operands are read cold from HBM, as the partition's fresh blocks
    are, and not from the 50 MB L2."""
    it = itertools.cycle(inputs)
    return graph_ms(torch, lambda: fn(*next(it)), reps=max(reps, len(inputs)))


def copies_for(torch, make, n_bytes: int, cold_bytes: float = 64e6,
               most: int = 64):
    """Enough fresh copies of an operand of ``n_bytes`` to fill
    ``cold_bytes`` (at most ``most``); and whether they exceed the L2."""
    k = min(most, max(2, -(-int(cold_bytes) // max(n_bytes, 1))))
    return [make() for _ in range(k)], k * n_bytes > 50e6


def launch_floor_ms(torch) -> float:
    """An empty kernel's time from the same kind of CUDA graph."""
    from repro_torch.kernels import distance

    return graph_ms(torch, distance.launch_noop)


def check_k1(torch, rows, k1_shapes, floor: float):
    """K1 at each operand shape the main path gave it: device time from a
    CUDA graph over operands rotated through more than the L2 (the figure
    in the kernels line, at the shape with the most launches), time a call
    with the host included, launches, bound and share of it, the plain
    version and one library call; then at [4096,128]x[65536,128] (the
    tiled kernel), which no caller of the main path runs."""
    from repro_torch.kernels import distance

    g = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    shapes = [(key, n) for key, n in k1_shapes.most_common()]
    shapes += [((4096, 65536, 128, dt, metric, "tiled"), 0)
               for dt in ("float32", "bfloat16") for metric in ("l2", "ip")]
    entry = None
    for (m, n, d, dt, metric, kernel), launches in shapes:
        dtype = dtypes[dt]

        def rand(rows_):
            return torch.randn(rows_, d, device="cuda", generator=g).to(dtype)

        qq, xx = rand(m), rand(n)
        plan = distance.plan_for(qq, xx)
        need(plan.kernel == kernel, f"K1 [{m},{d}]x[{n},{d}] took the "
             f"{kernel} kernel on the main path, {plan.kernel} here")
        got = distance.pairwise_distance_cuda(qq, xx, metric)
        want = distance.pairwise_distance_plain(qq, xx, metric)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        need(err <= 1e-5 * scale + 1e-3, f"K1 {dt} {metric} disagrees")
        reps = 3 if launches == 0 else 20
        if launches:
            qs, cold = copies_for(torch, lambda: rand(m),
                                  m * d * qq.element_size())
            ms = cold_graph_ms(torch, lambda a: distance
                               .pairwise_distance_cuda(a, xx, metric),
                               [(a,) for a in qs])
            del qs
            call_ms = events_ms(torch, lambda: distance.pairwise_distance_cuda(
                qq, xx, metric), reps=50)
        else:
            ms = call_ms = events_ms(torch, lambda: distance
                                     .pairwise_distance_cuda(qq, xx, metric),
                                     reps=reps)
            cold = True
        plain_ms = events_ms(torch, lambda: distance
                             .pairwise_distance_plain(qq, xx, metric),
                             reps=reps)
        use_cdist = metric == "l2" and dtype == torch.float32
        if use_cdist:
            lib = events_ms(torch, lambda: torch.cdist(qq, xx), reps=reps)
        else:
            lib = events_ms(torch, lambda: torch.mm(qq, xx.T), reps=reps)
        b, by = bound_ms((m + n) * d * qq.element_size() + m * n * 4,
                         2 * m * n * d, H100_FP32_FLOPS)
        where = (f"main path, {launches} launches" if launches
                 else "off the main path")
        timing = (f"graph_ms={ms:.5f} ({'cold' if cold else 'warm'} L2) "
                  f"per_call_ms={call_ms:.5f} (host included)" if launches
                  else f"ms={ms:.5f}")
        log(f"K1 {dt} {metric} [{m},{d}]x[{n},{d}] ({where}) "
            f"kernel={plan.kernel} vec={plan.vec} "
            f"max_abs_err={err:.3e} (max |d| {scale:.1f}) {timing} "
            f"plain_ms={plain_ms:.5f} library_ms={lib:.5f} "
            f"({'cdist' if use_cdist else 'mm'}) bound_ms={b:.5f} ({by}) "
            f"share_of_bound={b / ms:.3f} launch_floor_ms={floor:.5f}")
        if launches:
            need(kernel == "skinny",
                 f"K1 main-path shape [{m},{d}]x[{n},{d}] is not skinny")
        if entry is None:  # the row: the shape with the most launches
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=lib)
        del qq, xx, got, want
    rows["pairwise_distance"].update(entry)


def check_k2(torch, rows, ds, split, floor: float):
    """K2 at the routing tile of the main path (the quantized centroids
    against every query): L2 bit-exact, IP to 1e-5 of the largest value;
    device time from a CUDA graph over rotated copies of the codes, and a
    call with the host included."""
    import numpy as np

    from repro_torch.kernels import distance

    codes, spec, _ = split.centroid_quant()
    cq = torch.from_numpy(spec.quantize(ds.queries)).cuda()
    cx = torch.from_numpy(np.ascontiguousarray(codes)).cuda()
    m, n, d = cq.shape[0], cx.shape[0], cq.shape[1]
    plan = distance.plan_for(cq, cx)
    need(plan.kernel == "skinny", "K2's routing tile is not skinny")
    g = torch.Generator(device="cuda").manual_seed(6)
    for metric in ("ip", "l2"):
        got = distance.pairwise_distance_u8_cuda(cq, cx, spec.scale,
                                                 spec.zero_point, metric)
        want = distance.pairwise_distance_u8_plain(cq, cx, spec.scale,
                                                   spec.zero_point, metric)
        err = float((got - want).abs().max())
        qs, cold = copies_for(torch, lambda: torch.randint(
            0, 256, (m, d), device="cuda", generator=g, dtype=torch.uint8),
            m * d)
        ms = cold_graph_ms(torch, lambda a: distance.pairwise_distance_u8_cuda(
            a, cx, spec.scale, spec.zero_point, metric), [(a,) for a in qs])
        del qs
        call_ms = events_ms(torch, lambda: distance.pairwise_distance_u8_cuda(
            cq, cx, spec.scale, spec.zero_point, metric), reps=50)
        plain_ms = events_ms(torch, lambda: distance.pairwise_distance_u8_plain(
            cq, cx, spec.scale, spec.zero_point, metric), reps=10)
        b, by = bound_ms((m + n) * d + m * n * 4, 2 * m * n * d, H100_INT8_OPS)
        log(f"K2 uint8 {metric} [{m},{d}]x[{n},{d}] kernel={plan.kernel} "
            f"vec={plan.vec} max_abs_err={err:.3e} "
            f"bit_exact={bool(torch.equal(got, want))} graph_ms={ms:.5f} "
            f"({'cold' if cold else 'warm'} L2) per_call_ms={call_ms:.5f} "
            f"(host included) plain_ms={plain_ms:.4f} bound_ms={b:.5f} ({by}) "
            f"share_of_bound={b / ms:.3f} launch_floor_ms={floor:.5f}")
        if metric == "l2":
            need(torch.equal(got, want), "K2 uint8 L2 is not bit-exact")
        else:
            need(err <= 1e-5 * float(want.abs().max()) + 1e-4,
                 "K2 uint8 ip disagrees")
    rows["pairwise_distance_u8"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None)


def check_distance_variants(torch):
    """K1 and K2 on the paths the main path does not take, each against its
    plain version: element loads (a view at element offset 1 of a flat
    buffer; D = 100 in bf16 and uint8), the tiled kernel (N = 17, 64, 65,
    300), and ragged shapes (N = 1; M = 1; D = 100).  uint8 L2 must be
    bit-exact everywhere.  Every (kernel, load) path must be reached."""
    from repro_torch.kernels import distance

    g = torch.Generator(device="cuda").manual_seed(3)
    seen = set()
    # (M, N, D, misaligned)
    cases = [(1, 16, 128, False), (1000, 1, 128, False),
             (1000, 17, 128, False), (777, 64, 128, False),
             (1000, 16, 100, False), (513, 16, 128, True),
             (300, 17, 100, True), (1000, 65, 128, False),
             (129, 300, 100, True), (100_003, 16, 128, False)]

    def operand(rows_, d, dtype, misaligned):
        if dtype == torch.uint8:
            flat = torch.randint(0, 256, (rows_ * d + 1,), device="cuda",
                                 generator=g, dtype=torch.uint8)
        else:
            flat = torch.randn(rows_ * d + 1, device="cuda",
                               generator=g).to(dtype)
        off = 1 if misaligned else 0
        return flat[off:off + rows_ * d].view(rows_, d)

    for m, n, d, mis in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.uint8):
            qq = operand(m, d, dtype, mis)
            xx = operand(n, d, dtype, False)
            plan = distance.plan_for(qq, xx)
            seen.add((dtype, plan.kernel, plan.vec > 1))
            for metric in ("l2", "ip"):
                if dtype == torch.uint8:
                    args = (qq, xx, 0.0371, -4.25, metric)
                    got = distance.pairwise_distance_u8_cuda(*args)
                    want = distance.pairwise_distance_u8_plain(*args)
                    exact = bool(torch.equal(got, want))
                    err = float((got - want).abs().max())
                    ok = exact if metric == "l2" else \
                        err <= 1e-5 * float(want.abs().max()) + 1e-4
                else:
                    got = distance.pairwise_distance_cuda(qq, xx, metric)
                    want = distance.pairwise_distance_plain(qq, xx, metric)
                    exact = bool(torch.equal(got, want))
                    err = float((got - want).abs().max())
                    ok = err <= 1e-5 * float(want.abs().max()) + 1e-3
                torch.cuda.synchronize()
                log(f"K{2 if dtype == torch.uint8 else 1} variant "
                    f"{str(dtype)[6:]} {metric} [{m},{d}]x[{n},{d}] "
                    f"misaligned={mis} kernel={plan.kernel} vec={plan.vec} "
                    f"max_abs_err={err:.3e} bit_exact={exact}")
                need(ok, f"distance variant {dtype} {metric} [{m},{d}]x"
                     f"[{n},{d}] misaligned={mis} disagrees")
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        for path in (("skinny", True), ("skinny", False), ("tiled", False)):
            need((dtype, *path) in seen, f"distance path {dtype} {path} "
                 "was not reached")


def near_ties(q, x, got_ids, want_ids, rtol: float,
              metric: str = "l2") -> int:
    """Count positions where two id lists differ by more than a near-tie
    (``near_tie_breaks``, the quickstart's rule, with ``rtol`` alone)."""
    from repro_torch.data.synthetic import near_tie_breaks

    return int(near_tie_breaks(q, x, got_ids, want_ids, rtol=rtol,
                               metric=metric).sum())


def check_k4(torch, rows, ds, res):
    """K4 against its plain version: the tie-exact case (ids equal), the
    edge cases, ground truth's last block, then the largest shard (ids equal
    up to near-ties) with its timings beside cdist and topk, then the
    streamed panel at GIST-960's shard shapes (k 129 and 256) with its
    timings beside its FP32 bound."""
    import numpy as np

    from repro_torch.kernels import topk

    g = torch.Generator(device="cuda").manual_seed(5)
    # integer coordinates, every point twice: f32 distances are exact
    # integers, so any order of summation gives the plain version's ties
    pts = torch.randint(0, 6, (20000, 128), device="cuda", generator=g).float()
    pts[10000:] = pts[:10000]
    rnd = torch.randn(50001, 24, device="cuda", generator=g)
    cases = [("tie-exact", pts[:1000].contiguous(), pts, 129, "l2", True),
             ("tie-exact k=10", pts[:1000].contiguous(), pts, 10, "l2", True),
             ("tie-exact ip", pts[:500].contiguous(), pts, 64, "ip", True),
             ("ragged n", rnd[:777].contiguous(), rnd, 100, "l2", False),
             ("k > n", rnd[:100].contiguous(), rnd[:150].contiguous(), 200,
              "l2", False),
             ("k = 1", rnd[:1000].contiguous(), rnd, 1, "l2", False),
             ("k = 256", rnd[:1000].contiguous(), rnd, 256, "l2", False),
             ("ip", rnd[:1000].contiguous(), rnd, 64, "ip", False)]
    data = torch.from_numpy(np.ascontiguousarray(ds.data)).cuda()
    gt_q = torch.from_numpy(np.ascontiguousarray(
        ds.queries[-(len(ds.queries) % 4096 or 4096):])).cuda()
    cases.append(("ground truth's last block", gt_q, data, 10, "l2", False))
    for name, q, x, k, metric, exact in cases:
        gd, gi = topk.knn_cuda(q, x, k, metric)
        wd, wi = topk.knn_plain(q, x, k, metric)
        torch.cuda.synchronize()
        fin = torch.isfinite(wd)
        need(bool((torch.isfinite(gd) == fin).all()), f"K4 {name}: padding")
        err = float((gd - wd)[fin].abs().max())
        same = bool(torch.equal(gi.long(), wi))
        bad = 0 if same else near_ties(q, x, gi, wi, 1e-5, metric)
        log(f"K4 {name} [{q.shape[0]},{q.shape[1]}]x[{x.shape[0]},"
            f"{x.shape[1]}] k={k} {metric} max_abs_err={err:.3e} "
            f"ids_equal={same} beyond_near_ties={bad}")
        need(err <= 1e-5 * float(wd[fin].abs().max()) + 1e-4,
             f"K4 {name}: distances disagree")
        need(same if exact else bad == 0, f"K4 {name}: ids disagree")
        del gd, gi, wd, wi
    del pts, rnd, data, gt_q

    big = max(res.shards, key=lambda s: len(s.ids))
    x = torch.from_numpy(np.ascontiguousarray(ds.data[big.ids])).cuda()
    q = x[:4096].contiguous()
    k = 129
    gd, gi = topk.knn_cuda(q, x, k)
    wd, wi = topk.knn_plain(q, x, k)
    err = float((gd - wd).abs().max())
    agree = float((gi.long() == wi).float().mean())
    ms = events_ms(torch, lambda: topk.knn_cuda(q, x, k), reps=5)
    plain_ms = events_ms(torch, lambda: topk.knn_plain(q, x, k), reps=2)
    cd_ms = events_ms(torch, lambda: torch.cdist(q, x), reps=3)
    dist = torch.cdist(q, x)
    tk_ms = events_ms(torch, lambda: torch.topk(dist, k, largest=False), reps=3)
    del dist
    m, n, d = q.shape[0], x.shape[0], q.shape[1]
    log(f"K4 knn [{m},{d}]x[{n},{d}] k={k} max_abs_err={err:.3e} "
        f"id_agreement={agree:.6f} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"cdist_ms={cd_ms:.4f} topk_ms={tk_ms:.4f} "
        f"cdist+topk_ms={cd_ms + tk_ms:.4f}")
    bad = near_ties(q, x, gi, wi, 1e-5)
    log(f"K4 ids differing beyond a 1e-5 relative near-tie: {bad}")
    need(err <= 1e-5 * float(wd.abs().max()) + 1e-4, "K4 distances disagree")
    need(bad == 0, "K4 ids disagree beyond near-ties")
    need(ms < cd_ms + tk_ms, "K4 is slower than cdist + topk")
    b, by = bound_ms((m + n) * d * 4 + m * k * 8, 2 * m * n * d,
                     H100_FP32_FLOPS)
    need(topk.knn_plan(d, k) == topk.KnnPlan(64, "resident"),
         "K4 at D=128, k=129 left the resident 64-row panel")
    rows["knn"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b, bound_by=by, library_ms=None)
    del gd, gi, wd, wi, q, x

    # GIST-960's shard builds take the streamed panel, which the widths
    # above never reach: a shard of 12,500 rows (200,000 points in 16
    # clusters) at a CAGRA build's k = 129, and K4's largest k, 256
    x = torch.randn(12_500, 960, device="cuda", generator=g)
    wide = []
    for m, k, plan in ((12_500, 129, topk.KnnPlan(64, "streamed")),
                       (4_096, 256, topk.KnnPlan(32, "streamed"))):
        q = x[:m].contiguous()
        need(topk.knn_plan(960, k) == plan,
             f"K4 at D=960, k={k} took {topk.knn_plan(960, k)}, not {plan}")
        gd, gi = topk.knn_cuda(q, x, k)
        wd, wi = topk.knn_plain(q, x, k)
        err = float((gd - wd).abs().max())
        bad = near_ties(q, x, gi, wi, 1e-5)
        ms = events_ms(torch, lambda: topk.knn_cuda(q, x, k), reps=5)
        plain_ms = events_ms(torch, lambda: topk.knn_plain(q, x, k), reps=2)
        n, d = x.shape
        b, by = bound_ms((m + n) * d * 4 + m * k * 8, 2 * m * n * d,
                         H100_FP32_FLOPS)
        log(f"K4 knn {plan.panel} {plan.rows} rows [{m},{d}]x[{n},{d}] "
            f"k={k} max_abs_err={err:.3e} beyond_near_ties={bad} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} "
            f"({by}) share={100 * b / ms:.1f}%")
        need(err <= 1e-5 * float(wd.abs().max()) + 1e-4,
             f"K4 D=960 k={k}: distances disagree")
        need(bad == 0, f"K4 D=960 k={k}: ids disagree beyond near-ties")
        wide.append(dict(m=m, n=n, d=d, k=k, block_rows=plan.rows,
                         panel=plan.panel, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by))
        del gd, gi, wd, wi, q
    rows["knn"]["streamed"] = wide
    del x

    # the largest shard's build, split into its two phases: how much of a
    # shard build K4 is
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core import cagra

    cfg = IndexConfig()
    vecs = np.ascontiguousarray(ds.data[big.ids])
    t0 = time.perf_counter()
    nbrs, dists, _ = cagra.build_knn_graph(vecs, cfg.build_degree,
                                           metric=cfg.metric)
    t_knn = time.perf_counter() - t0
    t0 = time.perf_counter()
    cagra.optimize_graph(vecs, nbrs, dists, cfg.degree, metric=cfg.metric)
    t_opt = time.perf_counter() - t0
    log(f"largest shard ({len(vecs)} points) build: knn graph {t_knn:.3f} s "
        f"({-(-len(vecs) // 4096)} K4 launches), optimize_graph "
        f"{t_opt:.3f} s")


def k3_bound(x, graph, q, out, x_exact=None):
    """K3's bound from one launch's inputs and outputs ``(ids, dists,
    n_dist, hops, n_rerank)``.  Bytes: each input read once, and of a
    gathered one (store rows, graph rows, exact rows) no more than this
    run's gathers touch: a store that the launch sweeps many times counts
    once, the least it must move from HBM; each output written once.
    Operations: 2·D FP32 a distance, traversal and re-rank."""
    nd, hops, nrr = (int(t.sum()) for t in out[2:])
    d = x.shape[1]
    n_bytes = (min(nd * d, x.numel()) * x.element_size()
               + min(hops * graph.shape[1], graph.numel()) * 4
               + q.numel() * q.element_size()
               + sum(t.numel() * t.element_size() for t in out))
    if x_exact is not None:
        n_bytes += (min(nrr * d, x_exact.numel()) * 4
                    + q.shape[0] * d * 4)
    return bound_ms(n_bytes, 2 * (nd + nrr) * d, H100_FP32_FLOPS)


@contextlib.contextmanager
def k3_tally():
    """Tally K3's launches by (Q, dtype, k, re-rank) while the block runs,
    beside (not instead of) its launch counter, and keep the first launch
    of each shape's inputs so it can be timed after the run."""
    from repro_torch.kernels import beam

    shapes: collections.Counter = collections.Counter()
    first: dict = {}
    launch = beam.fused_beam_cuda

    def tallied(x, graph, entries, queries, k, **kw):
        key = (queries.shape[0], str(x.dtype)[6:], k, kw.get("rerank_k"))
        shapes[key] += 1
        first.setdefault(key, ((x, graph, entries, queries, k), kw))
        return launch(x, graph, entries, queries, k, **kw)

    beam.fused_beam_cuda = tallied
    try:
        yield shapes, first
    finally:
        beam.fused_beam_cuda = launch
    log(f"K3 main-path launches by (Q, dtype, k, rerank_k): "
        f"{dict(shapes.most_common())}")


def k3_by_q(torch, shapes, first):
    """K3 at every launch shape of the main path, on the inputs of its
    first launch there (the graph, data and queries that launch had):
    time, bound (:func:`k3_bound`), and launches × time summed by range
    of Q."""
    from repro_torch.kernels import beam

    buckets: dict = {}
    for key, n in sorted(shapes.items(),
                         key=lambda kv: (*kv[0][:3], kv[0][3] or 0)):
        args, kw = first[key]
        out = beam.fused_beam_cuda(*args, **kw)
        ms = events_ms(torch, lambda: beam.fused_beam_cuda(*args, **kw),
                       reps=3)
        x, graph, _, q, _ = args
        b, _ = k3_bound(x, graph, q, out,
                        kw.get("x_exact") if kw.get("rerank_k") else None)
        q_n = key[0]
        rng = ("Q <= 64" if q_n <= 64 else "64 < Q <= 512" if q_n <= 512
               else "512 < Q <= 2560" if q_n <= 2560 else f"Q = {q_n}")
        acc = buckets.setdefault(rng, [0, 0.0, 0.0])
        acc[0] += n
        acc[1] += n * ms
        acc[2] += n * b
        log(f"K3 shape Q={q_n} {key[1]} k={key[2]} rerank={key[3]} "
            f"launches={n} ms={ms:.4f} bound_ms={b:.4f}")
    for rng, (n, t, b) in buckets.items():
        log(f"K3 main path {rng}: launches={n} sum_ms={t:.3f} "
            f"sum_bound_ms={b:.3f}")
    total = sum(t for _, t, _ in buckets.values())
    log(f"K3 main path: launches={sum(n for n, _, _ in buckets.values())} "
        f"sum_ms={total:.3f} sum_bound_ms="
        f"{sum(b for _, _, b in buckets.values()):.3f}")


def plain_beam(torch, prep, entries, q, qf, kq, kw):
    """K3's plain version in slices of 2000 queries: each query is
    independent, and the plain version's visited mask is [Q, N] booleans."""
    from repro_torch.kernels import beam

    parts = []
    for lo in range(0, q.shape[0], 2000):
        kws = dict(kw)
        if "q_exact" in kws:
            kws["q_exact"] = qf[lo:lo + 2000]
        parts.append(beam.fused_beam_plain(prep.x, prep.graph, entries,
                                           q[lo:lo + 2000], kq, **kws))
    return [torch.cat(c) for c in zip(*parts)]


def check_merge(torch, rows, ds, res):
    """The merge kernel on the main path's own row table (its build's shard
    graphs and points) against its plain version on the same card tensors:
    graphs and unique counts equal entry for entry (both sum each distance
    in one order, ``ref.lane_sum`` with ``vec=4``), and the kernel's graph
    equal to the build's; then both timed beside the bound.  The bound
    counts the bytes read from HBM once (points, row table, graph and
    counts written) and 3 FP32 operations an element of each unique
    candidate's distance; the dedup's integer compares are left out."""
    import numpy as np

    from repro_torch.core.cagra import ShardIndex
    from repro_torch.core.merge import _row_table
    from repro_torch.kernels import merge as kmerge

    n, degree = len(ds.data), res.index.graph.shape[1]
    idxs = [ShardIndex(graph=g, n_distance_computations=0)
            for g in res.shard_graphs]
    nbr, row_ptr, row_of = _row_table(res.shards, idxs, n, "cuda")
    x = torch.from_numpy(np.ascontiguousarray(ds.data, np.float32)).cuda()
    gk, uk = kmerge.merge_rows_cuda(x, nbr, row_ptr, row_of, degree)
    gp, up = kmerge.merge_rows_plain(x, nbr, row_ptr, row_of, degree)
    torch.cuda.synchronize()
    # ids: the entries that differ, graph and unique counts together
    diff = int((gk != gp).sum()) + int((uk != up).sum())
    same_build = bool(np.array_equal(gk.cpu().numpy(), res.index.graph))
    ms = events_ms(torch, lambda: kmerge.merge_rows_cuda(
        x, nbr, row_ptr, row_of, degree), reps=5)
    plain_ms = events_ms(torch, lambda: kmerge.merge_rows_plain(
        x, nbr, row_ptr, row_of, degree), reps=1)
    u, d = int(uk.sum()), x.shape[1]
    n_bytes = (x.numel() + nbr.numel() + row_ptr.numel() + row_of.numel()
               + gk.numel() + uk.numel()) * 4
    b, by = bound_ms(n_bytes, 3 * u * d, H100_FP32_FLOPS)
    log(f"M merge_rows rows={n} shard_rows={nbr.shape[0]} "
        f"width={nbr.shape[1]} D={d} degree={degree} "
        f"candidates={nbr.numel()} unique={u} "
        f"kept={int((gk >= 0).sum())} differing_entries={diff} "
        f"equal_to_build={same_build} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b:.4f} ({by})")
    need(diff == 0, f"the merge kernel and its plain version differ in "
         f"{diff} entries")
    need(same_build, "the merge kernel's graph differs from the build's")
    rows["merge_rows"].update(max_abs_err=float(diff), ms=ms,
                              plain_ms=plain_ms, bound_ms=b, bound_by=by,
                              library_ms=None)
    del x, nbr, row_ptr, row_of, gk, uk, gp, up


def check_k3(torch, rows, ds, merged):
    """K3 on the built merged graph against its plain version, at 256
    queries and at the merged search's own launch (every query), in f32,
    bf16 and uint8 (uint8 ids and counters exact), each timed beside its
    bound (:func:`k3_bound`)."""
    import numpy as np

    from repro_torch.kernels import beam
    from repro_torch.search.fused_backend import _prep_queries, _prepared

    entries = torch.from_numpy(
        merged.index.entry_points(16).astype(np.int32)).cuda()
    exact = _prepared(merged.data, merged.index.graph, None,
                      torch.device("cuda"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for nq in (256, len(ds.queries)):
        queries = ds.queries[:nq]
        qf = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).cuda()
        for dtype in ("f32", "bf16", "uint8"):
            if dtype == "f32":
                store, quant = merged.data, None
                extra, kq = {}, 10
            else:
                store, spec = merged.quant_view(dtype)
                quant = spec if spec is not None else dtype
                extra, kq = dict(x_exact=exact.x, q_exact=qf, rerank_k=10), 40
            prep = _prepared(store, merged.index.graph, quant,
                             torch.device("cuda"))
            q, scale, zp = _prep_queries(queries, quant, torch.device("cuda"))
            kw = dict(width=64, n_iters=beam.default_n_iters(64), expand=8,
                      metric="l2", scale=scale, zp=zp, **extra)
            got = beam.fused_beam_cuda(prep.x, prep.graph, entries, q, kq,
                                       aux=prep.aux, **kw)
            t0 = time.perf_counter()
            want = plain_beam(torch, prep, entries, q, qf, kq, kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            ids_eq = float((got[0] == want[0]).float().mean())
            stats_eq = float(((got[2] == want[2]) & (got[3] == want[3])
                              & (got[4] == want[4])).float().mean())
            same = got[0] == want[0]
            fin = torch.isfinite(want[1]) & same
            err = float((got[1] - want[1])[fin].abs().max()) if fin.any() \
                else 0.0
            ms = events_ms(torch, lambda: beam.fused_beam_cuda(
                prep.x, prep.graph, entries, q, kq, aux=prep.aux, **kw),
                reps=3)
            nd, hops, nrr = (int(t.sum()) for t in got[2:])
            b, by = k3_bound(prep.x, prep.graph, q, got,
                             exact.x if extra else None)
            log(f"K3 fused_beam {dtype} Q={nq} N={prep.x.shape[0]} width=64 "
                f"k={kq} rerank={'10' if extra else '-'} "
                f"id_agreement={ids_eq:.6f} stats_agreement={stats_eq:.6f} "
                f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.1f} "
                f"bound_ms={b:.4f} ({by}) share_of_bound={b / ms:.3f} "
                f"(n_dist={nd} hops={hops} n_rerank={nrr})")
            if dtype == "uint8":
                # the traversal is integer-exact and the re-rank sums in the
                # plain version's order: ids, distances and counters equal
                # bit for bit, traversal alone and re-ranked
                trav = {k_: v_ for k_, v_ in kw.items()
                        if k_ not in ("x_exact", "q_exact", "rerank_k")}
                tg = beam.fused_beam_cuda(prep.x, prep.graph, entries, q, kq,
                                          aux=prep.aux, **trav)
                tw = plain_beam(torch, prep, entries, q, qf, kq, trav)
                exact_trav = all(torch.equal(a, b) for a, b in
                                 zip((tg[0], tg[2], tg[3]),
                                     (tw[0], tw[2], tw[3])))
                exact_rr = all(torch.equal(a, b) for a, b in zip(got, want))
                log(f"K3 uint8 Q={nq}: traversal (k={kq}, no re-rank) ids "
                    f"and counters bit-exact={exact_trav}; re-ranked ids, "
                    f"distances and counters bit-exact={exact_rr}")
                need(exact_trav, f"K3 uint8 Q={nq} traversal is not "
                     "bit-exact")
                need(exact_rr, f"K3 uint8 Q={nq} re-rank is not bit-exact")
                del tg, tw
            else:
                # f32/bf16 traversals sum in another order than the plain
                # version, so ids may differ at near-ties; where a re-ranked
                # id agrees, its exact distance is summed in one order
                bad = near_ties(qf, exact.x, got[0], want[0], 1e-5)
                d_equal = bool(torch.equal(got[1][same], want[1][same]))
                log(f"K3 {dtype} Q={nq}: ids differing beyond a 1e-5 "
                    f"near-tie of the exact distance: {bad}"
                    + (f"; re-ranked distances bit-equal where ids agree="
                       f"{d_equal}" if extra else ""))
                need(ids_eq >= 0.99 and stats_eq >= 0.95,
                     f"K3 {dtype} Q={nq} disagrees beyond near-ties")
                need(err <= 2e-3 + 1e-4 * float(want[1][fin].abs().max()),
                     f"K3 {dtype} Q={nq} distances disagree")
                if extra:
                    need(d_equal, f"K3 {dtype} Q={nq} re-ranked distances "
                         "differ where the ids agree")
            if dtype == "f32" and nq == 256:
                rows["fused_beam"].update(max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms, bound_ms=b,
                                          bound_by=by, library_ms=None)
            if dtype == "f32":
                occ = beam.fused_beam_occupancy(
                    prep.x, prep.graph.shape[1], entries.shape[0], nq=nq,
                    width=64, n_iters=kw["n_iters"], expand=8, metric="l2")
                log(f"K3 f32 Q={nq}: {occ['smem_bytes']} bytes of shared "
                    f"memory a block, {occ['blocks_per_sm']} blocks resident "
                    f"per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
                    f"{occ['blocks_per_sm'] * n_sm} queries in flight")
                # a launch of more queries than fit two to an SM keeps four
                need(nq <= 2 * n_sm or occ["blocks_per_sm"] >= 4,
                     f"K3 keeps fewer than 4 queries resident per SM at "
                     f"Q={nq}")
            del got, want


def check_small_against_cpu(torch):
    """A small index searched on the card and on the CPU's plain path."""
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core.builder import build_scalegann
    from repro_torch.data.synthetic import make_clustered
    from repro_torch.search import search

    ds = make_clustered(4000, 32, n_queries=64, spread=1.0, seed=7,
                        device="cpu")
    res = build_scalegann(ds.data, IndexConfig(n_clusters=4, degree=16,
                                               build_degree=32,
                                               block_size=1024),
                          device="cpu")
    for topo, nprobe in ((res.topology(ds.data), None),
                         (res.shard_topology(ds.data), 2),
                         (res.shard_topology(ds.data), "auto")):
        for dtype in ("f32", "bf16", "uint8"):
            kw = dict(k=10, width=32, dtype=dtype, nprobe=nprobe)
            gi, gs = search(topo, ds.queries, device="cuda", **kw)
            wi, ws = search(topo, ds.queries, device="cpu", **kw)
            agree = float((gi == wi).mean())
            same_stats = dataclasses.asdict(gs) == dataclasses.asdict(ws)
            log(f"small {type(topo).__name__} nprobe={nprobe} {dtype}: "
                f"id_agreement={agree:.4f} stats_equal={same_stats}")
            if dtype == "uint8":
                need(agree == 1.0 and same_stats,
                     "uint8 search on the card differs from the CPU")
            else:
                need(agree >= 0.99, f"{dtype} search on the card differs "
                     "from the CPU beyond near-ties")


def registry_sum(name: str) -> float:
    """Sum of a metric family's series in the process-wide registry."""
    from repro_torch.telemetry import current_registry

    fam = current_registry().snapshot().get(name, {"series": []})
    return float(sum(s.get("value", 0.0) for s in fam["series"]))


def ann_counts() -> dict:
    from repro_torch.kernels import LAUNCHES

    return {name: LAUNCHES[name] for name in ANN_KERNELS + BUILD_KERNELS}


async def poisson_load(srv, queries, n: int, rate, seed: int, *,
                       overrides=None, swap=None):
    """Open-loop arrivals at ``rate`` a second (exponential gaps from
    ``seed``), each request backdated to its scheduled arrival; ``rate``
    None submits all ``n`` at once.  ``overrides(j)`` gives request j's
    options; ``swap = (j, fn)`` calls ``fn()`` just before request j.
    Returns ``(j, options, QueryResult)`` for every request."""
    import asyncio

    import numpy as np

    gaps = (np.random.default_rng(seed).exponential(1.0 / rate, size=n)
            if rate else np.zeros(n))
    futs = []
    t_next = time.monotonic()
    for j in range(n):
        t_next += gaps[j]
        delay = t_next - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        if swap is not None and j == swap[0]:
            swap[1]()
        kw = overrides(j) if overrides else {}
        futs.append((j, kw, srv.submit_nowait(queries[j], t_submit=t_next,
                                              **kw)))
    outs = await asyncio.gather(*(f for _, _, f in futs))
    return [(j, kw, o) for (j, kw, _), o in zip(futs, outs)]


def stats_round_trip(st) -> bool:
    """``parse_prometheus(to_prometheus())`` gives back the counters."""
    from repro_torch.telemetry import parse_prometheus

    p = parse_prometheus(st.to_prometheus())
    f = frozenset
    want = {
        ("serving_requests_total", f({("outcome", "completed")})):
            st.n_completed,
        ("serving_requests_total", f({("outcome", "failed")})): st.n_failed,
        ("serving_engine_batches_total", f()): st.n_batches,
        ("serving_engine_lanes_total", f({("kind", "real")})):
            st.n_served_lanes,
        ("serving_engine_lanes_total", f({("kind", "padded")})):
            st.n_padded_lanes,
        ("serving_distance_computations_total", f({("stage", "total")})):
            st.dist_comps,
        ("serving_distance_computations_total", f({("stage", "rerank")})):
            st.rerank_comps,
        ("serving_hops_total", f()): st.hops,
        ("serving_engine_time_seconds_total", f()): st.batch_time_s,
        ("serving_request_latency_seconds_count", f()): st.n_completed,
    }
    return all(p.get(key) == v for key, v in want.items())


def serve_trial(torch, name, topo, cfg, queries, n, rate, seed, *,
                overrides=None, swap=None, tracer=None, time_k3=False):
    """One trial: start an ``AnnServer`` on the card, wait out its warm-up
    with one request, then offer ``n`` requests and read the server's
    stats over them; ``time_k3`` adds K3's device time from CUDA events
    around each of its launches (two event records a launch).  Gates on no
    failed, rejected or shed request, no signature first seen after
    warm-up, no kernel build and no device-copy upload during the traffic,
    and on the stats' Prometheus round trip."""
    import asyncio

    from repro_torch.kernels import reset_counts
    from repro_torch.serving import AnnServer, ServerStats

    async def run():
        srv = AnnServer(topo, cfg, tracer=tracer)
        async with srv:
            t0 = time.perf_counter()
            await srv.submit(queries[0])  # served after the warm-up
            warm_s = time.perf_counter() - t0
            warm_stats, srv.stats = srv.stats, ServerStats()
            before = (registry_sum("kernel_builds_total"),
                      registry_sum("search_device_uploads_total"))
            reset_counts()
            timer = k3_timer(torch) if time_k3 else contextlib.nullcontext(
                ([], {}))
            with timer as (events, _):
                out = await poisson_load(
                    srv, queries, n, rate, seed, overrides=overrides,
                    swap=None if swap is None else (swap[0],
                                                   lambda: swap[1](srv)))
            launches = ann_counts()
            moved = (registry_sum("kernel_builds_total") - before[0],
                     registry_sum("search_device_uploads_total") - before[1])
        torch.cuda.synchronize()
        k3_ms = sum(a.elapsed_time(b) for a, b in events)
        return srv, warm_stats, warm_s, out, launches, moved, k3_ms

    srv, warm_stats, warm_s, out, launches, moved, k3_ms = asyncio.run(run())
    st = srv.stats
    snap = st.snapshot()
    post_warm = sum(
        s["value"] for reg in (warm_stats.registry, st.registry)
        for s in reg.snapshot().get("serving_post_warm_signatures_total",
                                    {"series": []})["series"])
    row = {
        "trial": name, "requests": n, "offered_qps": rate,
        "served_qps": snap["qps"], "latency_ms": snap["latency_ms"],
        "queue_wait_ms": snap["queue_wait_ms"],
        "engine_service_ms": snap["engine_service_ms"],
        "mean_occupancy": snap["batch_occupancy"]["mean"],
        "padding_fraction": snap["padding_fraction"],
        "batches": snap["n_batches"],
        "engine_ms_per_batch": snap["engine_time_ms_per_batch"],
        "warm_up_s": warm_s, "launches": launches,
        "k3_device_ms": k3_ms if time_k3 else None,
        "k3_share_of_engine": (k3_ms / 1e3 / st.batch_time_s
                               if time_k3 else None),
        "kernel_builds_total": registry_sum("kernel_builds_total"),
        "kernel_builds_during_traffic": moved[0],
        "device_uploads_during_traffic": moved[1],
        "post_warm_signatures": post_warm,
    }
    for s in (warm_stats, st):
        need(s.n_failed == 0 and s.n_rejected == 0 and s.n_shed == 0,
             f"serving {name}: {s.n_failed} failed, {s.n_rejected} "
             f"rejected, {s.n_shed} shed")
    need(st.n_completed == n, f"serving {name}: {st.n_completed} of {n} "
         "requests completed")
    need(post_warm == 0, f"serving {name}: {post_warm} engine-call "
         "signatures first seen after warm-up")
    need(moved[0] == 0, f"serving {name}: {moved[0]} kernel builds during "
         "traffic")
    need(moved[1] == 0, f"serving {name}: {moved[1]} device-copy uploads "
         "after warm-up")
    need(stats_round_trip(st), f"serving {name}: the Prometheus text does "
         "not round-trip the stats' counters")
    return srv, row, out


def check_served_ids(torch, name, topo, cfg, data, queries, out):
    """Served ids against one direct ``search()`` per option group on the
    same queries with the same options: uint8 equal; f32 on 99.9% of ids,
    every differing id a near-tie within 1e-5 (K3 at another batch size
    may sum in another order)."""
    import numpy as np

    from repro_torch.search import search

    groups = collections.defaultdict(list)
    for j, kw, res in out:
        groups[tuple(sorted(kw.items()))].append((j, res.ids))
    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).cuda()
    for key, rows in sorted(groups.items(), key=repr):
        js = np.array([j for j, _ in rows])
        got = np.stack([ids for _, ids in rows])
        opts = {"nprobe": cfg.nprobe, "dtype": cfg.dtype, **dict(key)}
        want, _ = search(topo, queries[js], cfg.k, width=cfg.width,
                         n_entries=cfg.n_entries, rerank=cfg.rerank, **opts)
        agree = float((got == want).mean())
        bad = near_ties(torch.from_numpy(queries[js]).cuda(), x,
                        torch.from_numpy(got).cuda(),
                        torch.from_numpy(want).cuda(), 1e-5)
        log(f"serving {name} ids {opts} requests={len(js)} agreement "
            f"with a direct search={agree:.6f} differing beyond a 1e-5 "
            f"near-tie={bad}")
        if opts["dtype"] == "uint8":
            need(agree == 1.0, f"serving {name}: uint8 ids differ from a "
                 "direct search")
        else:
            need(agree >= 0.999 and bad == 0, f"serving {name}: f32 ids "
                 "differ from a direct search beyond near-ties")


def served_recall(out, gt) -> float:
    import numpy as np

    from repro_torch.data.synthetic import recall_at

    js = np.array([j for j, _, _ in out])
    return recall_at(np.stack([r.ids for _, _, r in out]), gt[js], 10)


def serving_path(torch, ds, res, merged, split):
    """The micro-batching server on the card over the main path's 1M index
    (the docstring's step 5).  Returns the launches of K1, K2 and K3 over
    the four trials' traffic, counted from zero for each trial."""
    import numpy as np

    from repro_torch.data.synthetic import recall_at
    from repro_torch.kernels import reset_counts
    from repro_torch.search import search
    from repro_torch.serving import ServingConfig
    from repro_torch.telemetry import (Tracer, check_serving_trace,
                                       validate_chrome_trace)

    k, width = 10, 64
    q = np.ascontiguousarray(ds.queries)
    total = collections.Counter()

    # 1. the batch-1 baseline: one blocking search() a query
    search(merged, q[:1], k, width=width)
    reset_counts()
    n1 = min(1000, len(q))
    ids1 = np.empty((n1, k), np.int64)
    t0 = time.perf_counter()
    for j in range(n1):
        ids1[j] = search(merged, q[j:j + 1], k, width=width)[0][0]
    wall = time.perf_counter() - t0
    total.update(ann_counts())
    qps1 = n1 / wall
    log("serving batch1 " + json.dumps({
        "requests": n1, "qps": qps1, "mean_latency_ms": wall / n1 * 1e3,
        "recall_at_10": recall_at(ids1, ds.gt[:n1], 10)}))
    rate = 4.0 * qps1

    # 2. merged: Poisson arrivals at 4x the batch-1 QPS, a swap at 5,000
    cfg = ServingConfig(backend="fused", k=k, width=width, max_batch=64,
                        max_wait_ms=2.0)
    srv, row, out = serve_trial(
        torch, "merged", merged, cfg, q, len(q), rate, 2, time_k3=True,
        swap=(len(q) // 2, lambda s: s.swap_topology(res.topology(ds.data),
                                                     reason="churn")))
    total.update(row["launches"])
    row["recall_at_10"] = served_recall(out, ds.gt)
    gen = srv.stats.registry.snapshot()["serving_topology_generation"]
    row["topology_generation"] = gen["series"][0]["value"]
    log("serving merged " + json.dumps(row))
    need(row["topology_generation"] == 1, "the topology_generation gauge "
         f"reads {row['topology_generation']} after one swap")
    check_served_ids(torch, "merged", merged, cfg, ds.data, q, out)

    # what a swap costs: the uint8 view is per topology object
    new = res.topology(ds.data)
    t0 = time.perf_counter()
    new.quant_view("uint8")
    quant_s = time.perf_counter() - t0
    ups = registry_sum("search_device_uploads_total")
    t0 = time.perf_counter()
    search(new, q[:64], k, width=width, dtype="uint8")
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    search(new, q[:64], k, width=width, dtype="uint8")
    log(f"serving swap cost, the uint8 view of a new merged topology: "
        f"quantize {quant_s:.4f} s, then a 64-query search "
        f"{first_s * 1e3:.3f} ms with "
        f"{registry_sum('search_device_uploads_total') - ups:.0f} upload, "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms once cached")
    del new

    # 3. saturation: all 10,000 at once
    srv, row, out = serve_trial(
        torch, "saturation", merged, dataclasses.replace(cfg, max_pending=len(q)),
        q, len(q), None, 3)
    total.update(row["launches"])
    row["recall_at_10"] = served_recall(out, ds.gt)
    log("serving saturation " + json.dumps(row))
    check_served_ids(torch, "saturation", merged, cfg, ds.data, q, out)

    # 4. split, traced: uint8 one request in two, nprobe="auto" one in five
    def overrides(j):
        kw = {"dtype": "uint8"} if j % 2 else {}
        if j % 5 == 0:
            kw["nprobe"] = "auto"
        return kw

    tracer = Tracer(clock=time.monotonic)
    scfg = ServingConfig(backend="fused", k=k, width=width, nprobe=2,
                         pretrace_dtypes=("uint8",),
                         pretrace_nprobes=("auto",))
    srv, row, out = serve_trial(torch, "split", split, scfg, q,
                                min(2000, len(q)), rate, 4,
                                overrides=overrides, tracer=tracer,
                                time_k3=True)
    total.update(row["launches"])
    row["recall_at_10"] = served_recall(out, ds.gt)
    log("serving split " + json.dumps(row))
    for name in ANN_KERNELS[:3]:
        need(row["launches"][name] > 0, f"kernel {name} was not launched "
             "in the split serving trial")
    check_served_ids(torch, "split", split, scfg, ds.data, q, out)
    obj = tracer.to_chrome()
    errs = validate_chrome_trace(obj)
    chk = check_serving_trace(obj, min_coverage=0.95)
    log(f"serving split trace: {len(obj['traceEvents'])} events, schema "
        f"errors {len(errs)}, {json.dumps(chk)}")
    need(not errs, f"the served trace is not valid: {errs[:3]}")
    need(chk["ok"] and chk["min_coverage_seen"] >= 0.95,
         "the served trace does not cover each request's latency")

    phases = {s["labels"]["phase"]: s["value"] for s in
              res.feed_metrics().snapshot()["build_phase_seconds"]["series"]}
    log(f"build metrics: build_phase_seconds {json.dumps(phases)} "
        f"(build_only_s {res.build_only_s:.3f}, wall_build_s "
        f"{res.wall_build_s:.3f})")
    need(phases == {"partition": res.partition_s,
                    "shards": res.wall_build_s, "merge": res.merge_s},
         "feed_metrics' build_phase_seconds differ from the build's")
    launches = {name: total[name] for name in ANN_KERNELS}
    log("serving launches " + json.dumps(launches))
    return launches


_PART = threading.local()


@contextlib.contextmanager
def live_timers(torch):
    """Wall time and calls of the live index's parts while the block runs
    (each part ends in a host read of its device results, so its wall
    time covers its device work), and K3 by the part that launched it:
    CUDA events around the C launch of every launch made inside an insert
    round or a split (the writer's; the server's launches carry no part),
    and the first launch's inputs and outputs of each part and of the
    server, for :func:`k3_bound`."""
    from repro_torch.kernels import beam
    from repro_torch.live.index import LiveIndex

    walls: dict = collections.defaultdict(lambda: [0, 0.0])
    events: dict = collections.defaultdict(list)
    first: dict = {}
    tags = {"_insert_rounds": "insert", "_split_shard": "split"}
    names = ("insert_batch", "_insert_rounds", "_split_shard", "_touch_shard",
             "_quant_list", "consolidate", "_reprune", "snapshot")
    originals = {n: LiveIndex.__dict__[n] for n in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            prev = getattr(_PART, "tag", None)
            _PART.tag = tags.get(name, prev)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc = walls[name]
                acc[0] += 1
                acc[1] += time.perf_counter() - t0
                _PART.tag = prev
        return timed

    launch = beam.fused_beam_cuda
    lib = beam._lib()
    c_launch = lib.repro_fused_beam

    def tallied(x, graph, entries, queries, k, **kw):
        out = launch(x, graph, entries, queries, k, **kw)
        tag = getattr(_PART, "tag", None) or "serve"
        if tag not in first and queries.shape[0] >= 8:
            first[tag] = ((x, graph, entries, queries, k), kw,
                          k3_bound(x, graph, queries, out,
                                   kw.get("x_exact") if kw.get("rerank_k")
                                   else None))
        return out

    def c_timed(*a):
        tag = getattr(_PART, "tag", None)
        if tag is None:
            return c_launch(*a)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = c_launch(*a)
        end.record()
        events[tag].append((start, end))
        return rc

    for n in names:
        setattr(LiveIndex, n, wrap(n, originals[n]))
    beam.fused_beam_cuda = tallied
    lib.repro_fused_beam = c_timed
    try:
        yield walls, events, first
    finally:
        for n in names:
            setattr(LiveIndex, n, originals[n])
        beam.fused_beam_cuda = launch
        lib.repro_fused_beam = c_launch


def shares_rows(a, b) -> bool:
    """Whether any row of ``a`` equals a row of ``b`` (rows keyed by a
    random projection, candidates compared exactly)."""
    import numpy as np

    r = np.random.default_rng(0).normal(size=a.shape[1])
    ka, kb = a.astype(np.float64) @ r, b.astype(np.float64) @ r
    hit = np.flatnonzero(np.isin(ka, kb))
    pos = {k: i for i, k in enumerate(kb.tolist())}
    return any(np.array_equal(a[i], b[pos[ka[i]]]) for i in hit)


def touched_shards(old, new) -> int:
    """Shards of ``new`` whose f32 store is not ``old``'s object (mutated
    or new shards), the non-empty ones."""
    olds, news = old.shard_store(), new.shard_store()
    return sum(1 for s, st in enumerate(news) if len(new.shard_ids[s])
               and (s >= len(olds) or st is not olds[s]))


async def open_loop(srv, queries, rate: float, seed: int, done, overrides):
    """Open-loop Poisson arrivals at ``rate`` a second until ``done`` is
    set, each backdated to its scheduled arrival and stamped with the
    served generation at its submission.  Returns ``(j, generation,
    options, QueryResult or exception)`` and the count of rejected
    submissions."""
    import asyncio

    import numpy as np

    from repro_torch.serving import ServerOverloadedError

    rng = np.random.default_rng(seed)
    futs, rejected = [], 0
    t_next = time.monotonic()
    j = 0
    while not done.is_set():
        t_next += rng.exponential(1.0 / rate)
        delay = t_next - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        kw = overrides(j)
        gen = srv.topology_generation
        try:
            futs.append((j, gen, kw, srv.submit_nowait(
                queries[j % len(queries)], t_submit=t_next, **kw)))
        except ServerOverloadedError:
            rejected += 1
        j += 1
    outs = await asyncio.gather(*(f for *_, f in futs),
                                return_exceptions=True)
    return [(j, g, kw, o) for (j, g, kw, _), o in zip(futs, outs)], rejected


def live_recall(torch, snap, queries, gt, tomb, recalls, what):
    """Search a live snapshot at split nprobe=2, k=10, width=64 in f32 and
    uint8: no tombstoned id returned, and recall@10 against ``gt`` (exact
    over the live ids) no more than 0.02 below the unchurned split
    index's (a gain is no fault; the delta is logged)."""
    import numpy as np

    from repro_torch.data.synthetic import recall_at
    from repro_torch.search import search

    for dtype in ("f32", "uint8"):
        t0 = time.perf_counter()
        ids, stats = search(snap, queries, 10, width=64, nprobe=2,
                            dtype=dtype)
        wall = time.perf_counter() - t0
        found = ids[ids >= 0]
        dead = int(tomb[found].sum())
        rec = recall_at(ids, gt, 10)
        base = recalls[("split", 2, dtype)]
        log(f"live search {what} split nprobe=2 {dtype}: recall@10={rec:.4f} "
            f"(unchurned {base:.4f}, delta {rec - base:+.4f}) tombstoned "
            f"ids returned={dead} qps={len(queries) / wall:.1f} "
            f"dist/q={stats.per_query()['distance_computations']:.1f}")
        need(dead == 0, f"live search {what} {dtype}: {dead} tombstoned ids "
             "returned")
        need(rec >= base - 0.02, f"live search {what} {dtype}: recall@10 "
             f"{rec:.4f} is more than 0.02 below the unchurned {base:.4f}")


def time_routing_tiles(torch, ds, split, snap):
    """K1 (f32 L2) and K2 (uint8 L2) at the routing tile of the 10,000
    queries against the split's 16 centroids (the skinny kernel) and the
    live index's 17 after its split (the tiled kernel), timed as K1 is on
    the main path: a CUDA graph over rotated copies of the queries, and a
    call with the host included; each against its plain version."""
    import numpy as np

    from repro_torch.kernels import distance

    g = torch.Generator(device="cuda").manual_seed(17)
    q = torch.from_numpy(np.ascontiguousarray(ds.queries)).cuda()
    m, d = q.shape
    for topo in (split, snap):
        cx = torch.from_numpy(np.ascontiguousarray(topo.centroids,
                                                   np.float32)).cuda()
        codes, spec, _ = topo.centroid_quant()
        cq = torch.from_numpy(spec.quantize(ds.queries)).cuda()
        cc = torch.from_numpy(np.ascontiguousarray(codes)).cuda()
        n = cx.shape[0]
        for name, a, x, fn, plain, mk, elt, peak in (
                ("K1 f32", q, cx,
                 lambda a_, x_: distance.pairwise_distance_cuda(a_, x_, "l2"),
                 lambda a_, x_: distance.pairwise_distance_plain(a_, x_,
                                                                 "l2"),
                 lambda: torch.randn(m, d, device="cuda", generator=g), 4,
                 H100_FP32_FLOPS),
                ("K2 uint8", cq, cc,
                 lambda a_, x_: distance.pairwise_distance_u8_cuda(
                     a_, x_, spec.scale, spec.zero_point, "l2"),
                 lambda a_, x_: distance.pairwise_distance_u8_plain(
                     a_, x_, spec.scale, spec.zero_point, "l2"),
                 lambda: torch.randint(0, 256, (m, d), device="cuda",
                                       generator=g, dtype=torch.uint8), 1,
                 H100_INT8_OPS)):
            plan = distance.plan_for(a, x)
            got, want = fn(a, x), plain(a, x)
            err = float((got - want).abs().max())
            need(err <= 1e-5 * float(want.abs().max()) + 1e-3,
                 f"{name} routing tile at N={n} disagrees")
            if elt == 1:
                need(torch.equal(got, want), f"{name} L2 at N={n} is not "
                     "bit-exact")
            qs, cold = copies_for(torch, mk, m * d * elt)
            ms = cold_graph_ms(torch, lambda a_: fn(a_, x), [(c,) for c in qs])
            del qs
            call_ms = events_ms(torch, lambda: fn(a, x), reps=50)
            b, by = bound_ms((m + n) * d * elt + m * n * 4, 2 * m * n * d,
                             peak)
            log(f"{name} routing tile [{m},{d}]x[{n},{d}] kernel={plan.kernel} "
                f"max_abs_err={err:.3e} graph_ms={ms:.5f} "
                f"({'cold' if cold else 'warm'} L2) per_call_ms={call_ms:.5f} "
                f"(host included) bound_ms={b:.5f} ({by}) "
                f"share_of_bound={b / ms:.3f}")
        need(distance.plan_for(q, cx).kernel
             == ("skinny" if n <= 16 else "tiled"),
             f"the routing tile at N={n} took another kernel")


def live_path(torch, ds, res, split, recalls):
    """The live index on the card over step 2's 1M build (the docstring's
    step 6), counters zeroed just before it and read just after: a
    ``LiveIndex`` served by an ``AnnServer`` while one writer thread
    inserts 50,000 vectors in 10 calls (one shard splits), deletes 5% of
    the ids uniformly and then 30% of one shard's residents, searches the
    tombstoned snapshot, consolidates and searches again, swapping each
    generation in; then a full-size save, a logged tail, a crash inside
    the next WAL append and a recovery that must equal the crashed
    process's index.  Returns the launches of K1–K4 in the phase."""
    import asyncio
    import shutil

    import numpy as np

    from repro_torch.common import backpressure
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core import vamana
    from repro_torch.data.synthetic import exact_ground_truth, make_clustered
    from repro_torch.durability import CrashInjector, SimulatedCrash
    from repro_torch.kernels import reset_counts
    from repro_torch.live import LiveConfig, LiveIndex
    from repro_torch.search import search
    from repro_torch.serving import AnnServer, ServerStats, ServingConfig

    t0 = time.perf_counter()
    n_insert, calls, rate = LIVE_INSERTS, LIVE_CALLS, LIVE_QPS
    per = n_insert // calls
    new = make_clustered(n_insert, 128, seed=0).data
    tail = make_clustered(per + per // 5, 128, seed=0).data
    shared = (shares_rows(new, ds.data), shares_rows(tail, ds.data),
              shares_rows(tail, new))
    log(f"live data: {n_insert} inserts in {calls} calls and a "
        f"{len(tail)}-row tail from "
        f"make_clustered(seed=0) (the index's centres and weights, new "
        f"noise), rows shared with the index / with each other {shared}, "
        f"{time.perf_counter() - t0:.3f} s")
    need(not any(shared), "the live phase's vectors repeat rows of the index")
    cfg = IndexConfig()
    # split_max: between the two largest shards' sizes after the inserts,
    # routed to the shards' means as the live index routes after a touch
    sizes = np.array([len(s.ids) for s in res.shards])
    means = np.stack([ds.data[s.ids].mean(axis=0) for s in res.shards])
    route = np.argmin((new * new).sum(1)[:, None] - 2.0 * (new @ means.T)
                      + (means * means).sum(1)[None, :], axis=1)
    final = np.sort(sizes + np.bincount(route, minlength=len(sizes)))[::-1]
    split_max = int((final[0] + final[1]) // 2)
    log(f"live split_max={split_max} (largest shard {sizes.max()} now, "
        f"predicted largest two after the inserts {final[:2].tolist()})")

    reset_counts()
    q = np.ascontiguousarray(ds.queries)
    rng = np.random.default_rng(3)
    live = LiveConfig(backend="fused", split_max=split_max)
    with live_timers(torch) as (walls, k3_events, k3_first):
        t0 = time.perf_counter()
        li = LiveIndex.from_build(res, ds.data, cfg, live)
        li.prepare("uint8")
        log(f"live index from the build and its uint8 views "
            f"{time.perf_counter() - t0:.3f} s ({li.n_shards} shards)")
        snap0 = li.snapshot()
        tombs = {0: li._tombstones}  # generation -> its deleted ids
        windows: list = []
        seen = {"snap": snap0}
        report: dict = {}

        def swap(srv, what):
            snap = li.snapshot()
            touched = touched_shards(seen["snap"], snap)
            start = registry_sum("search_device_uploads_total")
            t_sw = time.perf_counter()
            gen = srv.swap_topology(snap, reason="churn")
            windows.append(dict(what=what, gen=gen, touched=touched,
                                start=start, swap_s=time.perf_counter() - t_sw))
            tombs[gen] = li._tombstones
            seen["snap"] = snap
            return snap

        def writer(srv):
            t_w = time.perf_counter()
            for c in range(calls):
                li.insert_batch(new[c * per:(c + 1) * per])
                swap(srv, f"insert {c}")
            report["inserts_s"] = time.perf_counter() - t_w
            # the writer's prune graphs (its thread's set) stay in budget
            gs = vamana.thread_prune_graphs()
            pool_b, card_b = gs.pool_bytes(), gs.card_bytes()
            log(f"live prune graphs after the inserts: {len(gs)} kept, "
                f"{gs.captures} captured, {gs.resets} resets; static buffers "
                f"and pool {card_b / 2**20:.1f} MiB (pool "
                f"{pool_b / 2**20:.1f}; budget {gs.max_bytes / 2**20:.0f}); "
                f"card allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
                f"GiB, reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
            need(len(gs) > 0 and pool_b > 0, "the writer's inserts replayed "
                 "no prune graph, or its pool's bytes were not read")
            need(card_b <= gs.max_bytes + (1 << 30), f"the writer's prune "
                 f"graphs hold {card_b / 2**20:.1f} MiB, over their budget "
                 f"and one capture (1 GiB)")
            need(li.n_shards == len(res.shards) + 1,
                 f"the inserts left {li.n_shards} shards, not one split")
            t_d = time.perf_counter()
            li.delete_batch(rng.choice(li.n_vectors, li.n_vectors // 20,
                                       replace=False))
            swap(srv, "delete 5% uniform")
            big = int(np.argmax([len(i) for i in li._ids]))
            ids = li._ids[big]
            li.delete_batch(rng.choice(ids, int(0.3 * len(ids)),
                                       replace=False))
            snap = swap(srv, f"delete 30% of shard {big}")
            report["deletes_s"] = time.perf_counter() - t_d
            t_g = time.perf_counter()
            alive = np.flatnonzero(~li._tombstones)
            gt = alive[exact_ground_truth(li._data[alive], q, 10)]
            report["gt_s"] = time.perf_counter() - t_g
            log(f"live ground truth over {len(alive)} live ids (K4) "
                f"{report['gt_s']:.3f} s; resident dead {li.resident_dead}")
            live_recall(torch, snap, q, gt, li._tombstones, recalls,
                        "tombstoned")
            resident = li.resident_dead
            t_c = time.perf_counter()
            st = li.consolidate()
            report["consolidate_s"] = time.perf_counter() - t_c
            report["consolidate"] = st
            snap = swap(srv, "consolidate")
            log(f"live consolidate {json.dumps(st)} resident dead before "
                f"{resident}, after {li.resident_dead}; wall "
                f"{report['consolidate_s']:.3f} s")
            need(snap.tombstones is None and li.resident_dead == 0
                 and st["removed"] == resident,
                 "consolidation left resident dead ids")
            live_recall(torch, snap, q, gt, li._tombstones, recalls,
                        "consolidated")

        def run_writer(srv, done, errors):
            try:
                writer(srv)
            except BaseException as exc:  # re-raised in the main thread
                errors.append(exc)
            finally:
                done.set()

        def overrides(j):
            return {"dtype": "uint8"} if j % 2 else {}

        scfg = ServingConfig(backend="fused", k=10, width=64, nprobe=2,
                             max_batch=64, max_wait_ms=2.0,
                             pretrace_dtypes=("uint8",))

        async def serve():
            srv = AnnServer(snap0, scfg)
            async with srv:
                await srv.submit(q[0])  # served after the warm-up
                warm_stats, srv.stats = srv.stats, ServerStats()
                # capacity with no writer: LIVE_CAPACITY_N requests at once
                await poisson_load(srv, q, LIVE_CAPACITY_N, None, 6,
                                   overrides=overrides)
                cap_stats, srv.stats = srv.stats, ServerStats()
                done, errors = threading.Event(), []
                backpressure.reset_stats()
                th = threading.Thread(target=run_writer,
                                      args=(srv, done, errors))
                t_s = time.perf_counter()
                th.start()
                out, rejected = await open_loop(srv, q, rate, 5, done,
                                                overrides)
                th.join()
                end = registry_sum("search_device_uploads_total")
                wall = time.perf_counter() - t_s
            return (srv, warm_stats, cap_stats, out, rejected, errors, end,
                    wall)

        (srv, warm_stats, cap_stats, out, rejected, errors, end,
         wall) = asyncio.run(serve())
        cap = cap_stats.snapshot()
        log("live capacity with no writer " + json.dumps({
            "requests": cap["n_completed"], "served_qps": cap["qps"],
            "engine_service_ms": cap["engine_service_ms"],
            "mean_occupancy": cap["batch_occupancy"]["mean"],
            "failed": cap["n_failed"]}))
        need(cap_stats.n_failed == 0 and cap_stats.n_completed
             == LIVE_CAPACITY_N, "live serving: the capacity probe failed")
        if errors:
            raise errors[0]
        for w, nxt in zip(windows, windows[1:] + [dict(start=end)]):
            w["uploads"] = nxt["start"] - w["start"]
        st = srv.stats
        snap = st.snapshot()
        stale = sum(
            1 for _, gen, _, res_ in out if not isinstance(res_, Exception)
            and bool(((res_.ids >= 0) & (res_.ids < len(tombs[gen]))
                      & tombs[gen][np.clip(res_.ids, 0,
                                           len(tombs[gen]) - 1)]).any()))
        errs = [o for *_, o in out if isinstance(o, Exception)]
        failed = len(errs)
        row = {
            "requests": len(out), "offered_qps": rate,
            "wall_s": wall, "served_qps": snap["qps"],
            "latency_ms": snap["latency_ms"],
            "queue_wait_ms": snap["queue_wait_ms"],
            "engine_service_ms": snap["engine_service_ms"],
            "mean_occupancy": snap["batch_occupancy"]["mean"],
            "swaps": len(windows), "rejected_submissions": rejected,
            "failed_futures": failed,
            "responses_with_ids_deleted_before_their_swap": stale,
            # the writer's yield points that waited for the backlogged
            # server, and for how long
            "backpressure": backpressure.stats(),
        }
        log("live serving " + json.dumps(row))
        for w in windows:
            log(f"live swap {w['gen']} after {w['what']}: shards touched "
                f"{w['touched']}, device uploads {w['uploads']:.0f} (bound "
                f"{2 * w['touched']}), swap_topology {w['swap_s'] * 1e3:.1f} ms")
        for s_ in (warm_stats, st):
            need(s_.n_failed == 0 and s_.n_rejected == 0 and s_.n_shed == 0
                 and rejected == 0 and failed == 0,
                 f"live serving: {s_.n_failed} failed, {s_.n_rejected} "
                 f"rejected, {s_.n_shed} shed; {rejected} submissions "
                 f"rejected, {failed} futures failed {errs[:1]!r}")
        need(st.n_completed == len(out), "live serving: not every request "
             "completed")
        need(stale == 0, f"live serving: {stale} responses hold an id deleted "
             "before the swap that preceded their submission")
        for w in windows:
            need(w["uploads"] <= 2 * w["touched"], f"live serving: swap "
                 f"{w['gen']} ({w['what']}) cost {w['uploads']:.0f} uploads "
                 f"for {w['touched']} touched shards")

        # 7. durability at the full size
        root = ROOT / "build" / "live_snapshot"
        shutil.rmtree(root, ignore_errors=True)
        inj = CrashInjector(crash_at={"wal.append.torn": 4})
        t0 = time.perf_counter()
        manifest = li.save(root, injector=inj)
        save_s = time.perf_counter() - t0
        n_bytes = sum(p.stat().st_size for p in root.iterdir())
        k3_before = len(k3_events["insert"])
        rounds_before = walls["_insert_rounds"][1]
        t0 = time.perf_counter()
        li.insert_batch(tail[:per])
        tail_insert_s = time.perf_counter() - t0
        tail_k3 = [a.elapsed_time(b) for a, b in
                   k3_events["insert"][k3_before:]]
        tail_rounds_s = walls["_insert_rounds"][1] - rounds_before
        li.delete_batch(rng.choice(li.n_vectors, per, replace=False))
        tail_cons = li.consolidate()
        crashed = False
        try:
            li.insert_batch(tail[per:])
        except SimulatedCrash:
            crashed = True
        need(crashed, "the injector did not crash the WAL append")
        t0 = time.perf_counter()
        back = LiveIndex.load(root, cfg, live)
        load_s = time.perf_counter() - t0
        same = {
            "_ids": all(np.array_equal(a, b)
                        for a, b in zip(li._ids, back._ids))
            and len(li._ids) == len(back._ids),
            "_graphs": all(np.array_equal(a, b)
                           for a, b in zip(li._graphs, back._graphs))
            and len(li._graphs) == len(back._graphs),
        }
        for name in ("_entries", "_centroids", "_tombstones", "_data"):
            same[name] = np.array_equal(getattr(li, name),
                                        getattr(back, name))
        same["wal_seq"] = li.wal_seq == back.wal_seq
        for dtype in ("f32", "uint8"):
            a, _ = search(li.snapshot(), q, 10, width=64, nprobe=2,
                          dtype=dtype)
            b, _ = search(back.snapshot(), q, 10, width=64, nprobe=2,
                          dtype=dtype)
            same[f"search ids {dtype}"] = np.array_equal(a, b)
        log(f"live durability: save {save_s:.3f} s ({n_bytes} bytes, "
            f"{n_bytes / save_s / 1e6:.1f} MB/s, {li.n_vectors} vectors, "
            f"{li.n_shards} shards); tail insert of {per} {tail_insert_s:.3f}"
            f" s (rounds {tail_rounds_s:.3f} s, {len(tail_k3)} K3 launches "
            f"{sum(tail_k3):.3f} ms, uncontended), delete, consolidate "
            f"{json.dumps(tail_cons)}; crash at wal.append.torn on the next "
            f"insert; load + replay of "
            f"{back.wal_seq - manifest['wal_seq']} records {load_s:.3f} s; "
            f"recovered equal to the crashed index "
            f"{json.dumps(same)}")
        need(all(same.values()), "the recovered index differs from the "
             "crashed process's")
        li.close()
        back.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = ann_counts()
    log(f"live-phase launches {json.dumps(launches)}")
    for name in ANN_KERNELS:
        need(launches[name] > 0, f"kernel {name} was not launched in the "
             "live phase")
    # 8. where the time went
    k3_ms = {tag: [a.elapsed_time(b) for a, b in ev]
             for tag, ev in k3_events.items()}
    parts = {name: {"calls": c, "s": round(t, 6)}
             for name, (c, t) in sorted(walls.items())}
    ins = walls["insert_batch"][1]
    log(f"live parts {json.dumps(parts)}")
    log(f"live inserts: {calls} calls of {per} in {report['inserts_s']:.3f} s "
        f"wall (the whole phase's {walls['insert_batch'][0]} calls below, "
        f"the tail's and the replay's included); insert rounds {len(k3_ms.get('insert', []))} (K3 device "
        f"{sum(k3_ms.get('insert', [])):.3f} ms, CUDA events, the server's "
        f"kernels may interleave), rounds' wall (upload, K3, prune, reverse "
        f"edges, read back) {walls['_insert_rounds'][1]:.3f} s, less K3's "
        f"device time "
        f"{walls['_insert_rounds'][1] - sum(k3_ms.get('insert', [])) / 1e3:.3f}"
        f" s; split "
        f"{walls['_split_shard'][1]:.3f} s ({len(k3_ms.get('split', []))} "
        f"K3 launches, {sum(k3_ms.get('split', [])):.3f} ms); host "
        f"(routing, concatenations, centroids and entries) "
        f"{ins - walls['_insert_rounds'][1] - walls['_split_shard'][1]:.3f} "
        f"s of which _touch_shard {walls['_touch_shard'][1]:.3f} s; "
        f"quantized views {walls['_quant_list'][1]:.3f} s; swaps "
        f"{sum(w['swap_s'] for w in windows):.3f} s for "
        f"{sum(w['uploads'] for w in windows):.0f} uploads; two delete "
        f"waves with their swaps {report['deletes_s']:.3f} s; consolidation "
        f"{report['consolidate_s']:.3f} s (re-prune {walls['_reprune'][1]:.3f}"
        f" s over {report['consolidate']['rows_repruned']} rows); save "
        f"{save_s:.3f} s, load {load_s:.3f} s")
    for tag in ("insert", "serve"):
        if tag in k3_first:
            args, kw, (b, by) = k3_first[tag]
            from repro_torch.kernels import beam

            ms = events_ms(torch, lambda: beam.fused_beam_cuda(*args, **kw),
                           reps=5)
            x, _, e, qq, k = args
            log(f"K3 {tag} shape Q={qq.shape[0]} N={x.shape[0]} "
                f"{str(x.dtype)[6:]} k={k} width={kw.get('width')} "
                f"n_iters={kw.get('n_iters')} E={e.shape[0]} ms={ms:.4f} "
                f"bound_ms={b:.4f} ({by}) share_of_bound={b / ms:.3f}")
    time_routing_tiles(torch, ds, split, seen["snap"])
    return launches


@contextlib.contextmanager
def k3_timer(torch, pool: int | None = None):
    """Time every K3 launch — with ``pool``, only those at the Vamana build
    shape (k == width == pool) — with CUDA events around the C launch
    alone (the wrapper's checks stay outside), beside (not instead of) its
    launch counter, and keep the first such launch's inputs."""
    from repro_torch.kernels import beam

    events: list = []
    first: dict = {}
    on = [False]
    launch = beam.fused_beam_cuda
    lib = beam._lib()
    c_launch = lib.repro_fused_beam

    def timed(x, graph, entries, queries, k, **kw):
        if pool is not None and (k != pool or kw.get("width") != pool):
            return launch(x, graph, entries, queries, k, **kw)
        first.setdefault("args", ((x, graph, entries, queries, k), kw))
        on[0] = True
        try:
            return launch(x, graph, entries, queries, k, **kw)
        finally:
            on[0] = False

    def c_timed(*a):
        if not on[0]:
            return c_launch(*a)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = c_launch(*a)
        end.record()
        events.append((start, end))
        return rc

    beam.fused_beam_cuda = timed
    lib.repro_fused_beam = c_timed
    try:
        yield events, first
    finally:
        beam.fused_beam_cuda = launch
        lib.repro_fused_beam = c_launch


def diskann_path(torch, args):
    """The DiskANN baseline on the card, counters zeroed just before and
    read just after: ``make_clustered(n_v, 128, n_queries=2000, seed=1)``
    (ground truth from K4) written to a BIGANN ``.fbin`` and memmapped back,
    ``build_diskann`` with the ``IndexConfig`` defaults (uniform ω=2
    replication, Vamana R=64, L=128 per shard: every round a K3 launch at
    Q=256, width=k=n_iters=128, E=1, then the prune and reverse edges as
    torch ops on the card), then the merged index searched at k=10,
    width=64 in f32 on ``fused`` and ``torch`` (2000 queries) and on
    ``numpy`` (200).  K1, K3 and K4 must have launched."""
    import numpy as np

    from repro_torch.configs.base import IndexConfig
    from repro_torch.core.builder import build_diskann
    from repro_torch.data import formats
    from repro_torch.data.synthetic import make_clustered, recall_at
    from repro_torch.kernels import beam, reset_counts
    from repro_torch.search import search
    from repro_torch.telemetry import collect_stages

    cfg = IndexConfig()
    pool = max(cfg.build_degree, cfg.degree + 1)
    reset_counts()
    t0 = time.perf_counter()
    ds = make_clustered(args.vamana_n, 128, n_queries=2000, seed=1)
    path = ROOT / "build" / "diskann" / "base.fbin"
    path.parent.mkdir(parents=True, exist_ok=True)
    formats.write_bin(str(path), ds.data)
    data = formats.read_bin(str(path))
    need(isinstance(data, np.memmap) and data.shape == ds.data.shape
         and np.array_equal(data[-7:], ds.data[-7:]),
         "the .fbin does not read back")
    log(f"diskann data n={args.vamana_n} d=128 queries=2000 written to "
        f"{path.relative_to(ROOT)} ({path.stat().st_size} bytes) and "
        f"memmapped back {time.perf_counter() - t0:.3f} s")
    with k3_timer(torch, pool) as (events, first), \
            collect_stages() as stages:
        res = build_diskann(data, cfg)
    torch.cuda.synchronize()
    rounds = len(events)
    k3_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    n_rows = sum(len(s.ids) for s in res.shards)
    want_rounds = sum(2 * -(-len(s.ids) // 256) for s in res.shards
                      if len(s.ids) > 1)
    beam_s, prune_s = stages["vamana.beam"], stages["vamana.prune"]
    log(f"diskann build partition_s={res.partition_s:.3f} "
        f"build_only_s={res.build_only_s:.3f} merge_s={res.merge_s:.3f} "
        f"overall_s={res.overall_s:.3f} shards={len(res.shards)} "
        f"shard_rows={n_rows} replicas="
        f"{res.stats['replica_proportion']:.4f}")
    log(f"vamana rounds={rounds} (K3 launches at Q=256, width=k=n_iters="
        f"{pool}) wall {beam_s + prune_s:.3f} s = beam {beam_s:.3f} s "
        f"(K3 device {k3_s:.3f} s, {1e3 * k3_s / max(rounds, 1):.3f} ms a "
        f"round) + prune and reverse edges {prune_s:.3f} s "
        f"({1e3 * prune_s / max(rounds, 1):.3f} ms a round); "
        f"rounds_per_s={rounds / res.build_only_s:.1f}; 1M build_only_s "
        f"extrapolated linearly in rounds "
        f"{res.build_only_s * 1_000_000 / args.vamana_n:.1f}")
    need(rounds == want_rounds, f"{rounds} K3 build launches for "
         f"{want_rounds} Vamana rounds")
    (x, graph, _, _, _), _ = first["args"]
    occ = beam.fused_beam_occupancy(x, graph.shape[1], 1, nq=256,
                                    width=pool, n_iters=pool, expand=8,
                                    metric="l2")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"K3 build shape: {occ['smem_bytes']} bytes of shared memory a "
        f"block, {occ['blocks_per_sm']} blocks resident per SM, "
        f"{occ['blocks_per_sm'] * n_sm} queries in flight")
    topo = res.topology(data)
    found = {}
    for backend, nq in (("fused", 2000), ("torch", 2000), ("numpy", 200)):
        q = ds.queries[:nq]
        kw = dict(k=10, width=64, backend=backend)
        search(topo, q[:100], **kw)  # device residency + warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, stats = search(topo, q, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = recall_at(ids, ds.gt[:nq], 10)
        pq = stats.per_query()
        log(f"diskann search {backend} f32 queries={nq} recall@10={rec:.4f} "
            f"qps={nq / dt:.1f} wall_s={dt:.4f} "
            f"dist/q={pq['distance_computations']:.1f} "
            f"hops/q={pq['hops']:.1f}")
        need(ids.shape == (nq, 10), "diskann search output shape")
        need(rec >= 0.3, f"diskann {backend} recall@10 {rec:.4f} below 0.3")
        found[backend] = ids
    agree = float((found["fused"] == found["torch"]).mean())
    log(f"diskann fused vs torch f32 id agreement {agree:.6f}")
    need(agree >= 0.999, "fused and torch disagree on the DiskANN index")
    launches = ann_counts()
    log(f"diskann-path launches {json.dumps(launches)}")
    for name in ("pairwise_distance", "fused_beam", "knn", "merge_rows"):
        need(launches[name] > 0, f"kernel {name} was not launched on the "
             "DiskANN path")
    return ds, res, topo, first, launches


def check_torch_backend(torch, ds, topo):
    """The ``torch`` backend on the card against itself on the CPU, all
    2000 queries on the DiskANN index: uint8 ids and stats equal; f32 ids
    on 99.9% or more of 20,000 (the card's matmuls sum in another order
    than the CPU's, so ids may differ at near-ties of the distance; those
    differing beyond a 1e-5 near-tie of the exact distance are counted)."""
    import numpy as np

    from repro_torch.search import search

    q = np.ascontiguousarray(ds.queries)
    x = torch.from_numpy(np.ascontiguousarray(topo.data, np.float32)).cuda()
    for dtype in ("f32", "uint8"):
        kw = dict(k=10, width=64, backend="torch", dtype=dtype)
        gi, gs = search(topo, q, device="cuda", **kw)
        t0 = time.perf_counter()
        wi, ws = search(topo, q, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        agree = float((gi == wi).mean())
        same = dataclasses.asdict(gs) == dataclasses.asdict(ws)
        bad = near_ties(torch.from_numpy(q).cuda(), x,
                        torch.from_numpy(gi).cuda(),
                        torch.from_numpy(wi).cuda(), 1e-5)
        log(f"torch backend {dtype} card vs CPU ({len(q)} queries): "
            f"id_agreement={agree:.6f} ids differing beyond a 1e-5 "
            f"near-tie={bad} stats_equal={same} (CPU {cpu_s:.1f} s)")
        if dtype == "uint8":
            need(agree == 1.0 and same,
                 "torch uint8 on the card differs from the CPU")
        else:
            need(agree >= 0.999, "torch f32 on the card differs from the "
                 "CPU beyond near-ties")


def check_vamana_round(torch, res):
    """One Vamana round (α = 1.2) on integer-valued vectors at the largest
    shard's size, from a random regular graph (every row full, so the
    reverse edges overflow as in a pass's first rounds): K3 gives the pool
    on the card, then the prune and the reverse-edge update run on the
    card (each prune chunk replaying its shape's CUDA graph, rows and
    lanes padded) and on the CPU (the eager loop with its host early exit)
    from the same pool and graph.  Every distance is an exact integer, so
    the kept ids, the graph and the distance counter must be equal.  The
    eager loop on the card (what chunks of rows too wide for a graph run,
    as consolidation's) is held to the CPU's on the same pool too.  The
    card's round is timed by phase, then profiled: kernels launched and
    device busy time against its wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import IndexConfig
    from repro_torch.core import vamana
    from repro_torch.search import beam_pool

    cfg = IndexConfig()
    pool = max(cfg.build_degree, cfg.degree + 1)
    n = max(len(s.ids) for s in res.shards)
    rng = np.random.default_rng(2)
    ints = rng.integers(0, 16, (n, 128)).astype(np.float32)
    graph0 = vamana._random_regular_init(n, cfg.degree, rng)
    batch = rng.permutation(n)[:256]

    def one_round(dev, pool_in=None):
        x = torch.from_numpy(ints).to(dev)
        g = torch.from_numpy(graph0.astype(np.int32)).to(dev)
        b = torch.from_numpy(batch).to(dev)
        counter = [0]
        t0 = time.perf_counter()
        if pool_in is None:
            ids, dists, _ = beam_pool(x, g, 0, x[b], pool, n_iters=pool)
        else:
            ids, dists = (t.to(dev) for t in pool_in)
        t1 = time.perf_counter()
        kept = vamana.robust_prune_batch(b, ids, dists, x, 1.2, cfg.degree,
                                         counter)
        g[b] = kept.to(g.dtype)
        int(counter[0])
        t2 = time.perf_counter()
        vamana._apply_reverse_edges(b, kept, g, x, 1.2, cfg.degree, counter)
        count = int(counter[0])
        t3 = time.perf_counter()
        return (ids, dists), kept.cpu(), g.cpu(), count, (t1 - t0, t2 - t1,
                                                          t3 - t2)

    one_round("cuda")  # warm-up
    pool_c, kc, gc, cc, (tb, tp, tr) = one_round("cuda")
    _, kh, gh, ch, (_, hp, hr) = one_round("cpu", pool_c)
    same = (torch.equal(kc, kh), torch.equal(gc, gh), cc == ch)
    graphs = vamana.thread_prune_graphs()
    log(f"vamana round on integer points (n={n}, 256 points, pool {pool}): "
        f"card (prune chunks from {len(graphs)} CUDA graphs) vs CPU (eager, "
        f"host early exit) keep/graph/counter equal={same} counter={cc}; card "
        f"beam {1e3 * tb:.2f} ms, prune {1e3 * tp:.2f} ms, reverse edges "
        f"{1e3 * tr:.2f} ms; CPU prune {1e3 * hp:.1f} ms, reverse edges "
        f"{1e3 * hr:.1f} ms")
    need(all(same), "a Vamana round's prune on the card differs from the CPU")
    eager = []
    for dev in ("cuda", "cpu"):
        x = torch.from_numpy(ints).to(dev)
        ids, dists = pool_c[0].to(dev).long(), pool_c[1].to(dev).float()
        keep, count = vamana._prune_rows(
            torch.from_numpy(batch).to(dev), ids, dists,
            x[ids.clamp_min(0)], 1.2, cfg.degree)
        eager.append((keep.cpu(), int(count)))
    same = (torch.equal(eager[0][0], eager[1][0]), eager[0][1] == eager[1][1])
    log(f"vamana prune, the eager loop on the card vs the CPU on the same "
        f"pool: keep/counter equal={same}")
    need(all(same), "the eager prune on the card differs from the CPU")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round("cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} "
                    f"x{e.count}" for e in rows[:5])
    log(f"vamana round profiled: wall_ms={wall:.3f} device_busy_ms="
        f"{busy:.3f} device_idle_share={1 - busy / wall:.3f} "
        f"device_ops={sum(e.count for e in rows)} top_ms: {top}")


def check_k3_build_shape(torch, first):
    """K3 at the Vamana build shape against its plain version on the first
    build launch's store and queries and its shard's final graph: ids on
    99.9% or more, the per-query counters on as large a share; timed
    beside its bound (:func:`k3_bound`: the shard's store and graph count
    once, not once a gather)."""
    from repro_torch.kernels import beam

    (x, graph, entries, q, k), kw = first["args"]
    plain_kw = {a: b for a, b in kw.items() if a != "aux"}
    got = beam.fused_beam_cuda(x, graph, entries, q, k, **kw)
    t0 = time.perf_counter()
    want = beam.fused_beam_plain(x, graph, entries, q, k, **plain_kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ids_eq = float((got[0] == want[0]).float().mean())
    stats_eq = float(((got[2] == want[2]) & (got[3] == want[3]))
                     .float().mean())
    same = (got[0] == want[0]) & torch.isfinite(want[1])
    err = float((got[1] - want[1])[same].abs().max())
    ms = events_ms(torch, lambda: beam.fused_beam_cuda(x, graph, entries, q,
                                                       k, **kw), reps=5)
    nd, hops = int(got[2].sum()), int(got[3].sum())
    b, by = k3_bound(x, graph, q, got)
    log(f"K3 build shape f32 Q={q.shape[0]} N={x.shape[0]} width={k} "
        f"n_iters={kw['n_iters']} E={entries.shape[0]} "
        f"id_agreement={ids_eq:.6f} stats_agreement={stats_eq:.6f} "
        f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.1f} "
        f"bound_ms={b:.4f} ({by}) share_of_bound={b / ms:.3f} "
        f"(n_dist={nd} hops={hops})")
    need(ids_eq >= 0.999 and stats_eq >= 0.999,
         "K3 at the build shape disagrees with its plain version")
    need(err <= 1e-3 + 1e-5 * float(want[1][same].abs().max()),
         "K3 at the build shape: distances disagree")


def fleet_store(directory):
    """A ``CheckpointStore`` over ``directory`` that times each save (with
    its shard and round) and each load that finds a checkpoint, with the
    file's bytes."""
    from repro_torch.fleet import CheckpointStore

    class TimedStore(CheckpointStore):
        def __init__(self):
            super().__init__(directory)
            self.saves: list = []  # (shard, round, seconds, bytes)
            self.loads: list = []  # (seconds, bytes)

        def _bytes(self, shard: int) -> int:
            path = self.directory / f"shard{shard:05d}.ckpt.npz"
            return path.stat().st_size if path.exists() else 0

        def save(self, ckpt):
            t0 = time.perf_counter()
            super().save(ckpt)
            self.saves.append((ckpt.shard, ckpt.round_idx,
                               time.perf_counter() - t0,
                               self._bytes(ckpt.shard)))

        def load(self, shard):
            t0 = time.perf_counter()
            got = super().load(shard)
            if got is not None:
                self.loads.append((time.perf_counter() - t0,
                                   self._bytes(shard)))
            return got

    return TimedStore()


def io_stats(rows: list) -> dict:
    secs = [s for s, _ in rows]
    nbytes = [b for _, b in rows]
    return {"n": len(rows), "sum_s": sum(secs),
            "mean_s": sum(secs) / len(rows) if rows else 0.0,
            "max_s": max(secs, default=0.0),
            "mean_bytes": sum(nbytes) / len(rows) if rows else 0.0,
            "max_bytes": max(nbytes, default=0)}


def lazy_copy_ms(torch, n: int, r: int) -> dict:
    """What a round's state costs at an ``[n, r]`` int32 graph on the card:
    the device clone it now takes (CUDA events, 20 launches) against the
    int64 host copy it took before (host wall, synchronised, 5 copies)."""
    import numpy as np

    g = torch.randint(0, n, (n, r), dtype=torch.int32, device="cuda")
    clone_ms = events_ms(torch, g.clone, reps=20)
    g.cpu().numpy().astype(np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        g.cpu().numpy().astype(np.int64)
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    return {"rows": n, "clone_ms": clone_ms, "host_copy_ms": host_ms}


def fleet_path(torch, args):
    """The spot-fleet build on the card, counters zeroed just before and
    read just after: ``make_clustered(fleet_n, 128, n_queries=2000,
    seed=2)`` (ground truth from K4), ``calibrate_runtime`` on real
    ``fused`` builds at 256, 512 and 1024 rows, then
    ``build_scalegann_fleet`` with the ``IndexConfig`` defaults on two
    workers (each on its own stream), the calibrated model, ``fused``
    builds (every round one K3 launch), a ``CheckpointStore`` on disk
    every ``FLEET_CKPT_EVERY`` rounds and on notice, a ``Tracer``, and a
    ``PreemptionInjector`` (seed 0, mean lifetime 300 rounds, notice 2
    rounds, and a notice-less kill of the largest shard's first attempt
    half-way between two periodic checkpoints); then the merged index
    searched at k=10, width=64, f32 on ``fused``.  After the counters are
    read, every shard that took two attempts or more is built again
    uninterrupted on the default stream and must give the same graph and
    distance count.  Gates: preemptions >= 2, a notice, a resume, lost
    rounds; the largest shard's kill; ``check_fleet_trace``;
    ``fleet_rounds_total`` and K3's launches during the build equal to
    the rounds completed, which equal every shard's rounds plus the lost
    ones; no checkpoint left in the store or on disk."""
    import shutil

    import numpy as np

    from repro_torch.configs.base import IndexConfig
    from repro_torch.core import vamana
    from repro_torch.core.partition import partition
    from repro_torch.core.scheduler import (CPU_MACHINE, V100_SPOT,
                                            calibrate_runtime)
    from repro_torch.data.synthetic import make_clustered, recall_at
    from repro_torch.fleet import PreemptionInjector, build_scalegann_fleet
    from repro_torch.fleet import executor
    from repro_torch.kernels import LAUNCHES, reset_counts
    from repro_torch.telemetry import Tracer, check_fleet_trace

    cfg = IndexConfig()
    every = FLEET_CKPT_EVERY
    reset_counts()
    t_phase = time.perf_counter()
    ds = make_clustered(args.fleet_n, 128, n_queries=2000, seed=2)
    data = ds.data
    # the partition is deterministic: read the largest shard off it first
    sizes = [len(s.ids) for s in partition(data, cfg).shards]
    big = int(np.argmax(sizes))
    kill_at = every + every // 2
    need(2 * -(-sizes[big] // 256) > kill_at,
         f"the largest shard ({sizes[big]} rows) ends before round "
         f"{kill_at}")
    t0 = time.perf_counter()
    rm = calibrate_runtime(None, data, (256, 512, 1024), cfg=cfg,
                           backend="fused", seed=0)
    calibrate_s = time.perf_counter() - t0
    directory = ROOT / "build" / "fleet_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    store = fleet_store(directory)
    inj = PreemptionInjector(seed=0, mean_lifetime_rounds=300.0,
                             notice_rounds=2, kill_shard_at={big: kill_at})
    tracer = Tracer()
    built: list = []  # every ShardIndex the executor's builds return
    build = executor.build_shard_index_vamana

    def kept(*a, **kw):
        idx = build(*a, **kw)
        built.append(idx)
        return idx

    executor.build_shard_index_vamana = kept
    k3_before = LAUNCHES["fused_beam"]
    try:
        out = build_scalegann_fleet(
            data, cfg, n_workers=2, backend="fused", seed=0, injector=inj,
            runtime_model=rm, checkpoint_store=store,
            checkpoint_every_rounds=every, tracer=tracer)
    finally:
        executor.build_shard_index_vamana = build
    torch.cuda.synchronize()
    k3_build = LAUNCHES["fused_beam"] - k3_before
    rep, res = out.report, out.build
    need([len(s.ids) for s in res.shards] == sizes,
         "the fleet's partition differs from the one read before it")
    ids, _ = res.search(data, ds.queries, 10, backend="fused", width=64)
    torch.cuda.synchronize()
    recall = recall_at(ids, ds.gt, 10)
    launches = ann_counts()
    phase_s = time.perf_counter() - t_phase
    log(f"fleet-phase launches {json.dumps(launches)}")

    rounds_metric = rep.metrics["fleet_rounds_total"]["series"][0]["value"]
    rounds_want = sum(2 * -(-n // 256) for n in sizes if n > 1)
    trace = check_fleet_trace(tracer.to_chrome())
    ckpt_spans = [e["dur"] / 1e6 for e in tracer.to_chrome()["traceEvents"]
                  if e.get("name") == "fleet.checkpoint" and e["ph"] == "X"]
    left = sorted(p.name for p in directory.iterdir())
    log(f"fleet events {dict(collections.Counter(e[1] for e in rep.events))}"
        f" injector {inj.events}")

    # the baseline: each shard that was killed, built again uninterrupted
    # on the default stream in this thread, same seed and batch
    redo = [s for s, a in enumerate(rep.shard_attempts) if a >= 2]
    t0 = time.perf_counter()
    same = {}
    for s in redo:
        want = vamana.build_shard_index_vamana(
            np.asarray(data[res.shards[s].ids]), cfg, seed=0,
            backend="fused")
        got = next(i for i in built if i.graph is res.shard_graphs[s])
        same[s] = (np.array_equal(got.graph, want.graph)
                   and got.n_distance_computations
                   == want.n_distance_computations)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    alone_rounds = sum(2 * -(-sizes[s] // 256) for s in redo)
    copy = lazy_copy_ms(torch, max(sizes), cfg.degree)

    clean = [s for s, a in enumerate(rep.shard_attempts) if a == 1]
    est_err = {s: (rm.estimate(sizes[s], V100_SPOT) - res.per_shard_s[s])
               / res.per_shard_s[s] for s in clean}
    # a save at a round that raised a notice is the notice's; the rest
    # are periodic
    noticed = {(e[3], e[4]) for e in rep.events if e[1] == "notice"}
    periodic = [(t, b) for s, r, t, b in store.saves
                if (s, f"round {r}") not in noticed]
    on_notice = [(t, b) for s, r, t, b in store.saves
                 if (s, f"round {r}") in noticed]
    loads = io_stats(store.loads)
    line = {
        "n": args.fleet_n, "shards": len(sizes), "shard_rows": sizes,
        "replica_proportion": res.stats["replica_proportion"],
        "n_workers": rep.n_workers, "policy": rep.policy,
        "checkpoint_every_rounds": every, "kill_shard_at": {big: kill_at},
        "partition_s": rep.partition_s, "calibrate_s": calibrate_s,
        "fleet_wall_s": rep.fleet_wall_s,
        "accelerator_active_s": rep.accelerator_active_s,
        "merge_s": rep.merge_s, "makespan_s": rep.makespan_s,
        "phase_s": phase_s,
        "n_preemptions": rep.n_preemptions, "n_notices": rep.n_notices,
        "n_resumes": rep.n_resumes, "n_requeues": rep.n_requeues,
        "shard_attempts": rep.shard_attempts,
        "rounds_completed": rep.rounds_completed,
        "rounds_lost": rep.rounds_lost,
        "rounds_replayed": rep.rounds_completed - rounds_want,
        "rounds_per_s_fleet": rep.rounds_completed / rep.fleet_wall_s,
        "rounds_per_s_per_worker":
            rep.rounds_completed / rep.accelerator_active_s,
        "rounds_per_s_alone": alone_rounds / alone_s,
        "k3_launches_build": k3_build,
        "checkpoint_saves_periodic": io_stats(periodic),
        "checkpoint_saves_on_notice": io_stats(on_notice),
        "checkpoint_loads": loads,
        "periodic_save_share_of_fleet_wall":
            sum(t for t, _ in periodic) / rep.fleet_wall_s,
        "checkpoint_span_s": sum(ckpt_spans),
        "checkpoint_span_share_of_fleet_wall":
            sum(ckpt_spans) / rep.fleet_wall_s,
        "round_state": copy,
        "calibration": {
            "seconds_per_vector": rm.seconds_per_vector,
            "fixed_overhead_s": rm.fixed_overhead_s,
            "rel_error_unpreempted": est_err,
            "mean_abs_rel_error": (sum(abs(v) for v in est_err.values())
                                   / max(len(est_err), 1))},
        "cost_model_inputs_not_measured": (
            "priced at the paper's V100 SKU rates (V100 spot "
            f"${V100_SPOT.price_per_hour}/h, CPU machine "
            f"${CPU_MACHINE.price_per_hour}/h)"),
        "cost": {**dataclasses.asdict(rep.cost), "total": rep.cost.total},
        "recall_at_10": recall, "search": "k=10 width=64 f32 fused 2000 q",
        "baseline_shards": redo, "baseline_equal": same,
        "baseline_s": alone_s, "trace": trace,
        "left_in_store": [s for s in range(len(sizes)) if s in store],
        "left_on_disk": left,
    }
    log("fleet " + json.dumps(line))
    need(rep.n_preemptions >= 2 and rep.n_notices >= 1
         and rep.n_resumes >= 1 and rep.rounds_lost >= 1,
         f"the fleet ate {rep.n_preemptions} preemptions, {rep.n_notices} "
         f"notices, {rep.n_resumes} resumes, {rep.rounds_lost} lost rounds")
    need(any(e[0] == "kill" and e[2] == big and e[3] == kill_at
             for e in inj.events),
         f"shard {big} was not killed at round {kill_at}")
    need(redo and all(same.values()), f"preempted shards {redo}: a graph "
         f"or distance count differs from its uninterrupted build {same}")
    need(trace["ok"], f"check_fleet_trace failed: {trace}")
    need(rounds_metric == rep.rounds_completed
         == k3_build == rounds_want + rep.rounds_lost,
         f"rounds: fleet_rounds_total {rounds_metric}, "
         f"completed {rep.rounds_completed}, K3 launches {k3_build}, "
         f"shards' rounds {rounds_want} + lost {rep.rounds_lost}")
    need(not line["left_in_store"] and not left,
         f"checkpoints left behind: {line['left_in_store']} {left}")
    need(recall >= 0.3, f"fleet index recall@10 {recall:.4f} below 0.3")
    for name in ("pairwise_distance", "fused_beam", "knn", "merge_rows"):
        need(launches[name] > 0, f"kernel {name} was not launched on the "
             "fleet path")
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def lm_path(torch):
    """TinyLlama-1.1B served at full width; returns the LM kernels' launch
    counts and the longest cache length a decode step attended."""
    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import LAUNCHES, reset_counts
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_arch("tinyllama_1_1b")
    lm = build_model(cfg, max_seq_len=2048)
    t0 = time.perf_counter()
    params = lm.init(seed=0)
    scfg = ServeConfig(max_len=2048, n_slots=8, temperature=0.0)
    engine = ServeEngine(lm, params, scfg)
    del params
    torch.cuda.synchronize()
    log(f"LM {cfg.name} params={lm.n_params} layers={cfg.n_layers} "
        f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"init+cast_s={time.perf_counter() - t0:.3f} (seeded random bf16)")
    engine.generate([Request(rid=-1, prompt=np.arange(1, 17, dtype=np.int32),
                             max_new_tokens=2)])  # warm-up
    engine.waves.clear()
    rng = np.random.default_rng(0)
    lens = rng.integers(512, 1025, 12)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n),
                                               dtype=np.int32),
                    max_new_tokens=LM_NEW_TOKENS)
            for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: LAUNCHES[name] for name in LM_KERNELS}
    others = {n: c for n, c in LAUNCHES.items() if n not in LM_KERNELS and c}
    for i, w in enumerate(engine.waves):
        log(f"LM wave {i}: batch={w.batch} prompt_len={w.prompt_len} "
            f"prompt_tokens={w.prompt_tokens} prefill_s={w.prefill_s:.4f} "
            f"prefill_tok/s={w.prompt_tokens / w.prefill_s:.1f} "
            f"(padded {w.batch * w.prompt_len / w.prefill_s:.1f}) "
            f"decode_steps={w.decode_steps} decode_s={w.decode_s:.4f} "
            f"decode_tok/s={w.decode_tokens / w.decode_s:.1f} "
            f"step_ms={1e3 * w.decode_s / max(w.decode_steps, 1):.3f}")
    log(f"LM serve 12 requests wall_s={wall:.3f} launches "
        f"{json.dumps(launches)}")
    waves = -(-len(reqs) // scfg.n_slots)
    steps = [min(LM_NEW_TOKENS - 1, scfg.max_len - 1 - w.prompt_len)
             for w in engine.waves]
    need(len(engine.waves) == waves == 2, "LM requests did not run in 2 waves")
    need([w.decode_steps for w in engine.waves] == steps,
         f"decode steps {[w.decode_steps for w in engine.waves]} against "
         f"the loop's {steps}")
    need(launches["flash_attention"] == cfg.n_layers * waves,
         f"K5 launched {launches['flash_attention']} times, expected "
         f"{cfg.n_layers * waves}")
    need(launches["flash_decode"] == cfg.n_layers * sum(steps)
         == cfg.n_layers * (LM_NEW_TOKENS - 1) * waves,
         f"K6 launched {launches['flash_decode']} times, expected "
         f"{cfg.n_layers * sum(steps)}")
    need(not others, f"the LM path launched ANN kernels {others}")
    need(all(r.done and len(r.output) == LM_NEW_TOKENS for r in reqs),
         "an LM request did not complete")
    need(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
         "an LM token lies outside the vocabulary")
    longest = max(w.prompt_len + s for w, s in zip(engine.waves, steps))
    return launches, longest, engine


def profiled_ms(torch, fn, n: int):
    """(host wall ms, device busy ms, device ops, top kernels) a call of
    ``fn(i)`` over ``n`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / n / 1e3
    ops = sum(e.count for e in rows) / n
    top = ", ".join(f"{e.key[:48]} {e.self_device_time_total / n / 1e3:.3f}"
                    for e in rows[:5])
    return wall, busy, ops, top


def lm_breakdown(torch, engine, batch: int = 8, prompt: int = 1000):
    """Where a prefill and a decode step spend their time: host wall time
    against device busy time (sum of kernel times) under torch.profiler,
    outside the timed run.  Launches made here are not counted as the
    main path's."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, engine.model.cfg.vocab_size, (batch, prompt),
                         device="cuda", generator=gen)
    logits, cache = engine._prefill(toks)
    tok = logits[:, :engine.model.cfg.vocab_size].argmax(-1)
    engine._decode(cache, tok, prompt)
    torch.cuda.synchronize()

    def report(what, fn, n):
        wall, busy, ops, top = profiled_ms(torch, fn, n)
        log(f"LM {what} (batch {batch}, {prompt} tokens, profiled): "
            f"wall_ms={wall:.3f} device_busy_ms={busy:.3f} "
            f"device_idle_share={1 - busy / wall:.3f} "
            f"device_ops={ops:.0f} top_ms: {top}")

    report("prefill", lambda i: engine._prefill(toks), 1)
    report("decode step", lambda i: engine._decode(cache, tok, prompt + 1 + i),
           3)


def allclose_err(torch, got, want, tol: float) -> float:
    """Max |got - want|; fails unless |got - want| <= tol + tol·|want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    need(bool(torch.isfinite(got).all()), "non-finite kernel output")
    need(bool((diff <= tol + tol * want.abs()).all()),
         f"max |err| {float(diff.max()):.3e} beyond rtol=atol={tol}")
    return float(diff.max())


# bf16: both sides compute in f32 and round the output once, so two bf16
# ulps.  f32: ~10x the measured error, well under what a bf16 P or TF32
# products (both ruled out by design) would give.
TOL = {"bfloat16": 8e-3, "float32": 1e-5}


def scaled_err(torch, got, want, tol: float) -> tuple:
    """:func:`allclose_err` and, besides it, max |got - want| <= tol x
    max |want|: an output that averages thousands of random rows is far
    smaller than 1, and a bound in absolute terms alone would pass a kernel
    that returned zeros or skipped part of the keys.  Returns (max |err|,
    max |want|)."""
    err = allclose_err(torch, got, want, tol)
    top = float(want.float().abs().max())
    need(top > 0 and err <= tol * top,
         f"max |err| {err:.3e} beyond {tol} x max |want| {top:.3e}")
    return err, top


def check_k5(torch, rows, waves):
    """K5 at the main path's wave shapes ``waves`` [(batch, prompt_len)]
    (ragged last tiles), at the shapes that reach its other paths (head
    dims, non-causal, S < T, GQA groups 1 and 8), then at q [8,32,1024,64]
    with its timings: split P, a single bf16 P (timed only), SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain,
        flash_attention_single_p_cuda)

    g = torch.Generator(device="cuda").manual_seed(1)
    # (name, b, h, hkv, s, t, dh, causal)
    cases = [(f"wave shape {i}", b, 32, 4, s, s, 64, True)
             for i, (b, s) in enumerate(waves)]
    cases += [("head_dim 16", 2, 16, 4, 300, 300, 16, True),
              ("head_dim 32", 2, 16, 4, 300, 300, 32, True),
              ("head_dim 128", 2, 16, 4, 300, 300, 128, True),
              ("non-causal", 2, 16, 4, 300, 300, 64, False),
              ("S < T", 2, 16, 4, 100, 350, 64, True),
              ("GQA group 1", 2, 8, 8, 257, 257, 64, True),
              ("GQA group 8", 2, 16, 2, 257, 257, 128, True)]
    for name, b, h, hkv, s, t, dh, causal in cases:
        q = torch.randn(b, h, s, dh, device="cuda", generator=g).bfloat16()
        k = torch.randn(b, hkv, t, dh, device="cuda", generator=g).bfloat16()
        v = torch.randn(b, hkv, t, dh, device="cuda", generator=g).bfloat16()
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        err = allclose_err(torch, got, want, TOL["bfloat16"])
        bit_equal = float((got == want).float().mean())
        log(f"K5 bfloat16 {name} causal={causal} q[{b},{h},{s},{dh}] "
            f"kv[{b},{hkv},{t},{dh}] max_abs_err={err:.3e} "
            f"bit_equal_share={bit_equal:.6f}")
        del q, k, v, got, want
    b, s, h, hkv, dh = 8, 1024, 32, 4, 64
    q = torch.randn(b, h, s, dh, device="cuda", generator=g)
    k = torch.randn(b, hkv, s, dh, device="cuda", generator=g)
    v = torch.randn(b, hkv, s, dh, device="cuda", generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype)[6:]]
        qq, kk, vv = q.to(dtype), k.to(dtype), v.to(dtype)
        got = flash_attention_cuda(qq, kk, vv, causal=True)
        want = flash_attention_plain(qq, kk, vv, causal=True)
        torch.cuda.synchronize()
        err = allclose_err(torch, got, want, tol)
        bit_equal = float((got == want).float().mean())
        ms = events_ms(torch, lambda: flash_attention_cuda(qq, kk, vv,
                                                           causal=True),
                       reps=20)
        plain_ms = events_ms(torch, lambda: flash_attention_plain(
            qq, kk, vv, causal=True))
        lib = events_ms(torch, lambda: F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, enable_gqa=True), reps=20)
        log(f"K5 {str(dtype)[6:]} causal q[{b},{h},{s},{dh}] "
            f"kv[{b},{hkv},{s},{dh}] max_abs_err={err:.3e} "
            f"bit_equal_share={bit_equal:.6f} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib:.4f}")
        check_lse(torch, qq, kk, vv, True, f"causal q[{b},{h},{s},{dh}]", ms)
        if dtype == torch.bfloat16:
            one = flash_attention_single_p_cuda(qq, kk, vv, causal=True)
            one_err = float((one.float() - want.float()).abs().max())
            one_ms = events_ms(torch, lambda: flash_attention_single_p_cuda(
                qq, kk, vv, causal=True), reps=20)
            ms2 = events_ms(torch, lambda: flash_attention_cuda(
                qq, kk, vv, causal=True), reps=20)
            log(f"K5 bfloat16 P as hi+lo ms={ms:.4f} / {ms2:.4f}, single "
                f"bf16 P (timed only) ms={one_ms:.4f} max_abs_err="
                f"{one_err:.3e}: the P_lo product costs "
                f"{(ms + ms2) / 2 - one_ms:.4f} ms")
            n_bytes = 2 * (2 * q.numel() + 2 * k.numel())
            flops = 4 * b * h * dh * s * (s + 1) / 2
            bnd, by = bound_ms(n_bytes, flops, H100_BF16_FLOPS)
            log(f"K5 bound {bnd:.4f} ms by {by} (bf16 tensor cores; the "
                f"split P's MMA work is 1.5x: "
                f"{1.5 * flops / H100_BF16_FLOPS * 1e3:.4f} ms); FP32 bound "
                f"{flops / H100_FP32_FLOPS * 1e3:.4f} ms; bytes "
                f"{n_bytes / H100_HBM_BYTES * 1e3:.4f} ms; achieved "
                f"{1.5 * flops / ms / 1e9:.1f} TFLOP/s of MMA work")
            rows["flash_attention"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib)


def check_lse(torch, q, k, v, causal: bool, what: str, ms: float):
    """K5 with its log-sum-exp output against the plain version's
    ``torch.logsumexp`` (f32, 1e-4: the kernel's exp2 is ~2^-22 relative
    and its sums run in another order), the output unchanged by it, and
    its time beside the launch without it (``ms``)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_lse_cuda,
        flash_attention_lse_plain)

    out, lse = flash_attention_lse_cuda(q, k, v, causal=causal)
    want_out, want_lse = flash_attention_lse_plain(q, k, v, causal=causal)
    err = allclose_err(torch, lse, want_lse, 1e-4)
    same = bool(torch.equal(out, flash_attention_cuda(q, k, v,
                                                      causal=causal)))
    need(same, f"K5's output with lse differs from without ({what})")
    allclose_err(torch, out, want_out, TOL[str(q.dtype)[6:]])
    lse_ms = events_ms(torch, lambda: flash_attention_lse_cuda(
        q, k, v, causal=causal), reps=20)
    ms2 = events_ms(torch, lambda: flash_attention_cuda(q, k, v,
                                                        causal=causal),
                    reps=20)
    log(f"K5 {str(q.dtype)[6:]} {what} with lse: lse max_abs_err={err:.3e} "
        f"(f32, against torch.logsumexp), output equal to the launch "
        f"without; ms with lse={lse_ms:.4f}, without={ms:.4f} / {ms2:.4f}")
    return lse_ms


def check_k6(torch, rows, longest: int):
    """K6 against its plain version: f32 (1e-5) and bf16 (8e-3) at lengths
    on and around its chunk edges (a row of length 0 included), at head
    dims 16/32/128 and GQA groups 1, 8 and 32; then at the LM path's shape
    (q [8,32,64], cache [8,4,2048,64]) with the path's longest length and
    with every row full, timed beside SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (decode_plan,
                                                     flash_decode_cuda,
                                                     flash_decode_plain)

    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    # (name, b, h, hkv, t, dh)
    cases = [("LM shape", 8, 32, 4, 2048, 64),
             ("head_dim 16", 8, 8, 2, 1000, 16),
             ("head_dim 32", 8, 8, 2, 1000, 32),
             ("head_dim 128", 8, 16, 2, 1000, 128),
             ("GQA group 1", 8, 8, 8, 700, 64),
             ("GQA group 8", 8, 16, 2, 700, 128),
             ("GQA group 32", 8, 32, 1, 700, 64)]
    for name, b, h, hkv, t, dh in cases:
        for dtype in (torch.float32, torch.bfloat16):
            chunk, n_split = decode_plan(b, hkv, t, dh, dtype.itemsize)
            lens_list = [0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1]
            lens_list = [min(n, t) for n in lens_list]
            lens_list[-1] = t
            lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
            q, kc, vc = (rand(b, h, dh, dtype=dtype),
                         rand(b, hkv, t, dh, dtype=dtype),
                         rand(b, hkv, t, dh, dtype=dtype))
            got = flash_decode_cuda(q, kc, vc, lens)
            want = flash_decode_plain(q, kc, vc, lens)
            torch.cuda.synchronize()
            err = allclose_err(torch, got, want, TOL[str(dtype)[6:]])
            need(bool((got[0] == 0).all()), "K6: a row of length 0 is not 0")
            log(f"K6 {str(dtype)[6:]} {name} q[{b},{h},{dh}] "
                f"cache[{b},{hkv},{t},{dh}] chunk={chunk} splits={n_split} "
                f"lens={lens_list} max_abs_err={err:.3e}")
            del q, kc, vc, got, want

    b, h, hkv, t, dh = 8, 32, 4, 2048, 64
    chunk, n_split = decode_plan(b, hkv, t, dh, 2)
    q32 = torch.randn(b, h, dh, device="cuda", generator=g)
    kc32 = torch.randn(b, hkv, t, dh, device="cuda", generator=g)
    vc32 = torch.randn(b, hkv, t, dh, device="cuda", generator=g)
    lens = torch.full((b,), longest, dtype=torch.int32, device="cuda")
    err = allclose_err(torch, flash_decode_cuda(q32, kc32, vc32, lens),
                       flash_decode_plain(q32, kc32, vc32, lens),
                       TOL["float32"])
    log(f"K6 float32 main q[{b},{h},{dh}] cache[{b},{hkv},{t},{dh}] "
        f"lens={longest} max_abs_err={err:.3e}")
    q, kc, vc = q32.bfloat16(), kc32.bfloat16(), vc32.bfloat16()
    del q32, kc32, vc32
    for name, fill in (("main", longest), ("full", t)):
        lens_list = [fill] * b
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        got = flash_decode_cuda(q, kc, vc, lens)
        want = flash_decode_plain(q, kc, vc, lens)
        torch.cuda.synchronize()
        err = allclose_err(torch, got, want, TOL["bfloat16"])

        def k6():
            return flash_decode_cuda(q, kc, vc, lens)

        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask[:, None, None, :],
                enable_gqa=True)

        mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
        ms = graph_ms(torch, k6)
        lib = graph_ms(torch, sdpa)
        ms2 = graph_ms(torch, k6)
        call_ms = events_ms(torch, k6, reps=50)
        plain_ms = events_ms(torch, lambda: flash_decode_plain(q, kc, vc,
                                                               lens))
        total = sum(lens_list)
        n_bytes = 2 * (2 * hkv * total * dh) + 2 * 2 * q.numel()
        bnd, by = bound_ms(n_bytes, 4 * h * dh * total, H100_FP32_FLOPS)
        log(f"K6 bf16 {name} q[{b},{h},{dh}] cache[{b},{hkv},{t},{dh}] "
            f"chunk={chunk} splits={n_split} lens={fill} "
            f"max_abs_err={err:.3e} ms={ms:.5f} / {ms2:.5f} (CUDA graph "
            f"of 50 launches) per_call_ms={call_ms:.5f} (host included) "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib:.5f} (CUDA graph) "
            f"bound_ms={bnd:.5f} ({by})")
        if name == "main":
            rows["flash_decode"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib)


def check_k6_scratch(torch):
    """K6's scratch, kept per stream and grown on demand: launches of a
    small, a large and the small shape again, back to back with no wait,
    each against the plain version (f32, 1e-5); a launch captured in a CUDA
    graph and replayed on new inputs, then an eager launch after it; and a
    capture that would need new scratch, which must raise."""
    from repro_torch.kernels.flash_attention import (flash_decode_cuda,
                                                     flash_decode_plain)

    g = torch.Generator(device="cuda").manual_seed(5)

    def inputs(b, h, hkv, t, dh):
        return (torch.randn(b, h, dh, device="cuda", generator=g),
                torch.randn(b, hkv, t, dh, device="cuda", generator=g),
                torch.randn(b, hkv, t, dh, device="cuda", generator=g),
                torch.randint(0, t + 1, (b,), device="cuda", generator=g,
                              dtype=torch.int32))

    small, large = (2, 8, 2, 300, 64), (8, 32, 4, 2048, 64)
    cases = [inputs(*shape) for shape in (small, large, small)]
    got = [flash_decode_cuda(*c) for c in cases]
    torch.cuda.synchronize()
    err = max(allclose_err(torch, o, flash_decode_plain(*c), TOL["float32"])
              for o, c in zip(got, cases))
    log(f"K6 scratch: small, large, small back to back max_abs_err={err:.3e}")

    q, kc, vc, lens = inputs(*large)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        flash_decode_cuda(q, kc, vc, lens)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = flash_decode_cuda(q, kc, vc, lens)
    errs = []
    for _ in range(2):
        fresh = inputs(*large)
        for dst, src in zip((q, kc, vc, lens), fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        errs.append(allclose_err(torch, out, flash_decode_plain(q, kc, vc,
                                                                lens),
                                 TOL["float32"]))
    errs.append(allclose_err(torch, flash_decode_cuda(q, kc, vc, lens),
                             flash_decode_plain(q, kc, vc, lens),
                             TOL["float32"]))
    log(f"K6 scratch: CUDA graph replays on new inputs, then eager, "
        f"max_abs_err={max(errs):.3e}")

    # 32 rows x 4 KV heads: more tickets than any launch so far has needed
    q, kc, vc, lens = inputs(32, 8, 4, 256, 64)
    raised = False
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(),
                              stream=torch.cuda.Stream()):
            flash_decode_cuda(q, kc, vc, lens)
    except RuntimeError as e:
        raised = "captured" in str(e)
    torch.cuda.synchronize()
    log(f"K6 scratch: a capture that needs new scratch raises={raised}")
    need(raised, "K6 made scratch while a CUDA graph was being captured")


# ---------------------------------------------------------------------------
# LM families phase: every other model family at full width
# ---------------------------------------------------------------------------

# (arch, layers run or None for all, why the depth is cut); width is never cut
FAMILY_RUNS = (
    ("rwkv6_1_6b", None, ""),
    ("jamba_v0_1_52b", 8, "one period of Jamba's block (7 Mamba, 1 attention, "
     "4 MoE layers); all 32 layers are 52B parameters, 104 GB in bf16, "
     "beyond one 80 GB card"),
    ("kimi_k2_1t_a32b", 1, "1T parameters; one layer (384 experts top-8, one "
     "shared) with the embeddings is 19.4B, 38.9 GB in bf16"),
    ("arctic_480b", 1, "480B parameters; one layer (128 experts top-2 beside "
     "the dense residual MLP) with the embeddings is 14.1B, 28.1 GB"),
    ("phi3_mini_3_8b", None, ""),
    ("granite_3_2b", None, ""),
    ("whisper_base", None, ""),
    ("internvl2_76b", 4, "76B parameters, 152 GB in bf16; 4 layers with the "
     "embeddings and the projector are 5.6B, 11.2 GB"),
)
FAMILY_BATCH, FAMILY_NEW_TOKENS = 8, 32
FAMILY_LONGEST = 1024  # each wave's longest prompt: jamba's scan needs a
# multiple of its 256-token chunk, and RWKV6's chunk is the largest divisor
# of T up to 64, so a prime T would run it one token at a time


@contextlib.contextmanager
def moe_tally():
    """Each MoE call's (tokens, dropped fraction) while the block runs; the
    fractions stay on the card until read."""
    from repro_torch.models import moe

    calls = []
    forward = moe.moe_forward

    def tallied(x, p, dims):
        out, aux = forward(x, p, dims)
        calls.append((x.numel() // x.shape[-1], aux["dropped_fraction"]))
        return out, aux

    moe.moe_forward = tallied
    try:
        yield calls
    finally:
        moe.moe_forward = forward


def watch_finite(torch, lm):
    """Wrap the model's prefill and decode so that one flag on the card
    records whether every logit they returned was finite (no sync)."""
    flag = torch.ones((), dtype=torch.bool, device="cuda")

    def watched(fn):
        def run(*args, **kw):
            logits, cache = fn(*args, **kw)
            flag.logical_and_(torch.isfinite(logits).all())
            return logits, cache
        return run

    lm.prefill_fn, lm.decode_fn = watched(lm.prefill_fn), watched(lm.decode_fn)
    return flag


def family_inputs(torch, cfg, rng, gen):
    """One wave's inputs: prompts of 512–1024 tokens (engine families), or
    Whisper's 1,500 frames and 64 prompt tokens, or the VLM's 256 patch
    embeddings and 512 prompt tokens."""
    import numpy as np

    if cfg.family == "encdec":
        return {"tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (FAMILY_BATCH, 64))).cuda(),
                "frames": torch.randn(FAMILY_BATCH, cfg.n_audio_frames,
                                      cfg.d_model, device="cuda",
                                      generator=gen)}
    if cfg.family == "vlm":
        return {"tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (FAMILY_BATCH, 512))).cuda(),
                "patch_embeds": torch.randn(FAMILY_BATCH, cfg.n_patches,
                                            3200, device="cuda",
                                            generator=gen)}
    lens = rng.integers(FAMILY_LONGEST // 2, FAMILY_LONGEST + 1, FAMILY_BATCH)
    lens[0] = FAMILY_LONGEST
    return [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
            for n in lens]


def run_direct(torch, lm, params, batch, steps: int):
    """Whisper and the VLM through ``prefill_fn`` / ``decode_fn``: greedy
    tokens [B, steps + 1] and (prefill_s, decode_s) on the host's clock."""
    v = lm.cfg.vocab_size
    s = batch["tokens"].shape[1] + lm.cfg.n_patches
    t0 = time.perf_counter()
    logits, cache = lm.prefill_fn(params, batch, s + steps)
    tok = logits[:, :v].argmax(-1)
    out = [tok.cpu()]
    t_first = time.perf_counter()
    for i in range(steps):
        logits, cache = lm.decode_fn(params, cache, tok, s + i)
        tok = logits[:, :v].argmax(-1)
        out.append(tok.cpu())
    t_end = time.perf_counter()
    return torch.stack(out, 1), t_first - t0, t_end - t_first, cache


def family_run(torch, arch: str, depth, why: str) -> dict:
    """One config at full width: seeded bf16 init on the card, one wave of
    8 requests and its repeat, launches, dropped fractions, a profiled
    decode step; frees the model before returning its numbers."""
    import gc

    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import LAUNCHES, reset_counts
    from repro_torch.models.model import build_model, layer_plan
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_arch(arch)
    if depth is not None:
        log(f"CUT: {arch} n_layers={depth} instead of {cfg.n_layers} ({why})")
        cfg = dataclasses.replace(cfg, n_layers=depth)
    plans = layer_plan(cfg)
    attn_layers = sum(plans[i % len(plans)].mixer == "attn"
                      for i in range(cfg.n_layers))
    direct = cfg.family in ("encdec", "vlm")
    lm = build_model(cfg)
    finite = watch_finite(torch, lm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    f32_leaves = sum(p.dtype == torch.float32 for p in params.parameters())
    rng = np.random.default_rng(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    inputs = family_inputs(torch, cfg, rng, gen)
    waves, outputs = [], []
    with moe_tally() as moe_calls:
        torch.cuda.synchronize()
        reset_counts()
        if direct:
            for _ in range(2):
                toks, prefill_s, decode_s, cache = run_direct(
                    torch, lm, params, inputs, FAMILY_NEW_TOKENS)
                del cache
                outputs.append(toks)
                waves.append((prefill_s, decode_s, FAMILY_NEW_TOKENS,
                              FAMILY_BATCH * FAMILY_NEW_TOKENS))
            steps = FAMILY_NEW_TOKENS
        else:
            engine = ServeEngine(lm, params, ServeConfig(
                max_len=FAMILY_LONGEST + FAMILY_NEW_TOKENS,
                n_slots=FAMILY_BATCH))
            for _ in range(2):
                reqs = [Request(rid=i, prompt=p,
                                max_new_tokens=FAMILY_NEW_TOKENS)
                        for i, p in enumerate(inputs)]
                engine.generate(reqs)
                outputs.append(torch.tensor([r.output for r in reqs]))
            waves = [(w.prefill_s, w.decode_s, w.decode_steps,
                      w.decode_tokens) for w in engine.waves]
            steps = engine.waves[0].decode_steps
        torch.cuda.synchronize()
        launches = {n: LAUNCHES[n] for n in LM_KERNELS}
        others = {n: c for n, c in LAUNCHES.items()
                  if n not in LM_KERNELS and c}
        dropped = [(t, float(d)) for t, d in moe_calls]
    peak = torch.cuda.max_memory_allocated()
    cross = cfg.n_layers if cfg.family == "encdec" else 0
    want_k5 = 2 * (attn_layers + cross + cfg.n_encoder_layers)
    want_k6 = 2 * steps * (attn_layers + cross)
    row = dict(arch=arch, family=cfg.family, layers=cfg.n_layers,
               params=lm.n_params, active_params=lm.n_active_params(),
               param_bytes=n_bytes, f32_leaves=int(f32_leaves),
               init_s=round(init_s, 3), peak_bytes=peak,
               launches=launches, want_k5=want_k5, want_k6=want_k6,
               prefill_s=[round(w[0], 4) for w in waves],
               decode_steps=steps,
               decode_tok_s=[round(w[3] / w[1], 1) for w in waves],
               step_ms=[round(1e3 * w[1] / max(w[2], 1), 3) for w in waves])
    if dropped:
        pre = [d for t, d in dropped if t > FAMILY_BATCH]
        dec = [d for t, d in dropped if t == FAMILY_BATCH]
        row["dropped_fraction"] = dict(
            prefill=round(sum(pre) / max(len(pre), 1), 6),
            decode=round(sum(dec) / max(len(dec), 1), 6), calls=len(dropped))

    # a decode step's host wall against the card's busy time
    if direct:
        batch = inputs
        s = batch["tokens"].shape[1] + cfg.n_patches
        logits, cache = lm.prefill_fn(params, batch, s + 4)
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        wall, busy, ops, top = profiled_ms(
            torch, lambda i: lm.decode_fn(params, cache, tok, s + i), 3)
    else:
        toks = torch.from_numpy(np.stack([np.pad(
            p, (FAMILY_LONGEST - len(p), 0)) for p in inputs])).cuda()
        logits, cache = engine._prefill(toks)
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        wall, busy, ops, top = profiled_ms(
            torch, lambda i: engine._decode(cache, tok, FAMILY_LONGEST + i), 3)
    # the idle share against the warm wave's step, timed without the
    # profiler (whose host-side tracing lengthens the profiled wall)
    row.update(profiled_step_ms=round(wall, 3), device_busy_ms=round(busy, 3),
               device_ops=int(ops), device_idle_share=round(1 - busy / row["step_ms"][-1], 3))
    log(f"LM family {json.dumps(row)}")
    log(f"LM family {arch} decode step top kernels (ms): {top}")
    need(bool(finite), f"{arch}: non-finite logits")
    need(torch.equal(outputs[0], outputs[1]),
         f"{arch}: greedy tokens differ on a repeat of the wave")
    need(bool(((outputs[0] >= 0) & (outputs[0] < cfg.vocab_size)).all()),
         f"{arch}: a token lies outside the vocabulary")
    need(launches["flash_attention"] == want_k5,
         f"{arch}: K5 launched {launches['flash_attention']} times, the "
         f"layer plan implies {want_k5}")
    need(launches["flash_decode"] == want_k6,
         f"{arch}: K6 launched {launches['flash_decode']} times, the layer "
         f"plan implies {want_k6}")
    need(not others, f"{arch}: the LM path launched ANN kernels {others}")
    need(steps == FAMILY_NEW_TOKENS - (0 if direct else 1),
         f"{arch}: {steps} decode steps")
    if cfg.moe is not None:
        need(bool(dropped), f"{arch}: no MoE call was made")
    del params, cache, logits, tok, inputs, outputs
    if not direct:
        del engine
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return row


def families_path(torch):
    """Every config of the families phase, one after another; returns the
    summed K5/K6 launches."""
    totals = {name: 0 for name in LM_KERNELS}
    for arch, depth, why in FAMILY_RUNS:
        t0 = time.perf_counter()
        row = family_run(torch, arch, depth, why)
        for name in LM_KERNELS:
            totals[name] += row["launches"][name]
        log(f"LM family {arch} {time.perf_counter() - t0:.3f} s")
    return totals


def check_family_kernels(torch):
    """K5 and K6 against their plain versions (bf16, 8e-3) at the families
    phase's new shapes — head dim 96 (phi3-mini), GQA group 7 (arctic),
    Whisper's non-causal encoder at S = T = 1,500, its cross-attention at
    S = 64 against T = 1,500 — timed beside SDPA, with their bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        decode_plan, flash_attention_cuda, flash_attention_plain,
        flash_decode_cuda, flash_decode_plain)

    g = torch.Generator(device="cuda").manual_seed(8)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).bfloat16()

    longest = FAMILY_LONGEST + FAMILY_NEW_TOKENS - 1
    # (name, b, h, hkv, s, t, dh, causal)
    for name, b, h, hkv, s, t, dh, causal in (
            ("phi3-mini Dh 96", 8, 32, 32, 1024, 1024, 96, True),
            ("arctic GQA 7", 8, 56, 8, 1024, 1024, 128, True),
            ("whisper encoder", 8, 8, 8, 1500, 1500, 64, False),
            ("whisper cross", 8, 8, 8, 64, 1500, 64, False)):
        q, k, v = rand(b, h, s, dh), rand(b, hkv, t, dh), rand(b, hkv, t, dh)
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        err = allclose_err(torch, got, want, TOL["bfloat16"])
        ms = events_ms(torch, lambda: flash_attention_cuda(q, k, v,
                                                           causal=causal),
                       reps=20)
        plain_ms = events_ms(torch, lambda: flash_attention_plain(
            q, k, v, causal=causal), reps=1)
        lib = events_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps=20)
        pairs = s * (s + 1) / 2 if causal else s * t
        bnd, by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()),
                           4 * b * h * dh * pairs, H100_BF16_FLOPS)
        log(f"K5 bfloat16 {name} causal={causal} q[{b},{h},{s},{dh}] "
            f"kv[{b},{hkv},{t},{dh}] max_abs_err={err:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib:.4f} bound_ms={bnd:.5f} "
            f"({by})")
        check_lse(torch, q, k, v, causal, name, ms)
        del q, k, v, got, want
    for name, b, h, hkv, t, dh, fill in (
            ("phi3-mini Dh 96", 8, 32, 32, longest + 1, 96, longest),
            ("arctic GQA 7", 8, 56, 8, longest + 1, 128, longest),
            ("whisper cross", 8, 8, 8, 1500, 64, 1500)):
        q, kc, vc = rand(b, h, dh), rand(b, hkv, t, dh), rand(b, hkv, t, dh)
        lens = torch.full((b,), fill, dtype=torch.int32, device="cuda")
        err = allclose_err(torch, flash_decode_cuda(q, kc, vc, lens),
                           flash_decode_plain(q, kc, vc, lens),
                           TOL["bfloat16"])
        mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
        ms = graph_ms(torch, lambda: flash_decode_cuda(q, kc, vc, lens))
        lib = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask[:, None, None, :],
            enable_gqa=True))
        plain_ms = events_ms(torch, lambda: flash_decode_plain(q, kc, vc,
                                                               lens))
        total = b * fill
        bnd, by = bound_ms(2 * (2 * hkv * total * dh) + 2 * 2 * q.numel(),
                           4 * h * dh * total, H100_FP32_FLOPS)
        chunk, n_split = decode_plan(b, hkv, t, dh, 2)
        log(f"K6 bf16 {name} q[{b},{h},{dh}] cache[{b},{hkv},{t},{dh}] "
            f"lens={fill} chunk={chunk} splits={n_split} max_abs_err="
            f"{err:.3e} ms={ms:.5f} (CUDA graph) plain_ms={plain_ms:.4f} "
            f"sdpa_ms={lib:.5f} (CUDA graph) bound_ms={bnd:.5f} ({by})")
        del q, kc, vc


def check_small_lm_against_cpu(torch):
    """Every config's small version (TinyLlama's and the nine families')
    on the card (K5, K6) and on the CPU (plain versions), prefill and 4
    decode steps on the same weights: in f32 the logits to 1e-4 and the
    greedy tokens equal; in bf16, fed the CPU's tokens, the logits to the
    CPU tests' 2e-2 x max|logit| (Jamba's only printed: its random 16-layer
    small model amplifies 1-ulp differences past it, ROADMAP.md queue C)."""
    import numpy as np

    from repro_torch.configs.base import ARCH_IDS, get_arch, smoke_config
    from repro_torch.models.model import build_model, cast_params

    for arch in ARCH_IDS:
        cfg = smoke_config(get_arch(arch))
        lm = build_model(cfg)
        on_cpu = lm.init(seed=0, device="cpu")
        rng = np.random.default_rng(3)
        # jamba's scan needs a multiple of its 16-token small chunk
        n_tok = 144 if cfg.family == "hybrid" else 150
        batch = {"tokens": rng.integers(1, cfg.vocab_size, (3, n_tok))}
        batch["tokens"][0, :40] = 0  # left padding
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (3, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (3, cfg.n_patches, 3200)).astype(np.float32)
        s = n_tok + cfg.n_patches
        report = []
        for dtype in (torch.float32, torch.bfloat16):
            runs = {}
            for dev in ("cpu", "cuda"):
                params = cast_params(cfg, on_cpu, dtype, dev)
                b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                logits, cache = lm.prefill_fn(params, b, s + 10, dtype=dtype)
                out, toks = [logits.float().cpu()], []
                for step in range(4):
                    tok = (logits[:, :cfg.vocab_size].argmax(-1)
                           if dev == "cpu" else runs["cpu"][1][step].cuda())
                    toks.append(tok.cpu())
                    logits, cache = lm.decode_fn(params, cache, tok.to(dev),
                                                 s + step, dtype=dtype)
                    out.append(logits.float().cpu())
                runs[dev] = (out, toks)
            same = all(torch.equal(a.argmax(-1), b.argmax(-1))
                       for a, b in zip(runs["cuda"][0][:-1],
                                       runs["cpu"][0][:-1]))
            if dtype == torch.float32:
                err = max(allclose_err(torch, a, b, 1e-4)
                          for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
                need(same, f"{arch} small f32: greedy tokens on the card "
                     "differ from the CPU's")
                report.append(f"float32 max_abs_err={err:.3e} (rtol=atol="
                              f"1e-4) greedy_equal={same}")
                continue
            bound = 2e-2 * max(float(a.abs().max()) for a in runs["cpu"][0])
            err = max(float((a - b).abs().max())
                      for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
            if arch != "jamba_v0_1_52b":
                need(err <= bound, f"{arch} small bf16: card vs CPU logits "
                     f"differ by {err:.3e} > {bound:.3e}")
            report.append(f"bfloat16 max_abs_err={err:.3e} (bound "
                          f"{bound:.3e}) greedy_equal={same}")
        log(f"small {arch} ({cfg.family}, {cfg.n_layers} layers, head_dim "
            f"{cfg.resolved_head_dim}) card vs CPU: " + "; ".join(report))


RETRIEVAL_PROMPT = 1042  # one TinyLlama row: 1,042 prompt keys + the next


def retrieval_path(torch, engine):
    """ANN-retrieval attention over one row of the LM path's KV cache
    (step 14), counters zeroed just before and read just after: a
    1,042-token prompt is prefilled and decoded one step; the last layer's
    K6 call of that step gives the row's 32 query heads' q and its 4 KV
    heads' 1,043 keys and values.  The keys are indexed on the card
    (``build_key_indexes``: K1 in k-means and the partition, K4 for the
    CAGRA kNN graphs), one ``retrieval_decode_attention`` step runs with
    ``backend="fused"`` (K3 at Q = 1) at the reference's defaults, and the
    output is held to K6's full attention on the same row.  Gates: finite
    outputs; with ``exact_search`` and top_t = T the output equals full
    attention to 1e-4 x max; the ``fused`` ids on the card equal the
    port's ``torch`` backend's on the CPU over the same index (the parity
    contract: a differing id must be a near-tie).  Returns the phase's
    launches of K1-K4."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES, ops, reset_counts
    from repro_torch.kernels.flash_attention import flash_decode_cuda
    from repro_torch.search import search
    from repro_torch.serve import (build_key_indexes,
                                   full_decode_attention_ref,
                                   retrieval_decode_attention)

    cfg = engine.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (1, RETRIEVAL_PROMPT),
                         device="cuda", generator=gen)
    calls = []
    decode = ops.flash_decode

    def captured(q, k_cache, v_cache, cache_len, **kw):
        calls.append((q, k_cache, v_cache, cache_len))
        return decode(q, k_cache, v_cache, cache_len, **kw)

    with torch.inference_mode():
        logits, cache = engine._prefill(toks)
        ops.flash_decode = captured
        try:
            engine._decode(cache, logits[:, :cfg.vocab_size].argmax(-1),
                           RETRIEVAL_PROMPT)
        finally:
            ops.flash_decode = decode
        q, kc, vc, lens = calls[-1]  # the last layer's call
        t = int(lens[0])
        k_row = kc[:, :, :t].float().cpu().numpy()
        v_row = vc[:, :, :t].float().cpu().numpy()
        q_row = q.float().cpu().numpy()
        k6 = flash_decode_cuda(q, kc, vc, lens).float().cpu().numpy()
    need(len(calls) == cfg.n_layers, f"{len(calls)} K6 calls in one decode "
         "step, not one a layer")
    h, hkv = q_row.shape[1], k_row.shape[1]
    log(f"retrieval inputs: TinyLlama layer {cfg.n_layers - 1}'s K6 call, q "
        f"{list(q_row.shape)}, keys/values {list(k_row.shape)} (a cache row "
        f"of {t} positions)")
    dense = full_decode_attention_ref(q_row, k_row, v_row)
    reset_counts()
    t0 = time.perf_counter()
    idx = build_key_indexes(k_row, v_row)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    retrieval_decode_attention(q_row, idx, backend="fused")  # warm-up
    t0 = time.perf_counter()
    out, st = retrieval_decode_attention(q_row, idx, backend="fused")
    decode_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: LAUNCHES[name] for name in ANN_KERNELS}
    scale = float(np.abs(dense).max())
    err_k6 = float(np.abs(out - k6).max()) / scale
    err_dense = float(np.abs(out - dense).max()) / scale
    k6_err = float(np.abs(k6 - dense).max()) / scale
    exact, est = retrieval_decode_attention(q_row, idx, top_t=t,
                                            exact_search=True)
    exact_err = float(np.abs(exact - dense).max()) / scale
    # the parity contract: fused on the card against torch on the CPU
    differ = not_tie = 0
    for hi in range(h):
        ki = idx[0][hi // (h // hkv)]
        kw = dict(width=64, n_entries=8)
        a, _ = search(ki.topology(), q_row[0, hi][None], 64,
                      backend="fused", **kw)
        b, _ = search(ki.topology(), q_row[0, hi][None], 64,
                      backend="torch", device="cpu", **kw)
        differ += int((a != b).sum())
        not_tie += near_ties(torch.from_numpy(q_row[0, hi][None]),
                             torch.from_numpy(ki.keys), torch.from_numpy(a),
                             torch.from_numpy(b), 1e-5, metric="ip")
    row = {"keys": t, "kv_heads": hkv, "query_heads": h,
           "build_s": build_s, "decode_ms": decode_ms,
           "rel_err_vs_k6": err_k6, "rel_err_vs_f32_dense": err_dense,
           "k6_rel_err_vs_f32_dense": k6_err,
           "exact_top_t_T_rel_err": exact_err,
           "n_distance_computations": st["n_distance_computations"],
           "exhaustive_distance_computations": h * t,
           "fused_vs_cpu_torch_ids_differing": differ,
           "differing_beyond_near_tie": not_tie, "launches": launches}
    log("retrieval " + json.dumps(row))
    need(bool(np.isfinite(out).all() and np.isfinite(exact).all()),
         "retrieval attention gave non-finite outputs")
    need(exact_err <= 1e-4, f"exact retrieval over every key differs from "
         f"full attention by {exact_err:.3e} x max")
    need(est["n_distance_computations"] == h * t,
         "exact retrieval's distance count")
    need(not_tie == 0, f"{not_tie} fused ids on the card differ from the "
         "CPU torch backend's beyond a near-tie")
    for name in ("pairwise_distance", "fused_beam", "knn"):
        need(launches[name] > 0, f"kernel {name} was not launched in the "
             "retrieval phase")
    return launches


def _grads(torch, lm, params, batch):
    """(loss, gradients, forward s, backward s) of one batch, each part
    ended by a synchronize."""
    from repro_torch.common import params as par
    from repro_torch.models.model import param_tree

    leaves = par.leaves(param_tree(params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = lm.loss_fn(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return float(loss.detach()), grads, t1 - t0, time.perf_counter() - t1


def _worst_leaf(got, want, paths):
    """(the largest max|got - want| / max|want| over the leaves, its
    path)."""
    worst = (0.0, "")
    for g, w, p in zip(got, want, paths):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max()) / max(scale, 1e-30)
        worst = max(worst, (err, p))
    return worst


TRAIN_STEPS = 10
TRAIN_BF16_GRAD_TOL = 5e-2  # x max|g| per leaf; train_path says why


def train_path(torch):
    """Training on the card (step 15), counters zeroed just before the
    timed steps and read just after: TinyLlama-1.1B at full width with its
    bf16 parameters trainable, ``remat="full"``, AdamW and
    ``TrainConfig(warmup_steps=2)`` over ``TokenPipeline(32000, 1024, 8,
    seed=0)`` batches for 10 steps.  Gates: a finite loss every step and
    the last below the first; finite grad norms; K5 launched 22 times in a
    forward and 22 in its recompute, 44 a step; one batch's gradients
    through K5 + the FA2 backward equal to those through the plain
    attention (autograd through ``ref.mha_attention``) on the card, per
    leaf to 5e-2 x max|g| (bf16 gradients: each leaf rounds to 2^-8
    relative, and the two attentions round their bf16 outputs and
    gradients at different points through 22 layers); the TinyLlama and
    kimi smoke configs' f32 gradients on the card equal to the CPU's to
    1e-4 x max|g| per leaf; a checkpoint saved on the card restoring
    equal, leaf for leaf.  Returns K5's launches in the timed steps."""
    import dataclasses
    import shutil

    import numpy as np

    from repro_torch.common import params as par
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import LAUNCHES, ref, reset_counts
    from repro_torch.models import attention
    from repro_torch.models.model import (build_model, loss_fn,
                                          param_tree, params_module,
                                          stacked_tree)
    from repro_torch.train import (TrainConfig, adamw, checkpoint,
                                   init_train_state, make_train_step)

    t_phase = time.perf_counter()
    # f32 gradients of the small configs: the card against the CPU
    for arch in ("tinyllama_1_1b", "kimi_k2_1t_a32b"):
        cfg = smoke_config(get_arch(arch))
        lm = build_model(cfg)
        cpu = lm.init(seed=0, device="cpu", requires_grad=True)
        tree = stacked_tree(cfg, param_tree(cpu))
        card = params_module(cfg, par.tree_map(
            lambda x: x.detach().to("cuda"), tree), requires_grad=True)
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        got, want = [], []
        for params, out in ((card, got), (cpu, want)):
            loss, _ = loss_fn(cfg, params, batch, dtype=torch.float32)
            leaves = par.leaves(param_tree(params))
            out.extend(g.cpu() for g in torch.autograd.grad(loss, leaves))
        paths = [p for p, _ in par.leaves_with_paths(param_tree(cpu))]
        err, path = _worst_leaf(got, want, paths)
        log(f"train small {arch} f32 gradients card vs CPU: worst leaf "
            f"{path} max|dg|/max|g|={err:.3e} ({len(paths)} leaves)")
        need(err <= 1e-4, f"{arch}'s f32 gradients on the card differ from "
             f"the CPU's: {path} {err:.3e} x max|g|")
        del cpu, card

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_arch("tinyllama_1_1b")
    cfg = dataclasses.replace(base, remat="full")
    lm = build_model(cfg)
    t0 = time.perf_counter()
    params = lm.init(seed=0, dtype=torch.bfloat16, requires_grad=True)
    torch.cuda.synchronize()
    tcfg = TrainConfig(warmup_steps=2)
    log(f"CUT: training warmup_steps={tcfg.warmup_steps} instead of "
        f"{TrainConfig().warmup_steps} (a {TRAIN_STEPS}-step run); "
        f"{cfg.name} at full width, {cfg.n_layers} layers, bf16 parameters, "
        f"remat={cfg.remat} (the config's {base.remat}), AdamW; init "
        f"{time.perf_counter() - t0:.3f} s")
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, 1024, 8,
                                             seed=0))
    first = pipe.next_batch()

    # one batch: K5 + FA2 backward against the plain attention, and the
    # forward / backward split with K5's launches in each
    _grads(torch, lm, params, first)  # warm-up (cuBLAS, allocator)
    reset_counts()
    loss0, fa2, t_fwd, t_bwd = _grads(torch, lm, params, first)
    k5 = LAUNCHES["flash_attention"]
    need(k5 == 2 * cfg.n_layers, f"K5 launched {k5} times in one forward + "
         f"backward, not {cfg.n_layers} + {cfg.n_layers} (remat)")
    attend = attention._attend
    attention._attend = lambda q, k, v, *, causal: ref.mha_attention(
        q, k, v, causal=causal)
    try:
        loss_p, plain, *_ = _grads(torch, lm, params, first)
    finally:
        attention._attend = attend
    paths = [p for p, _ in par.leaves_with_paths(param_tree(params))]
    err, path = _worst_leaf(fa2, plain, paths)
    log(f"train one batch: loss {loss0:.6f} (plain attention {loss_p:.6f}); "
        f"K5 + FA2 backward against plain attention, bf16 gradients: worst "
        f"leaf {path} max|dg|/max|g|={err:.3e}; forward {t_fwd * 1e3:.1f} "
        f"ms (K5 {cfg.n_layers}), backward with recompute {t_bwd * 1e3:.1f}"
        f" ms (K5 {k5 - cfg.n_layers}), backward share "
        f"{t_bwd / (t_fwd + t_bwd):.3f}")
    need(err <= TRAIN_BF16_GRAD_TOL, f"gradients through K5 + FA2 differ "
         f"from the plain attention's: {path} {err:.3e} x max|g|")
    del fa2, plain

    opt = adamw()
    state = init_train_state(lm, opt, tcfg=tcfg, params=params)
    step = make_train_step(lm, opt, tcfg)
    pipe.seek(0)
    batches = [pipe.next_batch() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    reset_counts()
    losses, norms, walls = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        walls.append(time.perf_counter() - t0)
    launches = LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = walls[2:]
    step_ms = 1e3 * sum(warm) / len(warm)
    wall, busy, ops, top = profiled_ms(
        torch, lambda i: step(state, batches[i]), 1)
    row = {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
           "step_ms": step_ms, "step_ms_each": [1e3 * w for w in walls],
           "tokens_per_s": 8 * 1024 / (step_ms / 1e3),
           "profiled_step_wall_ms": wall, "profiled_busy_ms": busy,
           "profiled_idle_share": 1 - busy / wall, "device_ops": ops,
           "peak_gb": peak, "k5_launches": launches,
           "backward_share": t_bwd / (t_fwd + t_bwd)}
    log("train " + json.dumps(row))
    log(f"train profiled step top kernels ms: {top}")
    need(all(np.isfinite(losses)) and losses[-1] < losses[0],
         f"training losses {losses}")
    need(all(np.isfinite(norms)), f"grad norms {norms}")
    need(launches == TRAIN_STEPS * 2 * cfg.n_layers, f"K5 launched "
         f"{launches} times in {TRAIN_STEPS} steps, not "
         f"{TRAIN_STEPS * 2 * cfg.n_layers}")

    # a checkpoint on the card restores equal, leaf for leaf
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    with torch.no_grad():
        tree = {"params": stacked_tree(cfg, param_tree(state.params)),
                "count": state.opt_state["count"], "step": state.step}
    t0 = time.perf_counter()
    checkpoint.save(str(root), int(state.step), tree,
                    metadata={"arch": cfg.name})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, back, manifest = checkpoint.restore_latest(str(root), tree)
    load_s = time.perf_counter() - t0
    pairs = list(zip(par.leaves(tree), par.leaves(back)))
    equal = all(a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b) for a, b in pairs)
    n_bytes = sum(a.numel() * a.element_size() for a, _ in pairs)
    log(f"train checkpoint: {len(pairs)} leaves, {n_bytes} bytes, save "
        f"{save_s:.3f} s, restore {load_s:.3f} s, equal={equal}")
    shutil.rmtree(root, ignore_errors=True)
    need(equal and manifest["step"] == TRAIN_STEPS,
         "the checkpoint restored unequal")
    log(f"train phase body {time.perf_counter() - t_phase:.3f} s")
    return {"flash_attention": launches}


# ---------------------------------------------------------------------------
# Step 16: the launch phase
# ---------------------------------------------------------------------------

LAUNCH_JOBS = 6  # dry-run cells counted at once (the host has 8 cores)
LAUNCH_STEPS = 5  # timed steps of a prefill or decode cell (the median)


def launch_dryrun(torch) -> None:
    """The port's whole dry-run in-process (its cells counted in
    ``LAUNCH_JOBS`` processes on the host): 40 cells on both production
    meshes, 32 counted and 8 skipped, with 0 errors."""
    from repro_torch.configs.base import SUBQUADRATIC_FAMILIES, get_arch
    from repro_torch.launch import dryrun

    out = ROOT / "build" / "dryrun_results.json"
    out.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    rc = dryrun.main(["--out", str(out), "--quiet", "--jobs",
                      str(LAUNCH_JOBS)])
    secs = time.perf_counter() - t0
    rows = json.loads(out.read_text())
    status = collections.Counter(r["status"] for r in rows)
    skipped = [(r["arch"], r["shape"]) for r in rows
               if r["status"] == "skipped"]
    for r in rows:
        if r["status"] == "ok" and r["mesh"] == "single":
            multi = next(m for m in rows if m["status"] == "ok"
                         and m["mesh"] == "multi" and m["arch"] == r["arch"]
                         and m["shape"] == r["shape"])
            log(f"dryrun cell {r['arch']} {r['shape']} {r['kind']} "
                f"flops={r['flops']:.4e} bytes={r['bytes_accessed']:.4e} "
                f"argument_bytes/device single={r['memory']['argument_bytes']}"
                f" multi={multi['memory']['argument_bytes']} "
                f"count_s={r['analyze_s']}")
    cells = len({(r["arch"], r["shape"]) for r in rows})
    log("dryrun " + json.dumps({
        "cells": cells, "ok": status["ok"], "skipped": status["skipped"],
        "errors": status["error"], "seconds": round(secs, 3),
        "jobs": LAUNCH_JOBS}))
    need(rc == 0 and status["error"] == 0,
         f"the dry-run gave {status['error']} error rows (rc {rc})")
    need(cells == 40 and status["ok"] == 64 and len(skipped) == 8,
         f"the dry-run gave {status['ok']} ok rows and {len(skipped)} skips "
         f"over {cells} cells, not 64 and 8 over 40")
    need(all(s == "long_500k" and get_arch(a).family
             not in SUBQUADRATIC_FAMILIES for a, s in skipped),
         f"the dry-run skipped {skipped}")


def step_times(torch, fn, n: int) -> list:
    """Device time of each of ``n`` calls of ``fn`` (CUDA events around
    each call, which wait on the card)."""
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def tensors_bytes(*trees) -> int:
    """Bytes of the tensors in trees of them (``params.leaves``) and of
    modules' parameters."""
    from torch import nn

    from repro_torch.common import params as par

    return sum(t.numel() * t.element_size() for leaf in par.leaves(trees)
               for t in (leaf.parameters() if isinstance(leaf, nn.Module)
                         else [leaf]) if hasattr(t, "element_size"))


def randomize_cache(torch, cache, seed: int) -> None:
    """Every cache leaf refilled in place with seeded normal values (a
    ``seq_len - 1``-token history to decode the next token against)."""
    from repro_torch.common import params as par

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for leaf in par.leaves(cache):
        leaf.normal_(generator=gen)


def launch_report(torch, arch, shape_id, cost, ms_list, least_bytes,
                  reckoned, peak, launches, **extra) -> dict:
    """One ``launch cell {...}`` line and the gate on the bound."""
    import statistics

    ms = statistics.median(ms_list)
    t_ops = cost["flops"] / H100_BF16_FLOPS * 1e3
    t_bytes = least_bytes / H100_HBM_BYTES * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                           "operations")
    row = {"arch": arch, "shape": shape_id, "step_ms": ms,
           "step_ms_each": ms_list, "flops": cost["flops"],
           "least_bytes": least_bytes,
           "eager_op_bytes": cost["bytes"], "bound_ms": bnd,
           "bound_by": by, "bound_share": bnd / ms,
           "reckoned_gb": reckoned / 1e9, "peak_gb": peak / 1e9,
           "k5_launches": launches["flash_attention"],
           "k6_launches": launches["flash_decode"], **extra}
    log("launch cell " + json.dumps(row))
    need(ms >= 0.95 * bnd, f"{arch} x {shape_id}: {ms:.3f} ms is below "
         f"0.95 x its counted bound {bnd:.3f} ms: the count is wrong")
    return row


def count_cut(cfg, shape):
    """The step_cost count of a cell at its cut shape (on meta)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as lspecs

    cost, _, secs = dryrun.count_step(lspecs.make_cell(cfg, shape), cfg,
                                      shape)
    return cost, secs


def check_k6_long(torch, what, q, kc, vc, lens, fill):
    """K6 over a whole call against its plain version (bf16, 8e-3, and
    max |err| <= 8e-3 x max |want|: each output averages ``fill`` random V
    rows; the plain version 8 rows at a time: it broadcasts V over each
    GQA group, 17 GB at once for 64 rows of 32,768 keys), timed beside
    SDPA with its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (decode_plan,
                                                     flash_decode_cuda,
                                                     flash_decode_plain)

    b, h, dh = q.shape
    hkv, t = kc.shape[1], kc.shape[2]
    rows = 8

    def plain():
        return torch.cat([flash_decode_plain(q[i:i + rows], kc[i:i + rows],
                                             vc[i:i + rows], lens[i:i + rows])
                          for i in range(0, b, rows)])

    err, top = scaled_err(torch, flash_decode_cuda(q, kc, vc, lens),
                          plain(), TOL["bfloat16"])
    ms = events_ms(torch, lambda: flash_decode_cuda(q, kc, vc, lens),
                   reps=10)
    plain_ms = events_ms(torch, plain, reps=1)
    mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    lib = events_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask[:, None, None, :],
        enable_gqa=True), reps=10)
    total = b * fill
    bnd, by = bound_ms(2 * (2 * hkv * total * dh) + 2 * 2 * q.numel(),
                       4 * h * dh * total, H100_FP32_FLOPS)
    chunk, n_split = decode_plan(b, hkv, t, dh, 2)
    log(f"K6 bf16 {what} q[{b},{h},{dh}] cache[{b},{hkv},{t},{dh}] "
        f"lens={fill} chunk={chunk} splits={n_split} max_abs_err={err:.3e} "
        f"max_abs_want={top:.3e} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib:.4f} "
        f"bound_ms={bnd:.4f} ({by}) share={bnd / ms:.3f}")


def check_k5_long(torch, g):
    """K5 at the prefill_32k cell's layer shape, q [8,32,32768,64] and k/v
    [8,4,32768,64], causal: the last 512 query rows of every sequence of
    one launch against the plain version, one sequence at a time, with the
    causal offset (bf16, 8e-3, and max |err| <= 8e-3 x max |want|: those
    rows average ~32k random V rows); then timed beside SDPA with its
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    b, h, hkv, s, dh, held = 8, 32, 4, 32768, 64, 512

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).bfloat16()

    q, k, v = rand(b, h, s, dh), rand(b, hkv, s, dh), rand(b, hkv, s, dh)
    got = flash_attention_cuda(q, k, v, causal=True)[:, :, -held:]

    def plain(i):
        return flash_attention_plain(q[i:i + 1, :, -held:], k[i:i + 1],
                                     v[i:i + 1], causal=True)

    errs = [scaled_err(torch, got[i:i + 1], plain(i), TOL["bfloat16"])
            for i in range(b)]
    plain_ms = events_ms(torch, lambda: plain(0), reps=3)
    err = max(e for e, _ in errs)
    top = min(t for _, t in errs)
    log(f"K5 bfloat16 S=T={s} q[{b},{h},{s},{dh}] kv[{b},{hkv},{s},{dh}]: "
        f"the last {held} rows of each sequence against the plain version "
        f"(causal offset {s - held}) max_abs_err={err:.3e} "
        f"min_max_abs_want={top:.3e} plain_ms={plain_ms:.4f} (one "
        f"sequence's held rows)")
    del got
    ms = events_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True),
                   reps=3)
    lib = events_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=3)
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()),
                       4 * b * h * dh * s * (s + 1) / 2, H100_BF16_FLOPS)
    log(f"K5 bfloat16 prefill_32k layer q[{b},{h},{s},{dh}] "
        f"kv[{b},{hkv},{s},{dh}] causal ms={ms:.3f} sdpa_ms={lib:.3f} "
        f"bound_ms={bnd:.3f} ({by}) share={bnd / ms:.3f}")
    del q, k, v


def check_k5_train(torch, g):
    """K5 with its log-sum-exp at the train_4k cell's layer shape, q
    [8,32,4096,64] and k/v [8,4,4096,64], causal, and the FA2 backward on
    its residuals: the output (bf16, 8e-3, and 8e-3 x max |want|) and the
    lse (f32, 1e-4) of every sequence against the plain version, one
    sequence at a time; dq, dk and dv of the first and the last sequence
    against the plain version's autograd (5e-2 x max |g|, as step 15)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_lse_cuda, flash_attention_lse_plain,
        flash_attention_plain)
    from repro_torch.kernels.flash_vjp import flash_attention_bwd

    b, h, hkv, s, dh = 8, 32, 4, 4096, 64

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).bfloat16()

    q, k, v = rand(b, h, s, dh), rand(b, hkv, s, dh), rand(b, hkv, s, dh)
    out, lse = flash_attention_lse_cuda(q, k, v, causal=True)
    err = lse_err = 0.0
    for i in range(b):
        want, want_lse = flash_attention_lse_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True)
        err = max(err, scaled_err(torch, out[i:i + 1], want,
                                  TOL["bfloat16"])[0])
        lse_err = max(lse_err, allclose_err(torch, lse[i:i + 1], want_lse,
                                            1e-4))
    dout = rand(b, h, s, dh)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                scale=dh**-0.5)
    worst = 0.0
    for i in (0, b - 1):
        leaves = [x[i:i + 1].detach().clone().requires_grad_()
                  for x in (q, k, v)]
        o = flash_attention_plain(*leaves, causal=True)
        want = torch.autograd.grad(o, leaves, dout[i:i + 1])
        for name, got_g, want_g in zip("qkv", grads, want):
            d = float((got_g[i:i + 1].float() - want_g.float()).abs().max())
            top = float(want_g.float().abs().max())
            need(bool(torch.isfinite(got_g).all()) and top > 0
                 and d <= 5e-2 * top,
                 f"FA2 d{name} of sequence {i} at [8,32,4096,64]: max |err| "
                 f"{d:.3e} beyond 5e-2 x max |g| {top:.3e}")
            worst = max(worst, d / top)
    log(f"K5 bfloat16 train_4k layer q[{b},{h},{s},{dh}] kv[{b},{hkv},{s},"
        f"{dh}] causal with lse: every sequence against the plain version "
        f"max_abs_err={err:.3e} lse max_abs_err={lse_err:.3e}; FA2 backward "
        f"of sequences 0 and {b - 1} against autograd of the plain version: "
        f"max |err| / max |g| = {worst:.3e}")
    del q, k, v, out, lse, dout, grads


def launch_decode_cell(torch, arch, cfg, shape, seed):
    """A decode cell on the card: the model at full width in bf16, a
    cache of seeded random values (``seq_len - 1`` tokens held), one warm
    step then ``LAUNCH_STEPS`` timed steps of ``serve_step_fn`` at
    ``pos = seq_len - 1``.  Returns (report row, params, cache)."""
    from repro_torch.kernels import LAUNCHES, reset_counts
    from repro_torch.models.model import build_model, layer_plan
    from repro_torch.serve import serve_step_fn

    plans = layer_plan(cfg)
    attn = sum(plans[i % len(plans)].mixer == "attn"
               for i in range(cfg.n_layers))
    lm = build_model(cfg)
    b, t = shape.global_batch, shape.seq_len
    kv = attn * 2 * b * cfg.n_kv_heads * t * cfg.resolved_head_dim * 2
    reckoned = kv + 2 * lm.n_params
    log(f"launch {arch} x {shape.name} reckoned device bytes: KV cache "
        f"{kv / 1e9:.2f} GB ({attn} attention layers x 2 x {b} x "
        f"{cfg.n_kv_heads} x {t} x {cfg.resolved_head_dim} x 2 B) + "
        f"weights {2 * lm.n_params / 1e9:.2f} GB = {reckoned / 1e9:.2f} GB")
    cost, count_s = count_cut(cfg, shape)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(seed=seed, dtype=torch.bfloat16)
    cache = lm.init_cache_fn(b, t, torch.bfloat16)
    randomize_cache(torch, cache, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b,), device="cuda",
                           generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = serve_step_fn(lm)
    out = {}

    def run():
        out["logits"], _ = step(params, cache, tokens, t - 1)

    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        reset_counts()
        ms = step_times(torch, run, LAUNCH_STEPS)
        launches = dict(LAUNCHES)
    need(bool(torch.isfinite(out["logits"]).all()),
         f"{arch} x {shape.name}: non-finite logits")
    need(launches["flash_decode"] == attn * LAUNCH_STEPS
         and launches["flash_attention"] == 0,
         f"{arch} x {shape.name}: K6 launched {launches['flash_decode']} "
         f"times in {LAUNCH_STEPS} steps, not {attn} x {LAUNCH_STEPS}")
    written = out["logits"].numel() * 2 + attn * 2 * b * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 2
    least = tensors_bytes(params, cache) + tokens.numel() * 8 + written
    row = launch_report(torch, arch, shape.name, cost, ms, least, reckoned,
                        torch.cuda.max_memory_allocated(), launches,
                        init_s=init_s, count_s=count_s)
    return row, launches, params, cache


def launch_path(torch):
    """Step 16: the dry-run, then its cells that fit one H100 at full
    width on the card (module docstring).  Returns the K5 / K6 launches
    of the cells' timed steps."""
    import gc

    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.kernels import LAUNCHES, reset_counts
    from repro_torch.models.model import build_model
    from repro_torch.train import (TrainConfig, adamw, init_train_state,
                                   make_train_step)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    launch_dryrun(torch)
    total = collections.Counter()
    g = torch.Generator(device="cuda").manual_seed(16)

    # tinyllama x decode_32k: K6 at T = 32,768
    cfg = get_arch("tinyllama_1_1b")
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=64)
    log("CUT: tinyllama_1_1b x decode_32k batch 64 instead of 128 (a 32k "
        "KV cache is 738 MB a sequence: 94.5 GB at 128, 47.2 GB at 64 on "
        "an 80 GB card); full depth and width")
    _, launches, params, cache = launch_decode_cell(torch, "tinyllama_1_1b",
                                                    cfg, shape, 21)
    total.update(launches)
    kc, vc = cache["layers"][0]["k"], cache["layers"][0]["v"]
    q = torch.randn(64, cfg.n_heads, cfg.resolved_head_dim, device="cuda",
                    generator=g).bfloat16()
    lens = torch.full((64,), shape.seq_len, dtype=torch.int32, device="cuda")
    check_k6_long(torch, "decode_32k", q, kc, vc, lens, shape.seq_len)
    del cache, kc, vc, q
    gc.collect()
    torch.cuda.empty_cache()

    # tinyllama x prefill_32k: K5 at S = T = 32,768
    shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=8)
    log("CUT: tinyllama_1_1b x prefill_32k batch 8 instead of 32 (the "
        "shape's own microbatch); full depth and width")
    b, s = shape.global_batch, shape.seq_len
    kv = cfg.n_layers * 2 * b * cfg.n_kv_heads * s * cfg.resolved_head_dim * 2
    act = b * s * cfg.d_model * 2
    mlp = b * s * cfg.d_ff * 2
    reckoned = kv + 2 * build_model(cfg).n_params + 3 * act + 4 * mlp
    log(f"launch tinyllama_1_1b x prefill_32k reckoned device bytes: cache "
        f"{kv / 1e9:.2f} GB, a layer's x {act / 1e9:.2f} GB, an MLP product "
        f"{mlp / 1e9:.2f} GB (its f32 SiLU twice that), weights "
        f"{tensors_bytes(params) / 1e9:.2f} GB: ~{reckoned / 1e9:.1f} GB")
    cost, count_s = count_cut(cfg, shape)
    lm = build_model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=g)
    out = {}

    def prefill():
        out["logits"], out["cache"] = lm.prefill_fn(params, {"tokens": tokens},
                                                    s)

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        prefill()
        torch.cuda.synchronize()
        reset_counts()
        ms = step_times(torch, prefill, LAUNCH_STEPS)
        launches = dict(LAUNCHES)
    need(bool(torch.isfinite(out["logits"]).all()),
         "tinyllama_1_1b x prefill_32k: non-finite logits")
    need(launches["flash_attention"] == cfg.n_layers * LAUNCH_STEPS,
         f"prefill_32k: K5 launched {launches['flash_attention']} times, not "
         f"{cfg.n_layers} x {LAUNCH_STEPS}")
    total.update(launches)
    least = (tensors_bytes(params) + tokens.numel() * 8
             + out["logits"].numel() * 2 + tensors_bytes(out["cache"]))
    launch_report(torch, "tinyllama_1_1b", "prefill_32k", cost, ms, least,
                  reckoned, torch.cuda.max_memory_allocated(), launches,
                  count_s=count_s)
    out.clear()
    gc.collect()
    torch.cuda.empty_cache()
    check_k5_long(torch, g)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # tinyllama x train_4k: K5 + the FA2 backward at S = 4,096
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=32,
                                microbatch=8)
    log("CUT: tinyllama_1_1b x train_4k global batch 32 instead of 256, "
        "microbatch 8 instead of 32 (4 accumulations; the f32 logits of a "
        "32 x 4,096 microbatch and their gradient alone are 33.6 GB); full "
        "depth, remat=full, AdamW, bf16 parameters; 1 warm step, 1 timed")
    b, s, mb = shape.global_batch, shape.seq_len, shape.microbatch
    n_params = build_model(cfg).n_params
    state_b = 2 * n_params + 8 * n_params  # bf16 weights, f32 mu and nu
    logits_b = mb * s * 32000 * 4
    remat_b = cfg.n_layers * mb * s * cfg.d_model * 2
    reckoned = state_b + 4 * n_params + 3 * logits_b + remat_b
    log(f"launch tinyllama_1_1b x train_4k reckoned device bytes: state "
        f"{state_b / 1e9:.1f} GB (bf16 weights, f32 moments), f32 gradient "
        f"sum {4 * n_params / 1e9:.1f} GB, remat boundaries "
        f"{remat_b / 1e9:.2f} GB, f32 logits {logits_b / 1e9:.1f} GB with "
        f"their gradient: ~{reckoned / 1e9:.1f} GB")
    cost, count_s = count_cut(cfg, shape)
    lm = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(seed=22, dtype=torch.bfloat16, requires_grad=True)
    opt, tcfg = adamw(), TrainConfig(microbatch=mb)
    holder = {"state": init_train_state(lm, opt, tcfg=tcfg, params=params)}
    step = make_train_step(lm, opt, tcfg)
    toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                         generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def train():
        holder["state"], holder["metrics"] = step(holder["state"], batch)

    train()
    torch.cuda.synchronize()
    reset_counts()
    ms = step_times(torch, train, 1)
    launches = dict(LAUNCHES)
    loss = float(holder["metrics"]["loss"])
    need(torch.isfinite(torch.tensor(loss)).item(), f"train_4k loss {loss}")
    want_k5 = (b // mb) * 2 * cfg.n_layers
    need(launches["flash_attention"] == want_k5,
         f"train_4k: K5 launched {launches['flash_attention']} times, not "
         f"{want_k5} (forward + remat recompute, {b // mb} microbatches)")
    total.update(launches)
    st = holder["state"]
    least = 2 * tensors_bytes(params, st.opt_state) + 2 * toks.numel() * 8
    launch_report(torch, "tinyllama_1_1b", "train_4k", cost, ms, least,
                  reckoned, torch.cuda.max_memory_allocated(), launches,
                  loss=loss, count_s=count_s)
    del holder, st, params, step, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    check_k5_train(torch, g)
    gc.collect()
    torch.cuda.empty_cache()

    # rwkv6 x long_500k: the recurrent state, no kernel of the repo's
    cfg = get_arch("rwkv6_1_6b")
    shape = SHAPES["long_500k"]
    _, launches, params, cache = launch_decode_cell(torch, "rwkv6_1_6b", cfg,
                                                    shape, 23)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    # jamba x long_500k, one period of 8 layers: K6 at T = 524,288
    full = get_arch("jamba_v0_1_52b")
    cfg = dataclasses.replace(full, n_layers=8)
    log(f"CUT: jamba_v0_1_52b x long_500k n_layers=8 instead of "
        f"{full.n_layers} (one period: 7 Mamba layers, 1 attention, 4 MoE; "
        "all 32 layers are 104 GB in bf16); batch 1, full width")
    _, launches, params, cache = launch_decode_cell(
        torch, "jamba_v0_1_52b", cfg, shape, 24)
    total.update(launches)
    lc = next(c for c in cache["layers"] if "k" in c)
    q = torch.randn(1, cfg.n_heads, cfg.resolved_head_dim, device="cuda",
                    generator=g).bfloat16()
    lens = torch.full((1,), shape.seq_len, dtype=torch.int32, device="cuda")
    check_k6_long(torch, "long_500k", q, lc["k"], lc["v"], lens,
                  shape.seq_len)
    del params, cache, lc, q
    gc.collect()
    torch.cuda.empty_cache()
    log(f"launch phase body {time.perf_counter() - t_phase:.3f} s")
    return {name: total[name] for name in LM_KERNELS}



# ---------------------------------------------------------------------------
# Step 17: the examples phase
# ---------------------------------------------------------------------------

# the six entry points at the reference scripts' defaults; train_lm writes
# its checkpoints under build/ (its default directory could hold a run to
# resume)
EXAMPLES_CKPT = ROOT / "build" / "examples_ckpt"
EXAMPLE_ARGS = {
    "quickstart": [],
    "serve_ann": [],
    "build_spot_index": [],
    "lm_embed_index": [],
    "train_lm": ["--ckpt-dir", str(EXAMPLES_CKPT)],
    "serve_lm": [],
}
EXAMPLE_MARKERS = {
    "quickstart": ("recall@10",),
    "serve_ann": ("achieved QPS", "recall@10"),
    "build_spot_index": ("recall@10", "simulated [cost_greedy]"),
    "lm_embed_index": ("recall@10", "self-token found"),
    "train_lm": ("checkpoint →", "done: final loss"),
    "serve_lm": ("served 6 requests",),
}
EXAMPLE_RECALL_TOL = 0.01  # f32/bf16 quickstart recall, card against CPU
# the parts of a quickstart line that are timings, paths or the card-only
# near-tie report; the rest must be reproduced
QUICKSTART_UNTIMED = re.compile(
    r"p95 = [\d.]+ ms  mean batch = [\d.]+|\(\$[\d.]+ at spot prices\)|"
    r"  rows differ: \([^)]*\), near-ties: \([^)]*\)|open \S+ at")


def quickstart_fields(lines: list) -> list:
    """``(label, recall@10 or None, other numbers)`` of each quickstart line
    the card's run must reproduce; the timing lines (partition, build) are
    left out."""
    out = []
    for line in lines:
        if line.startswith(("partition ", "[build]")):
            continue
        line = QUICKSTART_UNTIMED.sub("", line)
        label = line.split("]")[0] + "]" if line.startswith("[") else \
            line.split()[0]
        m = re.search(r"recall@10 = ([\d.]+)", line)
        recall = float(m.group(1)) if m else None
        if m:
            line = line.replace(m.group(0), "")
        out.append((label, recall, re.findall(r"\d+(?:\.\d+)?",
                                              line[len(label):])))
    return out


def check_quickstart(card_out: str, cpu_out: str) -> None:
    """The card's quickstart: every printed check holds (fleet graphs, the
    trace, the deleted id, recovery; ``fused`` uint8 ids equal to
    ``torch``'s, f32 equal or differing at near-ties only), and its lines
    are the CPU run's: every counter and the uint8 lines equal, f32/bf16
    recall within ``EXAMPLE_RECALL_TOL``."""
    lines = card_out.splitlines()

    def line_of(prefix):
        hit = [ln for ln in lines if ln.startswith(prefix)]
        need(len(hit) == 1, f"quickstart printed {len(hit)} {prefix!r} lines")
        return hit[0]

    for prefix, want in (
        ("[fleet]", "graphs identical to uninterrupted build: True"),
        ("[trace]", "kill->backoff->resume on the timeline: True"),
        ("[live] gen", "returned anywhere: False"),
        ("[durability] recovered", "identical to the uncrashed run: True"),
        ("[fused/uint8]", "ids identical to torch: True"),
    ):
        need(want in line_of(prefix), f"quickstart on the card: "
             f"{line_of(prefix)!r} lacks {want!r}")
    fused = line_of("[fused] ")
    if "ids identical to torch: False" in fused:
        m = re.search(r"rows differ: \(([^)]*)\), near-ties: \(([^)]*)\)",
                      fused)
        need(m is not None, f"quickstart's fused line: {fused!r}")
        ties = [t.strip() for t in m.group(2).split(",") if t.strip()]
        need(ties and all(t == "True" for t in ties), "fused f32 ids on the "
             f"card differ from torch's beyond near-ties: {fused!r}")
        log(f"examples quickstart fused f32: rows {m.group(1)} differ from "
            "torch, each at a near-tie")
    else:
        need("ids identical to torch: True" in fused, fused)
    card, cpu = (quickstart_fields(o.splitlines())
                 for o in (card_out, cpu_out))
    need([c[0] for c in card] == [c[0] for c in cpu],
         f"quickstart lines card {[c[0] for c in card]} against CPU "
         f"{[c[0] for c in cpu]}")
    worst = 0.0
    for (label, r_card, n_card), (_, r_cpu, n_cpu) in zip(card, cpu):
        need(n_card == n_cpu, f"quickstart {label} counters on the card "
             f"{n_card} against the CPU's {n_cpu}")
        if r_card is None:
            continue
        if "uint8" in label:
            need(r_card == r_cpu, f"quickstart {label} recall on the card "
                 f"{r_card} against the CPU's {r_cpu}")
        worst = max(worst, abs(r_card - r_cpu))
        need(abs(r_card - r_cpu) <= EXAMPLE_RECALL_TOL, f"quickstart "
             f"{label} recall on the card {r_card} against the CPU's "
             f"{r_cpu}")
    log(f"examples quickstart card against CPU: {len(card)} lines, counters "
        f"equal, uint8 lines equal, largest recall difference {worst:.3f}")


def check_capture_streams(torch) -> None:
    """A prune capture's side stream is never one the default-priority
    pool hands out (a fleet worker's): 64 of each, no stream shared."""
    from repro_torch.core import vamana

    dev = torch.device("cuda")
    pooled = {torch.cuda.Stream(dev).cuda_stream for _ in range(64)}
    sides = {vamana._capture_stream(dev).cuda_stream for _ in range(64)}
    log(f"examples capture streams: {len(pooled)} default-pool streams, "
        f"{len(sides)} capture side streams, {len(pooled & sides)} shared")
    need(not pooled & sides, "a prune capture's side stream is a stream "
         "of the pool the fleet's workers draw from")


def examples_path(torch, card: str):
    """The six entry points of ``repro_torch.examples`` on the card (step
    17), each ``main([...])`` called in process at the reference scripts'
    defaults, every counter zeroed just before the first and read just
    after the last; then the quickstart runs once more with ``--device
    cpu`` in a subprocess (after the card's scripts, which are host-bound
    and timed), and the card's lines are held to it.  Returns the phase's
    launches."""
    import importlib
    import io
    import math
    import shutil

    from repro_torch.kernels import LAUNCHES, reset_counts

    t_phase = time.perf_counter()
    tmp = ROOT / "build" / "examples_cpu_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp), OMP_NUM_THREADS="4")
    cpu = None
    try:
        check_capture_streams(torch)
        torch.cuda.synchronize()
        reset_counts()
        outs, walls = {}, {}
        for name, args in EXAMPLE_ARGS.items():
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            before = dict(LAUNCHES)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(args)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            outs[name] = buf.getvalue()
            for line in outs[name].splitlines():
                log(f"example {name} | {line}")
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                        if LAUNCHES[k] != before[k]}
            log(f"example {name}: exit {rc}, wall {walls[name]:.3f} s on "
                f"{card}, launches {launched}")
            need(rc == 0, f"example {name} exited {rc}")
            for marker in EXAMPLE_MARKERS[name]:
                need(marker in outs[name], f"example {name} did not print "
                     f"{marker!r}")
        launches = dict(LAUNCHES)
        loss = float(outs["train_lm"].split("done: final loss")[1].split()[0])
        need(math.isfinite(loss), f"train_lm's final loss {loss}")
        t0 = time.perf_counter()
        cpu = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.examples.quickstart",
             "--device", "cpu"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        cpu_out, cpu_err = cpu.communicate(timeout=900)
        log(f"example quickstart (cpu): wall {time.perf_counter() - t0:.3f} "
            "s on the host")
    finally:
        if cpu is not None and cpu.poll() is None:
            cpu.kill()
            cpu.wait()
        shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    need(cpu.returncode == 0, "quickstart --device cpu exited "
         f"{cpu.returncode}: {cpu_err[-2000:]}")
    for line in cpu_out.splitlines():
        log(f"example quickstart (cpu) | {line}")
    shutil.rmtree(tmp, ignore_errors=True)
    check_quickstart(outs["quickstart"], cpu_out)
    log("examples " + json.dumps({
        "wall_s": walls, "launches": launches, "card": card}))
    for name in ANN_KERNELS + BUILD_KERNELS + LM_KERNELS:
        need(launches[name] > 0, f"the examples phase never launched {name}")
    log(f"examples phase body {time.perf_counter() - t_phase:.3f} s")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--vamana-n", type=int, default=50_000)
    ap.add_argument("--fleet-n", type=int, default=200_000)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.n != 1_000_000:
        log(f"CUT: n={args.n} instead of 1,000,000 (SIFT1M/BIGANN-1M shape)")
    log(f"CUT: DiskANN phase n={args.vamana_n} instead of 1,000,000 (the "
        "run's time limit; 50,000 by default since the live phase)")
    log(f"CUT: fleet phase n={args.fleet_n} instead of 1,000,000 (the run's "
        "time limit)")
    t_start = time.perf_counter()
    card = environment(torch)
    from repro_torch.kernels import LAUNCHES

    rows = {name: dict(name=name, route="cuda", launches=0)
            for name in LAUNCHES}
    meta = {
        "pairwise_distance": ("src/repro_torch/kernels/csrc/distance.cu",
                              "src/repro/kernels/distance.py:155"),
        "pairwise_distance_u8": ("src/repro_torch/kernels/csrc/distance.cu",
                                 "src/repro/kernels/distance.py:116"),
        "fused_beam": ("src/repro_torch/kernels/csrc/beam.cu",
                       "src/repro/kernels/beam.py:593"),
        "knn": ("src/repro_torch/kernels/csrc/knn.cu",
                "src/repro/kernels/topk.py:159"),
        "flash_attention": ("src/repro_torch/kernels/csrc/attention.cu",
                            "src/repro/kernels/flash_attention.py:81"),
        "flash_decode": ("src/repro_torch/kernels/csrc/attention.cu",
                         "src/repro/kernels/flash_attention.py:189"),
        "merge_rows": ("src/repro_torch/kernels/csrc/merge.cu",
                       "none: the reference merges on the host in numpy "
                       "(src/repro/core/merge.py:152)"),
    }
    for name, (src, rep) in meta.items():
        rows[name].update(source=src, replaces=rep)

    t0 = time.perf_counter()
    with k1_tally() as k1_shapes, k3_tally() as (k3_shapes, k3_first):
        ds, res, merged, split, launches, recalls = main_path(torch, args)
    log(f"main path {time.perf_counter() - t0:.3f} s")
    for name, count in launches.items():
        rows[name]["launches"] = count
    floor = launch_floor_ms(torch)
    log(f"launch floor: an empty kernel from a CUDA graph {floor:.5f} ms")
    check_k1(torch, rows, k1_shapes, floor)
    check_k2(torch, rows, ds, split, floor)
    check_distance_variants(torch)
    check_k4(torch, rows, ds, res)
    check_merge(torch, rows, ds, res)
    check_k3(torch, rows, ds, merged)
    k3_by_q(torch, k3_shapes, k3_first)
    del k3_first
    check_small_against_cpu(torch)
    t0 = time.perf_counter()
    for name, count in serving_path(torch, ds, res, merged, split).items():
        rows[name]["launches"] += count
    log(f"serving phase {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for name, count in live_path(torch, ds, res, split, recalls).items():
        rows[name]["launches"] += count
    log(f"live phase {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    dk_ds, dk_res, dk_topo, dk_first, dk_launches = diskann_path(torch, args)
    for name, count in dk_launches.items():
        rows[name]["launches"] += count
    check_torch_backend(torch, dk_ds, dk_topo)
    check_vamana_round(torch, dk_res)
    check_k3_build_shape(torch, dk_first)
    del dk_ds, dk_res, dk_topo, dk_first
    log(f"DiskANN phases {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for name, count in fleet_path(torch, args).items():
        rows[name]["launches"] += count
    log(f"fleet phase {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    lm_launches, longest, engine = lm_path(torch)
    for name, count in lm_launches.items():
        rows[name]["launches"] = count
    lm_breakdown(torch, engine)
    waves = [(w.batch, w.prompt_len) for w in engine.waves]
    t1 = time.perf_counter()
    for name, count in retrieval_path(torch, engine).items():
        rows[name]["launches"] += count
    log(f"retrieval attention phase {time.perf_counter() - t1:.3f} s")
    del engine
    check_k5(torch, rows, waves)
    check_k6(torch, rows, longest)
    check_k6_scratch(torch)
    check_small_lm_against_cpu(torch)
    log(f"LM phases {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for name, count in families_path(torch).items():
        rows[name]["launches"] += count
    check_family_kernels(torch)
    log(f"LM families phase {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for name, count in train_path(torch).items():
        rows[name]["launches"] += count
    log(f"training phase {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for name, count in launch_path(torch).items():
        rows[name]["launches"] += count
    log(f"launch phase {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for name, count in examples_path(torch, card).items():
        rows[name]["launches"] += count
    log(f"examples phase {time.perf_counter() - t0:.3f} s")
    log(f"total {time.perf_counter() - t_start:.3f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K4's row also carries its streamed panel at GIST-960's shapes
    print(json.dumps({"kernels": [
        {k: rows[n][k] for k in keys + ("streamed",) if k in rows[n]}
        for n in LAUNCHES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
