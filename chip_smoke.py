#!/usr/bin/env python3
"""Smoke run of ``repro_torch`` on one NVIDIA H100.

    python3 chip_smoke.py [--n 1000000] [--queries 10000] [--vamana-n 100000]

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the four CUDA sources (one ``nvcc`` per source, in
   parallel, into ``build/repro_torch_kernels``).
2. ANN main path, with every launch counter zeroed just before and read
   just after: ``make_clustered(n, 128, n_queries, seed=0)`` (SIFT1M/
   BIGANN-1M's shape, ground truth from K4), ``build_scalegann`` with the
   ``IndexConfig`` defaults (16 clusters, R=64, L=128, ε=1.2, ω=2), merged
   search at k=10, width=64 in f32, bf16 and uint8, and routed split search
   with nprobe=2 and "auto" in f32 and uint8.  K1–K4 must have launched.
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
   at one shard's shape with k=129 beside cdist + topk; K3 on the built
   merged graph for 256 queries and for the merged search's own
   10,000-query launch, in f32, bf16 and uint8 (uint8 traversal and
   re-ranked ids, distances and counters bit-exact; bf16 re-ranked
   distances bit-equal wherever the ids agree), with its resident blocks
   per SM, then at every launch shape of the main path on that launch's
   own inputs (time and bound summed by range of Q).
4. A small index searched on the card and on the CPU's plain path: the
   same ids and stats (uint8 exact).
5. DiskANN path, counters zeroed just before and read just after:
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
   edges on the card against the CPU on integer points (equal), and K3 at
   the build shape against its plain version (ids and counters on 99.9%).
6. LM main path, counters zeroed just before and read just after:
   TinyLlama-1.1B at full width (22 layers, d_model 2048, GQA 32/4) with
   seeded random weights in bf16, ``ServeEngine`` with 8 slots and
   max_len 2048 serving 12 greedy requests (prompts of 512–1024 tokens,
   64 new tokens each) in two waves.  K5 must launch once per layer and
   wave, K6 once per layer and decode step.  Then one prefill and three
   decode steps under torch.profiler: host wall time against device busy
   time, and the kernels that take it.
7. K5 against its plain version in bf16 (rtol=atol=8e-3) at each wave's
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
8. The small TinyLlama config in f32, prefill and 4 decode steps on the
   card and on the CPU's plain path: logits to 1e-4, greedy tokens equal.

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
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12     # outside the tensor cores (no TF32)
H100_INT8_OPS = 1979e12     # dense int8 tensor-core rate
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core rate
H100_HBM_BYTES = 3.35e12    # HBM3 bytes per second


ANN_KERNELS = ("pairwise_distance", "pairwise_distance_u8", "fused_beam", "knn")
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
    from repro_torch.kernels import LAUNCHES, reset_counts
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
    launches = {name: LAUNCHES[name] for name in ANN_KERNELS}
    log(f"main-path launches {json.dumps(launches)}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} was not launched on the main path")
    # a sanity floor only: agreement with the plain path is checked below
    need(results[("merged", None, "f32")] >= 0.3,
         f"merged f32 recall@10 {results[('merged', None, 'f32')]:.4f} "
         "below 0.3")
    return ds, res, merged, split, launches


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


def near_ties(torch, q, x, got_ids, want_ids, rtol: float,
               metric: str = "l2") -> int:
    """Count positions where two id lists differ by more than a near-tie:
    both ids' distances to the row's query, in float64, within ``rtol``."""
    rows, cols = torch.nonzero(got_ids != want_ids, as_tuple=True)
    if rows.numel() == 0:
        return 0
    a, b = got_ids[rows, cols].long(), want_ids[rows, cols].long()
    if bool(((a < 0) | (b < 0)).any()):
        return int(rows.numel())
    qd = q[rows].double()
    if metric == "ip":
        da = -(x[a].double() * qd).sum(dim=1)
        db = -(x[b].double() * qd).sum(dim=1)
    else:
        da = ((x[a].double() - qd) ** 2).sum(dim=1)
        db = ((x[b].double() - qd) ** 2).sum(dim=1)
    return int(((da - db).abs() > rtol * db.abs().clamp_min(1e-30)).sum())


def check_k4(torch, rows, ds, res):
    """K4 against its plain version: the tie-exact case (ids equal), the
    edge cases, ground truth's last block, then the largest shard (ids equal
    up to near-ties) with its timings beside cdist and topk."""
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
        bad = 0 if same else near_ties(torch, q, x, gi, wi, 1e-5, metric)
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
    bad = near_ties(torch, q, x, gi, wi, 1e-5)
    log(f"K4 ids differing beyond a 1e-5 relative near-tie: {bad}")
    need(err <= 1e-5 * float(wd.abs().max()) + 1e-4, "K4 distances disagree")
    need(bad == 0, "K4 ids disagree beyond near-ties")
    need(ms < cd_ms + tk_ms, "K4 is slower than cdist + topk")
    b, by = bound_ms((m + n) * d * 4 + m * k * 8, 2 * m * n * d,
                     H100_FP32_FLOPS)
    rows["knn"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b, bound_by=by, library_ms=None)
    del gd, gi, wd, wi, q, x

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
                bad = near_ties(torch, qf, exact.x, got[0], want[0], 1e-5)
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


@contextlib.contextmanager
def k3_build_timer(torch, pool: int):
    """Time every K3 launch at the Vamana build shape (k == width == the
    pool) with CUDA events around the C launch alone (the wrapper's checks
    stay outside), beside (not instead of) its launch counter, and keep the
    first such launch's inputs."""
    from repro_torch.kernels import beam

    events: list = []
    first: dict = {}
    on = [False]
    launch = beam.fused_beam_cuda
    lib = beam._lib()
    c_launch = lib.repro_fused_beam

    def timed(x, graph, entries, queries, k, **kw):
        if k != pool or kw.get("width") != pool:
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
    from repro_torch.kernels import LAUNCHES, beam, reset_counts
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
    with k3_build_timer(torch, pool) as (events, first), \
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
    launches = {name: LAUNCHES[name] for name in ANN_KERNELS}
    log(f"diskann-path launches {json.dumps(launches)}")
    for name in ("pairwise_distance", "fused_beam", "knn"):
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
        bad = near_ties(torch, torch.from_numpy(q).cuda(), x,
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
    card and on the CPU from the same pool and graph.  Every distance is
    an exact integer, so the kept ids, the graph and the distance counter
    must be equal.  The card's round is timed by phase, then profiled:
    kernels launched and device busy time against its wall time."""
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
    log(f"vamana round on integer points (n={n}, 256 points, pool {pool}): "
        f"card vs CPU keep/graph/counter equal={same} counter={cc}; card "
        f"beam {1e3 * tb:.2f} ms, prune {1e3 * tp:.2f} ms, reverse edges "
        f"{1e3 * tr:.2f} ms; CPU prune {1e3 * hp:.1f} ms, reverse edges "
        f"{1e3 * hr:.1f} ms")
    need(all(same), "a Vamana round's prune on the card differs from the CPU")
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


def lm_breakdown(torch, engine, batch: int = 8, prompt: int = 1000):
    """Where a prefill and a decode step spend their time: host wall time
    against device busy time (sum of kernel times) under torch.profiler,
    outside the timed run.  Launches made here are not counted as the
    main path's."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, engine.model.cfg.vocab_size, (batch, prompt),
                         device="cuda", generator=gen)
    logits, cache = engine._prefill(toks)
    tok = logits[:, :engine.model.cfg.vocab_size].argmax(-1)
    engine._decode(cache, tok, prompt)
    torch.cuda.synchronize()

    def report(what, fn, n):
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
        kernels = sum(e.count for e in rows) / n
        top = ", ".join(f"{e.key[:48]} {e.self_device_time_total / n / 1e3:.3f}"
                        for e in rows[:5])
        log(f"LM {what} (batch {batch}, {prompt} tokens, profiled): "
            f"wall_ms={wall:.3f} device_busy_ms={busy:.3f} "
            f"device_idle_share={1 - busy / wall:.3f} "
            f"device_ops={kernels:.0f} top_ms: {top}")

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


def check_small_lm_against_cpu(torch):
    """The small TinyLlama config in f32 on the card (K5, K6) and on the
    CPU (plain versions): logits to 1e-4 and the same greedy tokens."""
    import numpy as np

    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.models.model import build_model, cast_params

    cfg = smoke_config(get_arch("tinyllama_1_1b"))
    lm = build_model(cfg)
    on_cpu = lm.init(seed=0, device="cpu")
    on_card = cast_params(cfg, on_cpu, torch.float32, "cuda")
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (3, 150))
    toks[0, :40] = 0  # left padding
    f32 = dict(dtype=torch.float32)
    runs = {}
    for dev, params in (("cuda", on_card), ("cpu", on_cpu)):
        logits, cache = lm.prefill_fn(
            params, {"tokens": torch.from_numpy(toks).to(dev)}, 160, **f32)
        out, tokens = [logits.cpu()], []
        for step in range(4):
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            tokens.append(tok.cpu())
            logits, cache = lm.decode_fn(params, cache, tok, 150 + step,
                                         **f32)
            out.append(logits.cpu())
        runs[dev] = (out, tokens)
    err = max(allclose_err(torch, a, b, 1e-4)
              for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    same = all(torch.equal(a, b) for a, b in zip(runs["cuda"][1],
                                                 runs["cpu"][1]))
    log(f"small LM (f32, {cfg.n_layers} layers, head_dim 16) card vs CPU: "
        f"max_abs_err={err:.3e} greedy_equal={same}")
    need(same, "greedy tokens on the card differ from the CPU's")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--vamana-n", type=int, default=100_000)
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
    log(f"CUT: DiskANN phase n={args.vamana_n} instead of 1,000,000 (its "
        "host merge and the run's time limit)")
    t_start = time.perf_counter()
    card = environment(torch)
    from repro_torch.kernels import LAUNCHES

    rows = {name: dict(name=name, route="cuda") for name in LAUNCHES}
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
    }
    for name, (src, rep) in meta.items():
        rows[name].update(source=src, replaces=rep)

    t0 = time.perf_counter()
    with k1_tally() as k1_shapes, k3_tally() as (k3_shapes, k3_first):
        ds, res, merged, split, launches = main_path(torch, args)
    log(f"main path {time.perf_counter() - t0:.3f} s")
    for name, count in launches.items():
        rows[name]["launches"] = count
    floor = launch_floor_ms(torch)
    log(f"launch floor: an empty kernel from a CUDA graph {floor:.5f} ms")
    check_k1(torch, rows, k1_shapes, floor)
    check_k2(torch, rows, ds, split, floor)
    check_distance_variants(torch)
    check_k4(torch, rows, ds, res)
    check_k3(torch, rows, ds, merged)
    k3_by_q(torch, k3_shapes, k3_first)
    del k3_first
    check_small_against_cpu(torch)
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
    lm_launches, longest, engine = lm_path(torch)
    for name, count in lm_launches.items():
        rows[name]["launches"] = count
    lm_breakdown(torch, engine)
    waves = [(w.batch, w.prompt_len) for w in engine.waves]
    del engine
    check_k5(torch, rows, waves)
    check_k6(torch, rows, longest)
    check_k6_scratch(torch)
    check_small_lm_against_cpu(torch)
    log(f"LM phases {time.perf_counter() - t0:.3f} s")
    log(f"total {time.perf_counter() - t_start:.3f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys}
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
