#!/usr/bin/env python3
"""Smoke run of ``repro_torch`` on one NVIDIA H100.

    python3 chip_smoke.py [--n 1000000] [--queries 10000]

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the four CUDA kernels (one ``nvcc`` per source, in
   parallel, into ``build/repro_torch_kernels``).
2. Main path, with every launch counter zeroed just before and read just
   after: ``make_clustered(n, 128, n_queries, seed=0)`` (SIFT1M/BIGANN-1M's
   shape, ground truth from K4), ``build_scalegann`` with the
   ``IndexConfig`` defaults (16 clusters, R=64, L=128, ε=1.2, ω=2), merged
   search at k=10, width=64 in f32, bf16 and uint8, and routed split search
   with nprobe=2 and "auto" in f32 and uint8.  Every kernel must have
   launched.
3. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes: K1 [4096,128]x[65536,128] (f32/bf16, L2/IP), K2 at the
   routing tile (L2 bit-exact), K4 at one shard's shape with k=129, K3 on
   the built merged graph for 256 queries in f32, bf16 and uint8 (uint8
   ids and counters exact).  Times come from CUDA events.
4. A small index searched on the card and on the CPU's plain path: the
   same ids and stats (uint8 exact).

Prints one ``{"kernels": [...]}`` line, then the card's line, then
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero on any
failure, and when CUDA is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12     # outside the tensor cores (no TF32)
H100_INT8_OPS = 1979e12     # dense int8 tensor-core rate
H100_HBM_BYTES = 3.35e12    # HBM3 bytes per second


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
    launches = dict(LAUNCHES)
    log(f"main-path launches {json.dumps(launches)}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} was not launched on the main path")
    # a sanity floor only: agreement with the plain path is checked below
    need(results[("merged", None, "f32")] >= 0.3,
         f"merged f32 recall@10 {results[('merged', None, 'f32')]:.4f} "
         "below 0.3")
    return ds, res, merged, split, launches


def check_k1(torch, rows):
    from repro_torch.kernels import distance

    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(4096, 128, device="cuda", generator=g)
    x = torch.randn(65536, 128, device="cuda", generator=g)
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        for metric in ("l2", "ip"):
            qq, xx = q.to(dtype), x.to(dtype)
            got = distance.pairwise_distance_cuda(qq, xx, metric)
            want = distance.pairwise_distance_plain(qq, xx, metric)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ms = events_ms(torch, lambda: distance.pairwise_distance_cuda(
                qq, xx, metric))
            plain_ms = events_ms(torch, lambda: distance
                                 .pairwise_distance_plain(qq, xx, metric))
            if metric == "l2" and dtype == torch.float32:
                lib = events_ms(torch, lambda: torch.cdist(qq, xx))
            else:
                lib = events_ms(torch, lambda: torch.mm(qq, xx.T))
            log(f"K1 {str(dtype)[6:]} {metric} [4096,128]x[65536,128] "
                f"max_abs_err={err:.3e} (max |d| {scale:.1f}) ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib:.4f} "
                f"({'cdist' if metric == 'l2' and dtype == torch.float32 else 'mm'})")
            need(err <= 1e-5 * scale + 1e-3, f"K1 {dtype} {metric} disagrees")
            if entry is None:
                m, n, d = 4096, 65536, 128
                b, by = bound_ms((m + n) * d * 4 + m * n * 4, 2 * m * n * d,
                                 H100_FP32_FLOPS)
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=lib)
    rows["pairwise_distance"].update(entry)


def check_k2(torch, rows, ds, split):
    import numpy as np

    from repro_torch.kernels import distance

    codes, spec, _ = split.centroid_quant()
    cq = torch.from_numpy(spec.quantize(ds.queries)).cuda()
    cx = torch.from_numpy(np.ascontiguousarray(codes)).cuda()
    m, n, d = cq.shape[0], cx.shape[0], cq.shape[1]
    for metric in ("ip", "l2"):
        got = distance.pairwise_distance_u8_cuda(cq, cx, spec.scale,
                                                 spec.zero_point, metric)
        want = distance.pairwise_distance_u8_plain(cq, cx, spec.scale,
                                                   spec.zero_point, metric)
        err = float((got - want).abs().max())
        ms = events_ms(torch, lambda: distance.pairwise_distance_u8_cuda(
            cq, cx, spec.scale, spec.zero_point, metric), reps=10)
        plain_ms = events_ms(torch, lambda: distance.pairwise_distance_u8_plain(
            cq, cx, spec.scale, spec.zero_point, metric), reps=10)
        log(f"K2 uint8 {metric} [{m},{d}]x[{n},{d}] max_abs_err={err:.3e} "
            f"bit_exact={bool(torch.equal(got, want))} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f}")
        if metric == "l2":
            need(torch.equal(got, want), "K2 uint8 L2 is not bit-exact")
        else:
            need(err <= 1e-5 * float(want.abs().max()) + 1e-4,
                 "K2 uint8 ip disagrees")
    b, by = bound_ms((m + n) * d + m * n * 4, 2 * m * n * d, H100_INT8_OPS)
    rows["pairwise_distance_u8"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None)


def near_ties(torch, q, x, got_ids, want_ids, rtol: float) -> int:
    """Count positions where two id lists differ by more than a near-tie:
    both ids' distances to the row's query, in float64, within ``rtol``."""
    rows, cols = torch.nonzero(got_ids != want_ids, as_tuple=True)
    if rows.numel() == 0:
        return 0
    a, b = got_ids[rows, cols].long(), want_ids[rows, cols].long()
    if bool(((a < 0) | (b < 0)).any()):
        return int(rows.numel())
    qd = q[rows].double()
    da = ((x[a].double() - qd) ** 2).sum(dim=1)
    db = ((x[b].double() - qd) ** 2).sum(dim=1)
    return int(((da - db).abs() > rtol * db.abs().clamp_min(1e-30)).sum())


def check_k4(torch, rows, ds, res):
    import numpy as np

    from repro_torch.kernels import topk

    big = max(res.shards, key=lambda s: len(s.ids))
    x = torch.from_numpy(np.ascontiguousarray(ds.data[big.ids])).cuda()
    q = x[:4096].contiguous()
    k = 129
    gd, gi = topk.knn_cuda(q, x, k)
    wd, wi = topk.knn_plain(q, x, k)
    err = float((gd - wd).abs().max())
    agree = float((gi.long() == wi).float().mean())
    ms = events_ms(torch, lambda: topk.knn_cuda(q, x, k), reps=2)
    plain_ms = events_ms(torch, lambda: topk.knn_plain(q, x, k), reps=2)
    cd_ms = events_ms(torch, lambda: torch.cdist(q, x), reps=2)
    dist = torch.cdist(q, x)
    tk_ms = events_ms(torch, lambda: torch.topk(dist, k, largest=False), reps=2)
    m, n, d = q.shape[0], x.shape[0], q.shape[1]
    log(f"K4 knn [{m},{d}]x[{n},{d}] k={k} max_abs_err={err:.3e} "
        f"id_agreement={agree:.6f} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"cdist_ms={cd_ms:.4f} topk_ms={tk_ms:.4f}")
    bad = near_ties(torch, q, x, gi, wi, 1e-5)
    log(f"K4 ids differing beyond a 1e-5 relative near-tie: {bad}")
    need(err <= 1e-5 * float(wd.abs().max()) + 1e-4, "K4 distances disagree")
    need(bad == 0, "K4 ids disagree beyond near-ties")
    b, by = bound_ms((m + n) * d * 4 + m * k * 8, 2 * m * n * d,
                     H100_FP32_FLOPS)
    rows["knn"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b, bound_by=by, library_ms=None)


def check_k3(torch, rows, ds, merged):
    import numpy as np

    from repro_torch.kernels import beam
    from repro_torch.search.fused_backend import _prep_queries, _prepared

    queries = ds.queries[:256]
    entries = torch.from_numpy(
        merged.index.entry_points(16).astype(np.int32)).cuda()
    exact = _prepared(merged.data, merged.index.graph, None,
                      torch.device("cuda"))
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
        want = beam.fused_beam_plain(prep.x, prep.graph, entries, q, kq, **kw)
        ids_eq = float((got[0] == want[0]).float().mean())
        stats_eq = float(((got[2] == want[2]) & (got[3] == want[3])
                          & (got[4] == want[4])).float().mean())
        same = got[0] == want[0]
        fin = torch.isfinite(want[1]) & same
        err = float((got[1] - want[1])[fin].abs().max()) if fin.any() else 0.0
        ms = events_ms(torch, lambda: beam.fused_beam_cuda(
            prep.x, prep.graph, entries, q, kq, aux=prep.aux, **kw), reps=3)
        t0 = time.perf_counter()
        beam.fused_beam_plain(prep.x, prep.graph, entries, q, kq, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        nd, hops, nrr = (int(t.sum()) for t in got[2:])
        itemsize = prep.x.element_size()
        d, r = prep.x.shape[1], prep.graph.shape[1]
        n_bytes = (nd * d * itemsize + hops * r * 4 + nrr * d * 4
                   + q.numel() * q.element_size())
        b, by = bound_ms(n_bytes, 2 * nd * d, H100_FP32_FLOPS)
        log(f"K3 fused_beam {dtype} Q=256 N={prep.x.shape[0]} width=64 "
            f"k={kq} rerank={'10' if extra else '-'} id_agreement={ids_eq:.6f} "
            f"stats_agreement={stats_eq:.6f} max_abs_err={err:.3e} "
            f"ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={b:.4f} "
            f"(n_dist={nd} hops={hops} n_rerank={nrr})")
        if dtype == "uint8":
            need(ids_eq == 1.0 and stats_eq == 1.0,
                 "K3 uint8 ids/stats are not bit-exact")
        else:
            need(ids_eq >= 0.99 and stats_eq >= 0.95,
                 f"K3 {dtype} disagrees beyond near-ties")
            need(err <= 2e-3 + 1e-4 * float(want[1][fin].abs().max()),
                 f"K3 {dtype} distances disagree")
        if dtype == "f32":
            rows["fused_beam"].update(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=b,
                                      bound_by=by, library_ms=None)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
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
    }
    for name, (src, rep) in meta.items():
        rows[name].update(source=src, replaces=rep)

    t0 = time.perf_counter()
    ds, res, merged, split, launches = main_path(torch, args)
    log(f"main path {time.perf_counter() - t0:.3f} s")
    for name, count in launches.items():
        rows[name]["launches"] = count
    check_k1(torch, rows)
    check_k2(torch, rows, ds, split)
    check_k4(torch, rows, ds, res)
    check_k3(torch, rows, ds, merged)
    check_small_against_cpu(torch)
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
