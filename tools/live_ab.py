#!/usr/bin/env python3
"""Run ``chip_smoke.live_path`` of this checkout and of another checkout
on one NVIDIA H100, over one shared 1M build, and profile a Vamana round
beside the server.

    python3 tools/live_ab.py --base NAME=DIR [--n 1000000] [--queries 10000]
                             [--profile-call 2] [--out chiprun_out/live_ab]

DIR is the root of another checkout (a commit unpacked with ``git
archive`` into an ignored directory).  This checkout's ANN main path
(``chip_smoke.main_path``) builds the 1M index once and pickles what the
live phase needs under ``build/live_ab/``; then each checkout, the base
first, runs its own ``chip_smoke.live_path`` in a process of its own, with
its own package and kernels, on that build.  Each process reports:

* a Vamana insert round's wall time split into the beam search (up to
  its stats) and the prune (prune and reverse edges), for the rounds of
  the writer thread beside the
  server, for the phase's tail insert after it, and for one insert call
  into a fresh live index over the build with no server (alone);
* ``torch.profiler`` (CPU and CUDA activities, every thread where the
  installed torch offers it) over one insert call of the writer
  (``--profile-call``), while the server serves: per thread, the ops
  recorded, their summed time and the wall they span; the device's
  kernel time by stream;
* the live phase's own lines: insert wall, served QPS, rejected
  submissions, engine step p50, and whether its gates held.

Everything goes to ``OUT/<name>.json`` and the end of standard output.
"""

from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
STATE = ROOT / "build" / "live_ab" / "state.pkl"


def _import_smoke(tree: Path):
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke  # noqa: PLC0415 — the tree's own

    return chip_smoke


def build(args) -> None:
    import torch

    smoke = _import_smoke(ROOT)
    smoke.environment(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    ds, res, _, split, _, recalls = smoke.main_path(
        torch, SimpleNamespace(n=args.n, queries=args.queries))
    STATE.parent.mkdir(parents=True, exist_ok=True)
    with open(STATE, "wb") as f:
        pickle.dump((ds, res, split, recalls), f, protocol=5)


def _thread_summary(prof, t_lo: float, t_hi: float) -> dict:
    """Per thread: top-level CPU ops, their summed time and the wall from
    the first op's start to the last op's end (µs); the device's kernel
    time by stream."""
    threads: dict = {}
    streams: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = str(getattr(e, "device_index", 0)) + ":" + str(
                getattr(e, "thread", 0))
            s = streams.setdefault(key, [0, 0.0])
            s[0] += 1
            s[1] += e.time_range.elapsed_us()
            continue
        if e.cpu_parent is not None:
            continue
        t = threads.setdefault(e.thread, {"ops": 0, "op_us": 0.0,
                                          "start": e.time_range.start,
                                          "end": e.time_range.end})
        t["ops"] += 1
        t["op_us"] += e.time_range.elapsed_us()
        t["start"] = min(t["start"], e.time_range.start)
        t["end"] = max(t["end"], e.time_range.end)
    for t in threads.values():
        t["span_us"] = t.pop("end") - t.pop("start")
    return {"wall_s": t_hi - t_lo, "threads": threads,
            "kernels_by_stream": {k: {"kernels": n, "us": us}
                                  for k, (n, us) in streams.items()}}


def live(args) -> None:
    import torch

    tree = Path(args.tree).resolve()
    smoke = _import_smoke(tree)
    from repro_torch.live import LiveIndex
    from repro_torch.live import index as live_index

    import repro_torch.search as search_pkg

    smoke.environment(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(STATE, "rb") as f:
        ds, res, split, recalls = pickle.load(f)
    lines: list = []
    log = smoke.log

    def kept(msg):
        lines.append(msg)
        log(msg)

    smoke.log = kept
    rounds: list = []  # (thread: "writer" | "main", beam s, prune s)
    mark = threading.local()
    beam_pool = search_pkg.beam_pool
    reverse = live_index._apply_reverse_edges
    insert_batch = LiveIndex.insert_batch
    calls = [0]
    profiles: list = []

    def timed_beam(*a, **kw):
        t0 = time.perf_counter()
        out = beam_pool(*a, **kw)
        mark.t_beam = time.perf_counter()
        mark.beam = mark.t_beam - t0
        return out

    def timed_reverse(*a, **kw):
        out = reverse(*a, **kw)
        prune = time.perf_counter() - mark.t_beam
        where = ("main" if threading.current_thread() is
                 threading.main_thread() else "writer")
        rounds.append((where, mark.beam, prune))
        return out

    def profiled_insert(self, *a, **kw):
        calls[0] += 1
        if calls[0] != args.profile_call or threading.current_thread() is \
                threading.main_thread():
            return insert_batch(self, *a, **kw)
        from torch.profiler import ProfilerActivity, profile

        try:  # every thread's ops, the server's too, where torch can
            from torch._C._profiler import _ExperimentalConfig

            extra = {"experimental_config": _ExperimentalConfig(
                profile_all_threads=True)}
        except (ImportError, TypeError):
            extra = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **extra) as prof:
            t0 = time.perf_counter()
            out = insert_batch(self, *a, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        profiles.append(_thread_summary(prof, t0, t1))
        return out

    search_pkg.beam_pool = timed_beam
    live_index._apply_reverse_edges = timed_reverse
    LiveIndex.insert_batch = profiled_insert
    error = None
    t0 = time.perf_counter()
    try:
        smoke.live_path(torch, ds, res, split, recalls)
    except smoke.SmokeError as e:
        error = str(e)
        log(f"live phase gate failed: {e}")
    wall = time.perf_counter() - t0
    # rounds alone, whether or not the phase reached its own tail: a fresh
    # live index over the build takes one insert call with no server
    from repro_torch.configs.base import IndexConfig
    from repro_torch.data.synthetic import make_clustered
    from repro_torch.live import LiveConfig

    n_before = len(rounds)
    fresh = LiveIndex.from_build(res, ds.data, IndexConfig(),
                                 LiveConfig(backend="fused"))
    per = smoke.LIVE_INSERTS // smoke.LIVE_CALLS
    t1 = time.perf_counter()
    fresh.insert_batch(make_clustered(per, 128, seed=4).data)
    fresh_s = time.perf_counter() - t1
    fresh.close()
    fresh_rounds = rounds[n_before:]
    del rounds[n_before:]

    def stats(rows):
        if not rows:
            return {}
        n = len(rows)
        return {"rounds": n,
                "round_ms": 1e3 * sum(b + p for _, b, p in rows) / n,
                "beam_ms": 1e3 * sum(b for _, b, _ in rows) / n,
                "prune_ms": 1e3 * sum(p for *_, p in rows) / n}

    serving = next((json.loads(x[len("live serving "):]) for x in lines
                    if x.startswith("live serving ")), {})
    inserts = next((x for x in lines if x.startswith("live inserts:")), "")
    out = {
        "name": args.name, "tree": str(tree), "phase_s": wall,
        "gate_error": error,
        "beside_server": stats([r for r in rounds if r[0] == "writer"]),
        "alone": stats([r for r in rounds if r[0] == "main"]),
        "alone_fresh_index": dict(stats(fresh_rounds), insert_s=fresh_s,
                                  vectors=per),
        "served_qps": serving.get("served_qps"),
        "rejected_submissions": serving.get("rejected_submissions"),
        "engine_service_ms": serving.get("engine_service_ms"),
        "inserts_line": inserts, "profile": profiles,
    }
    dest = Path(args.out) / f"{args.name}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1, default=str))
    log("live_ab " + json.dumps({k: v for k, v in out.items()
                                 if k not in ("profile", "inserts_line")},
                                default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="NAME=DIR")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--profile-call", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "live_ab"))
    ap.add_argument("--worker", choices=("build", "live"))
    ap.add_argument("--tree")
    ap.add_argument("--name")
    args = ap.parse_args(argv)
    if args.worker == "build":
        build(args)
        return 0
    if args.worker == "live":
        live(args)
        return 0
    name, base = args.base.split("=", 1)
    common = ["--base", args.base, "--n", str(args.n), "--queries",
              str(args.queries), "--profile-call", str(args.profile_call),
              "--out", args.out]
    me = [sys.executable, str(Path(__file__).resolve())]
    t0 = time.perf_counter()
    rc = subprocess.run(me + common + ["--worker", "build"]).returncode
    print(f"live_ab build {time.perf_counter() - t0:.1f} s rc={rc}",
          flush=True)
    if rc:
        return rc
    for label, tree in ((name, base), ("change", str(ROOT))):
        t0 = time.perf_counter()
        rc = subprocess.run(me + common + ["--worker", "live", "--tree", tree,
                                           "--name", label]).returncode
        print(f"live_ab {label} {time.perf_counter() - t0:.1f} s rc={rc}",
              flush=True)
    STATE.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
