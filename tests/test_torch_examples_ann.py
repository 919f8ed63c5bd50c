"""The port's ANN entry points (``repro_torch.examples.quickstart``,
``serve_ann``, ``build_spot_index``) run as a user runs them: ``python -m
repro_torch.examples.<name> --device cpu`` in a subprocess with no card
visible, printing the markers ``tests/test_examples.py`` greps in the
reference scripts' output.  The quickstart's deterministic lines (replica
share, connectivity, every recall and distance count of its sections 4, 5,
7 and 9) must equal what the reference's library calls give on the same
seeds, with the reference's ``jax`` / ``pallas`` labels read as ``torch``
/ ``fused``; its checks (fleet graphs, trace, deleted id, recovery) must
hold.  ``serve_ann``'s served recall and ``build_spot_index``'s shards,
replica share and recall are held to the reference's library calls on the
same seeds too.  Without ``--device cpu`` each module refuses to run."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs.base import IndexConfig
from repro.core.builder import build_scalegann
from repro.core.merge import connectivity_stats
from repro.core.scheduler import RuntimeModel
from repro.data.synthetic import make_clustered, recall_at
from repro.fleet import build_scalegann_fleet
from repro.search import search
from repro_torch.data.synthetic import near_tie_breaks
from repro_torch.examples.quickstart import near_tie_rows

REPO = Path(__file__).resolve().parents[1]
# torch threads of an example's process: the suite runs files on
# several workers at once, and a process per core each would
# oversubscribe the host many times over
THREADS = "2"


def start(name, *args):
    """``python -m repro_torch.examples.<name> *args`` with no card
    visible, started (the caller collects it)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=THREADS)
    return subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)


def run(name, *args, timeout=300):
    p = start(name, *args)
    out, err = p.communicate(timeout=timeout)
    return p.returncode, out, err


@functools.lru_cache(maxsize=1)
def reference_build():
    """The reference's build of the quickstart's and serve_ann's index:
    both scripts draw the same 5,000 × 64 points from seed 0 (their
    queries, drawn after the points, differ) and build them alike."""
    ds = make_clustered(5000, 64, n_queries=50, spread=1.0, seed=0)
    cfg = IndexConfig(n_clusters=8, degree=16, build_degree=32,
                      epsilon=1.2, block_size=1024)
    return build_scalegann(ds.data, cfg, n_workers=4)


def reference_lines() -> list[str]:
    """The reference quickstart's deterministic lines from ``repro``'s own
    calls on its seeds, formatted as the reference script formats them,
    with the port's backend labels."""
    ds = make_clustered(5000, 64, n_queries=50, spread=1.0, seed=0)
    res = reference_build()
    nq = len(ds.queries)
    lines = [
        f"replicated {res.stats['replica_proportion']:.1%} of vectors",
        f"connectivity: {connectivity_stats(res.index)}",
    ]
    for backend, label in (("numpy", "numpy"), ("jax", "torch")):
        ids, stats = search(res.index, ds.queries, k=10, data=ds.data,
                            backend=backend, width=96)
        lines.append(f"[{label}] recall@10 = {recall_at(ids, ds.gt, 10):.3f}"
                     f"  ({stats.n_distance_computations / nq:.0f} "
                     "distance computations / query)")
        if backend == "jax":
            jax_line = lines[-1]
    shard_topo = res.shard_topology(ds.data)
    for nprobe in (None, 2, "auto"):
        ids, stats = search(shard_topo, ds.queries, k=10, backend="jax",
                            width=96, nprobe=nprobe)
        label = "scatter-all" if nprobe is None else f"nprobe={nprobe}"
        lines.append(f"[shards/{label}] recall@10 = "
                     f"{recall_at(ids, ds.gt, 10):.3f}  "
                     f"({stats.n_distance_computations / nq:.0f} "
                     "distance computations / query)")
    for dt in ("f32", "bf16", "uint8"):
        ids, stats = search(shard_topo, ds.queries, k=10, backend="jax",
                            width=96, nprobe=2, dtype=dt, rerank=4)
        pq = stats.per_query()
        lines.append(f"[dtype={dt:5s}] recall@10 = "
                     f"{recall_at(ids, ds.gt, 10):.3f}  "
                     f"({pq['distance_computations']:.0f} dist/q: "
                     f"{pq['quantized_distance_computations']:.0f} "
                     "quantized + "
                     f"{pq['rerank_distance_computations']:.0f} f32 "
                     "re-rank)")
    # section 9: the reference's pallas ids are its jax ids, so its fused
    # merged line carries the jax numbers
    recall, dists = jax_line.split("] recall@10 = ")[1].split("  ")
    lines.append(f"[fused] recall@10 = {recall}  ids identical to torch: "
                 f"True  {dists}")
    ids, stats = search(shard_topo, ds.queries, k=10, backend="pallas",
                        width=96, nprobe=2, dtype="uint8", rerank=4)
    pq = stats.per_query()
    lines.append(f"[fused/uint8] recall@10 = {recall_at(ids, ds.gt, 10):.3f}"
                 "  ids identical to torch: True  "
                 f"({pq['quantized_distance_computations']:.0f} quantized + "
                 f"{pq['rerank_distance_computations']:.0f} f32 re-rank "
                 "dist/q")
    victim = int(ds.gt[0, 0])
    lines.append(f"deleted id {victim} returned anywhere: False")
    return lines


def test_near_tie_breaks():
    """The near-tie rule of the quickstart and ``chip_smoke.py``: a
    position breaks when its ids differ and their exact distances differ
    by more than ``atol + rtol · |d(want)|``, or either id is missing."""
    data = np.array([[0, 0], [1, 0], [-1, 0], [0, 3], [1.001, 0]],
                    np.float32)
    q = np.zeros((1, 2), np.float32)
    want = np.array([[1, 3, 1, 2]])
    got = np.array([[2, 3, 4, -1]])  # a tie, equal, 0.2% apart, missing
    assert near_tie_breaks(q, data, got, want, rtol=1e-5).tolist() == \
        [[False, False, True, True]]
    assert near_tie_breaks(q, data, got, want, rtol=1e-2).tolist() == \
        [[False, False, False, True]]
    assert near_tie_breaks(q, data, got, want, rtol=0.0,
                           atol=3e-3).tolist() == [[False, False, False, True]]
    # inner product: -<x, q>, so [1, 0] and [1.001, 0] against q = [1, 0]
    ip_q = np.array([[1, 0]], np.float32)
    assert near_tie_breaks(ip_q, data, np.array([[4]]), np.array([[1]]),
                           rtol=1e-5, metric="ip").tolist() == [[True]]
    assert near_tie_breaks(ip_q, data, np.array([[4]]), np.array([[1]]),
                           rtol=1e-2, metric="ip").tolist() == [[False]]
    assert near_tie_rows(data, q, got, want) == [(0, False)]
    assert near_tie_rows(data, q, got[:, :3], want[:, :3]) == [(0, True)]


def test_quickstart_prints_the_reference_values():
    port = start("quickstart", "--device", "cpu")  # runs beside the reference
    try:
        want = reference_lines()
        out, err = port.communicate(timeout=400)
    finally:
        port.kill()
    assert port.returncode == 0, err[-3000:]
    assert "recall@10" in out
    for line in want:
        assert line in out, f"missing {line!r} in\n{out}"
    for check in (
        "graphs identical to uninterrupted build: True",
        "kill->backoff->resume on the timeline: True",
        "1 preemption -> 1 resume, 1 of 25 rounds lost",
        "5 attempt spans / 25 round spans across 2 worker tracks",
        "inserted 32 (first 8 self-findable: 8/8)",
        "removed 1 tombstones (5031 live of 5032 ids)",
        "16/16 in-flight futures resolved",
        "crashed at wal.append.torn; recovering",
        "served ids identical to the uncrashed run: True",
    ):
        assert check in out, f"missing {check!r} in\n{out}"


def test_serve_ann():
    """The served ids' recall is the reference's search of the same index
    with the same engine (``jax``, the port's ``torch``): each query's ids
    do not depend on the batch the server put it in.  The distance count
    a query does (539-541 in three runs here, 542 in the reference's) and
    the latencies depend on how arrivals fall into batches, and are not
    held."""
    port = start("serve_ann", "--device", "cpu")
    try:
        ds = make_clustered(5000, 64, n_queries=256, spread=1.0, seed=0)
        res = reference_build()
        ids, _ = search(res.index, ds.queries, k=10, data=ds.data,
                        backend="jax", width=96)
        want = f"recall@10      {recall_at(ids, ds.gt, 10):.3f}"
        out, err = port.communicate(timeout=300)
    finally:
        port.kill()
    assert port.returncode == 0, err[-3000:]
    assert "achieved QPS" in out
    assert want in out, f"missing {want!r} in\n{out}"


# build_spot_index's recall against the reference's: on this CPU torch
# sums the f32 distances of the partition and the build in an order that
# depends on its thread count, which flips near-ties (at 2 threads the
# graph differs from the reference's and recall is 0.905 against 0.907;
# at 1 and 4 threads the graphs are equal)
SPOT_RECALL_TOL = 0.01


def test_build_spot_index():
    """The preempted fleet's shards, replica share and served recall are
    the reference's: its fleet on the same points and configuration (with
    no injector: a resumed build's graphs are an uninterrupted one's, as
    the quickstart's fleet line checks), searched with ``pallas``, the
    reference's counterpart of the port's default ``fused``.  The
    preemption counts, the runtime model and the simulated makespans
    depend on measured build times, and are not held."""
    port = start("build_spot_index", "--device", "cpu")
    try:
        ds = make_clustered(6000, 64, n_queries=40, spread=1.0, seed=3)
        cfg = IndexConfig(n_clusters=10, degree=16, build_degree=32,
                          block_size=1024)
        res = build_scalegann_fleet(ds.data, cfg, n_workers=4,
                                    runtime_model=RuntimeModel(1e-4),
                                    batch_size=256).build
        sizes = [len(s.ids) for s in res.shards]
        shards = (f"{len(sizes)} shards, sizes {min(sizes)}–{max(sizes)}, "
                  f"replicas {res.stats['replica_proportion']:.1%}")
        ids, _ = search(res.index, ds.queries, 10, data=ds.data, width=96,
                        backend="pallas")
        want = recall_at(ids, ds.gt, 10)
        out, err = port.communicate(timeout=300)
    finally:
        port.kill()
    assert port.returncode == 0, err[-3000:]
    assert shards in out, f"missing {shards!r} in\n{out}"
    for policy in ("cost_greedy", "edd"):
        assert f"simulated [{policy}]" in out
    recall = float(out.split("recall@10 = ")[1].split()[0])
    assert abs(recall - want) <= SPOT_RECALL_TOL, (recall, want)


@pytest.mark.parametrize("name", ["quickstart", "serve_ann",
                                  "build_spot_index"])
def test_refuses_to_run_without_a_card(name):
    """The default ``--device cuda`` raises when no card is visible: no
    line of the example is printed and the exit code is non-zero."""
    rc, out, err = run(name, timeout=120)
    assert rc != 0
    assert out == ""
    assert "CUDA" in err


class PooledStream:
    """Stands in for ``torch.cuda.Stream`` as torch makes it: each call
    hands out the next of 32 streams of the pool of its priority, round
    robin (0: the default-priority pool, negative: a high-priority one)."""

    made = {}

    def __init__(self, device=None, priority=0):
        pool = 0 if priority >= 0 else -1
        n = PooledStream.made.get(pool, 0)
        PooledStream.made[pool] = n + 1
        self.cuda_stream = (pool, n % 32)


def test_prune_captures_never_use_a_fleet_workers_stream(monkeypatch):
    """The fault ``build_spot_index`` hit on the card: a prune capture's
    side stream drawn from the pool the fleet's workers draw theirs from
    was, after 32 streams, another worker's stream, whose launches then
    went into the capture (an id out of range, or "already recording to
    mempool_id").  The side stream now comes from a pool no worker uses,
    however many captures and workers there are."""
    import torch

    from repro_torch.core import vamana

    monkeypatch.setattr(PooledStream, "made", {})
    monkeypatch.setattr(torch.cuda, "Stream", PooledStream)
    dev = torch.device("cuda")
    workers = {torch.cuda.Stream(dev).cuda_stream for _ in range(4)}
    for _ in range(3):  # captures across several fleet runs
        sides = {vamana._capture_stream(dev).cuda_stream for _ in range(60)}
        assert not sides & workers
        workers |= {torch.cuda.Stream(dev).cuda_stream for _ in range(4)}
