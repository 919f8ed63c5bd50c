"""The port's live index (``repro_torch.live``) against the JAX package's,
on the CPU.

* Parity: the same ``ShardTopology`` arrays (built once by the reference,
  on integer points, so every distance is exact) go into both packages'
  ``LiveIndex`` and through the same schedule — inserts that split a
  shard, two delete waves, a consolidation that re-prunes rows, a second
  split, a last delete wave.  The port's ``torch`` and ``fused`` backends
  are held to the reference ``jax``, the port's ``numpy`` to the
  reference ``numpy``: ids, graphs, entries, tombstones, distance count
  and generation equal, centroids to 1e-4 (the tolerance of
  ``test_kmeans_centroids_match_reference``), and the snapshots' search
  ids and ``SearchStats`` equal.
* The partition pieces the live index needs: ``split_shard_rows`` (the
  2-means assignment equal on a fixture with no near-tie, the margin
  asserted) and ``partition(..., sequential=True)``.
* Consolidation's compacted re-prune keeps the same ids and count as the
  reference's padded rows.
* The reference's behavioural tests on the port: tombstones never
  returned, consolidation goes physical, copy-on-write generations, shard
  splits, epoch swaps under ``AnnServer(device="cpu")``, degenerate
  shards, concurrent mutators; and the device copies a mutation costs
  the ``fused`` backend (``search_device_uploads_total``).
"""

import asyncio
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import partition as jpartition
from repro.core import vamana as jvamana
from repro.core.builder import build_scalegann as jbuild_scalegann
from repro.live import LiveConfig as JLiveConfig
from repro.live import LiveIndex as JLiveIndex
from repro.search import search as jsearch
from repro_torch.configs.base import IndexConfig
from repro_torch.core import partition, vamana
from repro_torch.core.builder import build_scalegann
from repro_torch.core.merge import GlobalIndex
from repro_torch.data.synthetic import exact_ground_truth, make_clustered, \
    recall_at
from repro_torch.live import LiveConfig, LiveIndex
from repro_torch.live import index as live_index
from repro_torch.search import ShardTopology, fused_backend, search
from repro_torch.serving import AnnServer, ServingConfig
from repro_torch.telemetry import current_registry

KW = dict(degree=16, build_degree=32, n_clusters=4)
CFG = IndexConfig(**KW)
JCFG = JIndexConfig(**KW)
DIM = 16


# ---------------------------------------------------------------------------
# parity with the reference on integer points
# ---------------------------------------------------------------------------


def _ints(rng, m):
    return rng.integers(0, 6, (m, DIM)).astype(np.float32)


def _near(center, m, rng):
    """Integer points within one step of a rounded centroid: they route
    to that centroid's shard and push it past ``split_max``."""
    pts = np.round(center)[None, :] + rng.integers(-1, 2, (m, DIM))
    return np.clip(pts, 0, 5).astype(np.float32)


@pytest.fixture(scope="module")
def plan():
    """The reference-built topology on integer points and the mutation
    schedule both packages run (every argument fixed up front)."""
    rng = np.random.default_rng(0)
    base = _ints(rng, 600)
    topo = jbuild_scalegann(base, JCFG, algo="vamana").shard_topology(base)
    cent = np.asarray(topo.centroids, np.float32)
    sizes = [len(i) for i in topo.shard_ids]
    steps = [
        ("insert", np.concatenate([_ints(rng, 40), _near(cent[0], 70, rng)])),
        ("delete", rng.choice(710, 71, replace=False)),
        ("delete_shard", (1, 0.4)),
        ("consolidate", None),
        ("insert", np.concatenate([_ints(rng, 20),
                                   _near(cent[2], 130, rng)])),
        ("delete", 600 + rng.choice(260, 30, replace=False)),
    ]
    queries = _ints(rng, 40)
    return dict(topo=topo, steps=steps, split_max=max(sizes) + 30,
                queries=queries)


def _port_topology(t) -> ShardTopology:
    return ShardTopology(
        data=np.array(t.data), shard_ids=[np.array(i) for i in t.shard_ids],
        shard_graphs=[np.array(g) for g in t.shard_graphs], metric=t.metric,
        centroids=np.array(t.centroids))


def _run(li, plan) -> list:
    """Apply the schedule; returns what each mutation returned and the
    shard count after it."""
    out = []
    li.prepare("uint8")
    for op, arg in plan["steps"]:
        if op == "insert":
            got = li.insert_batch(arg)
        elif op == "delete":
            got = li.delete_batch(arg)
        elif op == "delete_shard":
            s, frac = arg
            ids = li._ids[s]
            got = li.delete_batch(ids[: int(frac * len(ids))])
        else:
            got = li.consolidate()
        out.append((op, got, li.n_shards))
    return out


@pytest.fixture(scope="module")
def reference_runs(plan):
    runs = {}
    for backend in ("jax", "numpy"):
        li = JLiveIndex.from_topology(
            plan["topo"], JCFG,
            JLiveConfig(backend=backend, split_max=plan["split_max"]))
        runs[backend] = (li, _run(li, plan))
    return runs


@pytest.fixture(scope="module")
def port_runs(plan):
    runs = {}
    for backend in ("torch", "fused", "numpy"):
        li = LiveIndex.from_topology(
            _port_topology(plan["topo"]), CFG,
            LiveConfig(backend=backend, split_max=plan["split_max"]),
            device="cpu")
        runs[backend] = (li, _run(li, plan))
    return runs


PAIRS = [("torch", "jax"), ("fused", "jax"), ("numpy", "numpy")]


@pytest.mark.parametrize("port_backend,ref_backend", PAIRS)
def test_live_state_matches_reference(port_runs, reference_runs,
                                      port_backend, ref_backend):
    got, got_log = port_runs[port_backend]
    want, want_log = reference_runs[ref_backend]
    # the schedule did what it is for: two splits, a re-pruning pass,
    # tombstones still resident at the end
    shards = [n for _, _, n in got_log]
    assert shards[0] == 5 and shards[-1] == 6, shards
    assert got_log[3][1]["rows_repruned"] > 0
    assert got.resident_dead > 0
    for (op, a, n), (_, b, m) in zip(got_log, want_log):
        assert n == m
        if op == "insert":
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, op
    assert len(got._ids) == len(want._ids)
    for name in ("_ids", "_graphs", "_stores"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(a, b)
    for name in ("_entries", "_tombstones", "_dead_in_shard", "_data"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_allclose(got._centroids, want._centroids, atol=1e-4)
    assert got.n_distance_computations == want.n_distance_computations
    assert got.generation == want.generation
    assert got._split_max == want._split_max


@pytest.mark.parametrize("port_backend,ref_backend", PAIRS)
def test_live_snapshot_search_matches_reference(port_runs, reference_runs,
                                                plan, port_backend,
                                                ref_backend):
    got, _ = port_runs[port_backend]
    want, _ = reference_runs[ref_backend]
    snap, jsnap = got.snapshot(), want.snapshot()
    assert snap.tombstones is not None
    for nprobe in (None, 2):
        for dtype in ("f32", "uint8"):
            kw = dict(width=32, nprobe=nprobe, dtype=dtype)
            ids, st = search(snap, plan["queries"], 10, backend=port_backend,
                             device="cpu", **kw)
            jids, jst = jsearch(jsnap, plan["queries"], 10,
                                backend=ref_backend, **kw)
            np.testing.assert_array_equal(ids, jids)
            assert dataclasses.asdict(st) == dataclasses.asdict(jst)


def test_split_shard_rows_matches_reference():
    """The 2-means of a shard split: the same assignment on a fixture whose
    rows all sit well off the bisector (margin asserted), centroids to
    1e-4."""
    ds = make_clustered(500, DIM, n_queries=2, n_true_clusters=2,
                        spread=0.2, seed=5, device="cpu")
    rows = ds.data
    got_a, got_c = partition.split_shard_rows(rows, seed=3, device="cpu")
    want_a, want_c = jpartition.split_shard_rows(rows, seed=3)
    d = ((rows[:, None, :] - want_c[None]) ** 2).sum(-1)
    assert np.abs(d[:, 0] - d[:, 1]).min() > 1e-2  # no near-tie
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got_c, want_c, atol=1e-4)
    assert 0 < got_a.sum() < len(rows)


def test_sequential_partition_matches_reference():
    """``partition(..., sequential=True)`` (the literal Algorithm 1 scan)
    on integer points with integer centroids, so every distance is exact
    in both packages."""
    rng = np.random.default_rng(4)
    data = _ints(rng, 700)
    cents = data[rng.choice(700, 4, replace=False)]
    cfg = dict(n_clusters=4, block_size=128, epsilon=1.3)
    got = partition.partition(data, IndexConfig(**cfg), centroids=cents,
                              sequential=True, device="cpu")
    want = jpartition.partition(data, JIndexConfig(**cfg), centroids=cents,
                                sequential=True)
    for a, b in zip(got.shards, want.shards):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.is_replica, b.is_replica)
    assert got.stats == want.stats
    assert got.stats["n_replicas"] > 0


@pytest.mark.parametrize("chunk_bytes", [None, 1 << 20])
def test_compacted_reprune_equals_padded(plan, monkeypatch, chunk_bytes):
    """Consolidation's re-prune on compacted rows (valid candidates first,
    in order, the chunk cut to its widest row) keeps the ids and counts
    the distances that the reference's prune does on the padded ``R +
    R²`` rows, and so does the port's prune on the padded rows; also when
    the byte budget cuts the rows into many slices of their own widths."""
    if chunk_bytes is not None:
        monkeypatch.setattr(live_index, "PRUNE_CHUNK_BYTES", chunk_bytes)
        monkeypatch.setattr(vamana, "PRUNE_CHUNK_BYTES", chunk_bytes)
    li = LiveIndex.from_topology(_port_topology(plan["topo"]), CFG,
                                 LiveConfig(backend="torch"), device="cpu")
    li.delete_batch(np.random.default_rng(8).choice(600, 150,
                                                    replace=False))
    s = 0
    ids, store = li._ids[s], li._stores[s]
    graph = np.asarray(li._graphs[s], np.int64)
    R = graph.shape[1]
    dead = li._tombstones[ids]
    nbr_valid = graph >= 0
    nbr_dead = nbr_valid & dead[np.maximum(graph, 0)]
    frac = nbr_dead.sum(1) / np.maximum(nbr_valid.sum(1), 1)
    fix = np.nonzero(~dead & (frac > 0.25))[0]
    assert fix.size > 10
    # the reference's padded candidates, as _consolidate_shard makes them
    c1 = np.where(nbr_valid[fix] & ~nbr_dead[fix], graph[fix], -1)
    two = graph[np.maximum(graph[fix], 0)]
    ok2 = nbr_dead[fix][:, :, None] & (two >= 0) & ~dead[np.maximum(two, 0)]
    cand = np.concatenate(
        [c1, np.where(ok2, two, -1).reshape(fix.size, R * R)], axis=1)
    cvecs = store[np.maximum(cand, 0)]
    diff = cvecs - store[fix][:, None, :]
    cand_d = np.where(cand >= 0, np.einsum("bcd,bcd->bc", diff, diff),
                      np.inf).astype(np.float32)
    want_c = [int((cand >= 0).sum())]
    want = jvamana.robust_prune_batch(fix, cand, cand_d, store, 1.2, R,
                                      want_c, vecs=cvecs)
    pad_c = [int((cand >= 0).sum())]
    padded = vamana.robust_prune_batch(
        torch.from_numpy(fix), torch.from_numpy(cand),
        torch.from_numpy(cand_d), torch.from_numpy(store), 1.2, R, pad_c,
        vecs=torch.from_numpy(cvecs))
    got_c = [0]
    got = li._reprune(store, graph, dead, nbr_dead, fix, got_c)
    np.testing.assert_array_equal(padded.numpy(), want)
    np.testing.assert_array_equal(got, want)
    assert got_c[0] == int(pad_c[0]) == want_c[0]
    # the compaction did cut: the widest valid row is narrower than R + R²
    widest = int((cand >= 0).sum(1).max())
    assert widest < R + R * R
    assert live_index._compact(torch.from_numpy(cand)).shape[1] == widest


def test_compact_keeps_order_and_cuts():
    cand = torch.tensor([[-1, 5, -1, 3, 9], [7, -1, -1, -1, -1],
                         [-1, -1, -1, -1, -1]])
    got = live_index._compact(cand)
    assert got.tolist() == [[5, 3, 9], [7, -1, -1], [-1, -1, -1]]
    assert live_index._compact(cand[2:]).tolist() == [[-1]]


# ---------------------------------------------------------------------------
# behaviour, on the port alone
# ---------------------------------------------------------------------------


def _build(data, live=None, **kw):
    res = build_scalegann(data, CFG, algo="vamana", device="cpu")
    return LiveIndex.from_build(res, data, CFG, live, device="cpu", **kw)


@pytest.fixture(scope="module")
def churned():
    """One seeded churn run, the reference test's: build on 600 points,
    insert 120 more, delete 60 (originals and fresh inserts), consolidate
    half-way.  Inserts on ``numpy``, as there: the batched beams (the
    reference ``jax``, the port's ``torch`` and ``fused``) give this
    fixture's live index recall@10 0.898 against the rebuild's 0.944,
    in both packages alike."""
    rng = np.random.default_rng(11)
    ds = make_clustered(720, DIM, n_queries=48, gt_k=10, seed=3,
                        device="cpu")
    li = _build(ds.data[:600], LiveConfig(backend="numpy"))
    li.insert_batch(ds.data[600:])  # global ids line up with dataset rows
    deleted = np.concatenate([
        rng.choice(600, 40, replace=False),
        600 + rng.choice(120, 20, replace=False),
    ])
    li.delete_batch(deleted[:30])
    li.consolidate()  # first wave goes physical
    li.delete_batch(deleted[30:])  # second wave stays tombstoned
    return li, set(int(i) for i in deleted), ds


def _live_gt(li, deleted, queries, k=10):
    live = np.asarray(sorted(set(range(li.n_vectors)) - deleted), np.int64)
    return live[exact_ground_truth(li._data[live], queries, k,
                                   device="cpu")]


def test_live_index_defaults_to_fused_and_the_card(monkeypatch):
    assert LiveConfig().backend == "fused"
    ds = make_clustered(100, 8, n_queries=1, seed=0, device="cpu")
    res = build_scalegann(ds.data, CFG, algo="vamana", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveIndex.from_build(res, ds.data, CFG)


def test_insert_recall_vs_offline_rebuild(churned):
    """recall@10 of the churned live index stays within 0.02 of a fresh
    offline build of the same final point set."""
    li, deleted, ds = churned
    gt = _live_gt(li, deleted, ds.queries)
    ids_live, _ = search(li.snapshot(), ds.queries, 10, width=64,
                         nprobe=3, device="cpu")
    live = np.asarray(sorted(set(range(li.n_vectors)) - deleted), np.int64)
    rebuilt = build_scalegann(li._data[live], CFG, algo="vamana",
                              device="cpu")
    ids_re, _ = search(rebuilt.shard_topology(li._data[live]), ds.queries,
                       10, width=64, nprobe=3, device="cpu")
    r_live = recall_at(ids_live, gt, 10)
    r_re = recall_at(live[ids_re], gt, 10)
    assert r_live >= r_re - 0.02, (r_live, r_re)


@pytest.mark.parametrize("backend", ["numpy", "torch", "fused"])
@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_tombstoned_never_returned(churned, backend, dtype):
    """Physically removed ids and still-resident tombstoned ids never
    appear in results, on every backend and distance stage."""
    li, deleted, ds = churned
    assert li.resident_dead > 0  # the mask path is actually exercised
    snap = li.snapshot()
    assert snap.tombstones is not None
    for nprobe in (None, 2):
        ids, _ = search(snap, ds.queries, 10, width=64, backend=backend,
                        dtype=dtype, nprobe=nprobe, device="cpu")
        assert not (set(ids.ravel().tolist()) & deleted)


def test_tombstoned_never_returned_merged(churned):
    _, _, ds = churned
    res = build_scalegann(ds.data, CFG, algo="vamana", device="cpu")
    topo = res.topology(ds.data)
    gt1 = exact_ground_truth(ds.data, ds.queries, 1, device="cpu")[:, 0]
    tomb = np.zeros(len(ds.data), bool)
    tomb[gt1] = True  # kill each query's true nearest: masking must act
    t = dataclasses.replace(topo, tombstones=tomb)
    for backend in ("numpy", "torch", "fused"):
        for dtype in ("f32", "uint8"):
            ids, _ = search(t, ds.queries, 10, width=64, backend=backend,
                            dtype=dtype, device="cpu")
            assert not (set(ids.ravel().tolist())
                        & set(gt1.tolist())), (backend, dtype)


def test_consolidate_goes_physical(churned):
    li, deleted, ds = churned
    before = li.resident_dead
    snap_before = li.snapshot()
    stats = li.consolidate()
    assert stats["removed"] == before
    assert li.resident_dead == 0
    snap = li.snapshot()
    assert snap.tombstones is None  # fast paths come back
    assert snap_before.tombstones is not None  # the old generation kept it
    assert not (set(np.concatenate(snap.shard_ids).tolist()) & deleted)
    ids, _ = search(snap, ds.queries, 10, width=64, device="cpu")
    gt = _live_gt(li, deleted, ds.queries)
    assert recall_at(ids, gt, 10) > 0.85
    assert not (set(ids.ravel().tolist()) & deleted)


def test_cow_generations_share_untouched_shards():
    """A mutation replaces only the mutated shard's arrays; earlier
    snapshots keep answering on theirs."""
    ds = make_clustered(400, 8, n_queries=4, gt_k=5, seed=0, device="cpu")
    li = _build(ds.data)
    li.prepare("uint8")
    s0 = li.snapshot()
    stores0 = s0.shard_store()
    quant0 = s0.shard_quant("uint8")
    graphs0 = [g.copy() for g in s0.shard_graphs]
    target = 1
    pts = li._centroids[target][None, :] + np.random.default_rng(0).normal(
        0, 1e-3, (5, 8)).astype(np.float32)
    li.insert_batch(pts)
    s1 = li.snapshot()
    touched = [i for i in range(li.n_shards)
               if s1.shard_store()[i] is not stores0[i]]
    assert touched == [target]
    assert [i for i in range(li.n_shards)
            if s1.shard_quant("uint8")[i][0] is not quant0[i][0]] == [target]
    for g_old, g_now in zip(graphs0, s0.shard_graphs):
        np.testing.assert_array_equal(g_old, g_now)
    li.delete_batch(np.asarray([0, 1, 2]))
    s2 = li.snapshot()
    assert all(a is b for a, b in zip(s1.shard_store(), s2.shard_store()))
    assert s1.tombstones is None and s2.tombstones is not None


def _uploads() -> float:
    fam = current_registry().snapshot().get("search_device_uploads_total",
                                            {"series": []})
    return sum(s["value"] for s in fam["series"])


def test_next_snapshot_uploads_only_the_touched_shard():
    """After one insert into one shard, searching the next snapshot on the
    ``fused`` backend at f32 and uint8 uploads exactly that shard's two
    (store, graph) pairs; every other shard's device copies are reused."""
    ds = make_clustered(400, 8, n_queries=8, gt_k=5, seed=2, device="cpu")
    li = _build(ds.data)
    li.prepare("uint8")
    s0 = li.snapshot()
    fused_backend.warm(s0, ("f32", "uint8"), torch.device("cpu"))
    target = 2
    pts = li._centroids[target][None, :] + np.random.default_rng(1).normal(
        0, 1e-3, (6, 8)).astype(np.float32)
    li.insert_batch(pts)
    s1 = li.snapshot()
    start = _uploads()
    for dtype in ("f32", "uint8"):
        search(s1, ds.queries, 5, width=32, dtype=dtype, device="cpu")
    assert _uploads() - start == 2
    start = _uploads()
    li.delete_batch(np.asarray([3, 4]))
    for dtype in ("f32", "uint8"):
        search(li.snapshot(), ds.queries, 5, width=32, dtype=dtype,
               device="cpu")
    assert _uploads() == start  # a delete replaces no shard array


def test_shard_split_fires_and_serves():
    ds = make_clustered(300, 8, n_queries=8, gt_k=5, seed=1, device="cpu")
    li = _build(ds.data, LiveConfig(split_max=120))
    n0 = li.n_shards
    rng = np.random.default_rng(2)
    pts = (li._centroids[0][None, :]
           + rng.normal(0, 0.5, (150, 8))).astype(np.float32)
    gids = li.insert_batch(pts)
    assert li.n_shards > n0
    assert li._centroids.shape[0] == li.n_shards
    snap = li.snapshot()
    ids, _ = search(snap, pts[:10], 5, width=32, device="cpu")
    hit = sum(g in set(row.tolist()) for g, row in zip(gids[:10], ids))
    assert hit >= 8  # inserted points are findable after the split


def test_epoch_swap_inflight_futures_resolve():
    """Mid-traffic generation swap: every future submitted before, during
    and after the swap resolves, post-swap answers see the inserts and
    never a tombstoned id."""
    ds = make_clustered(400, 8, n_queries=1, gt_k=5, seed=4, device="cpu")
    li = _build(ds.data, LiveConfig(backend="numpy"))
    rng = np.random.default_rng(5)
    new_pts = (ds.data[rng.choice(400, 12)]
               + rng.normal(0, 1e-3, (12, 8))).astype(np.float32)
    kill = rng.choice(400, 25, replace=False)

    async def main():
        cfg = ServingConfig(backend="numpy", k=5, width=32, max_batch=8,
                            max_wait_ms=1.0, pretrace=False)
        async with AnnServer(li.snapshot(), config=cfg,
                             device="cpu") as srv:
            assert srv.topology_generation == 0
            futs = [srv.submit_nowait(ds.data[i]) for i in range(30)]
            await asyncio.sleep(0)  # let some batches flush
            gids = li.insert_batch(new_pts)
            li.delete_batch(kill)
            assert srv.swap_topology(li.snapshot()) == 1
            futs += [srv.submit_nowait(q) for q in new_pts]
            futs += [srv.submit_nowait(ds.data[i]) for i in kill[:10]]
            results = await asyncio.gather(*futs)
            assert len(results) == len(futs)  # nothing rejected or hung
            dead = set(int(i) for i in kill)
            for r in results[30:]:
                assert r.ids.shape == (5,)
                assert not (set(r.ids.tolist()) & dead)
            found = 0
            for g, q in zip(gids, new_pts):
                r = await srv.submit(q)
                found += int(g in set(r.ids.tolist()))
            assert found >= len(gids) - 1
            assert srv.stats.registry.gauge(
                "serving_topology_generation",
                "current served topology generation "
                "(bumped by swap_topology)").value == 1

    asyncio.run(main())


def test_swap_warms_only_the_touched_shards(monkeypatch):
    """Serving a live index on the ``fused`` backend at f32 and uint8: a
    swap after an insert into one shard uploads that shard's two pairs
    (inside ``swap_topology``, before the store), keeps room for the
    replaced generation, and the traffic after it uploads nothing."""
    ds = make_clustered(400, 8, n_queries=16, gt_k=5, seed=6, device="cpu")
    li = _build(ds.data)
    li.prepare("uint8")
    monkeypatch.setattr(fused_backend, "_CACHE_CAP", 2)
    target = 3
    pts = li._centroids[target][None, :] + np.random.default_rng(2).normal(
        0, 1e-3, (6, 8)).astype(np.float32)

    async def main():
        cfg = ServingConfig(k=5, width=32, max_batch=8, max_wait_ms=1.0,
                            nprobe=2, pretrace_dtypes=("uint8",))
        async with AnnServer(li.snapshot(), config=cfg,
                             device="cpu") as srv:
            await srv.submit(ds.queries[0])  # after the warm-up
            n = li.n_shards
            assert fused_backend._CACHE_CAP == 2 * n
            li.insert_batch(pts)
            start = _uploads()
            srv.swap_topology(li.snapshot(), reason="churn")
            swapped = _uploads() - start
            assert fused_backend._CACHE_CAP == 2 * n + 2
            start = _uploads()
            futs = [srv.submit_nowait(q, dtype="uint8" if i % 2 else "f32")
                    for i, q in enumerate(ds.queries)]
            await asyncio.gather(*futs)
            return swapped, _uploads() - start

    swapped, during = asyncio.run(main())
    assert swapped == 2 and during == 0


def test_swap_topology_validates():
    ds = make_clustered(100, 8, n_queries=1, gt_k=5, seed=0, device="cpu")
    li = _build(ds.data)

    async def main():
        cfg = ServingConfig(backend="numpy", k=5, width=32, pretrace=False)
        async with AnnServer(li.snapshot(), config=cfg,
                             device="cpu") as srv:
            other = make_clustered(50, 4, n_queries=1, gt_k=1, seed=1,
                                   device="cpu")
            wrong = _build(other.data)
            with pytest.raises(ValueError, match="dim"):
                srv.swap_topology(wrong.snapshot())
            assert srv.topology_generation == 0

    asyncio.run(main())


@pytest.mark.parametrize("build", ["batched", "sequential"])
@pytest.mark.parametrize("n", [0, 1])
def test_degenerate_shard_builds(build, n):
    vec = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    if build == "batched":
        idx = vamana.build_shard_index_vamana(vec, CFG, device="cpu")
    else:
        idx = vamana.build_shard_index_vamana_sequential(vec, CFG)
    assert idx.graph.shape == (n, min(CFG.degree, 1))
    assert (idx.graph == -1).all()
    assert idx.n_distance_computations == 0


def test_entry_points_exact_count():
    g = np.full((100, 4), -1, np.int32)
    gi = GlobalIndex(graph=g, medoid=0, n_vectors=100)
    for n in (1, 4, 16, 99, 150):
        seeds = gi.entry_points(n)
        assert len(seeds) == min(n + 1, 100), n
        assert len(np.unique(seeds)) == len(seeds)
        assert 0 in seeds


def test_insert_empty_and_single_point_shard():
    """Inserts into a shard emptied by consolidation rebuild it through
    the degenerate-guarded offline builder."""
    ds = make_clustered(200, 8, n_queries=4, gt_k=5, seed=6, device="cpu")
    li = _build(ds.data)
    li.delete_batch(li._ids[0])
    li.consolidate()
    assert len(li._ids[0]) == 0
    p = li._centroids[0][None, :].astype(np.float32)
    gid = li.insert_batch(p)
    assert len(li._ids[0]) == 1
    ids, _ = search(li.snapshot(), p, 3, width=32, device="cpu")
    assert int(gid[0]) in set(ids.ravel().tolist())
    li.insert_batch(p + 0.5)  # one-point shard: a round over one row
    assert len(li._ids[0]) == 2
    assert (li._graphs[0] >= -1).all()


def test_concurrent_mutators_and_snapshots():
    """Mutator threads and snapshotting searchers race; the writer lock
    serializes the mutations, snapshots cut whole generations, and the
    final state accounts for every mutation."""
    ds = make_clustered(300, DIM, n_queries=8, gt_k=10, seed=3,
                        device="cpu")
    li = _build(ds.data)
    extra = np.random.default_rng(5).normal(size=(60, DIM)).astype(
        np.float32)
    errors = []

    def guard(fn):
        def run():
            try:
                fn()
            except Exception as exc:  # reported below
                errors.append(exc)
        return run

    def inserts():
        for i in range(6):
            li.insert_batch(extra[i * 10:(i + 1) * 10])

    def deletes():
        for i in range(10):
            li.delete_batch(np.arange(i * 5, i * 5 + 5))

    def snapshots():
        for _ in range(12):
            ids, _ = search(li.snapshot(), ds.queries[:4], 5,
                            device="cpu")
            assert ids.shape == (4, 5)

    threads = [threading.Thread(target=guard(f))
               for f in (inserts, deletes, snapshots, snapshots)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert li.n_vectors == 300 + 60
    assert li.n_live == 300 + 60 - 50
    assert li.generation == 16
    ids, _ = search(li.snapshot(), ds.queries, 10, device="cpu")
    assert not (set(ids.ravel().tolist()) & set(range(50)))
