"""The port's Vamana build and the DiskANN baseline against the JAX
package, on the CPU.

* ``robust_prune_batch`` and ``_apply_reverse_edges`` on CPU tensors give
  the reference's kept ids, graph and distance counter on integer points
  (every distance exact), reverse-edge overflow included.
* ``build_shard_index_vamana(backend="torch"|"fused", device="cpu")``
  reproduces the reference ``backend="jax"`` build's graph and distance
  count on integer points, and its recall@10 within 0.01 on float points.
* The sequential build is bit-identical to the reference's; resume at
  mid-pass and at a pass boundary (from either package's checkpoint) gives
  the uninterrupted graph.
* ``beam_pool`` on device tensors reads the live graph: a graph mutated in
  place between two calls is seen by the second (no stale device copy).
* ``build_diskann`` and ``build_scalegann(algo="vamana", reference=True)``
  reach the reference's recall@10 within 0.01, and the seed-loop paths
  they need (CAGRA ``reference=True``, the merge loop, ``kmeans_cost``,
  ``BufferedShardReader``, ``connectivity_stats``) agree with the
  reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import builder as jbuilder
from repro.core import cagra as jcagra
from repro.core import kmeans as jkmeans
from repro.core import merge as jmerge
from repro.core import vamana as jvamana
from repro.core.merge import GlobalIndex as JGlobalIndex
from repro.data.synthetic import exact_ground_truth, make_clustered, recall_at
from repro.search import search as jsearch
from repro_torch.configs.base import IndexConfig
from repro_torch.core import builder, cagra, kmeans, merge, vamana
from repro_torch.core.partition import Shard
from repro_torch.search import beam_pool

CFG = dict(degree=12, build_degree=24)


@pytest.fixture(scope="module")
def ints():
    """Integer points: every squared distance is an exact small integer,
    so any summation order gives the same value and every tie is real."""
    return np.random.default_rng(0).integers(0, 6, (300, 16)).astype(
        np.float32)


@pytest.fixture(scope="module")
def ref_int_build(ints):
    return jvamana.build_shard_index_vamana(ints, JIndexConfig(**CFG),
                                            backend="jax", batch_size=64)


@pytest.fixture(scope="module")
def ds():
    return make_clustered(700, 24, n_queries=40, spread=1.0, seed=13)


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_robust_prune_batch_matches_reference(ints, alpha):
    rng = np.random.default_rng(5)
    data = ints
    p_ids = rng.choice(len(data), size=24, replace=False)
    cand = rng.choice(len(data), size=(24, 40))
    cand[:, 3] = p_ids  # self-candidates and padding, as in a real pool
    cand[:, 33:] = -1
    cand_d = np.where(
        cand >= 0,
        ((data[np.maximum(cand, 0)] - data[p_ids][:, None, :]) ** 2).sum(-1),
        np.inf).astype(np.float32)
    want_c = [0]
    want = jvamana.robust_prune_batch(p_ids, cand, cand_d, data, alpha, 8,
                                      want_c)
    got_c = [0]
    got = vamana.robust_prune_batch(
        torch.from_numpy(p_ids), torch.from_numpy(cand),
        torch.from_numpy(cand_d), torch.from_numpy(data), alpha, 8, got_c)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got_c[0]) == want_c[0]


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_apply_reverse_edges_matches_reference(ints, alpha):
    rng = np.random.default_rng(3)
    n, R = len(ints), 8
    graph = jvamana._random_regular_init(n, R, rng)
    graph[:120, 3:] = -1  # rows with room; the rest overflow
    batch = rng.choice(n, size=40, replace=False)
    pruned = np.full((40, R), -1, np.int64)
    for b, p in enumerate(batch):  # unique, self-free, compacted rows
        nb = rng.choice(np.setdiff1d(np.arange(n), [p]), size=rng.integers(
            1, R + 1), replace=False)
        pruned[b, :len(nb)] = nb
    want_g, want_c = graph.copy(), [0]
    jvamana._apply_reverse_edges(batch, pruned, want_g, ints, alpha, R,
                                 want_c)
    got_g, got_c = torch.from_numpy(graph.astype(np.int32)), [0]
    vamana._apply_reverse_edges(torch.from_numpy(batch),
                                torch.from_numpy(pruned), got_g,
                                torch.from_numpy(ints), alpha, R, got_c)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    assert int(got_c[0]) == want_c[0] > 0  # overflow re-prunes ran
    assert ((want_g[:120] >= 0).sum(1) > 3).any()  # in-capacity scatters


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_batched_build_reproduces_reference_graph(ints, ref_int_build,
                                                  backend):
    got = vamana.build_shard_index_vamana(ints, IndexConfig(**CFG),
                                          backend=backend, batch_size=64,
                                          device="cpu")
    np.testing.assert_array_equal(got.graph, ref_int_build.graph)
    assert got.n_distance_computations == \
        ref_int_build.n_distance_computations


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_batched_build_recall_matches_reference(ds, backend):
    vecs = ds.data
    gt = exact_ground_truth(vecs, ds.queries, 10)
    cfg = dict(degree=16, build_degree=32)
    want = jvamana.build_shard_index_vamana(vecs, JIndexConfig(**cfg),
                                            backend="jax")
    got = vamana.build_shard_index_vamana(vecs, IndexConfig(**cfg),
                                          backend=backend, device="cpu")
    recalls = {}
    for name, idx in (("ref", want), ("port", got)):
        gi = JGlobalIndex(graph=idx.graph, medoid=0, n_vectors=len(vecs))
        ids, _ = jsearch(gi, ds.queries, 10, data=vecs, width=64)
        recalls[name] = recall_at(ids, gt, 10)
    assert abs(recalls["port"] - recalls["ref"]) <= 0.01, recalls
    assert got.graph.dtype == np.int32 and got.graph.shape == want.graph.shape


def test_sequential_build_bit_identical(ints):
    want = jvamana.build_shard_index_vamana_sequential(
        ints[:150], JIndexConfig(**CFG))
    got = vamana.build_shard_index_vamana_sequential(ints[:150],
                                                     IndexConfig(**CFG))
    np.testing.assert_array_equal(got.graph, want.graph)
    assert got.n_distance_computations == want.n_distance_computations


class _Kill(Exception):
    pass


def _states_until(build, data, cfg, kill_round, **kw):
    states = []

    def hook(st):
        states.append(st)
        if st.round_idx == kill_round:
            raise _Kill

    with pytest.raises(_Kill):
        build(data, cfg, batch_size=64, round_hook=hook, **kw)
    return states


# 5 rounds a pass at n=300, batch 64: round 2 is mid-pass, round 5 ends
# pass 0 (its cursor 320 >= n), round 7 is mid-pass 1
@pytest.mark.parametrize("kill_round", [2, 5, 7])
def test_resume_is_bit_compatible(ints, ref_int_build, kill_round):
    states = _states_until(vamana.build_shard_index_vamana, ints,
                           IndexConfig(**CFG), kill_round, backend="torch",
                           device="cpu")
    assert [s.round_idx for s in states] == list(range(1, kill_round + 1))
    assert states[-1].n_rounds_total == 10 and states[-1].R == 12
    res = vamana.build_shard_index_vamana(
        ints, IndexConfig(**CFG), backend="torch", batch_size=64,
        resume=states[-1], device="cpu")
    np.testing.assert_array_equal(res.graph, ref_int_build.graph)
    assert res.n_distance_computations == \
        ref_int_build.n_distance_computations


def test_resume_from_reference_checkpoint(ints, ref_int_build):
    """A checkpoint the JAX package wrote resumes in the port to the same
    graph: the fleet can hand a shard from one package to the other."""
    states = _states_until(jvamana.build_shard_index_vamana, ints,
                           JIndexConfig(**CFG), 3, backend="jax")
    res = vamana.build_shard_index_vamana(
        ints, IndexConfig(**CFG), backend="fused", batch_size=64,
        resume=states[-1], device="cpu")
    np.testing.assert_array_equal(res.graph, ref_int_build.graph)
    bad = dataclasses.replace(states[-1], n=len(ints) + 1)
    with pytest.raises(ValueError, match="mismatch"):
        vamana.build_shard_index_vamana(ints, IndexConfig(**CFG),
                                        batch_size=64, resume=bad,
                                        device="cpu")


@pytest.mark.parametrize("store_form", ["tensor", "numpy"])
@pytest.mark.parametrize("query_form", ["tensor", "numpy"])
@pytest.mark.parametrize("backend", ["numpy", "torch", "fused"])
def test_beam_pool_reads_the_live_graph(ints, backend, query_form,
                                        store_form):
    """The stale-graph trap: a build mutates its one graph tensor in place
    every round, so a backend that kept a device copy of it would search
    round 1's graph forever.  The second call must see the mutation,
    whatever form the store and the queries come in: a graph tensor alone
    makes the state live."""
    rng = np.random.default_rng(1)
    n = len(ints)
    store = torch.from_numpy(ints) if store_form == "tensor" else ints
    graph = torch.from_numpy(
        jvamana._random_regular_init(n, 8, rng).astype(np.int32))
    q = torch.from_numpy(ints[:16]) if query_form == "tensor" else ints[:16]
    kw = dict(backend=backend, n_iters=24, device="cpu")
    first = beam_pool(store, graph, 0, q, 24, **kw)
    graph[:, 4:] = -1  # in place: the same tensor object, fewer edges
    graph[5] = torch.arange(8, dtype=torch.int32) + 100
    second = beam_pool(store, graph, 0, q, 24, **kw)
    fresh = beam_pool(store, graph.clone(), 0, q, 24, **kw)
    assert isinstance(second[0], torch.Tensor)
    torch.testing.assert_close(second[0], fresh[0], rtol=0, atol=0)
    assert second[2] == fresh[2]
    assert not torch.equal(first[0], second[0])


@pytest.fixture(scope="module")
def small():
    return make_clustered(900, 16, n_queries=40, spread=1.0, seed=21)


BUILD_CFG = dict(n_clusters=3, degree=12, build_degree=24, block_size=256)


def test_build_diskann_recall_matches_reference(small):
    want = jbuilder.build_diskann(small.data, JIndexConfig(**BUILD_CFG))
    got = builder.build_diskann(small.data, IndexConfig(**BUILD_CFG),
                                device="cpu")
    assert got.name == want.name == "diskann"
    assert got.stats == want.stats  # the same uniform replication
    ids, stats = got.search(small.data, small.queries, 10, device="cpu")
    want_ids, _ = want.search(small.data, small.queries, 10, backend="jax")
    r_got, r_want = (recall_at(i, small.gt, 10) for i in (ids, want_ids))
    assert abs(r_got - r_want) <= 0.01, (r_got, r_want)
    assert stats.n_queries == len(small.queries)
    assert got.merge_s > 0 and got.build_only_s > 0


def test_build_scalegann_vamana_reference_matches(small):
    """``reference=True``: the sequential host builds and the merge loop,
    bit for bit the reference's (they are the same numpy algorithm on the
    same partition)."""
    sub = small.data[:400]
    gt = exact_ground_truth(sub, small.queries, 10)
    want = jbuilder.build_scalegann(sub, JIndexConfig(**BUILD_CFG),
                                    algo="vamana", reference=True)
    got = builder.build_scalegann(sub, IndexConfig(**BUILD_CFG),
                                  algo="vamana", reference=True,
                                  device="cpu")
    for g, w in zip(got.shard_graphs, want.shard_graphs, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.index.graph, want.index.graph)
    ids, _ = got.search(sub, small.queries, 10, backend="numpy",
                        device="cpu")
    want_ids, _ = want.search(sub, small.queries, 10)
    assert abs(recall_at(ids, gt, 10) - recall_at(want_ids, gt, 10)) <= 0.01


def test_cagra_reference_flag_matches(small):
    vecs = small.data[:300]
    cfg = IndexConfig(**BUILD_CFG)
    a = cagra.build_shard_index(vecs, cfg, reference=True, device="cpu")
    b = cagra.build_shard_index(vecs, cfg, device="cpu")
    w = jcagra.build_shard_index(vecs, JIndexConfig(**BUILD_CFG),
                                 reference=True)
    np.testing.assert_array_equal(a.graph, w.graph)
    np.testing.assert_array_equal(a.graph, b.graph)
    assert a.n_distance_computations == w.n_distance_computations


def test_merge_loop_and_connectivity_match_reference(small):
    cfg = JIndexConfig(**BUILD_CFG)
    part = jbuilder.partition(small.data, cfg, selective=False)
    idxs = [jcagra.build_shard_index(small.data[s.ids], cfg)
            for s in part.shards]
    shards = [Shard(ids=s.ids, is_replica=s.is_replica) for s in part.shards]
    tidx = [cagra.ShardIndex(graph=i.graph, n_distance_computations=0)
            for i in idxs]
    for data in (small.data, None):
        want = jmerge.merge_shard_indexes(part.shards, idxs, len(small.data),
                                          12, data=data, reference=True)
        got = merge.merge_shard_indexes(shards, tidx, len(small.data), 12,
                                        data=data, reference=True)
        np.testing.assert_array_equal(got.graph, want.graph)
        assert got.medoid == want.medoid
        assert merge.connectivity_stats(got) == \
            jmerge.connectivity_stats(want)


def test_kmeans_cost_matches_reference(small):
    cent = jkmeans.train_centroids(small.data, 3, seed=0)
    want = jkmeans.kmeans_cost(small.data, cent)
    got = kmeans.kmeans_cost(small.data, cent, device="cpu")
    assert got == pytest.approx(want, rel=1e-5)


def test_buffered_shard_reader_matches_reference(small):
    rows = small.data[:100]
    got = merge.BufferedShardReader(rows, buffer_rows=16)
    want = jmerge.BufferedShardReader(rows, buffer_rows=16)
    for i in list(range(40)) + [90, 5, 6, 99, 0]:  # sequential, then jumps
        row = got.get(i)
        np.testing.assert_array_equal(row, want.get(i))
        np.testing.assert_array_equal(row, rows[i])
    assert (got.hits, got.misses) == (want.hits, want.misses)
    assert got.misses == 7


def test_prune_chunks_change_nothing(ints, monkeypatch):
    """Rows are independent: a prune cut into chunks of a few rows (the
    overflow re-prune of a large round) keeps the same ids and count."""
    rng = np.random.default_rng(8)
    p_ids = torch.from_numpy(rng.choice(len(ints), 50, replace=False))
    cand = torch.from_numpy(rng.choice(len(ints), size=(50, 30)))
    x = torch.from_numpy(ints)
    cand_d = ((x[cand] - x[p_ids][:, None, :]) ** 2).sum(-1)
    whole_c = [0]
    whole = vamana.robust_prune_batch(p_ids, cand, cand_d, x, 1.2, 8,
                                      whole_c)
    monkeypatch.setattr(vamana, "PRUNE_CHUNK_BYTES", 4 * 30 * 54 * 7)
    assert vamana._rows_per_chunk(30, 16) == 7
    parts_c = [0]
    parts = vamana.robust_prune_batch(p_ids, cand, cand_d, x, 1.2, 8,
                                      parts_c)
    assert torch.equal(parts, whole) and int(parts_c[0]) == int(whole_c[0])
