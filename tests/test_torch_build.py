"""The port's build path (``repro_torch.core``) against the JAX package, on
the CPU, on ``tests/test_search_backends.py``'s fixture
(``make_clustered(2000, 32, spread=1.0, seed=7)``, 4 clusters, R=16, L=32):

* k-means centroids to 1e-4 (f32 sums in another order) and identical
  partition assignments, originals and replicas alike; where a cluster
  keeps one vector alone, the port also replicates it into its nearest
  other cluster, and its merged row has edges where the reference's is
  empty;
* ``optimize_graph`` and ``merge_shard_indexes`` bit-identical given the
  same kNN input and shard graphs;
* the port's ``build_scalegann`` reaches recall@10 within 0.01 of the
  reference build's.
"""

import numpy as np
import pytest

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import builder as jbuilder
from repro.core import cagra as jcagra
from repro.core import kmeans as jkmeans
from repro.core import merge as jmerge
from repro.core import partition as jpartition
from repro.search import MergedTopology as JMerged
from repro.search import search as jsearch
from repro_torch.configs.base import IndexConfig
from repro_torch.core import builder, cagra, kmeans, merge, partition
from repro_torch.data.synthetic import make_clustered, recall_at
from repro_torch.search import search

CFG = dict(n_clusters=4, degree=16, build_degree=32, block_size=512)


@pytest.fixture(scope="module")
def ds():
    return make_clustered(2000, 32, n_queries=30, spread=1.0, seed=7,
                          device="cpu")


@pytest.fixture(scope="module")
def jbuild(ds):
    return jbuilder.build_scalegann(ds.data, JIndexConfig(**CFG), n_workers=2)


def test_dataset_matches_reference(ds):
    from repro.data.synthetic import make_clustered as jmake

    ref = jmake(2000, 32, n_queries=30, spread=1.0, seed=7)
    np.testing.assert_array_equal(ds.data, ref.data)
    np.testing.assert_array_equal(ds.queries, ref.queries)
    np.testing.assert_array_equal(ds.gt, ref.gt)


def test_kmeans_centroids_match_reference(ds):
    want = jkmeans.train_centroids(ds.data, 4, iters=12, seed=0)
    got = kmeans.train_centroids(ds.data, 4, iters=12, seed=0, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("selective", [True, False])
def test_partition_assignments_identical(ds, selective):
    want = jpartition.partition(ds.data, JIndexConfig(**CFG),
                                selective=selective)
    got = partition.partition(ds.data, IndexConfig(**CFG),
                              selective=selective, device="cpu")
    assert len(got.shards) == len(want.shards)
    for g, w in zip(got.shards, want.shards):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.is_replica, w.is_replica)
    assert got.stats == want.stats


@pytest.mark.parametrize("omega", [2, 1])
def test_lone_vector_gets_a_replica_where_omega_allows(ds, omega):
    """A centre placed on one outlying vector keeps it alone, as k-means's
    re-seed at the farthest point can: the reference leaves that vector
    with no edge.  The port replicates it into its nearest other cluster
    (ω = 2), and every merged row has an edge; at ω = 1 it cannot."""
    x = ds.data.copy()
    x[1234] += 40.0  # far from every cluster
    cfg = dict(CFG, omega=omega, n_clusters=5)
    cents = kmeans.train_centroids(ds.data, 4, iters=12, seed=0,
                                   device="cpu")
    cents = np.concatenate([cents, x[1234][None]])
    want = jpartition.partition(x, JIndexConfig(**cfg), centroids=cents)
    got = partition.partition(x, IndexConfig(**cfg), centroids=cents,
                              device="cpu")
    assert [len(w.ids) for w in want.shards][4] == 1
    d = ((cents[:4] - x[1234]) ** 2).sum(1)  # the nearest with space
    d[[len(w.ids) >= want.stats["capacity"] for w in want.shards[:4]]] = \
        np.inf
    for c, (g, w) in enumerate(zip(got.shards, want.shards)):
        rescued = omega == 2 and c == int(np.argmin(d))
        np.testing.assert_array_equal(
            g.ids, np.append(w.ids, 1234) if rescued else w.ids)
        np.testing.assert_array_equal(
            g.is_replica, np.append(w.is_replica, True) if rescued
            else w.is_replica)
    assert got.stats["n_replicas"] == want.stats["n_replicas"] + (omega == 2)
    assert got.n_rescued == (omega == 2)
    idxs = [cagra.build_shard_index(x[s.ids], IndexConfig(**cfg),
                                    device="cpu") for s in got.shards]
    graph = merge.merge_shard_indexes(got.shards, idxs, len(x), 16,
                                      data=x).graph
    empty = (graph < 0).all(1)
    assert empty.sum() == (omega == 1) and empty[1234] == (omega == 1)


def test_knn_graph_matches_reference(ds):
    x = ds.data[:600]
    wn, wd, wc = jcagra.build_knn_graph(x, 32)
    gn, gd, gc = cagra.build_knn_graph(x, 32, device="cpu")
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    assert gc == wc


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_optimize_graph_bit_identical(ds, metric):
    x = ds.data[:600]
    nbrs, dists, _ = jcagra.build_knn_graph(x, 32, metric=metric)
    wg, wn = jcagra.optimize_graph(x, nbrs, dists, 16, metric=metric)
    gg, gn = cagra.optimize_graph(x, nbrs, dists, 16, metric=metric,
                                  device="cpu")
    np.testing.assert_array_equal(gg, wg)
    assert gn == wn


def test_merge_bit_identical(ds, jbuild):
    shards = [partition.Shard(ids=s.ids, is_replica=s.is_replica)
              for s in jbuild.shards]
    idxs = [cagra.ShardIndex(graph=g, n_distance_computations=0)
            for g in jbuild.shard_graphs]
    got = merge.merge_shard_indexes(shards, idxs, len(ds.data), 16,
                                    data=ds.data)
    np.testing.assert_array_equal(got.graph, jbuild.index.graph)
    assert got.medoid == jbuild.index.medoid
    np.testing.assert_array_equal(got.entry_points(16),
                                  jbuild.index.entry_points(16))
    without = merge.merge_shard_indexes(shards, idxs, len(ds.data), 16)
    jshards = [jpartition.Shard(ids=s.ids, is_replica=s.is_replica)
               for s in jbuild.shards]
    jidxs = [jcagra.ShardIndex(graph=g, n_distance_computations=0)
             for g in jbuild.shard_graphs]
    np.testing.assert_array_equal(
        without.graph,
        jmerge.merge_shard_indexes(jshards, jidxs, len(ds.data), 16).graph)


def test_build_recall_matches_reference(ds, jbuild):
    res = builder.build_scalegann(ds.data, IndexConfig(**CFG), n_workers=2,
                                  device="cpu")
    got_ids, _ = search(res.topology(ds.data), ds.queries, 10, device="cpu")
    want_ids, _ = jsearch(JMerged(data=ds.data, index=jbuild.index),
                          ds.queries, 10, backend="jax")
    got, want = recall_at(got_ids, ds.gt, 10), recall_at(want_ids, ds.gt, 10)
    assert abs(got - want) <= 0.01, (got, want)
    assert res.stats == jbuild.stats
    assert res.partition_s > 0 and res.merge_s > 0
    assert len(res.shard_graphs) == len(jbuild.shard_graphs)


def test_split_only_build_matches_reference_partition(ds):
    want = jbuilder.build_extended_cagra(ds.data, JIndexConfig(**CFG))
    got = builder.build_split_only(ds.data, IndexConfig(**CFG),
                                   name="extended_cagra", kmeans_split=True,
                                   device="cpu")
    for g, w in zip(got.shards, want.shards):
        np.testing.assert_array_equal(g.ids, w.ids)
    np.testing.assert_allclose(got.centroids, want.centroids, atol=1e-4)
    assert got.index is None and got.merge_s == 0.0
