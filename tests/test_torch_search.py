"""``repro_torch.search.search(backend="fused", device="cpu")`` against
``repro.search.search(backend="jax")`` on the *same* reference-built graphs,
carried across with ``topology_from_arrays`` so search parity does not
depend on build parity.

Merged and split (nprobe None, 2, "auto") topologies × f32, bf16, uint8,
with and without tombstones: ids equal and ``dataclasses.asdict(stats)``
equal.  An f32/bf16 id may differ only at a genuine near-tie, where the
reference's exact distances of the two ids differ by at most 1e-5
relative; uint8 has no such exception (integer-exact traversal).
"""

import dataclasses

import numpy as np
import pytest

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import builder as jbuilder
from repro.data.synthetic import make_clustered as jmake
from repro.search import MergedTopology as JMerged
from repro.search import ShardTopology as JShard
from repro.search import search as jsearch
from repro_torch.search import (MergedTopology, ShardTopology, beam_pool,
                                search, topology_from_arrays)


@pytest.fixture(scope="module")
def ref():
    ds = jmake(2000, 32, n_queries=30, spread=1.0, seed=7)
    cfg = JIndexConfig(n_clusters=4, degree=16, build_degree=32,
                       block_size=512)
    build = jbuilder.build_scalegann(ds.data, cfg, n_workers=2)
    tomb = np.random.default_rng(5).random(len(ds.data)) < 0.05
    return ds, build, tomb


def _topologies(ds, build, tomb, kind):
    if kind == "merged":
        jt = JMerged(data=ds.data, index=build.index, tombstones=tomb)
        tt = topology_from_arrays(ds.data, graph=build.index.graph,
                                  medoid=build.index.medoid, tombstones=tomb)
    else:
        ids = [s.ids for s in build.shards]
        jt = JShard(data=ds.data, shard_ids=ids,
                    shard_graphs=build.shard_graphs,
                    centroids=build.centroids, tombstones=tomb)
        tt = topology_from_arrays(ds.data, shard_ids=ids,
                                  shard_graphs=build.shard_graphs,
                                  centroids=build.centroids, tombstones=tomb)
    return jt, tt


def _assert_same_ids(got, want, data, queries, dtype):
    if dtype == "uint8" or np.array_equal(got, want):
        np.testing.assert_array_equal(got, want)
        return
    rows, cols = np.nonzero(got != want)
    for r, c in zip(rows, cols):  # near-tie: the two ids score the same
        a, b = got[r, c], want[r, c]
        assert a >= 0 and b >= 0, (r, c, a, b)
        da = float(((data[a] - queries[r]) ** 2).sum())
        db = float(((data[b] - queries[r]) ** 2).sum())
        assert abs(da - db) <= 1e-5 * max(abs(db), 1e-30), (r, c, da, db)


CASES = ([("merged", None)] + [("split", p) for p in (None, 2, "auto")])


@pytest.mark.parametrize("tombstones", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "uint8"])
@pytest.mark.parametrize("kind,nprobe", CASES)
def test_search_matches_jax_backend(ref, kind, nprobe, dtype, tombstones):
    ds, build, tomb = ref
    jt, tt = _topologies(ds, build, tomb if tombstones else None, kind)
    kw = dict(k=10, width=32, nprobe=nprobe, dtype=dtype)
    want_ids, want_stats = jsearch(jt, ds.queries, backend="jax", **kw)
    got_ids, got_stats = search(tt, ds.queries, device="cpu", **kw)
    _assert_same_ids(got_ids, want_ids, ds.data, ds.queries, dtype)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)
    if tombstones:
        assert not tomb[got_ids[got_ids >= 0]].any()


def test_topology_from_arrays_validates(ref):
    ds, build, _ = ref
    tt = topology_from_arrays(ds.data, graph=build.index.graph,
                              medoid=build.index.medoid)
    assert isinstance(tt, MergedTopology)
    st = topology_from_arrays(ds.data, shard_ids=[s.ids for s in build.shards],
                              shard_graphs=build.shard_graphs)
    assert isinstance(st, ShardTopology) and st.centroids is None
    with pytest.raises(ValueError):
        topology_from_arrays(ds.data, graph=build.index.graph[:-1])
    with pytest.raises(ValueError):
        topology_from_arrays(ds.data, shard_ids=[build.shards[0].ids],
                             shard_graphs=build.shard_graphs)


def test_beam_pool_matches_reference(ref):
    from repro.search import beam_pool as jbeam_pool

    ds, build, _ = ref
    entries = build.index.entry_points(8)
    want = jbeam_pool(ds.data, build.index.graph, entries, ds.queries[:12],
                      24, backend="jax", n_real=10)
    got = beam_pool(ds.data, build.index.graph, entries, ds.queries[:12],
                    24, n_real=10, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


def test_search_rejects_bad_arguments(ref):
    ds, build, _ = ref
    tt = topology_from_arrays(ds.data, graph=build.index.graph,
                              medoid=build.index.medoid)
    with pytest.raises(ValueError):
        search(tt, ds.queries, 10, width=8, device="cpu")
    with pytest.raises(ValueError):
        search(tt, ds.queries, 10, dtype="int4", device="cpu")
    with pytest.raises(ValueError):
        search(tt, ds.queries, 10, nprobe=0, device="cpu")
    with pytest.raises(ValueError):
        search(tt, ds.queries, 10, backend="jax", device="cpu")
