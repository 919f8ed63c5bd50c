"""Search at ``metric="ip"`` (negated inner product) on every port backend
against the JAX package, on the CPU: an index built by the reference with
``IndexConfig(metric="ip")`` and carried across with
``topology_from_arrays``, searched merged and split (nprobe None / 2 /
"auto") × f32 / bf16 / uint8.  ``fused`` and ``torch`` are held to the
reference's ``jax`` backend, ``numpy`` to its ``numpy``: ids equal and
``SearchStats`` equal.  This covers the IP routing tiles (the uint8 one
with its certified error bounds and f32 fallback), the IP shard entries
and the IP exact re-rank."""

import dataclasses

import numpy as np
import pytest

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import builder as jbuilder
from repro.data.synthetic import make_clustered as jmake
from repro.search import MergedTopology as JMerged
from repro.search import ShardTopology as JShard
from repro.search import search as jsearch
from repro_torch.search import search, topology_from_arrays

PAIRS = {"numpy": "numpy", "torch": "jax", "fused": "jax"}
CASES = ([("merged", None)] + [("split", p) for p in (None, 2, "auto")])


@pytest.fixture(scope="module")
def ref():
    ds = jmake(1500, 32, n_queries=24, spread=1.0, seed=9)
    cfg = JIndexConfig(n_clusters=4, degree=16, build_degree=32,
                       block_size=512, metric="ip")
    build = jbuilder.build_scalegann(ds.data, cfg, n_workers=2)
    return ds, build


def _topologies(ds, build, kind):
    if kind == "merged":
        jt = JMerged(data=ds.data, index=build.index, metric="ip")
        tt = topology_from_arrays(ds.data, graph=build.index.graph,
                                  medoid=build.index.medoid, metric="ip")
    else:
        ids = [s.ids for s in build.shards]
        jt = JShard(data=ds.data, shard_ids=ids,
                    shard_graphs=build.shard_graphs,
                    centroids=build.centroids, metric="ip")
        tt = topology_from_arrays(ds.data, shard_ids=ids,
                                  shard_graphs=build.shard_graphs,
                                  centroids=build.centroids, metric="ip")
    return jt, tt


@pytest.mark.parametrize("dtype", ["f32", "bf16", "uint8"])
@pytest.mark.parametrize("kind,nprobe", CASES)
@pytest.mark.parametrize("backend", ["fused", "torch", "numpy"])
def test_ip_search_matches_reference(ref, backend, kind, nprobe, dtype):
    ds, build = ref
    jt, tt = _topologies(ds, build, kind)
    kw = dict(k=10, width=32, nprobe=nprobe, dtype=dtype)
    want_ids, want_stats = jsearch(jt, ds.queries, backend=PAIRS[backend],
                                   **kw)
    got_ids, got_stats = search(tt, ds.queries, backend=backend,
                                device="cpu", **kw)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)


def test_ip_metric_overrides_an_l2_topology(ref):
    """``search(..., metric="ip")`` on an L2 topology searches by inner
    product, as the reference does, without touching the caller's object."""
    ds, build = ref
    jt = JMerged(data=ds.data, index=build.index)
    tt = topology_from_arrays(ds.data, graph=build.index.graph,
                              medoid=build.index.medoid)
    want, ws = jsearch(jt, ds.queries, 10, backend="jax", width=32,
                       metric="ip")
    got, gs = search(tt, ds.queries, 10, width=32, metric="ip", device="cpu")
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    assert tt.metric == "l2"


def test_ip_uint8_routing_is_counted_as_quantized(ref):
    ds, build = ref
    _, tt = _topologies(ds, build, "split")
    _, stats = search(tt, ds.queries, 10, width=32, nprobe=2, dtype="uint8",
                      device="cpu")
    n_live = sum(len(i) > 0 for i in tt.shard_ids)
    assert stats.n_quantized_distance_computations >= len(ds.queries) * n_live
    assert stats.n_rerank_distance_computations > 0
