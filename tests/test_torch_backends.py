"""The port's ``numpy`` and ``torch`` search backends against the JAX
package's ``numpy`` and ``jax`` backends, on the CPU, on
``tests/test_torch_search.py``'s fixture (a reference-built index carried
across with ``topology_from_arrays``):

* ``search`` gives the same ids and ``SearchStats`` (``asdict`` equality)
  for merged and split (nprobe None / 2 / "auto") topologies × f32 / bf16 /
  uint8 × with and without tombstones;
* ``beam_pool`` on all three port backends: ids equal, distances to 1e-5
  relative, stats equal, with ``n_real`` padding;
* the ``torch`` backend's query chunking changes no id and no counter
  (uint8 distances are exact integers scaled, so they agree bit for bit;
  f32 ones to 1e-6 relative, the batched product's blocking following the
  chunk's shape);
* the ``repro_torch.core.search`` shim warns and returns what the
  reference's shim returns.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import builder as jbuilder
from repro.core import search as jshim
from repro.data.synthetic import make_clustered as jmake
from repro.search import MergedTopology as JMerged
from repro.search import ShardTopology as JShard
from repro.search import beam_pool as jbeam_pool
from repro.search import search as jsearch
from repro_torch.core import search as shim
from repro_torch.core.merge import GlobalIndex
from repro_torch.search import (available_backends, beam_pool, search,
                                topology_from_arrays)
from repro_torch.search import torch_backend

# port backend -> the reference backend it is held to
PAIRS = {"numpy": "numpy", "torch": "jax", "fused": "jax"}


@pytest.fixture(scope="module")
def ref():
    ds = jmake(2000, 32, n_queries=30, spread=1.0, seed=7)
    cfg = JIndexConfig(n_clusters=4, degree=16, build_degree=32,
                       block_size=512)
    build = jbuilder.build_scalegann(ds.data, cfg, n_workers=2)
    tomb = np.random.default_rng(5).random(len(ds.data)) < 0.05
    return ds, build, tomb


def _topologies(ds, build, tomb, kind, metric="l2"):
    if kind == "merged":
        jt = JMerged(data=ds.data, index=build.index, tombstones=tomb,
                     metric=metric)
        tt = topology_from_arrays(ds.data, graph=build.index.graph,
                                  medoid=build.index.medoid, tombstones=tomb,
                                  metric=metric)
    else:
        ids = [s.ids for s in build.shards]
        jt = JShard(data=ds.data, shard_ids=ids,
                    shard_graphs=build.shard_graphs,
                    centroids=build.centroids, tombstones=tomb, metric=metric)
        tt = topology_from_arrays(ds.data, shard_ids=ids,
                                  shard_graphs=build.shard_graphs,
                                  centroids=build.centroids, tombstones=tomb,
                                  metric=metric)
    return jt, tt


CASES = ([("merged", None)] + [("split", p) for p in (None, 2, "auto")])


def test_registry_holds_three_backends():
    assert available_backends() == ["fused", "numpy", "torch"]


@pytest.mark.parametrize("tombstones", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "uint8"])
@pytest.mark.parametrize("kind,nprobe", CASES)
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_search_matches_reference_backend(ref, backend, kind, nprobe, dtype,
                                          tombstones):
    ds, build, tomb = ref
    jt, tt = _topologies(ds, build, tomb if tombstones else None, kind)
    kw = dict(k=10, width=32, nprobe=nprobe, dtype=dtype)
    want_ids, want_stats = jsearch(jt, ds.queries, backend=PAIRS[backend],
                                   **kw)
    got_ids, got_stats = search(tt, ds.queries, backend=backend,
                                device="cpu", **kw)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)
    if tombstones:
        assert not tomb[got_ids[got_ids >= 0]].any()


@pytest.mark.parametrize("backend", ["numpy", "torch", "fused"])
def test_beam_pool_matches_reference(ref, backend):
    ds, build, _ = ref
    entries = build.index.entry_points(8)
    want = jbeam_pool(ds.data, build.index.graph, entries, ds.queries[:12],
                      24, backend=PAIRS[backend], n_real=10)
    got = beam_pool(ds.data, build.index.graph, entries, ds.queries[:12],
                    24, backend=backend, n_real=10, device="cpu")
    assert got[0].shape == want[0].shape == (10, 24)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_torch_chunking_changes_nothing(ref, dtype, monkeypatch):
    ds, build, _ = ref
    topo = topology_from_arrays(ds.data, graph=build.index.graph,
                                medoid=build.index.medoid)
    store, spec = (ds.data, None) if dtype == "f32" else \
        topo.quant_view("uint8")
    args = (store, build.index.graph, build.index.entry_points(16),
            ds.queries, 10)
    kw = dict(width=32, quant=spec, device="cpu", n_real=25)
    whole = torch_backend.batch_beam_search(*args, **kw)
    for budget in (1, 300_000):  # one query a chunk; three a chunk
        monkeypatch.setattr(torch_backend, "CHUNK_BYTES", budget)
        parts = torch_backend.batch_beam_search(*args, **kw)
        assert torch_backend._chunk_queries(
            2000, 32, 32, 8 * 16, budget) == (1 if budget == 1 else 3)
        np.testing.assert_array_equal(parts[0], whole[0])
        if dtype == "uint8":
            np.testing.assert_array_equal(parts[1], whole[1])
        else:
            np.testing.assert_allclose(parts[1], whole[1], rtol=1e-6)
        assert parts[2] == whole[2]


def test_deprecated_shim_matches_reference_shim(ref):
    ds, build, _ = ref
    gi = GlobalIndex.from_arrays(build.index.graph, build.index.medoid,
                                 len(ds.data))
    ids = [s.ids for s in build.shards]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = [
            jshim.beam_search(ds.data, build.index.graph, build.index.medoid,
                              ds.queries[0], 10, width=32),
            jshim.search_index(ds.data, build.index, ds.queries, 10,
                               width=32),
            jshim.split_search(ds.data, ids, build.shard_graphs, ds.queries,
                               10, width=32),
            jshim.batch_search(ds.data, build.index, ds.queries, 10,
                               width=32),
        ]
    with pytest.warns(DeprecationWarning, match="beam_search"):
        got_bs = shim.beam_search(ds.data, build.index.graph,
                                  build.index.medoid, ds.queries[0], 10,
                                  width=32)
    with pytest.warns(DeprecationWarning, match="search_index"):
        got_si = shim.search_index(ds.data, gi, ds.queries, 10, width=32,
                                   device="cpu")
    with pytest.warns(DeprecationWarning, match="split_search"):
        got_ss = shim.split_search(ds.data, ids, build.shard_graphs,
                                   ds.queries, 10, width=32, device="cpu")
    with pytest.warns(DeprecationWarning, match="batch_search"):
        got_bt = shim.batch_search(ds.data, gi, ds.queries, 10, width=32,
                                   device="cpu")
    for got, exp in zip((got_bs, got_si, got_ss), want[:3]):
        np.testing.assert_array_equal(got[0], exp[0])
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(exp[1])
    np.testing.assert_array_equal(got_bt, want[3])
    assert isinstance(shim.SearchStats(), type(got_si[1]))
