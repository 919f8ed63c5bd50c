"""The program's inner spans on the CPU at a tiny size: a traced CAGRA build
records the merge's steps under ``build.merge`` and each shard build's
``shard.knn`` / ``shard.prune`` (with the prune's three steps) under
``build.shard``, nested by ``parent_id``, with work counts that agree with
the graph; a traced ``search()`` records its phases under
``search.engine`` on the merged f32, fused staged bf16 and split paths;
tracing changes no output; untraced, ``search()`` reads the tracer's
``enabled`` flag and nothing else.  ``shard.knn`` carries the width at
SIFT's and GIST's widths, and on the CPU no K4 block shape (K4 puts it
there when it launches: ``tests/test_torch_knn_card.py``);
``build.partition`` counts the lone vectors it rescued; traced, each kNN
call is recorded for the benchmark's K4 roofline, untraced none, and
``reset_counts()`` drops what came before."""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.core.cagra import build_shard_index
from repro_torch.data.synthetic import make_clustered
from repro_torch.kernels import knn_launches, ops, reset_counts
from repro_torch.search import search
from repro_torch.telemetry import NullTracer, Tracer, use_tracer

CFG = IndexConfig(n_clusters=4, degree=16, build_degree=32, block_size=512)
MERGE_STEPS = ["merge.edge_list", "merge.dedup_sort", "merge.distances",
               "merge.cap_sort", "merge.scatter", "merge.medoid"]
SEARCHES = {
    "merged-f32": ("merged", dict(dtype="f32")),
    "merged-bf16": ("merged", dict(dtype="bf16")),
    "split": ("split", dict(dtype="f32", nprobe=2)),
}


def _spans(tracer) -> list:
    """The tracer's finished spans as ``(name, span_id, parent_id, args)``
    in the order they opened."""
    out = [(e["name"], e["args"]["span_id"], e["args"]["parent_id"],
            e["args"]) for e in tracer.to_chrome()["traceEvents"]
           if e.get("ph") == "X"]
    return sorted(out, key=lambda s: s[1])


def _children(spans, sid) -> list:
    return [s for s in spans if s[2] == sid]


@pytest.fixture(scope="module")
def ds():
    return make_clustered(1500, 16, n_queries=40, spread=1.0, seed=3,
                          device="cpu")


@pytest.fixture(scope="module")
def builds(ds):
    """``(untraced build, traced build, its spans)``."""
    plain = build_scalegann(ds.data, CFG, algo="cagra", device="cpu")
    tracer = Tracer()
    with use_tracer(tracer):
        traced = build_scalegann(ds.data, CFG, algo="cagra", device="cpu")
    return plain, traced, _spans(tracer)


def test_build_spans_nest_and_count_the_merge(ds, builds):
    plain, traced, spans = builds
    np.testing.assert_array_equal(traced.index.graph, plain.index.graph)
    assert traced.index.medoid == plain.index.medoid
    for a, b in zip(traced.shard_graphs, plain.shard_graphs):
        np.testing.assert_array_equal(a, b)

    (merge,) = [s for s in spans if s[0] == "build.merge"]
    steps = _children(spans, merge[1])
    assert [s[0] for s in steps] == MERGE_STEPS
    args = {s[0]: s[3] for s in steps}
    n_edges = args["merge.edge_list"]["n_edges"]
    n_unique = args["merge.dedup_sort"]["n_unique"]
    n_kept = args["merge.scatter"]["n_kept"]
    assert n_edges >= n_unique >= n_kept > 0
    assert n_kept == int((traced.index.graph >= 0).sum())

    (part,) = [s for s in spans if s[0] == "build.partition"]
    assert part[3]["n_rescued"] == 0

    shards = [s for s in spans if s[0] == "build.shard"]
    assert len(shards) == len(traced.shards)
    for shard in shards:
        knn, prune = _children(spans, shard[1])
        assert (knn[0], prune[0]) == ("shard.knn", "shard.prune")
        n = shard[3]["n"]
        assert knn[3]["n"] == n
        assert knn[3]["k"] == min(CFG.build_degree + 1, n)
        assert knn[3]["d"] == ds.data.shape[1]
        assert "block_rows" not in knn[3] and "panel" not in knn[3]
        assert [s[0] for s in _children(spans, prune[1])] == [
            "prune.detour", "prune.select", "prune.dedup"]


def _topology(ds, build, kind):
    if kind == "merged":
        return build.topology(ds.data)
    return build.shard_topology(ds.data)


@pytest.mark.parametrize("case", list(SEARCHES))
def test_search_phases_in_order(ds, builds, case):
    kind, kw = SEARCHES[case]
    _, build, _ = builds
    topo = _topology(ds, build, kind)
    want, _ = search(topo, ds.queries, 10, width=32, device="cpu", **kw)
    tracer = Tracer()
    with use_tracer(tracer):
        got, _ = search(topo, ds.queries, 10, width=32, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)

    spans = _spans(tracer)
    (engine,) = [s for s in spans if s[0] == "search.engine"]
    assert engine[3]["n_queries"] == len(ds.queries)
    assert all(s[2] == engine[1] for s in spans if s is not engine)
    names = [s[0] for s in _children(spans, engine[1])]
    order = [name for name, _ in itertools.groupby(names)]
    if kind == "merged":
        assert order == ["search.prep", "search.upload", "search.launch",
                         "search.wait", "search.finish"]
    else:  # one upload and launch a probed shard, then one wait
        assert order[:3] == ["search.prep", "search.route", "search.prep"]
        assert order[-2:] == ["search.wait", "search.finish"]
        shards = order[2:-2]
        assert shards == ["search.prep", "search.upload",
                          "search.launch"] * (len(shards) // 3)
        assert 1 <= len(shards) // 3 <= CFG.n_clusters
    for s in spans:
        if s[0] == "search.launch":
            assert s[3]["width"] == 32 and 1 <= s[3]["n_queries"]


class _CountingTracer(NullTracer):
    """A disabled tracer that records every attribute read but
    ``enabled``."""

    def __init__(self):
        self.reads = []

    def __getattribute__(self, name):
        if name not in ("enabled", "reads"):
            object.__getattribute__(self, "reads").append(name)
        return object.__getattribute__(self, name)


@pytest.mark.parametrize("case", list(SEARCHES))
def test_untraced_search_reads_only_enabled(ds, builds, case):
    kind, kw = SEARCHES[case]
    _, build, _ = builds
    topo = _topology(ds, build, kind)
    counting = _CountingTracer()
    with use_tracer(counting):
        search(topo, ds.queries, 10, width=32, device="cpu", **kw)
    assert counting.reads == []


@pytest.mark.parametrize("d", [16, 864, 960])
def test_shard_knn_span_records_width_and_block_shape(d):
    """A CAGRA shard at a build's k = L + 1 = 129: the width on
    ``shard.knn``, and no block shape, since on the CPU no K4 block runs
    (the card's is checked in ``tests/test_torch_knn_card.py``)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((200, d)).astype(np.float32)
    cfg = IndexConfig(degree=64, build_degree=128)
    tracer = Tracer()
    with use_tracer(tracer):
        build_shard_index(x, cfg, device="cpu")
    (knn,) = [s[3] for s in _spans(tracer) if s[0] == "shard.knn"]
    assert (knn["n"], knn["k"], knn["d"]) == (200, 129, d)
    assert "block_rows" not in knn and "panel" not in knn


def test_knn_calls_are_recorded_only_while_traced():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((30, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((90, 24)).astype(np.float32))
    reset_counts()
    ops.knn(q, x, 7)
    assert knn_launches() == []
    with use_tracer(Tracer()):
        ops.knn(q, x, 7)
        ops.knn(q[:5], x, 3, "ip")
    (a, b) = knn_launches()
    assert a[:4] == (30, 90, 24, 7) and b[:4] == (5, 90, 24, 3)
    assert a[4] > 0 and b[4] > 0  # the plain path's wall time


def test_reset_counts_drops_earlier_knn_calls():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    with use_tracer(Tracer()):
        ops.knn(x, x, 4)
        reset_counts()
        ops.knn(x[:10], x, 4)
    assert [r[:4] for r in knn_launches()] == [(10, 50, 8, 4)]
    reset_counts()
    assert knn_launches() == []
