"""The merge on the card (``core/merge.py`` ``_merge_rows``, the kernel in
``kernels/csrc/merge.cu`` and its plain version ``kernels/ref.py``
``merge_rows_plain``) held to the host's vectorized union.

On the CPU the device path runs with CPU tensors, through the plain
version: on a real partition and CAGRA shard build it gives
``_union_dedup_cap``'s graph exactly, with and without the points; small
handmade cases pin the rule (repeats collapse to their first occurrence,
the cap keeps the nearest, exact ties go to the first seen, rows with no
edge stay -1, self-edges drop, empty shards and shard widths other than
the degree); the row table's CSR invariants; the distances' summation
order; the spans and the ``path`` a build's merge takes.  Every CPU case is
held to the reference package's merge of the same shard graphs too.  On
the card (``card`` marker) a 20,000-point build's merged graph is held to
the kernel's plain version on the same card tensors, exactly, and to the
host union of its own shard graphs, near-ties aside."""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core import builder, merge
from repro_torch.core.cagra import ShardIndex
from repro_torch.core.partition import Shard
from repro_torch.data.synthetic import make_clustered, near_tie_breaks
from repro_torch.kernels.ref import lane_sum
from repro_torch.telemetry import Tracer, use_tracer

CFG = IndexConfig(n_clusters=4, degree=16, build_degree=32, block_size=512)


@pytest.fixture(scope="module")
def ds():
    return make_clustered(2000, 32, n_queries=10, spread=1.0, seed=7,
                          device="cpu")


@pytest.fixture(scope="module")
def builds(ds):
    """A CAGRA build on the CPU, selective replication and uniform."""
    return {sel: builder.build_scalegann(ds.data, CFG, selective=sel,
                                         device="cpu")
            for sel in (True, False)}


def _indexes(res):
    return [ShardIndex(graph=g, n_distance_computations=0)
            for g in res.shard_graphs]


def _reference_graph(shards, idxs, n, degree, data):
    """The reference package's merge (numpy) of the same shard graphs."""
    from repro.core import cagra as jcagra
    from repro.core import merge as jmerge
    from repro.core import partition as jpartition

    jshards = [jpartition.Shard(ids=s.ids, is_replica=s.is_replica)
               for s in shards]
    jidxs = [jcagra.ShardIndex(graph=i.graph, n_distance_computations=0)
             for i in idxs]
    return jmerge.merge_shard_indexes(jshards, jidxs, n, degree,
                                      data=data).graph


@pytest.mark.parametrize("with_data", [True, False], ids=["data", "no_data"])
@pytest.mark.parametrize("selective", [True, False],
                         ids=["selective", "uniform"])
def test_rows_match_the_host_union(ds, builds, selective, with_data):
    res = builds[selective]
    data = ds.data if with_data else None
    want = merge._union_dedup_cap(res.shards, _indexes(res), len(ds.data),
                                  CFG.degree, data)
    got = merge._merge_rows(res.shards, _indexes(res), len(ds.data),
                            CFG.degree, data, "cpu")
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _reference_graph(
        res.shards, _indexes(res), len(ds.data), CFG.degree, data))


# Handmade cases: shards as (global ids, local graph), 1-d points, the
# degree, and the rows they pin, (with the points, without them).
CASES = {
    "repeats_self_and_empty_rows": dict(
        shards=[([0, 1, 2, 3], [[1, 2, -1], [0, -1, -1], [0, 1, -1],
                                [-1, -1, -1]]),
                ([0, 4, 5, 1], [[3, 1, 0], [0, 2, -1], [1, -1, -1],
                                [0, -1, -1]])],
        x=[0, 3, 1, 5, 2, 9], degree=4,
        rows={0: ([2, 4, 1, -1], [1, 2, 4, -1]),  # 1 twice, 0 itself
              1: ([0, -1, -1, -1],) * 2,  # 0 in both shards
              3: ([-1] * 4,) * 2}),  # no edge
    "cap_keeps_nearest": dict(
        shards=[(list(range(7)), [[1, 2, 3, 4, 5, 6]] + [[-1] * 6] * 6)],
        x=[0, 6, 5, 4, 3, 2, 1], degree=3,
        rows={0: ([6, 5, 4], [1, 2, 3]), 1: ([-1] * 3,) * 2}),
    "exact_ties_first_seen": dict(
        shards=[([0, 1, 2], [[2, 1], [-1, -1], [-1, -1]]),
                ([3, 4, 0], [[-1, -1], [-1, -1], [1, 0]])],
        x=[0, 1, -1, 2, -2], degree=3,
        rows={0: ([2, 1, 4], [2, 1, 4])}),  # d 1, 1, 4, 4 in that order
    "empty_shards": dict(
        shards=[([], np.zeros((0, 2), np.int32)),
                ([0, 1, 2], [[1, 2], [0, -1], [-1, -1]]),
                ([], np.zeros((0, 2), np.int32))],
        x=[0, 2, 1], degree=2,
        rows={0: ([2, 1], [1, 2]), 1: ([0, -1],) * 2, 2: ([-1, -1],) * 2}),
    "width_below_degree": dict(
        shards=[([0, 1, 2], [[1, 2], [0, 2], [1, 0]]),
                ([3, 0, 4], [[1, 2], [2, 0], [1, 0]])],
        x=[0, 1, 2, 3, 4], degree=5,
        rows={0: ([1, 2, 3, 4, -1], [1, 2, 4, 3, -1]),
              3: ([4, 0, -1, -1, -1], [0, 4, -1, -1, -1])}),
    "width_above_degree": dict(
        shards=[([0, 1, 2, 3, 4], [[4, 3, 2, 1], [0, 2, 3, 4], [-1] * 4,
                                   [-1] * 4, [-1] * 4])],
        x=[0, 1, 2, 3, 4], degree=2,
        rows={0: ([1, 2], [4, 3]), 1: ([0, 2], [0, 2])}),
}


def _case(name):
    c = CASES[name]
    shards = [Shard(ids=np.asarray(ids, np.int64),
                    is_replica=np.zeros(len(ids), bool))
              for ids, _ in c["shards"]]
    idxs = [ShardIndex(graph=np.asarray(g, np.int32),
                       n_distance_computations=0) for _, g in c["shards"]]
    x = np.asarray(c["x"], np.float32)[:, None] * np.ones((1, 3), np.float32)
    return shards, idxs, len(c["x"]), c["degree"], x, c["rows"]


@pytest.mark.parametrize("with_data", [True, False], ids=["data", "no_data"])
@pytest.mark.parametrize("name", list(CASES))
def test_handmade_rows(name, with_data):
    shards, idxs, n, degree, x, rows = _case(name)
    data = x if with_data else None
    got = merge._merge_rows(shards, idxs, n, degree, data, "cpu")
    np.testing.assert_array_equal(
        got, merge._union_dedup_cap(shards, idxs, n, degree, data))
    np.testing.assert_array_equal(
        got, _reference_graph(shards, idxs, n, degree, data))
    for gid, want in rows.items():
        assert got[gid].tolist() == want[0 if with_data else -1], gid


@pytest.mark.parametrize("selective", [True, False],
                         ids=["selective", "uniform"])
def test_row_table_is_a_csr_of_shard_rows(ds, builds, selective):
    res = builds[selective]
    nbr, row_ptr, row_of = merge._row_table(res.shards, _indexes(res),
                                            len(ds.data), "cpu")
    offsets = np.cumsum([0] + [len(s.ids) for s in res.shards])
    assert nbr.dtype == row_ptr.dtype == row_of.dtype == torch.int32
    assert nbr.shape == (offsets[-1], CFG.degree)
    for s, (shard, g) in enumerate(zip(res.shards, res.shard_graphs)):
        np.testing.assert_array_equal(
            nbr[offsets[s]:offsets[s + 1]].numpy(),
            merge._translate(g, shard.ids))
    row_ptr, row_of = row_ptr.numpy(), row_of.numpy()
    assert row_ptr[0] == 0 and row_ptr[-1] == offsets[-1]
    assert (np.diff(row_ptr) >= 0).all()
    # every (shard, row) once
    assert np.array_equal(np.sort(row_of), np.arange(offsets[-1]))
    owner = np.concatenate([s.ids for s in res.shards])
    shard_of = np.searchsorted(offsets, np.arange(offsets[-1]), "right") - 1
    for gid in range(len(ds.data)):
        rows = row_of[row_ptr[gid]:row_ptr[gid + 1]]
        assert (owner[rows] == gid).all()
        assert (np.diff(shard_of[rows]) > 0).all()  # shard order, once each
    assert (np.diff(row_ptr) <= CFG.omega).all()


@pytest.mark.parametrize("fault", ["id_out_of_range", "local_out_of_range",
                                   "rows_and_ids_differ"])
def test_row_table_refuses_bad_shards(fault):
    shards, idxs, n, degree, x, _ = _case("repeats_self_and_empty_rows")
    if fault == "id_out_of_range":
        shards[1].ids = np.array([0, 4, 6, 1])
    elif fault == "local_out_of_range":
        idxs[0].graph = idxs[0].graph.copy()
        idxs[0].graph[1, 0] = 4
    else:
        idxs[1].graph = idxs[1].graph[:3]
    with pytest.raises(ValueError):
        merge._merge_rows(shards, idxs, n, degree, x, "cpu")


def _lane_sum4_numpy(terms):
    """The merge kernel's order, one scalar f32 operation at a time: lane
    ``l`` takes float4 units ``l, l + 32, ...``, each unit's four terms in
    turn, then the xor butterfly."""
    t = terms.reshape(-1)
    lanes = np.zeros(32, np.float32)
    for lane in range(32):
        for base in range(4 * lane, t.shape[0], 128):
            for i in range(base, min(base + 4, t.shape[0])):
                lanes[lane] = np.float32(lanes[lane] + t[i])
    for off in (16, 8, 4, 2, 1):
        lanes = np.array([np.float32(lanes[i] + lanes[i ^ off])
                          for i in range(32)], np.float32)
    return lanes[0]


@pytest.mark.parametrize("d", [1, 3, 32, 128, 130, 960])
def test_lane_sum_in_merge_order(d):
    rng = np.random.default_rng(d)
    terms = (rng.standard_normal((3, d)) * 10).astype(np.float32) ** 2
    got = lane_sum(torch.from_numpy(terms), vec=4).numpy()
    want = np.array([_lane_sum4_numpy(r) for r in terms], np.float32)
    np.testing.assert_array_equal(got, want)


def _spans(tracer):
    return sorted(((e["name"], e["args"]["span_id"], e["args"]["parent_id"],
                    e["args"]) for e in tracer.to_chrome()["traceEvents"]
                   if e.get("ph") == "X"), key=lambda s: s[1])


STEPS = {
    "rows": ["merge.rows_table", "merge.rows", "merge.medoid"],
    "sort": ["merge.edge_list", "merge.dedup_sort", "merge.distances",
             "merge.cap_sort", "merge.scatter", "merge.medoid"],
    "loop": ["merge.medoid"],
}


@pytest.mark.parametrize("path", list(STEPS))
def test_merge_spans_carry_the_path(ds, builds, monkeypatch, path):
    """The CPU takes the sort (and ``reference=True`` the loop); the rows
    path is forced onto the CPU here to trace its steps on the plain
    version, which gives the sort's graph on this data."""
    if path == "rows":
        def rows_on_the_cpu(device=None, reference=False):
            return "loop" if reference else "rows"

        monkeypatch.setattr(merge, "merge_path", rows_on_the_cpu)
    small = ds.data[:600]
    tracer = Tracer()
    with use_tracer(tracer):
        res = builder.build_scalegann(small, CFG, device="cpu",
                                      reference=path == "loop")
    spans = _spans(tracer)
    (top,) = [s for s in spans if s[0] == "build.merge"]
    assert top[3]["path"] == path
    steps = [s for s in spans if s[2] == top[1]]
    assert [s[0] for s in steps] == STEPS[path]
    if path == "rows":
        a = steps[1][3]
        assert a["n_rows"] == len(small)
        assert a["n_candidates"] == CFG.degree * sum(
            len(s.ids) for s in res.shards)
        assert a["n_candidates"] >= a["n_unique"] >= a["n_kept"] > 0
        assert a["n_kept"] == int((res.index.graph >= 0).sum())
        sort = merge._union_dedup_cap(res.shards, _indexes(res), len(small),
                                      CFG.degree, small)
        np.testing.assert_array_equal(res.index.graph, sort)


def test_merge_path_follows_the_device():
    """Builds and the fleet pass their device: the card's takes the rows,
    the CPU's (and a merge given none) the host union."""
    assert merge.merge_path() == merge.merge_path("cpu") == "sort"
    assert merge.merge_path(torch.device("cpu")) == "sort"
    assert merge.merge_path("cuda") == "rows"
    assert merge.merge_path("cuda", reference=True) == "loop"


@pytest.mark.parametrize("under_a_span", [True, False],
                         ids=["span", "no_span"])
def test_merge_labels_its_callers_span(under_a_span):
    shards, idxs, n, degree, x, _ = _case("cap_keeps_nearest")
    tracer = Tracer()
    with use_tracer(tracer):
        if under_a_span:
            with tracer.span("caller", track="t", n=1):
                merge.merge_shard_indexes(shards, idxs, n, degree, data=x)
        else:
            merge.merge_shard_indexes(shards, idxs, n, degree, data=x)
    spans = {s[0]: s[3] for s in _spans(tracer)}
    assert ("caller" in spans) == under_a_span
    if under_a_span:
        assert spans["caller"]["path"] == "sort"
        assert spans["caller"]["n"] == 1
    assert all("path" not in a for name, a in spans.items()
               if name != "caller")


@pytest.mark.card
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_card_merge_matches_the_host_union_but_near_ties():
    from annbench.reference.graph import graph_violations
    from repro_torch.kernels import LAUNCHES, reset_counts
    from repro_torch.kernels.merge import merge_rows_cuda, merge_rows_plain

    cfg = IndexConfig()
    data = make_clustered(20_000, 128, n_queries=10, spread=0.35, seed=5,
                          device="cpu").data
    reset_counts()
    res = builder.build_scalegann(data, cfg, device="cuda")
    assert LAUNCHES["merge_rows"] == 1
    got = res.index.graph
    # the kernel against its plain version on the same card tensors, and
    # against the build's graph: equal entry for entry
    nbr, row_ptr, row_of = merge._row_table(res.shards, _indexes(res),
                                            len(data), "cuda")
    xc = torch.from_numpy(np.ascontiguousarray(data, np.float32)).cuda()
    gk, uk = merge_rows_cuda(xc, nbr, row_ptr, row_of, cfg.degree)
    gp, up = merge_rows_plain(xc, nbr, row_ptr, row_of, cfg.degree)
    assert torch.equal(gk, gp) and torch.equal(uk, up)
    np.testing.assert_array_equal(gk.cpu().numpy(), got)
    want = merge._union_dedup_cap(res.shards, _indexes(res), len(data),
                                  cfg.degree, data)
    assert graph_violations(got, len(data), cfg.degree) == 0
    x = data.astype(np.float64)
    rows = np.flatnonzero((np.sort(got, 1) != np.sort(want, 1)).any(1))
    print(f"rows whose sets differ: {len(rows)} of {len(data)}; rows in "
          f"another order: {int((got != want).any(1).sum())}")

    def by_exact_distance(g):  # the rows ordered by float64 distance, id
        g = g[rows]
        d = ((x[np.maximum(g, 0)] - x[rows, None]) ** 2).sum(-1)
        d[g < 0] = np.inf
        return np.take_along_axis(g, np.lexsort((g, d), axis=1), 1)

    breaks = near_tie_breaks(data[rows], data, by_exact_distance(got),
                             by_exact_distance(want), rtol=1e-5)
    assert not bool(breaks.any()), rows[breaks.any(1).numpy()]
