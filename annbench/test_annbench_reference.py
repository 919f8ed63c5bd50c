"""The reference's exact search, recall and index checks against
brute-force NumPy and hand-made cases."""

import numpy as np
import pytest

from annbench.reference import exact, graph


def brute(data, queries, k):
    d = ((queries[:, None, :].astype(np.float64)
          - data[None, :, :].astype(np.float64)) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(len(data)), d.shape), d),
                       axis=1)
    return order[:, :k]


@pytest.mark.parametrize("n,d,k", [(500, 8, 10), (300, 33, 1), (64, 4, 64)])
def test_exact_knn_equals_brute_force(n, d, k):
    rng = np.random.default_rng(n + d)
    data = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(37, d)).astype(np.float32)
    got = exact.exact_knn(data, queries, k, device="cpu", block=16)
    np.testing.assert_array_equal(got, brute(data, queries, k))


def test_exact_knn_breaks_ties_by_id():
    data = np.repeat(np.eye(4, dtype=np.float32), 3, axis=0)  # duplicates
    queries = np.eye(4, dtype=np.float32)[[2, 0]]
    got = exact.exact_knn(data, queries, 5, device="cpu")
    np.testing.assert_array_equal(got[0, :3], [6, 7, 8])
    np.testing.assert_array_equal(got[1, :3], [0, 1, 2])


def test_recall_counts_each_true_neighbour_once():
    truth = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    found = np.array([[1, 1, 1, 9], [8, 7, 6, 5]])  # a repeat counts once
    assert exact.recall(found, truth, 4) == pytest.approx((1 + 4) / 8)
    assert exact.recall(found[:, :2], truth, 2) == pytest.approx(1 / 4)


def test_invalid_ids():
    ids = np.array([[0, 1, 2], [3, 3, 4], [-1, 5, 10], [9, 8, 7]])
    assert exact.invalid_ids(ids, 10) == 3  # one repeat, -1, 10


def test_order_gap_reads_inversions_only():
    data = np.array([[0.0], [1.0], [2.0], [4.0]], np.float32)
    q = np.zeros((2, 1), np.float32)
    sorted_ids = np.array([[0, 1, 2], [1, 2, 3]])
    assert exact.order_gap(data, q, sorted_ids, device="cpu") == 0.0
    swapped = np.array([[0, 2, 1], [1, 2, 3]])  # 4 before 1: (4-1)/1
    assert exact.order_gap(data, q, swapped, device="cpu") == \
        pytest.approx(3.0)
    # a -1 answer is invalid_ids' to count, not an inversion
    assert exact.order_gap(data, q, np.array([[1, -1, 0]]),
                           device="cpu") == 0.0


def test_tf32_control_is_the_same_search_without_re_rank():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(400, 16)).astype(np.float32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    ctl = exact.exact_knn(data, q, 10, device="cpu", tf32=True)
    assert exact.recall(ctl, brute(data, q, 10), 10) == 1.0


def test_partition_violations():
    assert graph.partition_violations([[0, 1], [2, 3]], 4, 2) == 0
    assert graph.partition_violations([[0, 1], [1, 2, 3]], 4, 2) == 0
    assert graph.partition_violations([[0, 1], [1], [1, 2, 3]], 4, 2) == 1
    assert graph.partition_violations([[0, 1]], 4, 2) == 2  # 2, 3 held by none
    assert graph.partition_violations([[0, 0, 1, 2, 3, 7]], 4, 2) == 2


def test_graph_violations():
    g = np.array([[1, 2, -1], [0, -1, -1], [0, 1, -1]])
    assert graph.graph_violations(g, 3, 3) == 0
    assert graph.graph_violations(g, 3, 2) == 3  # wider than the degree
    bad = np.array([[0, 2, -1], [2, 2, -1], [-1, -1, -1]])
    assert graph.graph_violations(bad, 3, 3) == 3  # self, repeat, empty row
    # out of range; below -1, and so a row with no edge
    assert graph.graph_violations(np.array([[3], [-2], [1]]), 3, 3) == 3


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest():
    import torch

    x = torch.tensor([1 + 2**-11, 1 + 2**-12, -(1 + 3 * 2**-11), 3.0,
                      1 + 2**-10 + 2**-11], dtype=torch.float32)
    want = [1 + 2**-10, 1.0, -(1 + 2**-9), 3.0, 1 + 2**-9]
    assert exact.round_tf32(x).tolist() == want
    y = exact.round_tf32(torch.randn(1000))
    assert not (y.view(torch.int32) & 0x1FFF).any()


def by_hand_cagra(x, L, R):
    """A CAGRA shard graph by loops in float64: the rule that
    :func:`graph.build_gap` rebuilds, written out independently."""
    n = len(x)
    fk = R - R // 2
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    nbrs, fwd = [], []
    for u in range(n):
        order = [v for v in np.lexsort((np.arange(n), d2[u])) if v != u][:L]
        counts = []
        for j, vj in enumerate(order):
            counts.append(sum(
                np.sqrt(d2[order[i], vj]) < d2[u, vj] for i in range(j)))
        ranked = [order[j] for j in np.argsort(counts, kind="stable")]
        nbrs.append(ranked)
        fwd.append(ranked[:fk])
    g = np.full((n, R), -1, np.int64)
    for u in range(n):
        rev = [s for s in range(n) if u in fwd[s]][: R // 2]
        row = []
        for v in fwd[u] + rev + nbrs[u][fk:]:
            if v != u and v not in row and len(row) < R:
                row.append(v)
        g[u, :len(row)] = row
    return g


def test_build_gap_rebuilds_a_shard_and_a_merge_by_the_rule():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(150, 6)).astype(np.float32)
    a, b = np.arange(0, 100), np.arange(60, 150)  # rows 60..99 in both
    ga = by_hand_cagra(data[a].astype(np.float64), 12, 8)
    gb = by_hand_cagra(data[b].astype(np.float64), 12, 8)
    merged = np.full((150, 8), -1, np.int64)
    for u in range(150):
        cand = []
        for ids, g in ((a, ga), (b, gb)):
            if u in ids:
                loc = int(np.nonzero(ids == u)[0][0])
                cand += [int(ids[v]) for v in g[loc] if v >= 0]
        cand = list(dict.fromkeys(c for c in cand if c != u))
        d = [((data[c].astype(np.float64) - data[u]) ** 2).sum()
             for c in cand]
        keep = [cand[i] for i in np.argsort(d, kind="stable")[:8]]
        merged[u, :len(keep)] = keep
    rows = np.arange(150)
    kw = dict(build_degree=12, degree=8, device="cpu")
    gap = graph.build_gap(data, [a, b], [ga, gb], merged, rows, **kw)
    assert gap["differ"] == 0
    assert gap["slots"] == (4 + 8) * (100 + 90) + 8 * 150
    # one forward slot of row 70 of shard a swapped for a far point
    far = next(v for v in range(100) if v not in ga[70] and v != 70)
    bad = ga.copy()
    bad[70, 0] = far
    gap = graph.build_gap(data, [a, b], [bad, gb], merged, rows, **kw)
    assert (gap["forward"], gap["shard_row"]) == (1, 1)
    # one merged slot altered
    bad = merged.copy()
    bad[3, 0] = next(v for v in range(150) if v not in merged[3] and v != 3)
    gap = graph.build_gap(data, [a, b], [ga, gb], bad, rows, **kw)
    assert (gap["forward"], gap["shard_row"], gap["merge"]) == (0, 0, 1)


def test_build_gap_reads_nought_on_the_programs_build(few_threads):
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core.builder import build_scalegann

    from annbench import datagen, harness

    cfg = harness.config(harness.load_benchmark(), "sift-128-l2")
    cfg = dict(cfg, dim=32)
    ic = dict(cfg["index_config"], n_clusters=4, degree=16,
              build_degree=32, kmeans_sample=2000)
    data = datagen.job_data(cfg, 2000, 0)
    res = build_scalegann(data, IndexConfig(**ic), device="cpu")
    rows = np.arange(0, 2000, 3)
    gap = graph.build_gap(data, [s.ids for s in res.shards],
                          res.shard_graphs, res.index.graph, rows,
                          build_degree=32, degree=16, device="cpu")
    assert gap["slots"] > 30_000
    assert gap["differ"] <= 2, gap  # near-ties of float32 against float64
