"""The readers of the program's inner spans against values worked out by
hand from a made-up window of spans, and nothing where the program has
the parent spans but not the inner ones (an older program)."""

import pytest

from annbench import harness

S = 10**9  # nanoseconds a second

# two build jobs: each a build.shards span with two shard builds, then a
# build.merge span; the shard.knn, shard.prune and merge.* spans nest in
# them as (name, start_ns, end_ns)
BUILD = [
    ("build.shards", 0, 10 * S),
    ("build.shard", 0, 5 * S), ("shard.knn", 0, 2 * S),
    ("shard.prune", 2 * S, 5 * S),
    ("build.shard", 5 * S, 10 * S), ("shard.knn", 5 * S, 8 * S),
    ("shard.prune", 8 * S, 10 * S),
    ("build.merge", 10 * S, 20 * S),
    ("merge.dedup_sort", 11 * S, 13 * S), ("merge.distances", 13 * S, 17 * S),
    ("merge.cap_sort", 17 * S, 18 * S),
    ("build.shards", 20 * S, 24 * S),
    ("build.shard", 20 * S, 24 * S), ("shard.knn", 20 * S, 21 * S),
    ("shard.prune", 21 * S, 24 * S),
    ("build.merge", 24 * S, 34 * S),
    ("merge.dedup_sort", 25 * S, 26 * S), ("merge.distances", 26 * S, 29 * S),
    ("merge.cap_sort", 29 * S, 31 * S),
]
# three search() calls of 10, 12 and 8 ms, waiting 6, 9 and 5 ms
MS = 10**6
SEARCH = [
    ("search.engine", 0, 10 * MS), ("search.wait", 3 * MS, 9 * MS),
    ("annbench.next_queries", 10 * MS, 11 * MS),
    ("search.engine", 11 * MS, 23 * MS), ("search.wait", 13 * MS, 22 * MS),
    ("search.engine", 23 * MS, 31 * MS), ("search.wait", 25 * MS, 30 * MS),
]
# the same calls beside a build's live search, whose 4 ms wait lies in no
# call
SEARCH_AND_LIVE = SEARCH + [("search.wait", 40 * MS, 44 * MS)]

CASES = [
    # (2 + 1 + 1 + 2) s of sorts over 2 merges
    ("merge_sort_s", BUILD, 3.0),
    # (4 + 3) s of distances over 2 merges
    ("merge_dist_s", BUILD, 3.5),
    # (2 + 3 + 1) s of kNN graphs over 2 build.shards spans
    ("shard_knn_s", BUILD, 3.0),
    # (3 + 2 + 3) s of pruning over 2 build.shards spans
    ("shard_prune_s", BUILD, 4.0),
    # ((10 + 12 + 8) - (6 + 9 + 5)) ms over 3 calls
    ("search_host_ms", SEARCH, 10.0 / 3),
    # the live search's wait is not subtracted
    ("search_host_ms", SEARCH_AND_LIVE, 10.0 / 3),
]


@pytest.mark.parametrize("metric,spans,want", CASES,
                         ids=[c[0] for c in CASES[:-1]]
                         + ["search_host_ms-live_wait"])
def test_reader_by_hand(metric, spans, want):
    assert harness.reader(metric)({"spans": spans}) == pytest.approx(
        want, rel=1e-12)


OLDER = {  # the parent spans alone, as a program without the inner ones
    "merge_sort_s": [("build.merge", 0, S)],
    "merge_dist_s": [("build.merge", 0, S)],
    "shard_knn_s": [("build.shards", 0, S), ("build.shard", 0, S)],
    "shard_prune_s": [("build.shards", 0, S), ("build.shard", 0, S)],
    "search_host_ms": [("search.engine", 0, MS)],
}


@pytest.mark.parametrize("metric", list(OLDER))
def test_reader_of_an_older_program_reads_nothing(metric):
    assert harness.reader(metric)({"spans": OLDER[metric]}) is None
