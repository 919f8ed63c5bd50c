"""The pieces the Vamana prune's CUDA graphs capture, on the CPU.

On the card each prune chunk replays CUDA graphs of ``_prune_setup`` and
of each ``_prune_segment`` of 16 steps, reading between segments whether
any row is alive, as ``_prune_rows`` does; its rows are padded to a power
of two (at least 64) and its lanes to a multiple of 32, the padding -1 at
distance inf.  None of this may change a kept id or the distance count:

* every segment run, with no early exit, equals the loop that stops once
  nothing is alive, rows that run out of candidates early and
  all-padding rows included;
* a prune over bucketed (padded) rows and lanes equals the prune over the
  unpadded ones;
* ``_apply_reverse_edges`` equals the reference's on integer points, for
  overflow widths on and off the 16-lane grid and for overflowing rows
  spread over several chunks.

Which chunks replay graphs (narrow rows, cut to a power of two) and how a
thread's set stays near its byte budget is plain bookkeeping, also
checked here with a stand-in for the captured graphs.
"""

import numpy as np
import pytest
import torch

from repro.core import vamana as jvamana
from repro_torch.core import vamana


def _candidates(rng, nb, c, n, data, short):
    """[nb, c] candidate rows on integer points: some rows hold only a few
    candidates (they run out early), some none (padding rows), the rest a
    full row with repeats and the row's own id."""
    p_ids = rng.choice(n, nb, replace=False)
    cand = rng.integers(0, n, (nb, c))
    cand[:, 0] = p_ids  # a self-candidate, masked by the prune
    for r in range(short):
        cand[r, rng.integers(1, 4):] = -1
    cand[short:2 * short] = -1  # nothing at all
    d = ((data[np.maximum(cand, 0)] - data[p_ids][:, None]) ** 2).sum(-1)
    cand_d = np.where(cand >= 0, d, np.inf).astype(np.float32)
    return (torch.from_numpy(p_ids), torch.from_numpy(cand),
            torch.from_numpy(cand_d))


@pytest.fixture(scope="module")
def ints():
    return np.random.default_rng(5).integers(0, 5, (400, 16)).astype(
        np.float32)


@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("R", [8, 33])
def test_graph_body_equals_eager_loop(ints, alpha, R):
    rng = np.random.default_rng(R)
    x = torch.from_numpy(ints)
    p_ids, cand, cand_d = _candidates(rng, 48, 40, len(ints), ints, 6)
    vecs = x[cand.clamp_min(0)]
    eager = vamana._prune_rows(p_ids, cand, cand_d, vecs, alpha, R)
    keep = torch.zeros((len(cand), R), dtype=torch.long)
    count = torch.ones((), dtype=torch.long)  # the setup resets both
    st = vamana._prune_setup(p_ids, cand, cand_d, vecs, alpha, keep, count)
    for t0 in range(0, R, vamana.PRUNE_SEGMENT):
        vamana._prune_segment(st, t0, min(t0 + vamana.PRUNE_SEGMENT, R))
    assert torch.equal(eager[0], keep)
    assert int(eager[1]) == int(count) > 0
    assert (eager[0][6:12] == -1).all()  # padding rows keep nothing
    assert (keep[:6, 3:] == -1).all()  # short rows ran out early


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_prune_at_bucketed_shape_equals_unpadded(ints, alpha):
    rng = np.random.default_rng(11)
    R = 8
    x = torch.from_numpy(ints)
    p_ids, cand, cand_d = _candidates(rng, 37, 13, len(ints), ints, 4)
    c0 = [0]
    want = vamana.robust_prune_batch(p_ids, cand, cand_d, x, alpha, R, c0)
    rows, width = vamana._bucket(37), R + 16
    assert rows == 64
    pc = torch.full((rows, width), -1, dtype=torch.long)
    pc[:37, :13] = cand
    pd = torch.full((rows, width), torch.inf)
    pd[:37, :13] = cand_d
    pp = torch.zeros(rows, dtype=torch.long)
    pp[:37] = p_ids
    c1 = [0]
    got = vamana.robust_prune_batch(pp, pc, pd, x, alpha, R, c1)
    assert torch.equal(got[:37], want)
    assert (got[37:] == -1).all()
    assert int(c1[0]) == int(c0[0]) > 0


def test_bucket_rounds_rows_up_to_a_power_of_two():
    assert [vamana._bucket(n) for n in (1, 5, 64, 65, 256, 300, 512)] == [
        64, 64, 64, 128, 256, 512, 512]


@pytest.mark.parametrize("max_new", [1, 16, 17, 40])
def test_reverse_edges_at_bucketed_shapes_match_reference(ints, max_new):
    """Every row full (so every destination overflows), with ``max_new``
    new sources for one destination: on the card the re-prune's lanes
    round up to 32, 32, 32 and 64 (R = 8)."""
    rng = np.random.default_rng(max_new)
    n, R = len(ints), 8
    graph = jvamana._random_regular_init(n, R, rng)
    hot = 7
    others = np.setdiff1d(np.arange(n), [hot])
    batch = rng.choice(others, size=max(max_new, 21), replace=False)
    pruned = np.full((len(batch), R), -1, np.int64)
    for b, p in enumerate(batch):
        nb = rng.choice(np.setdiff1d(others, [p]), size=R - 1, replace=False)
        pruned[b, :R - 1] = nb
        if b < max_new:
            pruned[b, R - 1] = hot  # max_new sources for one row
    graph[hot] = rng.choice(np.setdiff1d(others, batch), R, replace=False)
    want_g, want_c = graph.copy(), [0]
    jvamana._apply_reverse_edges(batch, pruned, want_g, ints, 1.2, R,
                                 want_c)
    got_g, got_c = torch.from_numpy(graph.astype(np.int32)), [0]
    vamana._apply_reverse_edges(torch.from_numpy(batch),
                                torch.from_numpy(pruned), got_g,
                                torch.from_numpy(ints), 1.2, R, got_c)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    assert int(got_c[0]) == want_c[0] > 0


def test_reverse_edges_over_several_chunks_match_reference(ints,
                                                           monkeypatch):
    """Hundreds of overflowing rows in chunks of 64 (the byte budget cut
    down) give the reference's graph and count."""
    monkeypatch.setattr(vamana, "PRUNE_CHUNK_BYTES",
                        64 * 4 * 24 * (24 + 16 + 8))  # 64 rows at width 24
    rng = np.random.default_rng(21)
    n, R = len(ints), 8
    graph = jvamana._random_regular_init(n, R, rng)  # every row full
    batch = rng.choice(n, size=60, replace=False)
    pruned = np.stack([rng.choice(np.setdiff1d(np.arange(n), [p]), R,
                                  replace=False) for p in batch])
    want_g, want_c = graph.copy(), [0]
    jvamana._apply_reverse_edges(batch, pruned, want_g, ints, 1.2, R,
                                 want_c)
    got_g, got_c = torch.from_numpy(graph.astype(np.int32)), [0]
    vamana._apply_reverse_edges(torch.from_numpy(batch),
                                torch.from_numpy(pruned), got_g,
                                torch.from_numpy(ints), 1.2, R, got_c)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    assert int(got_c[0]) == want_c[0] > 0
    assert (want_g != graph).any(axis=1).sum() > 2 * 64  # several chunks


def test_graph_rows_cut_narrow_chunks_to_a_power_of_two():
    """A round's prune (C = 128) and its overflow re-prune (R + max_new)
    replay graphs in power-of-two chunks inside the budget; rows so wide
    that 64 do not fit (consolidation's 2-hop candidates) run eagerly."""
    D = 128
    for c in (128, 80, 65, 200):
        rows = vamana._graph_rows(c, D)
        lanes = vamana._lanes(c)
        assert rows >= 64 and rows & (rows - 1) == 0
        work = 4 * lanes * (lanes + D + 8)
        assert rows * work <= vamana.PRUNE_GRAPH_CHUNK_BYTES < 2 * rows * work
    assert vamana._graph_rows(128, D) == 1024
    assert vamana._graph_rows(2000, D) == 0
    assert [vamana._lanes(c) for c in (1, 32, 33, 80, 96, 97)] == [
        32, 32, 64, 96, 96, 128]


class _FakeCapture:
    """Stands in for ``_CapturedPrune`` on the CPU: static bytes, the bytes
    it adds to the pool, a pool id and the eager prune."""

    made: list = []

    def __init__(self, nb, c, d, alpha, R, dev, pool=None):
        self.nbytes = nb * c
        self.in_pool = 2 * nb * c
        self.setup = type("G", (), {"pool": staticmethod(lambda: (1, 2))})()
        _FakeCapture.made.append((nb, c))

    def __call__(self, p_ids, cand, cand_d, vecs):
        return vamana._prune_rows(p_ids, cand, cand_d, vecs, 1.2, 8)


def test_prune_graphs_reset_when_past_their_budget(ints, monkeypatch):
    """A capture that would start past the budget drops every graph and
    the pool first; replays capture nothing; the ids are the eager
    loop's throughout."""
    monkeypatch.setattr(vamana, "_CapturedPrune", _FakeCapture)
    monkeypatch.setattr(vamana.PruneGraphs, "pool_bytes", lambda self: sum(
        g.in_pool for g in self._graphs.values()))
    _FakeCapture.made = []
    graphs = vamana.PruneGraphs(max_bytes=15000)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(ints)

    def run(nb, c):
        p, cand, cand_d = _candidates(rng, nb, c, len(ints), ints, 2)
        want = vamana._prune_rows(p, cand, cand_d, x[cand.clamp_min(0)],
                                  1.2, 8)
        got = graphs(p, cand, cand_d, x[cand.clamp_min(0)], 1.2, 8)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])

    run(10, 20)  # key (64 rows, 32 lanes): 2048 static + 4096 pool
    run(40, 30)  # the same key: replayed
    run(70, 17)  # (128, 32): 6144 before it, within the budget
    assert _FakeCapture.made == [(64, 32), (128, 32)]
    assert graphs.card_bytes() == 18432 and graphs.resets == 0
    run(100, 3)  # (128, 32) replayed, past the budget: no capture
    run(9, 40)  # (64, 64): 18432 before it, past the budget: a reset
    assert _FakeCapture.made == [(64, 32), (128, 32), (64, 64)]
    assert len(graphs) == 1 and graphs.resets == 1 and graphs.captures == 3
    assert graphs.card_bytes() == 3 * 64 * 64
