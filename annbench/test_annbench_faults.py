"""A run with its timed path broken underneath comes out not correct: once
for each fault a cell can have, judged on as many rows a batch or a job as
the cell judges.  One chip, so no exchange between chips to leave out."""

import numpy as np
import pytest

from annbench.tiny import CELLS, run


def search_fault(monkeypatch, edit):
    """Break the engine's merged search: ``edit(ids, n)`` changes its
    answers where they are produced."""
    from repro_torch.search import fused_backend

    plain = fused_backend.search_merged

    def broken(topo, queries, k, **kw):
        ids, st = plain(topo, queries, k, **kw)
        return edit(ids.copy(), len(topo.data), topo, queries, k, kw), st

    monkeypatch.setattr(fused_backend, "search_merged", broken)


def unchanged(monkeypatch, cell):
    if cell.endswith(".build"):  # the merge leaves its graph as it starts
        from repro_torch.core import builder
        from repro_torch.core.merge import GlobalIndex

        def empty(shards, idxs, n, degree, **kw):
            return GlobalIndex(graph=np.full((n, degree), -1, np.int32),
                               medoid=0, n_vectors=n)

        monkeypatch.setattr(builder, "merge_shard_indexes", empty)
    else:  # the beam never takes a step from its entries
        from repro_torch.kernels import beam

        monkeypatch.setattr(beam, "default_n_iters", lambda width: 0)


def half_left_out(monkeypatch, cell):
    if cell.endswith(".build"):  # the partition drops half the points
        from repro_torch.core import builder

        plain = builder.partition

        def half(data, cfg, **kw):
            part = plain(data, cfg, **kw)
            for s in part.shards:
                keep = s.ids < len(data) // 2
                s.ids, s.is_replica = s.ids[keep], s.is_replica[keep]
            return part

        monkeypatch.setattr(builder, "partition", half)
    else:  # only the first half of a batch is answered
        def edit(ids, n, topo, queries, k, kw):
            ids[(len(ids) + 1) // 2:] = -1
            return ids

        search_fault(monkeypatch, edit)


def altered(monkeypatch, cell):
    if cell.endswith(".build"):  # one edge of the merged graph
        from repro_torch.core import builder

        plain = builder.merge_shard_indexes

        def merge(*a, **kw):
            g = plain(*a, **kw)
            g.graph[0, 0] = 0
            return g

        monkeypatch.setattr(builder, "merge_shard_indexes", merge)
    else:  # the first answer of each engine call
        def edit(ids, n, topo, queries, k, kw):
            ids[0, 0] = (ids[0, 0] + n // 2) % n
            return ids

        search_fault(monkeypatch, edit)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_not_correct(cell, fault, monkeypatch,
                                         few_threads):
    fault(monkeypatch, cell)
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert any(not c["ok"] for c in r["checks"].values())

