"""The control of ``correct``: the reference computed in TF32, the
precision just below the configurations' float32, put in the program's
place, makes a run come out not correct through the harness's own
comparison, where the program's own run is correct.  The build's control
is the reference's kNN in TF32 in the place of the program's kNN kernel
(K4); the search's, the reference's exact search in TF32 in the place of
the program's merged search.  At a tiny size on the CPU (TF32 as the
tensor cores round their inputs), and on the card at a 20,000-point
index of the SIFT configuration."""

import numpy as np
import pytest

from annbench import datagen, harness
from annbench.reference import exact, graph
from annbench.tiny import run


def tf32_knn(monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "knn", exact.knn_tf32)


def tf32_search(monkeypatch):
    from repro_torch.search import fused_backend

    plain = fused_backend.search_merged

    def control(topo, queries, k, **kw):
        _, st = plain(topo, queries, k, **kw)
        ids = exact.exact_knn(topo.data, np.asarray(queries), k,
                              device="cpu", tf32=True)
        return ids, st

    monkeypatch.setattr(fused_backend, "search_merged", control)


@pytest.mark.parametrize("cell,control,number", [
    ("sift.build", tf32_knn, "build_gap"),
    ("sift.search", tf32_search, "order_gap"),
])
def test_control_through_the_harness_is_not_correct(cell, control, number,
                                                    monkeypatch,
                                                    few_threads):
    assert run(cell)["checks"][number]["ok"]
    control(monkeypatch)
    r = run(cell)
    assert not r["correct"]
    assert not r["checks"][number]["ok"], r["checks"]


@pytest.mark.card
def test_tf32_control_fails_where_the_program_passes(card, monkeypatch):
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core.builder import build_scalegann
    from repro_torch.kernels import ops
    from repro_torch.search import search

    bench = harness.load_benchmark()
    cfg = harness.config(bench, "sift-128-l2")
    ic = cfg["index_config"]
    order_limit = harness.limits("sift.search")["order_gap"]["max"]
    build_limit = harness.limits("sift.build")["build_gap"]["max"]
    data = datagen.base_data(cfg, 20_000)
    res = build_scalegann(data, IndexConfig(**ic))
    with monkeypatch.context() as m:
        m.setattr(ops, "knn", exact.knn_tf32)
        ctl_build = build_scalegann(data, IndexConfig(**ic))

    def gap(r, seed):
        rows = np.sort(np.random.default_rng(seed).choice(
            len(data), 2048, replace=False))
        g = graph.build_gap(data, [s.ids for s in r.shards], r.shard_graphs,
                            r.index.graph, rows,
                            build_degree=ic["build_degree"],
                            degree=ic["degree"], device=card)
        return g["differ"] / g["slots"]

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        assert gap(res, seed) <= build_limit
        assert gap(ctl_build, seed) > build_limit
        q = datagen.QueryStream(cfg, 1, datagen.sub_seed(seed, "q"),
                                card).take(4000)
        ids, _ = search(res.topology(data), q, 10, width=64)
        ctl = exact.exact_knn(data, q, 10, device=card, tf32=True)
        assert exact.order_gap(data, q, ids, device=card) <= order_limit
        assert exact.order_gap(data, q, ctl, device=card) > order_limit
        assert exact.invalid_ids(np.asarray(ctl), len(data)) == 0
