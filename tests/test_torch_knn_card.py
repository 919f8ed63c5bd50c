"""K4 (``kernels/csrc/knn.cu``) on the card at the widths where its Q panel
no longer fits a block's shared memory, held to its plain version: D 864
(the widest resident panel at k = 129), 960 (GIST) and 1,024, at a CAGRA
build's k = L + 1 = 129 and at the kernel's largest k, 256; M not a
multiple of a block's rows, N over several column spans, L2 and IP.  Also:
the block shape the library picks (the resident panel wherever it fits),
every block shape that fits gives the same bits, and a traced shard build
carries the block shape on ``shard.knn``.  Skipped without a card:

    PYTHONPATH=src python -m pytest -m card tests/test_torch_knn_card.py
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core.cagra import build_shard_index
from repro_torch.kernels import topk
from repro_torch.telemetry import Tracer, use_tracer

RTOL = 1e-5  # float32 distances summed in another order than the plain path
PLANS = [topk.KnnPlan(r, p) for p in ("resident", "streamed") for r in (64, 32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _points(m, n, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, device="cuda", generator=g)
    q = torch.randn(m, d, device="cuda", generator=g)
    return q, x


def _fits(plan, d, k):
    return topk._lib().repro_knn_splits(
        1000, 9000, d, k, plan.rows, int(plan.panel == "streamed")) > 0


@pytest.mark.card
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d,k", list(itertools.product((864, 960, 1024),
                                                       (129, 256))))
def test_k4_matches_plain_at_large_d(card, d, k, metric):
    m, n = 1000, 20_000  # 1000 rows: 15 blocks of 64 and 40 rows
    q, x = _points(m, n, d, seed=d + k)
    plan = topk.knn_plan(d, k)
    assert m % plan.rows != 0
    gd, gi = topk.knn_cuda(q, x, k, metric)
    wd, wi = topk.knn_plain(q, x, k + 1, metric)  # one more: the row's gap
    torch.cuda.synchronize()
    scale = float(wd.abs().max())
    torch.testing.assert_close(gd, wd[:, :k], rtol=RTOL, atol=RTOL * scale)
    got = torch.sort(gi.long(), dim=1).values
    want = torch.sort(wi[:, :k], dim=1).values
    differ = (got != want).any(dim=1)
    # a row's sets may differ only where its k-th and (k+1)-th distances
    # lie within the tolerance of each other
    gap = (wd[:, k] - wd[:, k - 1]).abs()
    near = gap <= RTOL * wd[:, k].abs() + RTOL * scale
    assert not bool((differ & ~near).any()), int((differ & ~near).sum())
    print(f"K4 {plan} D={d} k={k} {metric}: rows whose sets differ "
          f"{int(differ.sum())} of {m}, all near-ties")


@pytest.mark.card
@pytest.mark.parametrize("d,k,rows,panel", [
    (128, 129, 64, "resident"),  # SIFT's shard builds: the kernel as it was
    (128, 256, 32, "resident"),
    (864, 129, 32, "resident"),  # the widest resident panel at k = 129
    (896, 129, 64, "streamed"),
    (960, 129, 64, "streamed"),  # GIST's shard builds
    (1024, 256, 32, "streamed"),
])
def test_knn_plan_keeps_the_resident_panel_where_it_fits(card, d, k, rows,
                                                         panel):
    assert topk.knn_plan(d, k) == topk.KnnPlan(rows, panel)
    assert _fits(topk.KnnPlan(rows, panel), d, k)
    # every shape before it in the library's order does not fit
    for plan in PLANS[:PLANS.index(topk.KnnPlan(rows, panel))]:
        assert not _fits(plan, d, k), plan


@pytest.mark.card
def test_knn_plan_names_the_limit_where_nothing_fits(card):
    with pytest.raises(ValueError, match="232448 bytes"):
        topk.knn_plan(128, 2048)


@pytest.mark.card
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d,k", [(128, 129), (512, 129), (864, 129),
                                 (100, 256)])
def test_every_block_shape_gives_the_same_bits(card, d, k, metric):
    """Where the resident panel fits, the streamed one (and the other row
    count) sums each distance in the same order: equal outputs."""
    q, x = _points(777, 9_000, d, seed=d)
    want = topk.knn_cuda(q, x, k, metric)
    for plan in PLANS:
        if not _fits(plan, d, k):
            continue
        got = topk._launch(q, x, k, metric, plan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            plan


@pytest.mark.card
@pytest.mark.parametrize("d,rows,panel", [(128, 64, "resident"),
                                          (960, 64, "streamed")])
def test_traced_shard_build_records_k4_block_shape(card, d, rows, panel):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((5000, d)).astype(np.float32)
    tracer = Tracer()
    with use_tracer(tracer):
        build_shard_index(x, IndexConfig(degree=64, build_degree=128),
                          device="cuda")
    (knn,) = [e["args"] for e in tracer.to_chrome()["traceEvents"]
              if e.get("name") == "shard.knn"]
    assert (knn["d"], knn["k"]) == (d, 129)
    assert (knn["block_rows"], knn["panel"]) == (rows, panel)
