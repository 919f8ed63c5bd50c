"""Background work giving way to a backlogged server
(``repro_torch.common.backpressure``), on the CPU.

* A yield point costs nothing while no server presses, waits while one
  does, and gives up after its longest wait.
* ``AnnServer`` presses once more than two batches wait, and releases
  when it is back under one batch and when it stops.
* A Vamana build whose yield points wait (a server pressing meanwhile)
  gives the graph and distance count of one that never waits.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

from repro_torch.common import backpressure
from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.core.vamana import build_shard_index_vamana
from repro_torch.data.synthetic import make_clustered
from repro_torch.serving import AnnServer, ServingConfig


class _Owner:
    pass


@pytest.fixture(autouse=True)
def _clean():
    backpressure.reset_stats()
    yield
    assert not backpressure.pressed()


def test_yield_point_is_free_without_a_pressing_server():
    assert backpressure.yield_point() == 0.0
    assert backpressure.stats() == {"presses": 0, "waits": 0, "wait_s": 0.0}


def test_yield_point_waits_until_the_server_releases():
    owner = _Owner()
    backpressure.press(owner)
    backpressure.press(owner)  # pressing again is one press
    assert backpressure.pressed()
    timer = threading.Timer(0.1, backpressure.release, args=(owner,))
    timer.start()
    waited = backpressure.yield_point(max_wait_s=5.0)
    timer.join()
    assert 0.05 <= waited < 5.0
    st = backpressure.stats()
    assert st["presses"] == 1 and st["waits"] == 1
    assert st["wait_s"] == pytest.approx(waited)


def test_yield_point_gives_up_after_its_longest_wait():
    owner = _Owner()
    backpressure.press(owner)
    try:
        waited = backpressure.yield_point(max_wait_s=0.05)
        assert 0.04 <= waited < 1.0
        assert backpressure.pressed()
    finally:
        backpressure.release(owner)
    backpressure.release(owner)  # releasing twice is harmless


def test_server_presses_when_two_batches_behind():
    ds = make_clustered(600, 16, n_queries=40, seed=2, device="cpu")
    res = build_scalegann(ds.data, IndexConfig(degree=16, build_degree=32,
                                               n_clusters=4),
                          algo="vamana", device="cpu")
    topo = res.shard_topology(ds.data)
    cfg = ServingConfig(backend="numpy", k=5, width=16, nprobe=2,
                        max_batch=4, max_wait_ms=1.0, pretrace=False)
    seen = {}

    async def run():
        async with AnnServer(topo, cfg, device="cpu") as srv:
            futs = [srv.submit_nowait(q) for q in ds.queries[:8]]
            seen["at_two_batches"] = backpressure.pressed()
            futs.append(srv.submit_nowait(ds.queries[8]))
            seen["past_two_batches"] = backpressure.pressed()
            outs = await asyncio.gather(*futs)
            seen["caught_up"] = backpressure.pressed()
            futs = [srv.submit_nowait(q) for q in ds.queries[:20]]
            seen["behind_again"] = backpressure.pressed()
        seen["stopped"] = backpressure.pressed()
        await asyncio.gather(*futs)
        return outs

    outs = asyncio.run(run())
    assert len(outs) == 9
    assert seen == {"at_two_batches": False, "past_two_batches": True,
                    "caught_up": False, "behind_again": True,
                    "stopped": False}
    assert backpressure.stats()["presses"] == 2


def test_vamana_build_unchanged_by_waiting():
    x = np.random.default_rng(5).integers(0, 8, (300, 8)).astype(np.float32)
    cfg = IndexConfig(degree=8, build_degree=16)
    plain = build_shard_index_vamana(x, cfg, batch_size=32, device="cpu")
    owner = _Owner()
    stop = threading.Event()

    def pulse():  # a server catching up and falling behind, over and over
        while not stop.is_set():
            time.sleep(0.002)
            backpressure.release(owner)
            time.sleep(0.002)
            backpressure.press(owner)

    backpressure.press(owner)  # behind from the start: the first round waits
    th = threading.Thread(target=pulse)
    th.start()
    try:
        waited = build_shard_index_vamana(x, cfg, batch_size=32,
                                          device="cpu")
    finally:
        stop.set()
        th.join()
        backpressure.release(owner)
    np.testing.assert_array_equal(waited.graph, plain.graph)
    assert waited.n_distance_computations == plain.n_distance_computations
    assert backpressure.stats()["waits"] > 0
