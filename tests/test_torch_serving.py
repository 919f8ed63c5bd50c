"""``repro_torch.serving`` against ``repro.serving`` on the same inputs.

Every comparison here is exact:

* the batching state machines — the same script of ``add``/``poll``/
  ``take``/``submit`` calls on a fake clock gives the same flushes (by
  request index), deadlines, rejections and shed victims, and the
  policies the same ``window_ms`` sequence;
* ``ServerStats`` — the same operations give byte-equal Prometheus text
  and equal snapshots;
* ``AnnServer`` end to end on the CPU — the same requests, with mixed
  per-request ``nprobe``/``dtype`` overrides and a ``swap_topology``
  between two waves, give each request the same ids and the same batch
  size, and the stats the same engine counters (distance, hop, quantized
  and re-rank computations, batches, lanes, occupancy), with
  ``run_in_executor`` on and off.  Port ``numpy`` is held to reference
  ``numpy``; port ``torch`` and ``fused`` (``device="cpu"``, so the beam
  kernel's plain version) to reference ``jax``.  Latencies depend on the
  clock and are not compared, except under a ``ManualClock``, where the
  served trace's Chrome JSON is byte-equal;
* the reference's failure semantics hold in both packages.

The index is built once by the reference and carried across with
``topology_from_arrays``, so serving parity does not rest on build parity.
"""

import asyncio
import dataclasses
import itertools
import json
import time

import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro.serving.server as jserver_mod
import repro.telemetry as jtel
import repro_torch.serving as tserving
import repro_torch.serving.server as tserver_mod
import repro_torch.telemetry as ttel
from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import builder as jbuilder
from repro.data.synthetic import make_clustered as jmake
from repro.search import MergedTopology as JMerged
from repro.search import ShardTopology as JShard
from repro_torch.search import ShardTopology, fused_backend, search
from repro_torch.search import topology_from_arrays

PKGS = {"ref": jserving, "port": tserving}
DEVICE = {"ref": {}, "port": {"device": "cpu"}}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def _ring_arrays():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(40, 8)).astype(np.float32)
    g = np.stack([(np.arange(40) + s) % 40 for s in range(1, 6)],
                 axis=1).astype(np.int32)
    return data, [np.arange(40, dtype=np.int64)], [g]


@pytest.fixture(scope="module")
def ring():
    """One 40-vector shard with a ring graph (the reference suite's):
    width 64 > n, so beam search visits everything."""
    data, ids, graphs = _ring_arrays()
    return {
        "ref": JShard(data=data, shard_ids=ids, shard_graphs=graphs),
        "port": ShardTopology(data=data, shard_ids=ids, shard_graphs=graphs),
        "data": data,
    }


@pytest.fixture(scope="module")
def built():
    """A small index built by the reference: 300 points in 16 dims,
    4 clusters, R=8; merged and split topologies in both packages."""
    ds = jmake(300, 16, n_queries=24, spread=1.0, seed=5)
    cfg = JIndexConfig(n_clusters=4, degree=8, build_degree=16,
                       block_size=256)
    b = jbuilder.build_scalegann(ds.data, cfg, n_workers=1)
    ids = [s.ids for s in b.shards]
    return {
        "ds": ds,
        "merged": {
            "ref": JMerged(data=ds.data, index=b.index),
            "port": topology_from_arrays(ds.data, graph=b.index.graph,
                                         medoid=b.index.medoid),
        },
        "split": {
            "ref": JShard(data=ds.data, shard_ids=ids,
                          shard_graphs=b.shard_graphs,
                          centroids=b.centroids),
            "port": topology_from_arrays(ds.data, shard_ids=ids,
                                         shard_graphs=b.shard_graphs,
                                         centroids=b.centroids),
        },
    }


def _req(t_submit: float, future=None, pkg="port"):
    return PKGS[pkg].PendingRequest(query=None, future=future,
                                    t_submit=t_submit)


def test_public_names_match_reference():
    assert sorted(tserving.__all__) == sorted(jserving.__all__)
    for name in tserving.__all__:
        assert hasattr(tserving, name), name
    got = {f.name: f.default for f in dataclasses.fields(
        tserving.ServingConfig)}
    want = {f.name: f.default for f in dataclasses.fields(
        jserving.ServingConfig)}
    assert got.pop("pretrace_nprobes") == ()  # the port's addition
    assert want.pop("backend") == "jax" and got.pop("backend") == "fused"
    assert got == want


def test_serve_vs_serving_namespaces():
    import repro_torch.serve as lm

    assert "LM decode" in lm.__doc__ and "repro_torch.serving" in lm.__doc__
    assert "ANN" in tserving.__doc__ and "repro_torch.serve" in \
        tserving.__doc__
    assert set(lm.__all__).isdisjoint(tserving.__all__)


# ---------------------------------------------------------------------------
# batching state machines on a fake clock
# ---------------------------------------------------------------------------


def _batcher_script(pkg, seed: int, max_batch: int, max_wait: float):
    """Seeded add/poll/take/shed/retune script; returns every observable
    as request indices."""
    rng = np.random.default_rng(seed)
    mb = PKGS[pkg].MicroBatcher(max_batch, max_wait)
    reqs, log, now = [], [], 0.0
    idx = {}
    for _ in range(300):
        now += float(rng.exponential(max_wait / 3 + 1e-4))
        op = int(rng.integers(0, 10))
        if op < 6:
            r = _req(now, pkg=pkg)
            idx[id(r)] = len(reqs)
            reqs.append(r)
            out = mb.add(r)
        elif op < 8:
            out = mb.poll(now)
        elif op == 8:
            out = mb.take() if rng.random() < 0.5 else [mb.shed_oldest()]
        else:
            mb.max_wait_s = float(rng.uniform(0.0, 2 * max_wait))
            out = None
        log.append((
            None if out is None else [idx[id(r)] if r is not None else None
                                      for r in out],
            len(mb), mb.deadline(),
        ))
    return log


@pytest.mark.parametrize("seed,max_batch,max_wait", [
    (0, 4, 0.005), (1, 8, 0.002), (2, 1, 0.01), (3, 64, 0.05)])
def test_micro_batcher_matches_reference(seed, max_batch, max_wait):
    assert _batcher_script("port", seed, max_batch, max_wait) == \
        _batcher_script("ref", seed, max_batch, max_wait)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_micro_batcher_rejects_bad_arguments(pkg):
    with pytest.raises(ValueError, match="max_batch"):
        PKGS[pkg].MicroBatcher(0, 1.0)
    with pytest.raises(ValueError, match="max_wait"):
        PKGS[pkg].MicroBatcher(1, -1.0)


def _queue_script(pkg, seed: int, admission: str, max_pending: int):
    """Seeded admission script on a fake clock, then a drain after close:
    rejections, shed victims, depths, flushed batches and how each future
    ended, all by request index."""
    async def main():
        loop = asyncio.get_running_loop()
        now = {"t": 0.0}
        q = PKGS[pkg].RequestQueue(
            PKGS[pkg].MicroBatcher(3, 0.004), max_pending,
            admission=admission, clock=lambda: now["t"])
        rng = np.random.default_rng(seed)
        reqs, log = [], []
        idx = lambda r: reqs.index(r)  # noqa: E731
        for _ in range(40):
            now["t"] += float(rng.exponential(0.002))
            r = _req(now["t"], loop.create_future(), pkg=pkg)
            reqs.append(r)
            try:
                shed = q.submit(r)
                log.append(("ok", None if shed is None else idx(shed)))
            except PKGS[pkg].ServerOverloadedError:
                log.append(("rejected", None))
            log.append(("depth", q.depth()))
            if rng.random() < 0.3 and q.depth():  # the worker takes one
                dl = q.batcher.deadline()
                if not q._ready and dl is not None:
                    # on the fake clock an open batch is due at its deadline
                    now["t"] = max(now["t"], dl)
                b = await asyncio.wait_for(q.next_batch(), 5.0)
                log.append(("batch", [idx(x) for x in b]))
        q.close()
        with pytest.raises(RuntimeError, match="clos"):
            q.submit(_req(now["t"], loop.create_future(), pkg=pkg))
        while (b := await q.next_batch()) is not None:
            log.append(("drain", [idx(x) for x in b]))
        ends = []
        for r in reqs:
            if r.future.done():
                ends.append(type(r.future.exception()).__name__)
            else:
                ends.append("pending")
        return log, ends

    return asyncio.run(main())


@pytest.mark.parametrize("admission,max_pending", [
    ("reject", 4), ("shed", 4), ("shed", 7), ("reject", 100)])
def test_request_queue_matches_reference(admission, max_pending):
    got = _queue_script("port", 11, admission, max_pending)
    want = _queue_script("ref", 11, admission, max_pending)
    assert got == want
    kinds = {e[0] for e in got[0]}
    if max_pending == 4:
        assert ("rejected" in kinds) == (admission == "reject")


def test_fail_all_matches_reference():
    async def run(pkg):
        loop = asyncio.get_running_loop()
        q = PKGS[pkg].RequestQueue(PKGS[pkg].MicroBatcher(2, 1e9), 10)
        reqs = [_req(float(i), loop.create_future(), pkg=pkg)
                for i in range(5)]
        for r in reqs:
            q.submit(r)
        n = q.fail_all(RuntimeError("worker died"))
        return n, [str(r.future.exception()) for r in reqs], q.depth()

    assert asyncio.run(run("port")) == asyncio.run(run("ref"))


@pytest.mark.parametrize("policy", [
    ("FixedWindow", (3.0,)), ("AdaptiveWindow", (10.0, 10, 0.5)),
    ("AdaptiveWindow", (2.0, 64)), ("AdaptiveWindow", (5.0, 0))])
def test_policies_match_reference(policy):
    name, args = policy
    got = getattr(tserving, name)(*args)
    want = getattr(jserving, name)(*args)
    depths = list(range(0, 130)) + [1000]
    assert [got.window_ms(d) for d in depths] == \
        [want.window_ms(d) for d in depths]
    assert isinstance(got, tserving.SLOPolicy)


def test_bucket_batch_size_matches_reference():
    for cap in (1, 2, 7, 32, 64, 256):
        for m in range(0, 300):
            assert tserver_mod.bucket_batch_size(m, cap) == \
                jserver_mod.bucket_batch_size(m, cap)


# ---------------------------------------------------------------------------
# ServerStats
# ---------------------------------------------------------------------------


def _stats_script(pkg, seed: int):
    from repro.search import SearchStats as JStats
    from repro_torch.search import SearchStats as TStats

    stats_cls = {"ref": JStats, "port": TStats}[pkg]
    rng = np.random.default_rng(seed)
    st = PKGS[pkg].ServerStats(latency_cap=32)
    for _ in range(200):
        op = int(rng.integers(0, 8))
        t0 = float(rng.uniform(0, 10))
        if op < 4:
            st.record_completion(
                t0, t0 + float(rng.exponential(0.01)),
                queue_wait_s=float(rng.exponential(0.002)),
                engine_s=float(rng.exponential(0.003)))
        elif op == 4:
            st.record_completion(t0, t0 - 1.0)  # clamps to 0
        elif op == 5:
            n_real = int(rng.integers(1, 65))
            n_pad = tserver_mod.bucket_batch_size(n_real, 64)
            st.observe_batch(n_real, n_pad, stats_cls(
                n_distance_computations=int(rng.integers(0, 10**6)),
                n_hops=int(rng.integers(0, 10**4)), n_queries=n_pad,
                n_quantized_distance_computations=int(rng.integers(0, 10)),
                n_rerank_distance_computations=int(rng.integers(0, 99)),
            ), float(rng.exponential(0.001)))
        elif op == 6:
            st.record_rejected()
            st.record_shed()
        else:
            st.record_failed(int(rng.integers(1, 4)))
    return st


@pytest.mark.parametrize("seed", [0, 1])
def test_server_stats_match_reference(seed):
    got, want = _stats_script("port", seed), _stats_script("ref", seed)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.snapshot() == want.snapshot()
    assert dataclasses.asdict(got.search) == dataclasses.asdict(want.search)
    text = got.to_prometheus()
    parsed = ttel.parse_prometheus(text)
    assert parsed == jtel.parse_prometheus(text)
    assert parsed[("serving_requests_total",
                   frozenset({("outcome", "completed")}))] == got.n_completed
    assert parsed[("serving_engine_batches_total", frozenset())] == \
        got.n_batches


# ---------------------------------------------------------------------------
# AnnServer end to end: the port against the reference
# ---------------------------------------------------------------------------

# (nprobe, dtype) overrides, None = the server default
COMBOS = [(None, None), ("auto", "uint8"), (2, None), (None, "bf16"),
          (1, "uint8"), (("auto", 1.25), "f32"), (np.int64(2), "uint8")]


def _serve(pkg, topo, swap_to, queries, backend, run_in_executor,
           **cfg_kw):
    """Two waves of requests, all submitted before the worker runs (so
    batches form the same way in both packages), with ``swap_to`` served
    from the second wave on."""
    srv_mod = PKGS[pkg]
    cfg = srv_mod.ServingConfig(backend=backend, k=5, width=16,
                                max_batch=8, max_wait_ms=1.0,
                                run_in_executor=run_in_executor, **cfg_kw)

    async def main():
        srv = srv_mod.AnnServer(topo, config=cfg, **DEVICE[pkg])
        results = []
        async with srv:
            half = len(queries) // 2
            for lo, hi in ((0, half), (half, len(queries))):
                futs = []
                for i in range(lo, hi):
                    nprobe, dtype = COMBOS[i % len(COMBOS)]
                    kw = {}
                    if nprobe is not None:
                        kw["nprobe"] = nprobe
                    if dtype is not None:
                        kw["dtype"] = dtype
                    futs.append(srv.submit_nowait(queries[i], **kw))
                for r in await asyncio.gather(*futs):
                    results.append((r.ids.tolist(), r.batch_size))
                if lo == 0:
                    assert srv.swap_topology(swap_to, reason="churn") == 1
        st = srv.stats
        snap = st.registry.snapshot()
        counters = dict(
            n_completed=st.n_completed, n_failed=st.n_failed,
            n_batches=st.n_batches, lanes=st.n_served_lanes,
            padded=st.n_padded_lanes, dist=st.dist_comps, hops=st.hops,
            quant=st.quant_comps, rerank=st.rerank_comps,
            occupancy=st.occupancy(), search=dataclasses.asdict(st.search),
            post_warm=snap["serving_post_warm_signatures_total"],
            generation=snap["serving_topology_generation"],
            swaps=snap["serving_topology_swaps_total"],
        )
        return results, counters

    return asyncio.run(main())


_REF_RUNS: dict = {}

PAIRS = [("numpy", "numpy"), ("torch", "jax"), ("fused", "jax")]


@pytest.mark.parametrize("run_in_executor", [True, False])
@pytest.mark.parametrize("kind", ["ring", "merged", "split"])
@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_served_requests_match_reference(ring, built, kind, backend,
                                         ref_backend, run_in_executor):
    if kind == "ring":
        data = ring["data"]
        queries = np.concatenate([data[:14], data[::-3]])
        topos = {p: ring[p] for p in ("ref", "port")}
        swaps = {"ref": JShard(data=data, shard_ids=ring["ref"].shard_ids,
                               shard_graphs=ring["ref"].shard_graphs),
                 "port": ShardTopology(data=data,
                                       shard_ids=ring["port"].shard_ids,
                                       shard_graphs=ring["port"].shard_graphs)}
    else:
        queries = np.concatenate([built["ds"].queries, built["ds"].data[:6]])
        other = "split" if kind == "merged" else "merged"
        topos, swaps = built[kind], built[other]
    key = (kind, ref_backend, run_in_executor)
    if key not in _REF_RUNS:
        _REF_RUNS[key] = _serve("ref", topos["ref"], swaps["ref"], queries,
                                ref_backend, run_in_executor)
    want_res, want_st = _REF_RUNS[key]
    got_res, got_st = _serve("port", topos["port"], swaps["port"], queries,
                             backend, run_in_executor)
    assert got_res == want_res
    assert got_st == want_st
    assert got_st["n_completed"] == len(queries) and got_st["n_failed"] == 0
    assert got_st["quant"] > 0 and got_st["rerank"] > 0


def test_served_trace_byte_equal_under_manual_clock(ring, monkeypatch):
    """f32 traffic (no wall-clock re-rank stage) on a fake server clock:
    the same requests draw the same Chrome JSON in both packages."""
    def run(pkg):
        srv_pkg = PKGS[pkg]
        tel = {"ref": jtel, "port": ttel}[pkg]
        mod = {"ref": jserver_mod, "port": tserver_mod}[pkg]
        monkeypatch.setattr(mod, "_SERVER_SEQ", itertools.count())
        clock = tel.ManualClock(100.0)
        tracer = tel.Tracer(clock, process="serving")
        cfg = srv_pkg.ServingConfig(
            backend={"ref": "numpy", "port": "numpy"}[pkg], k=3, width=16,
            max_batch=4, max_wait_ms=0.0, pretrace=False,
            run_in_executor=False)

        async def main():
            async with srv_pkg.AnnServer(ring[pkg], config=cfg, clock=clock,
                                         tracer=tracer,
                                         **DEVICE[pkg]) as srv:
                futs = []
                for i in range(10):
                    clock.advance(0.001)
                    futs.append(srv.submit_nowait(ring["data"][i]))
                await asyncio.gather(*futs)
                srv.swap_topology(ring[pkg], reason="churn")
                clock.advance(0.5)
                await srv.submit(ring["data"][11], nprobe=1)

        asyncio.run(main())
        return tracer.to_json()

    got, want = run("port"), run("ref")
    assert got == want
    parsed = json.loads(got)
    assert ttel.validate_chrome_trace(parsed) == []
    chk = ttel.check_serving_trace(parsed)
    assert chk["ok"] and chk["n_requests"] == 11
    names = {e["name"] for e in parsed["traceEvents"]}
    assert {"serve.epoch_swap", "serve.retrace_risk"} <= names


@pytest.mark.parametrize("backend", ["numpy", "torch", "fused"])
def test_traced_serving_decomposes_request_latency(ring, backend):
    tracer = ttel.Tracer(clock=time.monotonic)  # must match the server

    async def main():
        sc = tserving.ServingConfig(backend=backend, k=5, width=64,
                                    max_batch=4, max_wait_ms=2.0,
                                    pretrace_dtypes=("uint8",))
        async with tserving.AnnServer(ring["port"], config=sc,
                                      tracer=tracer, device="cpu") as srv:
            futs = [srv.submit_nowait(ring["data"][i],
                                      dtype="uint8" if i % 3 else "f32")
                    for i in range(12)]
            outs = await asyncio.gather(*futs)
        assert [int(o.ids[0]) for o in outs] == list(range(12))
        snap = srv.stats.registry.snapshot()
        assert snap["serving_post_warm_signatures_total"]["series"][0][
            "value"] == 0

    asyncio.run(main())
    obj = tracer.to_chrome()
    assert ttel.validate_chrome_trace(obj) == []
    chk = ttel.check_serving_trace(obj)
    assert chk["ok"], chk
    assert chk["n_requests"] == 12 and chk["min_coverage_seen"] >= 0.95


def _recording(monkeypatch, mod):
    calls = []
    real = mod.search

    def recording_search(t, queries, k, **kw):
        calls.append((len(queries), str(kw.get("nprobe")), kw.get("dtype")))
        return real(t, queries, k, **kw)

    monkeypatch.setattr(mod, "search", recording_search)
    return calls


@pytest.mark.parametrize("pretrace_nprobes", [(), ("auto", 2)])
def test_mixed_batches_group_as_reference(ring, monkeypatch,
                                          pretrace_nprobes):
    """One flush of mixed overrides makes the same engine calls, in the
    same order and shapes, as the reference — warm-up included — and a
    fake clock gives exact latencies.  ``pretrace_nprobes`` (the port's
    addition) adds warm-up calls and nothing else."""
    def run(pkg):
        mod = {"ref": jserver_mod, "port": tserver_mod}[pkg]
        calls = _recording(monkeypatch, mod)
        now = {"t": 0.0}
        kw = {"pretrace_nprobes": pretrace_nprobes} if pkg == "port" else {}
        sc = PKGS[pkg].ServingConfig(backend="numpy", k=3, width=16,
                                     max_batch=8, max_wait_ms=50.0, **kw)

        async def main():
            async with PKGS[pkg].AnnServer(ring[pkg], config=sc,
                                           clock=lambda: now["t"],
                                           **DEVICE[pkg]) as srv:
                combos = [(None, "f32"), (None, "uint8"), (None, "bf16"),
                          (1, "uint8")]
                futs = [srv.submit_nowait(ring["data"][i],
                                          nprobe=combos[i % 4][0],
                                          dtype=combos[i % 4][1],
                                          t_submit=i * 0.001)
                        for i in range(8)]
                now["t"] = 1.0
                outs = await asyncio.gather(*futs)
            post = srv.stats.registry.snapshot()[
                "serving_post_warm_signatures_total"]["series"][0]["value"]
            return ([(int(o.ids[0]), o.batch_size, o.latency_s)
                     for o in outs], post, srv.stats.n_batches)

        out = asyncio.run(main())
        monkeypatch.undo()
        return calls, out

    got_calls, got = run("port")
    want_calls, want = run("ref")
    assert got == want
    assert [o[2] for o in got[0]] == [1.0 - i * 0.001 for i in range(8)]
    if not pretrace_nprobes:
        assert got_calls == want_calls
        return
    n_warm = 4 * (1 + len(pretrace_nprobes))
    assert got_calls[n_warm:] == want_calls[4:]
    assert sorted(got_calls[:n_warm]) == sorted(
        (size, str(npb), "f32") for size in (1, 2, 4, 8)
        for npb in (None, "auto", 2))


# ---------------------------------------------------------------------------
# failure semantics, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_worker_death_fails_futures_not_hangs(ring, pkg):
    srv_pkg, data = PKGS[pkg], ring["data"]

    async def main():
        sc = srv_pkg.ServingConfig(backend="numpy", k=3, width=16,
                                   max_batch=64, max_wait_ms=5.0)
        srv = srv_pkg.AnnServer(ring[pkg], config=sc, **DEVICE[pkg])

        def boom():
            raise RuntimeError("pretrace exploded")

        srv._pretrace = boom
        srv.start()
        task = srv._worker_task
        fut = srv.submit_nowait(data[0])
        with pytest.raises(RuntimeError, match="exploded"):
            await fut
        await asyncio.wait({task})
        with pytest.raises(RuntimeError, match="no longer running"):
            srv.submit_nowait(data[1])
        with pytest.raises(RuntimeError, match="exploded"):
            await srv.stop()
        return srv.stats.n_failed

    assert asyncio.run(main()) == 1


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_engine_error_fails_batch_but_server_survives(ring, pkg):
    srv_pkg, data = PKGS[pkg], ring["data"]

    async def main():
        sc = srv_pkg.ServingConfig(backend="numpy", k=3, width=16,
                                   max_batch=64, max_wait_ms=5.0,
                                   pretrace=False)
        async with srv_pkg.AnnServer(ring[pkg], config=sc,
                                     **DEVICE[pkg]) as srv:
            real = srv._execute
            srv._execute = None  # the next batch blows up in the worker
            with pytest.raises(TypeError):
                await srv.submit_nowait(data[0])
            srv._execute = real
            assert (await srv.submit(data[1])).ids[0] == 1
        return srv.stats.n_failed, srv.stats.n_completed

    assert asyncio.run(main()) == (1, 1)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_stop_answers_everything_and_reject_surfaces(ring, pkg):
    srv_pkg, data = PKGS[pkg], ring["data"]

    async def main():
        sc = srv_pkg.ServingConfig(backend="numpy", k=3, width=16,
                                   max_batch=4, max_wait_ms=10_000.0,
                                   max_pending=6)
        async with srv_pkg.AnnServer(ring[pkg], config=sc,
                                     **DEVICE[pkg]) as srv:
            futs, rejected = [], 0
            for i in range(12):
                try:
                    futs.append(srv.submit_nowait(data[i]))
                except srv_pkg.ServerOverloadedError:
                    rejected += 1
        outs = [f.result() for f in futs]  # exiting drained immediately
        assert all(o.ids[0] == i for i, o in enumerate(outs))
        return rejected, srv.stats.n_rejected, srv.stats.n_completed

    got = asyncio.run(main())
    assert got[0] > 0 and got[0] == got[1] and got[0] + got[2] == 12


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_cancellation_fails_inflight_batch(ring, pkg):
    srv_pkg, data = PKGS[pkg], ring["data"]

    async def main():
        sc = srv_pkg.ServingConfig(backend="numpy", k=3, width=16,
                                   max_batch=2, max_wait_ms=1.0,
                                   pretrace=False)
        srv = srv_pkg.AnnServer(ring[pkg], config=sc, **DEVICE[pkg])
        srv.start()
        real = srv._execute
        srv._execute = lambda batch: (time.sleep(0.2), real(batch))[1]
        f1 = srv.submit_nowait(data[0])
        f2 = srv.submit_nowait(data[1])  # size-flush: batch goes in-flight
        await asyncio.sleep(0.05)
        task = srv._worker_task
        task.cancel()
        await asyncio.wait({task})
        for f in (f1, f2):
            assert f.done()
            with pytest.raises(asyncio.CancelledError):
                f.result()
        return srv.stats.n_failed

    assert asyncio.run(main()) == 2


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_bad_config_and_submissions_raise(ring, pkg):
    srv_pkg, topo, data = PKGS[pkg], ring[pkg], ring["data"]
    dev = DEVICE[pkg]
    with pytest.raises(ValueError, match="backend"):
        srv_pkg.AnnServer(topo, config=srv_pkg.ServingConfig(backend="cuda"),
                          **dev)
    for bad in (dict(nprobe=0), dict(dtype="int4"), dict(k=10, width=4),
                dict(pretrace_dtypes=("fp4",))):
        with pytest.raises(ValueError):
            srv_pkg.AnnServer(topo, config=srv_pkg.ServingConfig(
                backend="numpy", **bad), **dev)
    srv = srv_pkg.AnnServer(topo, config=srv_pkg.ServingConfig(
        backend="numpy"), **dev)
    with pytest.raises(RuntimeError, match="not started"):
        srv.submit_nowait(np.zeros(8, np.float32))

    async def main():
        async with srv_pkg.AnnServer(topo, config=srv_pkg.ServingConfig(
                backend="numpy", k=3, width=16), **dev) as s:
            with pytest.raises(ValueError, match="vector"):
                s.submit_nowait(np.zeros((3, 8), np.float32))
            with pytest.raises(ValueError, match="vector"):
                s.submit_nowait(np.zeros(7, np.float32))
            with pytest.raises(ValueError, match="nprobe"):
                s.submit_nowait(data[0], nprobe="always")
            with pytest.raises(ValueError, match="dtype"):
                s.submit_nowait(data[0], dtype="fp4")
            with pytest.raises(ValueError, match="dim"):
                s.swap_topology((ring[pkg].shard_ids, ring[pkg].shard_graphs),
                                data=np.zeros((40, 4), np.float32))

    asyncio.run(main())


def test_port_rejects_bad_pretrace_nprobe(ring):
    with pytest.raises(ValueError, match="nprobe"):
        tserving.AnnServer(ring["port"], config=tserving.ServingConfig(
            pretrace_nprobes=("always",)), device="cpu")


def test_server_runs_on_the_card_or_raises(ring, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.AnnServer(ring["port"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.AnnServer(ring["port"], device="cuda")
    srv = tserving.AnnServer(ring["port"], device="cpu")
    assert srv.device.type == "cpu" and srv.config.backend == "fused"


# ---------------------------------------------------------------------------
# the fused backend's device copies under serving
# ---------------------------------------------------------------------------


def _uploads() -> float:
    snap = ttel.current_registry().snapshot()
    fam = snap.get("search_device_uploads_total", {"series": []})
    return sum(s["value"] for s in fam["series"])


def test_search_stats_are_python_ints(built):
    topo = built["split"]["port"]
    q = built["ds"].queries[:5]
    for backend in ("numpy", "torch", "fused"):
        for dtype in ("f32", "uint8"):
            _, st = search(topo, q, 5, width=16, backend=backend,
                           nprobe="auto", dtype=dtype, device="cpu")
            for name, v in dataclasses.asdict(st).items():
                assert type(v) is int, (backend, dtype, name, type(v))


def test_split_serving_uploads_nothing_after_warmup(built, monkeypatch):
    """A split topology served at two stages needs n_shards × 2 device
    copies; with the cache's cap below that, every batch would re-upload
    shards.  The server's warm-up sizes the cache and uploads them all, so
    traffic — both stages, nprobe overrides included — uploads
    nothing and meets no signature it has not warmed."""
    topo = dataclasses.replace(built["split"]["port"])  # fresh views
    n_shards = len(topo.shard_ids)
    monkeypatch.setattr(fused_backend, "_CACHE_CAP", 2)
    queries = built["ds"].queries

    async def main():
        sc = tserving.ServingConfig(k=5, width=16, max_batch=8,
                                    max_wait_ms=1.0, nprobe=2,
                                    pretrace_dtypes=("uint8",),
                                    pretrace_nprobes=("auto",))
        async with tserving.AnnServer(topo, config=sc, device="cpu") as srv:
            await srv.submit(queries[0])  # after the warm-up
            before = _uploads()
            futs = [srv.submit_nowait(
                q, dtype="uint8" if i % 2 else "f32",
                nprobe="auto" if i % 5 == 0 else np.int64(2))
                for i, q in enumerate(queries)]
            await asyncio.gather(*futs)
            return before, _uploads(), srv.stats.registry.snapshot()

    before, after, snap = asyncio.run(main())
    assert fused_backend._CACHE_CAP == 2 * n_shards
    assert after == before
    series = snap["serving_post_warm_signatures_total"]["series"]
    assert series[0]["value"] == 0
    # the same alternating traffic without the warm-up's cap thrashes
    monkeypatch.setattr(fused_backend, "_CACHE_CAP", 2)
    cold = dataclasses.replace(topo)  # views of its own: nothing cached
    start = _uploads()
    for dtype in ("f32", "uint8", "f32"):
        search(cold, queries, 5, width=16, nprobe=None, dtype=dtype,
               device="cpu")
    assert _uploads() - start == 3 * n_shards


def test_merged_swap_reuses_f32_copies(built):
    """A new merged topology over the same arrays finds its f32 copies in
    the cache; its uint8 view is per topology object, so that is a new
    upload."""
    old = built["merged"]["port"]
    q = built["ds"].queries[:4]
    for dtype in ("f32", "uint8"):
        search(old, q, 5, width=16, dtype=dtype, device="cpu")
    new = dataclasses.replace(old)
    start = _uploads()
    search(new, q, 5, width=16, dtype="f32", device="cpu")
    assert _uploads() == start
    search(new, q, 5, width=16, dtype="uint8", device="cpu")
    assert _uploads() == start + 1
