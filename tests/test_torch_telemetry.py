"""``repro_torch.telemetry`` against ``repro.telemetry`` on the same inputs.

Every comparison here is exact: the same script of registry operations
gives byte-equal Prometheus text, equal snapshots, equal parses and equal
histogram quantiles past the reservoir; the same script of tracer calls
under a ``ManualClock`` gives byte-equal Chrome JSON; each validator gives
equal results on the same traces, well-formed and malformed; the
signature guard answers the same.  The kernel-build listener (the port's
counterpart of the reference's jax compile listener) is driven through
``kernels._build``'s hook with a stand-in for ``nvcc``, which this
machine need not have.  ``BuildResult.feed_metrics`` of the port and the
reference on the same small build give the same families and labels and
equal counters.
"""

import gc
import json
import sys

import numpy as np
import pytest

import repro.telemetry as jtel
import repro_torch.telemetry as ttel
from repro_torch.kernels import _build
from repro_torch.telemetry import jit as tjit

PKGS = {"ref": jtel, "port": ttel}


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------


def test_public_names_match_reference():
    assert sorted(ttel.__all__) == sorted(jtel.__all__)
    for name in ttel.__all__:
        assert hasattr(ttel, name), name
    assert ttel.DEFAULT_BUCKETS == jtel.DEFAULT_BUCKETS


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def _registry_script(pkg, seed: int, reservoir: int):
    """One seeded script of registry operations; returns the registry."""
    rng = np.random.default_rng(seed)
    reg = pkg.MetricsRegistry()
    reg.counter("requests_total", "served requests",
                outcome="completed").inc(7)
    reg.counter("requests_total", outcome="shed").inc()
    reg.counter("errs_total", kind='bad "quote"\\path\n').inc(2)
    g = reg.gauge("queue_depth", "pending requests")
    h = reg.histogram("latency_seconds", "e2e latency",
                      buckets=(0.01, 0.1, 1.0), reservoir=reservoir)
    h2 = reg.histogram("occupancy", buckets=(1, 2, 4, 8, 16, 32, 64),
                       reservoir=reservoir, shard="a")
    for i in range(int(rng.integers(800, 1200))):
        op = int(rng.integers(0, 6))
        v = float(rng.exponential(0.05))
        if op == 0:
            reg.counter("requests_total", outcome="completed").inc(
                round(v * 100, 3))
        elif op == 1:
            g.set(v * 10)
        elif op == 2:
            g.inc(v)
        elif op == 3:
            g.dec(v / 2)
        elif op == 4:
            h.observe(v)
        else:
            h2.observe(float(rng.integers(1, 65)))
    for v in (0.0, 5.0, 1e20, float("inf")):  # edge formats
        h.observe(v)
    reg.gauge("big_value").set(1e16)
    reg.gauge("neg_inf").set(float("-inf"))
    return reg


@pytest.mark.parametrize("seed,reservoir", [(0, 16), (1, 64), (2, 10_000)])
def test_registry_exposition_byte_equal(seed, reservoir):
    ref = _registry_script(jtel, seed, reservoir)
    port = _registry_script(ttel, seed, reservoir)
    text = port.to_prometheus()
    assert text == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert ttel.parse_prometheus(text) == jtel.parse_prometheus(text)
    hr = ref.histogram("latency_seconds", buckets=(0.01, 0.1, 1.0),
                       reservoir=reservoir)
    hp = port.histogram("latency_seconds", buckets=(0.01, 0.1, 1.0),
                        reservoir=reservoir)
    assert hp.count > reservoir or reservoir == 10_000
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert repr(hp.percentile(q)) == repr(hr.percentile(q))  # nan too
    assert repr(hp.summary(1e3)) == repr(hr.summary(1e3))
    assert hp.cumulative_buckets() == hr.cumulative_buckets()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_registry_modeling_errors_raise(pkg):
    reg = PKGS[pkg].MetricsRegistry()
    reg.counter("a_total", x="1")
    with pytest.raises(ValueError):  # same name, different label set
        reg.counter("a_total", y="1")
    with pytest.raises(ValueError):  # same name, different kind
        reg.gauge("a_total", x="1")
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError):
        reg.counter("a_total", **{"bad-label": "1"})
    with pytest.raises(ValueError):
        reg.counter("a_total", x="1").inc(-1)
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=())
    with pytest.raises(ValueError):
        PKGS[pkg].parse_prometheus("not a sample line at all {")


def test_use_registry_installs_and_restores():
    before = ttel.current_registry()
    mine = ttel.MetricsRegistry()
    with ttel.use_registry(mine) as reg:
        assert reg is mine and ttel.current_registry() is mine
        with ttel.use_registry(None) as fresh:
            assert fresh is not mine and fresh.snapshot() == {}
        assert ttel.current_registry() is mine
    assert ttel.current_registry() is before
    prev = ttel.set_registry(mine)
    assert ttel.set_registry(prev) is mine


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def _trace_script(pkg, max_events: int):
    """The reference suite's fixture recording, extended: nested spans on
    explicit and inherited tracks, instants inside and outside spans, a
    post-hoc complete, async lanes, an error span and the event cap."""
    clock = pkg.ManualClock(start=3.25)
    tr = pkg.Tracer(clock, process="fixture", max_events=max_events)
    with tr.span("build.partition", track="build", n=1000):
        clock.advance(0.5)
    with tr.span("fleet.shard_build", track="worker-0", shard=3) as sp:
        clock.advance(0.1)
        tr.instant("fleet.preempt.notice", shard=3)  # inherits track
        with tr.span("vamana.pass"):  # inherits worker-0
            t0 = tr.now()
            clock.advance(0.2)
            tr.complete("vamana.round", t0, tr.now(), round=1)
        sp.set(done=True)
        clock.advance(0.05)
    tr.instant("kernel.ready", track="jit", source="beam")
    tr.instant("no.track")  # falls back to this thread's track
    tr.complete("kernel.build", clock() - 1.5, clock(), track="jit",
                source="beam")
    tr.complete("backwards", clock() + 1.0, clock())  # clamps to dur 0
    for rid in range(3):
        t0 = tr.now()
        clock.advance(0.001 * (rid + 1))
        t1 = tr.now()
        aid = f"srv0:req{rid}"
        tr.async_complete("serve.request", aid, t0, t1, cat="serving",
                          track="requests", rid=rid)
        tr.async_complete("serve.engine", aid, t0, t1, cat="serving",
                          track="requests")
    tr.async_complete("default.lane", 7, clock(), clock())
    with pytest.raises(ValueError):
        with tr.span("build.shard", track="build"):
            clock.advance(0.01)
            raise ValueError("boom")
    return tr


@pytest.mark.parametrize("max_events", [2_000_000, 9, 1])
def test_chrome_export_byte_equal_under_manual_clock(max_events):
    ref = _trace_script(jtel, max_events)
    port = _trace_script(ttel, max_events)
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=2) == ref.to_json(indent=2)
    assert port.n_dropped == ref.n_dropped
    obj = port.to_chrome()
    assert ttel.validate_chrome_trace(obj) == \
        jtel.validate_chrome_trace(obj)


def test_manual_clock_matches_reference():
    a, b = ttel.ManualClock(), jtel.ManualClock(0.0)
    assert a() == b() == 0.0
    assert a.advance(0.25) == b.advance(0.25) and a() == b()


def test_null_tracer_new_methods():
    nt = ttel.NULL_TRACER
    assert nt.now() == 0.0
    assert nt.instant("x", track="jit", a=1) is None
    assert nt.complete("x", 0.0, 1.0, track="jit") is None
    assert nt.async_complete("x", 1, 0.0, 1.0, cat="serving") is None
    assert nt.to_chrome() == jtel.NULL_TRACER.to_chrome()


def _null_calls(tr, n: int) -> None:
    for _ in range(n):
        tr.now()
        tr.instant("serve.retrace_risk")
        tr.complete("kernel.build", 0.0, 1.0)
        tr.async_complete("serve.request", 0, 0.0, 1.0)


def _net_blocks(n: int) -> int:
    gc.collect()
    before = sys.getallocatedblocks()
    _null_calls(ttel.NULL_TRACER, n)
    return sys.getallocatedblocks() - before


def test_null_tracer_new_methods_allocate_nothing():
    """What the loop itself leaves is the same for 1,000 calls and for
    100,000: no call keeps a block."""
    _null_calls(ttel.NULL_TRACER, 1000)  # warm code objects / freelists
    small, large = _net_blocks(1000), _net_blocks(100_000)
    assert abs(large - small) <= 2 and large <= 8


# ---------------------------------------------------------------------------
# validators
# ---------------------------------------------------------------------------


def _ev(name, ph, tid, ts, **kw):
    return dict(name=name, ph=ph, pid=1, tid=tid, ts=ts, **kw)


def _meta(tid, track):
    return {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": track}}


def _fleet_trace(nested: bool, backoff: bool):
    events = [_meta(1, "worker-0"), _meta(2, "coordinator"),
              _ev("fleet.shard_build", "X", 1, 0.0, dur=100.0),
              _ev("fleet.preempt.kill", "i", 1 if nested else 2, 50.0),
              _ev("fleet.shard_build", "X", 1, 200.0, dur=100.0),
              _ev("fleet.resume", "X", 1, 210.0, dur=5.0)]
    if backoff:
        events.append(_ev("fleet.backoff", "X", 2, 120.0, dur=50.0))
    return {"traceEvents": events}


def _durability_trace(crashes: int, replay_inside: bool):
    events = [_ev("durability.wal_append", "X", 1, 0.0, dur=1.0),
              _ev("durability.snapshot_save", "X", 1, 5.0, dur=2.0),
              _ev("durability.recover", "X", 1, 20.0, dur=10.0),
              _ev("durability.replay", "X", 1,
                  25.0 if replay_inside else 40.0, dur=1.0)]
    events += [_ev("durability.crash", "i", 1, 10.0 + i)
               for i in range(crashes)]
    return {"traceEvents": events}


def _serving_trace(gap_us: float):
    """Two requests; the second's child phases leave ``gap_us`` of its
    100 µs uncovered."""
    events = []
    for rid, gap in ((0, 0.0), (1, gap_us)):
        aid = f"req{rid}"
        events += [
            _ev("serve.request", "b", 1, 0.0, id=aid, cat="serving"),
            _ev("serve.request", "e", 1, 100.0, id=aid, cat="serving"),
            _ev("serve.queue_wait", "b", 1, 0.0, id=aid, cat="serving"),
            _ev("serve.queue_wait", "e", 1, 40.0, id=aid, cat="serving"),
            _ev("serve.engine", "b", 1, 40.0 + gap, id=aid, cat="serving"),
            _ev("serve.engine", "e", 1, 100.0, id=aid, cat="serving"),
        ]
    events.append(_ev("serve.request", "b", 1, 0.0, id="zero",
                      cat="serving"))
    events.append(_ev("serve.request", "e", 1, 0.0, id="zero",
                      cat="serving"))
    events.append(_ev("serve.engine", "e", 1, 5.0, id="orphan",
                      cat="serving"))
    return {"traceEvents": events}


MALFORMED = [
    [],
    {},
    {"traceEvents": {}},
    {"traceEvents": [
        "not an event",
        {"name": "x", "ph": "Z", "pid": 1, "tid": 1, "ts": 0},
        {"name": "", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": -1},
        {"name": "x", "ph": "X", "tid": 1, "ts": "0"},
        {"name": "x", "ph": "e", "pid": 1, "tid": 1, "ts": 0, "id": "a",
         "cat": "c"},
        {"name": "x", "ph": "b", "pid": 1, "tid": 1, "ts": 0, "cat": "c"},
        {"name": "x", "ph": "i", "pid": 1, "tid": 1, "ts": 0, "args": []},
    ]},
    {"traceEvents": [
        {"name": "x", "ph": "b", "pid": 1, "tid": 1, "ts": 0, "id": "a",
         "cat": "c"},
    ]},
]

TRACES = (
    [_fleet_trace(n, b) for n in (True, False) for b in (True, False)]
    + [_durability_trace(c, r) for c in (0, 1, 3) for r in (True, False)]
    + [_serving_trace(g) for g in (0.0, 4.0, 6.0, 60.0)]
    + MALFORMED
)


@pytest.mark.parametrize("i", range(len(TRACES)))
def test_validators_match_reference(i):
    obj = TRACES[i]
    assert ttel.validate_chrome_trace(obj) == \
        jtel.validate_chrome_trace(obj)
    if isinstance(obj, dict) and isinstance(obj.get("traceEvents"), list) \
            and all(isinstance(e, dict) for e in obj["traceEvents"]):
        for fn in ("check_fleet_trace", "check_serving_trace"):
            assert getattr(ttel, fn)(obj) == getattr(jtel, fn)(obj), fn
        for mc in (1, 2):
            assert ttel.check_durability_trace(obj, mc) == \
                jtel.check_durability_trace(obj, mc)
        for cov in (0.5, 0.95):
            assert ttel.check_serving_trace(obj, cov) == \
                jtel.check_serving_trace(obj, cov)


def test_validators_on_recorded_traces():
    for max_events in (2_000_000, 9):
        obj = json.loads(_trace_script(ttel, max_events).to_json())
        for fn in ("validate_chrome_trace", "check_fleet_trace",
                   "check_serving_trace", "check_durability_trace"):
            assert getattr(ttel, fn)(obj) == getattr(jtel, fn)(obj), fn


# ---------------------------------------------------------------------------
# signature guard and the kernel-build listener
# ---------------------------------------------------------------------------


def test_signature_guard_matches_reference():
    rng = np.random.default_rng(4)
    sigs = [("fused", int(2 ** rng.integers(0, 7)),
             ("fixed", int(rng.integers(1, 3)), 0.0),
             str(rng.choice(["f32", "uint8"]))) for _ in range(60)]
    got, want = ttel.SignatureGuard(), jtel.SignatureGuard()
    for g in (got, want):
        for s in sigs[:10]:
            g.warm(s)
    out = []
    for i, s in enumerate(sigs):
        if i == 30:
            got.finish_warmup()
            want.finish_warmup()
        out.append((got.observe(s), want.observe(s)))
    assert all(a == b for a, b in out)
    assert any(a == (True, True) for a, _ in out)
    assert got.n_signatures == want.n_signatures


def test_compile_listener_idempotent(monkeypatch):
    monkeypatch.setattr(_build, "on_build", None)
    assert ttel.install_compile_listener() is True
    assert _build.on_build is tjit._on_build
    assert ttel.install_compile_listener() is True
    assert _build.on_build is tjit._on_build


def test_build_hook_feeds_registry_and_tracer(monkeypatch):
    monkeypatch.setattr(_build, "on_build", None)
    ttel.install_compile_listener()
    reg = ttel.MetricsRegistry()
    clock = ttel.ManualClock(10.0)
    tr = ttel.Tracer(clock)
    with ttel.use_registry(reg), ttel.use_tracer(tr):
        _build.on_build("beam", 1.5)
        _build.on_build("beam", 20.0)
        _build.on_build("distance", 0.25)
    _build.on_build("knn", 3.0)  # another registry: not counted here
    parsed = ttel.parse_prometheus(reg.to_prometheus())
    assert parsed[("kernel_builds_total",
                   frozenset({("source", "beam")}))] == 2
    assert parsed[("kernel_builds_total",
                   frozenset({("source", "distance")}))] == 1
    assert parsed[("kernel_build_seconds_count", frozenset())] == 3
    assert parsed[("kernel_build_seconds_sum", frozenset())] == 21.75
    assert ("kernel_builds_total", frozenset({("source", "knn")})) \
        not in parsed
    obj = tr.to_chrome()
    assert ttel.validate_chrome_trace(obj) == []
    tracks = {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = [e for e in obj["traceEvents"] if e["name"] == "kernel.build"]
    assert [e["args"]["source"] for e in spans] == \
        ["beam", "beam", "distance"]  # by start: 10 - 20, 10 - 1.5, ...
    assert {tracks[e["tid"]] for e in spans} == {"jit"}
    assert sorted(e["dur"] for e in spans) == [0.25e6, 1.5e6, 20e6]


class _FakeNvcc:
    def __init__(self, rc: int):
        self.returncode = rc

    def communicate(self):
        return "ptxas info: 0 bytes spill\n", None


@pytest.mark.parametrize("rc", [0, 1])
def test_build_all_reports_every_nvcc_run(tmp_path, monkeypatch, rc):
    """build_all hands each compiler run to the hook, failed ones too; the
    compiler is stood in for, since the CPU machine has no nvcc."""
    seen = []
    monkeypatch.setattr(_build, "on_build",
                        lambda src, s: seen.append((src, s)))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: tmp_path / f"lib{name}.so")

    def start(name):
        out = tmp_path / f"lib{name}.so"
        tmp = tmp_path / f"lib{name}.tmp"
        tmp.write_bytes(b"")
        return _FakeNvcc(rc), tmp, out

    monkeypatch.setattr(_build, "_start", start)
    if rc == 0:
        logs = _build.build_all(("beam", "knn"))
        assert sorted(logs) == ["beam", "knn"]
        assert (tmp_path / "libbeam.so").exists()
    else:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.build_all(("beam", "knn"))
    assert [s for s, _ in seen] == ["beam", "knn"]
    assert all(t >= 0.0 for _, t in seen)
    seen.clear()
    if rc == 0:  # built libraries are reused: no second compiler run
        _build.build_all(("beam", "knn"))
        assert seen == []


# ---------------------------------------------------------------------------
# BuildResult.feed_metrics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def builds():
    from repro.configs.base import IndexConfig as JIndexConfig
    from repro.core import builder as jbuilder
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core import builder
    from repro_torch.data.synthetic import make_clustered

    ds = make_clustered(400, 16, n_queries=8, spread=1.0, seed=3,
                        device="cpu")
    cfg = dict(n_clusters=4, degree=8, build_degree=16, block_size=256)
    ref = jbuilder.build_scalegann(ds.data, JIndexConfig(**cfg), n_workers=1)
    port = builder.build_scalegann(ds.data, IndexConfig(**cfg), device="cpu")
    return ref, port


def _families(reg):
    return {name: (fam["type"], fam["help"],
                   [s["labels"] for s in fam["series"]])
            for name, fam in reg.snapshot().items()}


def test_feed_metrics_matches_reference(builds):
    ref, port = builds
    want, got = ref.feed_metrics(), port.feed_metrics()
    assert _families(got) == _families(want)
    snap_w, snap_g = want.snapshot(), got.snapshot()
    for name in ("build_shards_total", "build_distance_computations_total",
                 "build_shard_attempts_total"):
        assert snap_g[name] == snap_w[name], name
    assert snap_g["build_shard_seconds"]["series"][0]["count"] == \
        len(port.shards)
    phases = {s["labels"]["phase"]: s["value"]
              for s in snap_g["build_phase_seconds"]["series"]}
    assert phases == {"partition": port.partition_s,
                      "shards": port.wall_build_s, "merge": port.merge_s}
    overall = snap_g["build_overall_seconds"]["series"][0]["value"]
    assert overall == port.overall_s


def test_feed_metrics_shares_a_registry(builds):
    ref, port = builds
    reg = ttel.MetricsRegistry()
    assert port.feed_metrics(reg) is reg
    port.feed_metrics(reg)
    parsed = ttel.parse_prometheus(reg.to_prometheus())
    key = ("build_shards_total", frozenset({("system", port.name)}))
    assert parsed[key] == 2 * len(port.shards)
