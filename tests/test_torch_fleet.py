"""The port's spot-fleet build (``repro_torch.fleet``) against the JAX
package's, on the CPU.

* Checkpoints: for the same ``ShardCheckpoint`` both packages write the
  same bytes (with the clock held still: a zip member carries the second
  it was written), each package's ``from_bytes`` and
  ``CheckpointStore(directory=...)`` read the other's, and a torn or
  corrupt file counts as missing in both and ticks
  ``fleet_checkpoint_corrupt_total``.
* The injector: the same seeds give the same lifetimes and the same
  signal traces.
* The executor on integer points (every distance exact): with one worker
  and an explicit kill, ``build_scalegann_fleet`` on ``torch`` and
  ``fused`` gives the reference ``jax`` fleet's shard graphs, distance
  count, report counters, event kinds and ``fleet_*`` counters, and the
  port's own ``build_scalegann(algo="vamana")`` graphs.  A seeded storm
  on two workers, a kill before the first checkpoint, a flaky builder,
  both policies and a checkpoint the reference's executor left on disk
  all finish to the uninterrupted graphs; ``check_fleet_trace`` holds on
  a traced run with a kill.
* A round state kept after the hook returns reads its own round's graph,
  equal to the reference's state of that round.
"""

import dataclasses
import time

import numpy as np
import pytest

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import vamana as jvamana
from repro.core.scheduler import RuntimeModel as JRuntimeModel
from repro.fleet import CheckpointStore as JCheckpointStore
from repro.fleet import PreemptionInjector as JPreemptionInjector
from repro.fleet import ShardCheckpoint as JShardCheckpoint
from repro.fleet import build_scalegann_fleet as jbuild_fleet
from repro.telemetry import MetricsRegistry as JMetricsRegistry
from repro.telemetry import use_registry as juse_registry
from repro_torch.configs.base import IndexConfig
from repro_torch.core import builder, vamana
from repro_torch.core.builder import ShardBuildError, build_scalegann
from repro_torch.core.scheduler import RuntimeModel
from repro_torch.fleet import (CheckpointStore, CostGreedyPolicy,
                               DeadlinePolicy, PreemptionInjector,
                               ShardCheckpoint, build_scalegann_fleet,
                               executor)
from repro_torch.telemetry import (MetricsRegistry, Tracer,
                                   check_fleet_trace, use_registry)

KW = dict(n_clusters=4, degree=8, build_degree=16, block_size=512)
CFG = IndexConfig(**KW)
RM = RuntimeModel(seconds_per_vector=1e-4)
JRM = JRuntimeModel(seconds_per_vector=1e-4)
META = ("shard", "pass_idx", "next_start", "n_distance_computations", "n",
        "R", "seed", "batch_size", "round_idx", "n_rounds_total")
COUNTERS = ("n_preemptions", "n_resumes", "n_requeues", "n_notices",
            "rounds_completed", "rounds_lost", "shard_attempts")


@pytest.fixture(scope="module")
def ints():
    """Four clusters of integer points: every squared distance is an exact
    integer, so both packages' builds make the same choices."""
    rng = np.random.default_rng(0)
    centers = rng.integers(0, 40, (4, 16))
    return (centers[rng.integers(0, 4, 1200)]
            + rng.integers(-3, 4, (1200, 16))).astype(np.float32)


@pytest.fixture(scope="module")
def plain(ints):
    """The port's uninterrupted build (default batch) every fleet run at
    the default batch must reproduce."""
    return build_scalegann(ints, CFG, algo="vamana", device="cpu")


def _fleet(data, **kw):
    kw.setdefault("runtime_model", RM)
    return build_scalegann_fleet(data, CFG, device="cpu", **kw)


def _same_graphs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_fields(n=40, R=8):
    rng = np.random.default_rng(0)
    return dict(shard=3, pass_idx=1, next_start=256,
                graph=rng.integers(-1, n, size=(n, R)).astype(np.int64),
                n_distance_computations=12345, n=n, R=R, seed=7,
                batch_size=128, round_idx=5, n_rounds_total=8)


def _same_ckpt(a, b):
    assert all(getattr(a, f) == getattr(b, f) for f in META)
    assert a.graph.dtype == b.graph.dtype == np.int64
    np.testing.assert_array_equal(a.graph, b.graph)


def test_checkpoint_bytes_equal_and_cross_read(monkeypatch):
    fields = _ckpt_fields()
    mine, theirs = ShardCheckpoint(**fields), JShardCheckpoint(**fields)
    for raw in (mine.to_bytes(), theirs.to_bytes()):
        _same_ckpt(ShardCheckpoint.from_bytes(raw), mine)
        _same_ckpt(JShardCheckpoint.from_bytes(raw), mine)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)  # zip member dates
    assert mine.to_bytes() == theirs.to_bytes()


def test_checkpoint_store_loads_the_other_packages_files(tmp_path):
    fields = _ckpt_fields()
    JCheckpointStore(tmp_path / "ref").save(JShardCheckpoint(**fields))
    CheckpointStore(tmp_path / "port").save(ShardCheckpoint(**fields))
    got = CheckpointStore(tmp_path / "ref").load(3)
    back = JCheckpointStore(tmp_path / "port").load(3)
    _same_ckpt(got, ShardCheckpoint(**fields))
    _same_ckpt(back, ShardCheckpoint(**fields))
    assert 3 in CheckpointStore(tmp_path / "ref")
    store = CheckpointStore(tmp_path / "ref")
    store.discard(3)
    assert 3 not in store and JCheckpointStore(tmp_path / "ref").load(3) \
        is None


@pytest.mark.parametrize("damage", ["torn", "bit_flip", "bad_magic"])
def test_corrupt_checkpoint_counts_as_missing_in_both(tmp_path, damage):
    raw = ShardCheckpoint(**_ckpt_fields()).to_bytes()
    if damage == "torn":
        raw = raw[:len(raw) // 2]
    elif damage == "bit_flip":
        raw = raw[:-9] + bytes([raw[-9] ^ 0x10]) + raw[-8:]
    else:
        raw = b"XXXX" + raw[4:]
    (tmp_path / "shard00003.ckpt.npz").write_bytes(raw)
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    with use_registry(reg):
        assert CheckpointStore(tmp_path).load(3) is None
    with juse_registry(jreg):
        assert JCheckpointStore(tmp_path).load(3) is None
    assert reg.snapshot() == jreg.snapshot()
    series = reg.snapshot()["fleet_checkpoint_corrupt_total"]["series"]
    assert series[0]["value"] == 1.0


# ---------------------------------------------------------------------------
# injector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,life,notice,kills", [
    (7, 6.0, 2, None), (3, 3.0, 1, None), (11, 4.0, 2, {0: 3, 2: 1}),
    (0, None, 2, {1: 2}), (5, 10.0, 0, {0: 5})])
def test_injector_matches_reference(seed, life, notice, kills):
    kw = dict(seed=seed, mean_lifetime_rounds=life, notice_rounds=notice,
              kill_shard_at=kills, max_kills=6)
    mine, theirs = PreemptionInjector(**kw), JPreemptionInjector(**kw)
    traces = []
    for inj in (mine, theirs):
        trace = []
        for w in range(3):
            inj.start_instance(w)
        for r in range(1, 40):  # two shards a worker, a replacement on kill
            for w in range(3):
                sig = inj.observe_round(w, (w + r // 20) % 3, r // 30, r)
                trace.append((sig, inj.known_remaining_rounds(w)))
                if sig == "kill":
                    inj.start_instance(w)
        traces.append((trace, [inj.lifetime_rounds(w) for w in range(3)],
                       inj.events, inj.n_kills, inj.n_notices))
    assert traces[0] == traces[1]


# ---------------------------------------------------------------------------
# round states
# ---------------------------------------------------------------------------


def test_kept_round_state_reads_its_own_round(ints):
    """The port hands the hook a device clone and copies it to the host on
    the first read; a state kept past its round still reads that round."""
    data = ints[:300]
    mine, theirs = [], []
    vamana.build_shard_index_vamana(data, CFG, backend="torch",
                                    batch_size=64, round_hook=mine.append,
                                    device="cpu")
    jvamana.build_shard_index_vamana(data, JIndexConfig(**KW),
                                     backend="jax", batch_size=64,
                                     round_hook=theirs.append)
    assert len(mine) == len(theirs) == 10
    for m, t in zip(mine, theirs):
        np.testing.assert_array_equal(m.graph, t.graph)
        assert m.graph.dtype == np.int64
        assert (m.round_idx, m.pass_idx, m.next_start,
                m.n_distance_computations) == (
            t.round_idx, t.pass_idx, t.next_start,
            t.n_distance_computations)
    assert not np.array_equal(mine[0].graph, mine[-1].graph)
    mine[0].graph[:] = -7  # a copy, not a view of the live graph
    assert not np.array_equal(mine[0].graph, mine[1].graph)
    assert (mine[1].device_graph >= 0).any()


# ---------------------------------------------------------------------------
# the executor against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_fleet(ints):
    return jbuild_fleet(
        ints, JIndexConfig(**KW), n_workers=1,
        injector=JPreemptionInjector(kill_shard_at={0: 3}),
        runtime_model=JRM, backend="jax", batch_size=64,
        checkpoint_every_rounds=2)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_fleet_matches_reference(ints, ref_fleet, backend):
    out = _fleet(ints, n_workers=1,
                 injector=PreemptionInjector(kill_shard_at={0: 3}),
                 backend=backend, batch_size=64, checkpoint_every_rounds=2)
    _same_graphs(out.build.shard_graphs, ref_fleet.build.shard_graphs)
    assert out.build.n_distance_computations == \
        ref_fleet.build.n_distance_computations
    for f in COUNTERS:
        assert getattr(out.report, f) == getattr(ref_fleet.report, f), f
    assert out.report.n_preemptions == 1 and out.report.rounds_lost == 1
    assert [e[1] for e in out.report.events] == \
        [e[1] for e in ref_fleet.report.events]
    assert out.report.metrics == ref_fleet.report.metrics
    assert [(t.shard, t.attempts, t.rounds_completed, t.checkpoints_saved)
            for t in out.report.shard_timelines] == \
        [(t.shard, t.attempts, t.rounds_completed, t.checkpoints_saved)
         for t in ref_fleet.report.shard_timelines]
    np.testing.assert_array_equal(out.build.index.graph,
                                  ref_fleet.build.index.graph)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_fleet_matches_plain_build(ints, plain, backend):
    """At the default batch, a killed and resumed shard ends as the port's
    own uninterrupted ``build_scalegann(algo="vamana")``."""
    out = _fleet(ints, n_workers=1, backend=backend,
                 injector=PreemptionInjector(kill_shard_at={0: 3}))
    assert out.report.shard_attempts[0] == 2 and out.report.n_resumes == 1
    _same_graphs(out.build.shard_graphs, plain.shard_graphs)
    assert out.build.n_distance_computations == \
        plain.n_distance_computations
    np.testing.assert_array_equal(out.build.index.graph, plain.index.graph)


def test_fleet_survives_preemption_storm(ints, plain):
    inj = PreemptionInjector(seed=3, mean_lifetime_rounds=3.0,
                             notice_rounds=1)
    out = _fleet(ints, n_workers=2, injector=inj)
    r = out.report
    assert r.n_preemptions >= 2 and r.rounds_lost >= 1
    assert r.n_notices >= 1 and r.n_resumes >= 1
    _same_graphs(out.build.shard_graphs, plain.shard_graphs)
    assert r.rounds_completed == sum(t.rounds_completed
                                     for t in r.shard_timelines)
    assert r.cost.total > 0


def test_fleet_restarts_from_zero_before_first_checkpoint(ints, plain):
    out = _fleet(ints, n_workers=1,
                 injector=PreemptionInjector(kill_shard_at={1: 1}),
                 checkpoint_every_rounds=100)
    r = out.report
    assert r.n_preemptions == 1 and r.n_resumes == 0 and r.rounds_lost == 1
    _same_graphs(out.build.shard_graphs, plain.shard_graphs)


@pytest.mark.parametrize("policy", [CostGreedyPolicy(), DeadlinePolicy()])
def test_fleet_policies(ints, plain, policy):
    out = _fleet(ints, n_workers=2, policy=policy)
    assert out.report.policy == policy.name
    assert out.report.n_preemptions == 0
    _same_graphs(out.build.shard_graphs, plain.shard_graphs)


def test_fleet_rejects_non_round_grain_algo(ints):
    with pytest.raises(ValueError, match="not supported"):
        _fleet(ints, algo="cagra")


def _flaky(fail_times: int):
    """The real builder behind a shim whose first ``fail_times`` calls per
    shard size raise."""
    calls: dict = {}

    def build(vecs, cfg, **kw):
        calls[len(vecs)] = calls.get(len(vecs), 0) + 1
        if calls[len(vecs)] <= fail_times:
            raise OSError(f"transient failure #{calls[len(vecs)]}")
        return vamana.build_shard_index_vamana(vecs, cfg, **kw)

    return build


def test_fleet_retries_a_flaky_builder(ints, plain, monkeypatch):
    monkeypatch.setattr(executor, "build_shard_index_vamana", _flaky(1))
    out = _fleet(ints, n_workers=1, backoff_base_s=0.001)
    assert out.report.n_error_retries == out.report.n_shards
    assert all(a == 2 for a in out.build.shard_attempts)
    assert all("transient failure" in e for e in out.build.shard_errors)
    _same_graphs(out.build.shard_graphs, plain.shard_graphs)


def test_fleet_surfaces_an_exhausted_shard(ints, monkeypatch):
    monkeypatch.setattr(executor, "build_shard_index_vamana", _flaky(99))
    with pytest.raises(ShardBuildError, match="transient failure") as ei:
        _fleet(ints, n_workers=1, max_error_retries=1, backoff_base_s=0.001)
    assert all(a == 2 for a in ei.value.attempts.values())


def test_build_scalegann_retries_transient_failures(ints, plain,
                                                    monkeypatch):
    monkeypatch.setitem(builder.BUILDERS, "vamana", _flaky(1))
    res = build_scalegann(ints, CFG, algo="vamana", retry_backoff_s=0.001,
                          device="cpu")
    assert max(res.shard_attempts) >= 2
    assert any(e and "transient failure" in e for e in res.shard_errors)
    _same_graphs(res.shard_graphs, plain.shard_graphs)


def test_build_scalegann_surfaces_exhausted_shard(ints, monkeypatch):
    def always_fail(vecs, cfg, **kw):
        raise OSError("persistent failure")

    monkeypatch.setitem(builder.BUILDERS, "vamana", always_fail)
    with pytest.raises(ShardBuildError, match="persistent failure") as ei:
        build_scalegann(ints, CFG, algo="vamana", max_retries=1,
                        retry_backoff_s=0.001, device="cpu")
    assert ei.value.errors and all(
        a == 2 for a in ei.value.attempts.values())


def test_reference_checkpoint_resumes_in_the_port(ints, plain, tmp_path):
    """The reference's executor dies after a kill (no requeue allowed) and
    leaves shard 0's checkpoint on disk; the port's executor over the same
    directory resumes it and finishes to the uninterrupted graphs."""
    with pytest.raises(RuntimeError, match="max_requeues"):
        jbuild_fleet(ints, JIndexConfig(**KW), n_workers=1,
                     injector=JPreemptionInjector(kill_shard_at={0: 3}),
                     runtime_model=JRM, backend="jax", max_requeues=0,
                     checkpoint_store=JCheckpointStore(tmp_path))
    left = JCheckpointStore(tmp_path).load(0)
    assert left is not None and left.round_idx == 2
    out = _fleet(ints, n_workers=1, checkpoint_store=CheckpointStore(tmp_path))
    r = out.report
    assert r.n_preemptions == 0 and r.n_resumes == 1
    assert ("resume", 0, "round 2") in [e[1:2] + e[3:] for e in r.events]
    _same_graphs(out.build.shard_graphs, plain.shard_graphs)
    assert out.build.n_distance_computations == \
        plain.n_distance_computations
    assert not list(tmp_path.iterdir())  # finished shards leave nothing


def test_fleet_trace_holds_check_fleet_trace(ints):
    tracer = Tracer()
    out = _fleet(ints, n_workers=2, tracer=tracer,
                 injector=PreemptionInjector(kill_shard_at={0: 3}))
    assert out.report.n_preemptions == 1
    summary = check_fleet_trace(tracer.to_chrome())
    assert summary["ok"], summary
    assert summary["n_worker_tracks"] == 2


def test_fleet_calibrates_when_no_model_is_given(ints):
    out = build_scalegann_fleet(ints[:600], CFG, n_workers=1,
                                backend="torch", device="cpu")
    rm = out.report.runtime_model
    assert rm.seconds_per_vector > 0 and np.isfinite(rm.fixed_overhead_s)
    assert dataclasses.asdict(out.report.cost)["cpu_hours"] > 0
