"""The port's durability layer (``repro_torch.durability``) and the live
index's save/load, on the CPU.

* The reference's corruption matrix on the port: WAL round trip, torn
  final record truncated, mid-file damage fails loudly with the path and
  offset, group commit; truncated or bit-flipped segment or manifest,
  missing or malformed ``CURRENT``, a config pin that disagrees.
* Crash → recover → serve on the port's ``LiveIndex`` (the ``fused``
  backend on the CPU): every crash point of ``durability/crash.py``, the
  recovered index serving ids identical to the uncrashed run, and the
  durability trace holding ``check_durability_trace``.
* Across packages, on integer points with ``backend="numpy"`` on both
  sides (the replay pins compare the backend string): a snapshot plus
  WAL tail written by either package loads and replays in the other, and
  the recovered state equals the writer's; WAL records decode to the same
  ``(seq, op, arrays)`` in both readers.  The bytes of npz segments are
  not compared: zip headers carry timestamps.
"""

import threading

import numpy as np
import pytest

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core.builder import build_scalegann as jbuild_scalegann
from repro.durability import WriteAheadLog as JWriteAheadLog
from repro.durability import crash as jcrash
from repro.live import LiveConfig as JLiveConfig
from repro.live import LiveIndex as JLiveIndex
from repro.search import search as jsearch
from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.data.synthetic import make_clustered
from repro_torch.durability import (SNAPSHOT_FORMAT_VERSION, CrashInjector,
                                    SimulatedCrash, SnapshotCorruptionError,
                                    WalCorruptionError, WriteAheadLog,
                                    bit_flip, truncate_at)
from repro_torch.durability import crash
from repro_torch.live import LiveConfig, LiveIndex
from repro_torch.search import ShardTopology, search
from repro_torch.telemetry import (ManualClock, MetricsRegistry, Tracer,
                                   check_durability_trace, use_registry,
                                   use_tracer, validate_chrome_trace)

KW = dict(degree=16, build_degree=32, n_clusters=4)
CFG = IndexConfig(**KW)
LIVE = LiveConfig()  # the port's default: the fused backend


@pytest.fixture(scope="module")
def ds():
    return make_clustered(420, 16, n_queries=24, gt_k=10, seed=3,
                          device="cpu")


@pytest.fixture(scope="module")
def built(ds):
    return build_scalegann(ds.data[:300], CFG, algo="vamana", device="cpu")


def _fresh(ds, built):
    return LiveIndex.from_build(built, ds.data[:300], CFG, LIVE,
                                device="cpu")


def _load(root, live=LIVE, **kw):
    return LiveIndex.load(root, CFG, live, device="cpu", **kw)


def _schedule(ds, seed=7):
    """A seeded mutation schedule hitting all three logged ops."""
    rng = np.random.default_rng(seed)
    return [
        ("insert", ds.data[300:360]),
        ("delete", rng.choice(300, 40, replace=False)),
        ("insert", ds.data[360:]),
        ("consolidate", None),
        ("delete", 300 + rng.choice(60, 15, replace=False)),
    ]


def _apply(li, op, arg):
    if op == "insert":
        li.insert_batch(arg)
    elif op == "delete":
        li.delete_batch(arg)
    else:
        li.consolidate(arg)


def _ids(li, ds):
    return search(li.snapshot(), ds.queries, 10, device="cpu")[0]


@pytest.fixture(scope="module")
def reference_ids(ds, built):
    li = _fresh(ds, built)
    for op, arg in _schedule(ds):
        _apply(li, op, arg)
    return _ids(li, ds)


def _run_with_crashes(ds, built, root, injector, *, fsync_interval=1,
                      max_recoveries=20):
    """Apply the schedule; on every simulated crash drop the index, reload
    from disk and resume at the position the recovered ``wal_seq`` proves
    was applied."""
    li = _fresh(ds, built)
    li.save(root, fsync_interval=fsync_interval, injector=injector)
    seq0 = li.wal_seq
    sched = _schedule(ds)
    pos = recoveries = 0
    while pos < len(sched):
        try:
            _apply(li, *sched[pos])
            pos += 1
        except SimulatedCrash:
            recoveries += 1
            assert recoveries <= max_recoveries, "crash/recover livelock"
            while True:
                try:
                    li = _load(root, fsync_interval=fsync_interval,
                               injector=injector)
                    break
                except SimulatedCrash:  # crashed mid-replay: go again
                    recoveries += 1
                    assert recoveries <= max_recoveries
            pos = li.wal_seq - seq0
    return li, recoveries


# ---- WAL framing + torn-tail policy --------------------------------------


def test_wal_roundtrip_reopen(tmp_path):
    path = tmp_path / "wal-000001.log"
    with WriteAheadLog(path) as w:
        w.append(1, "insert", {"vectors": np.ones((3, 4), np.float32)})
        w.append(2, "delete", {"ids": np.array([7, 9], np.int64)})
        w.append(3, "consolidate",
                 {"threshold": np.array([0.25], np.float64)})
    w2 = WriteAheadLog(path)
    assert [(r.seq, r.op) for r in w2.records] == [
        (1, "insert"), (2, "delete"), (3, "consolidate")]
    assert np.array_equal(w2.records[1].arrays["ids"], [7, 9])
    assert w2.seq == 3
    w2.close()


def test_wal_torn_final_record_is_truncated(tmp_path):
    path = tmp_path / "wal-000001.log"
    with WriteAheadLog(path) as w:
        w.append(1, "delete", {"ids": np.arange(4, dtype=np.int64)})
        w.append(2, "delete", {"ids": np.arange(9, dtype=np.int64)})
    truncate_at(path, -11)  # tear into the last record's payload
    reg = MetricsRegistry()
    with use_registry(reg):
        w2 = WriteAheadLog(path)
    assert [r.seq for r in w2.records] == [1]
    assert w2.torn_bytes_dropped > 0
    assert reg.counter("wal_torn_records_total").value == 1
    w2.append(2, "delete", {"ids": np.arange(2, dtype=np.int64)})
    w2.close()
    assert [r.seq for r in WriteAheadLog(path).records] == [1, 2]


def test_wal_midfile_corruption_fails_loudly(tmp_path):
    path = tmp_path / "wal-000001.log"
    with WriteAheadLog(path) as w:
        w.append(1, "delete", {"ids": np.arange(4, dtype=np.int64)})
        first_len = path.stat().st_size
        w.append(2, "delete", {"ids": np.arange(4, dtype=np.int64)})
    bit_flip(path, first_len // 2)  # damage record 1, not the tail
    with pytest.raises(WalCorruptionError) as ei:
        WriteAheadLog(path)
    assert str(path) in str(ei.value)
    assert ei.value.offset == 0  # names the damaged record's offset


def test_wal_group_commit_interval(tmp_path):
    path = tmp_path / "wal-000001.log"
    w = WriteAheadLog(path, fsync_interval=3)
    for seq in range(1, 7):
        w.append(seq, "delete", {"ids": np.array([seq], np.int64)})
    assert w.n_fsyncs == 2  # at records 3 and 6, not every append
    w.close()


def test_crash_points_and_formats_match_reference():
    """The port names the same crash points and writes the same formats."""
    from repro.durability import snapshot as jsnapshot
    from repro.durability import wal as jwal
    from repro_torch.durability import snapshot, wal

    for mod, jmod in ((wal, jwal), (snapshot, jsnapshot), (crash, jcrash)):
        assert mod.__all__ == jmod.__all__
    assert wal.OP_CODES == jwal.OP_CODES
    assert wal._HEADER.format == jwal._HEADER.format
    assert wal._MAGIC == jwal._MAGIC
    assert SNAPSHOT_FORMAT_VERSION == jsnapshot.SNAPSHOT_FORMAT_VERSION
    assert snapshot.wal_name(7) == jsnapshot.wal_name(7)
    assert crash.__doc__.split("======")[1:] == \
        jcrash.__doc__.split("======")[1:]  # the crash-point table


# ---- snapshot corruption matrix ------------------------------------------


def _durable(ds, built, tmp_path, *, mutate=True):
    li = _fresh(ds, built)
    root = tmp_path / "idx"
    li.save(root)
    if mutate:
        for op, arg in _schedule(ds)[:2]:
            _apply(li, op, arg)
        li.save(root)
    li.close()
    return li, root


def test_save_load_roundtrip_serves_identical_ids(ds, built, tmp_path):
    li = _fresh(ds, built)
    root = tmp_path / "idx"
    li.save(root)
    for op, arg in _schedule(ds):
        _apply(li, op, arg)  # all WAL tail — no second save
    li.close()
    back = _load(root)
    assert back.wal_seq == li.wal_seq
    assert back.generation == li.generation
    assert back.n_vectors == li.n_vectors
    assert back.device.type == "cpu"
    np.testing.assert_array_equal(_ids(li, ds), _ids(back, ds))
    back.close()


def test_truncated_segment_fails_loudly(ds, built, tmp_path):
    _, root = _durable(ds, built, tmp_path)
    seg = sorted(root.glob("seg-*-shard0001.npz"))[-1]
    truncate_at(seg, -20)
    with pytest.raises(SnapshotCorruptionError) as ei:
        _load(root)
    assert seg.name in str(ei.value)
    assert "size mismatch" in str(ei.value)


def test_bitflipped_segment_fails_loudly(ds, built, tmp_path):
    _, root = _durable(ds, built, tmp_path)
    seg = sorted(root.glob("seg-*-global.npz"))[-1]
    bit_flip(seg, seg.stat().st_size // 2)
    with pytest.raises(SnapshotCorruptionError) as ei:
        _load(root)
    assert seg.name in str(ei.value) and "CRC" in str(ei.value)


def test_bitflipped_manifest_fails_loudly(ds, built, tmp_path):
    _, root = _durable(ds, built, tmp_path)
    manifest = sorted(root.glob("manifest-*.json"))[-1]
    bit_flip(manifest, 40)
    with pytest.raises(SnapshotCorruptionError) as ei:
        _load(root)
    assert manifest.name in str(ei.value) and "CRC" in str(ei.value)


def test_missing_current_and_malformed_current(ds, built, tmp_path):
    _, root = _durable(ds, built, tmp_path, mutate=False)
    (root / "CURRENT").write_text("not a valid pointer line at all\n")
    with pytest.raises(SnapshotCorruptionError):
        _load(root)
    (root / "CURRENT").unlink()
    with pytest.raises(SnapshotCorruptionError) as ei:
        _load(root)
    assert "CURRENT" in str(ei.value)


def test_config_pin_mismatch_refuses_replay(ds, built, tmp_path):
    _, root = _durable(ds, built, tmp_path, mutate=False)
    with pytest.raises(ValueError, match="diverge"):
        _load(root, LiveConfig(alpha=1.5))
    with pytest.raises(ValueError, match="diverge"):
        _load(root, LiveConfig(backend="numpy"))


def test_crash_between_tmp_write_and_rename_keeps_old_generation(
        ds, built, tmp_path):
    li = _fresh(ds, built)
    root = tmp_path / "idx"
    li.save(root)
    _apply(li, *_schedule(ds)[0])
    n_after_insert = li.n_vectors
    with pytest.raises(SimulatedCrash):
        li.save(root, injector=CrashInjector(
            crash_at={"snapshot.current.pre_rename": 1}))
    li.close()
    back = _load(root)
    assert back.n_vectors == n_after_insert
    assert list(root.glob("*.tmp"))  # the un-renamed tmp is still there…
    back.save(root)  # …until the next committed save GCs it
    assert not list(root.glob("*.tmp"))
    back.close()


def test_crash_mid_replay_is_crash_safe(ds, built, tmp_path):
    li = _fresh(ds, built)
    root = tmp_path / "idx"
    li.save(root)
    for op, arg in _schedule(ds)[:3]:
        _apply(li, op, arg)
    li.close()
    with pytest.raises(SimulatedCrash):
        _load(root, injector=CrashInjector(crash_at={"replay.record": 2}))
    back = _load(root)
    assert back.wal_seq == li.wal_seq
    np.testing.assert_array_equal(_ids(li, ds), _ids(back, ds))
    back.close()


# ---- crash-loop parity ---------------------------------------------------


@pytest.mark.parametrize("crash_at", [
    {"wal.append.torn": 2},
    {"wal.append.pre_fsync": 3},
    {"wal.append.begin": 1, "wal.append.torn": 4, "replay.record": 1},
    {"snapshot.segment.pre_rename": 1},
    {"snapshot.manifest.pre_rename": 1},
    {"wal.rotate": 1},
])
def test_crash_recover_loop_serves_identical_ids(ds, built, reference_ids,
                                                 tmp_path, crash_at):
    """Every crash point of ``durability/crash.py``: the three WAL points
    and replay hit mid-schedule; the snapshot points and the rotate hit
    inside a second save, after which the driver recovers and goes on."""
    inj = CrashInjector(crash_at=dict(crash_at))
    if any(p.startswith(("snapshot.", "wal.rotate")) for p in crash_at):
        root = tmp_path / "idx"
        li = _fresh(ds, built)
        li.save(root)  # the first save is not the one that crashes
        sched = _schedule(ds)
        _apply(li, *sched[0])
        with pytest.raises(SimulatedCrash):
            li.save(root, injector=inj)
        li.close()
        li = _load(root)
        for op, arg in sched[1:]:
            _apply(li, op, arg)
        li.close()
        li = _load(root)
        recoveries = 1
    else:
        li, recoveries = _run_with_crashes(ds, built, tmp_path / "idx", inj)
    assert recoveries >= len(crash_at)
    assert inj.crash_points_hit == set(crash_at)
    np.testing.assert_array_equal(reference_ids, _ids(li, ds))
    li.close()


def test_group_commit_window_loss_still_converges(ds, built, reference_ids,
                                                  tmp_path):
    li, recoveries = _run_with_crashes(
        ds, built, tmp_path / "idx",
        CrashInjector(crash_at={"wal.append.pre_fsync": 4}),
        fsync_interval=3)
    assert recoveries == 1
    np.testing.assert_array_equal(reference_ids, _ids(li, ds))
    li.close()


def test_durability_trace_lifecycle(ds, built, tmp_path):
    tracer = Tracer(ManualClock(), process="test")
    with use_tracer(tracer):
        li, _ = _run_with_crashes(
            ds, built, tmp_path / "idx",
            CrashInjector(crash_at={"wal.append.torn": 2,
                                    "replay.record": 1}))
        li.close()
    obj = tracer.to_chrome()
    assert validate_chrome_trace(obj) == []
    summary = check_durability_trace(obj, min_crashes=2)
    assert summary["ok"], summary


def test_concurrent_mutators_save_and_snapshots(ds, built, tmp_path):
    """Mutators, a saver and snapshotting searchers race on a durable
    index; every mutation lands in the log exactly once, in order, and a
    recovery equals the final state."""
    li = _fresh(ds, built)
    root = tmp_path / "idx"
    li.save(root)
    extra = np.asarray(
        np.random.default_rng(5).normal(size=(40, 16)), np.float32)
    errors = []

    def guard(fn):
        def run():
            try:
                fn()
            except Exception as exc:  # reported below
                errors.append(exc)
        return run

    def inserts():
        for i in range(4):
            li.insert_batch(extra[i * 10:(i + 1) * 10])

    def deletes():
        for i in range(6):
            li.delete_batch(np.arange(i * 5, i * 5 + 5))

    def saves():
        for _ in range(2):
            li.save(root)

    def snapshots():
        for _ in range(6):
            ids, _ = search(li.snapshot(), ds.queries[:4], 5, device="cpu")
            assert ids.shape == (4, 5)

    threads = [threading.Thread(target=guard(f))
               for f in (inserts, deletes, saves, snapshots)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert li.wal_seq == 10
    li.close()
    back = _load(root)
    assert back.wal_seq == 10 and back.n_live == li.n_live
    np.testing.assert_array_equal(_ids(li, ds), _ids(back, ds))
    back.close()


# ---- across packages -----------------------------------------------------


@pytest.fixture(scope="module")
def ints_plan():
    rng = np.random.default_rng(21)
    base = rng.integers(0, 6, (300, 16)).astype(np.float32)
    topo = jbuild_scalegann(base, JIndexConfig(**KW),
                            algo="vamana").shard_topology(base)
    tail = [
        ("insert", rng.integers(0, 6, (50, 16)).astype(np.float32)),
        ("delete", rng.choice(350, 60, replace=False)),
        ("consolidate", None),
        ("insert", rng.integers(0, 6, (20, 16)).astype(np.float32)),
    ]
    return topo, tail, rng.integers(0, 6, (20, 16)).astype(np.float32)


def _port_topology(t) -> ShardTopology:
    return ShardTopology(
        data=np.array(t.data), shard_ids=[np.array(i) for i in t.shard_ids],
        shard_graphs=[np.array(g) for g in t.shard_graphs], metric=t.metric,
        centroids=np.array(t.centroids))


def _assert_same_state(a, b):
    assert a.n_shards == b.n_shards
    for name in ("_ids", "_graphs", "_stores"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            np.testing.assert_array_equal(x, y)
    for name in ("_data", "_entries", "_tombstones", "_dead_in_shard",
                 "_centroids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.wal_seq, a.generation, a._split_max) == \
        (b.wal_seq, b.generation, b._split_max)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_and_wal_load_across_packages(ints_plan, tmp_path, writer):
    """One package saves and logs a tail of every op; the other loads the
    snapshot and replays the tail to the writer's state, and serves the
    same ids (``numpy`` backends: the pins compare the backend)."""
    topo, tail, queries = ints_plan
    root = tmp_path / "idx"
    if writer == "reference":
        li = JLiveIndex.from_topology(topo, JIndexConfig(**KW),
                                      JLiveConfig(backend="numpy"))
    else:
        li = LiveIndex.from_topology(_port_topology(topo), CFG,
                                     LiveConfig(backend="numpy"),
                                     device="cpu")
    li.save(root)
    for op, arg in tail:
        _apply(li, op, arg)
    li.close()
    if writer == "reference":
        back = LiveIndex.load(root, CFG, LiveConfig(backend="numpy"),
                              device="cpu")
        got = search(back.snapshot(), queries, 5, backend="numpy",
                     device="cpu")[0]
        want = jsearch(li.snapshot(), queries, 5, backend="numpy")[0]
    else:
        back = JLiveIndex.load(root, JIndexConfig(**KW),
                               JLiveConfig(backend="numpy"))
        got = jsearch(back.snapshot(), queries, 5, backend="numpy")[0]
        want = search(li.snapshot(), queries, 5, backend="numpy",
                      device="cpu")[0]
    assert back.wal_seq == len(tail)
    _assert_same_state(back, li)
    np.testing.assert_array_equal(got, want)
    back.close()


def test_wal_records_decode_equal_across_packages(tmp_path):
    """Each package's reader decodes the other's log to the same
    ``(seq, op, arrays)``."""
    arrays = [
        ("insert", {"vectors": np.arange(12, dtype=np.float32).reshape(3, 4)}),
        ("delete", {"ids": np.array([5, 1, 9], np.int64)}),
        ("consolidate", {"threshold": np.array([0.25], np.float64)}),
    ]
    for writer, reader in ((WriteAheadLog, JWriteAheadLog),
                           (JWriteAheadLog, WriteAheadLog)):
        path = tmp_path / f"wal-{writer.__module__.split('.')[0]}.log"
        with writer(path) as w:
            for seq, (op, arrs) in enumerate(arrays, start=1):
                w.append(seq, op, arrs)
        mine, theirs = writer(path), reader(path)
        for a, b in zip(mine.records, theirs.records):
            assert (a.seq, a.op, a.offset) == (b.seq, b.op, b.offset)
            assert a.arrays.keys() == b.arrays.keys()
            for k in a.arrays:
                np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
                assert a.arrays[k].dtype == b.arrays[k].dtype
        assert len(theirs.records) == len(arrays)
        mine.close()
        theirs.close()
        assert path.read_bytes()[:2] == b"WA"
