"""Deterministic crash injection for the durability layer (counterpart of
``repro/durability/crash.py``, a copy: same crash-point names).

The fleet layer already proved the pattern (the reference's
``PreemptionInjector``): a robustness claim is only testable when the
failure it survives is *delivered deterministically*.  Preemptions tick
on completed build rounds; durability crashes tick on **crash points** —
named byte-level boundaries the WAL and snapshot writers pass through on
every append / save / recovery:

====================================  ====================================
point                                 where the process "dies"
====================================  ====================================
``wal.append.begin``                  before any byte of the record is
                                      written (power-loss semantics: all
                                      unsynced bytes are discarded)
``wal.append.torn``                   half the framed record is on disk —
                                      the torn-write case recovery must
                                      truncate
``wal.append.pre_fsync``              the record is fully written but not
                                      fsync'd (power-loss semantics: the
                                      file rolls back to the last synced
                                      offset, so group-committed but
                                      unacked-to-disk records vanish)
``snapshot.segment.pre_rename``       a segment tmp file is written and
                                      fsync'd but never renamed
``snapshot.manifest.pre_rename``      the manifest tmp exists, the rename
                                      that would publish it does not
``snapshot.current.pre_rename``       segments + manifest are durable but
                                      the ``CURRENT`` pointer flip — the
                                      commit point — never happens
``wal.rotate``                        the new snapshot is committed but
                                      the fresh WAL file was never created
``replay.record``                     between two replayed WAL records
                                      during recovery (recovery itself is
                                      crash-safe: it mutates nothing on
                                      disk except the torn-tail truncate)
====================================  ====================================

Two delivery modes, composable:

* ``crash_at={point: hit_or_hits}`` — crash on the N-th time the named
  point is reached (1-based), the fully deterministic form the tests and
  the bench schedule pin.
* ``p_crash`` + ``seed`` — seeded Bernoulli chaos per crash-point hit,
  capped by ``max_crashes`` (single-writer mutation means hit order, and
  therefore the kill schedule, is reproducible).

A fired crash raises :class:`SimulatedCrash`; the component that invoked
the point performs its declared durability-loss effect (e.g. the WAL
truncating to its synced offset) and re-raises, so what the next
:func:`LiveIndex.load` sees on disk is exactly what a ``kill -9`` /
power-loss at that boundary would leave.

The module also carries the **corruption modes** — :func:`truncate_at`
and :func:`bit_flip` — for damaging files that are already durable
(a torn final record, a flipped manifest byte), completing the recovery
test matrix.
"""

from __future__ import annotations

import os
import pathlib
import threading

import numpy as np

from repro_torch.telemetry import current_tracer

__all__ = ["CrashInjector", "SimulatedCrash", "bit_flip", "truncate_at"]


class SimulatedCrash(Exception):
    """The injector killed the process at a crash point.

    Tests and the bench catch this, drop the in-memory index (the
    process is notionally dead), and recover via ``LiveIndex.load`` —
    the on-disk state is exactly what the named boundary leaves behind.
    """

    def __init__(self, point: str, hit: int):
        self.point = point
        self.hit = hit
        super().__init__(f"simulated crash at {point!r} (hit {hit})")


class CrashInjector:
    """Seeded / scheduled crash delivery at named crash points.

    Parameters
    ----------
    seed:
        Seed for the chaos mode's Bernoulli draws.
    crash_at:
        ``{point: hit}`` or ``{point: [hits...]}`` — crash when ``point``
        is reached for the (1-based) ``hit``-th time.  Each scheduled hit
        fires exactly once.
    p_crash:
        Per-hit crash probability for chaos mode (0 disables).
    max_crashes:
        Cap on *total* crashes delivered (scheduled + chaos); None means
        unlimited.
    """

    def __init__(self, *, seed: int = 0,
                 crash_at: dict[str, int | list[int]] | None = None,
                 p_crash: float = 0.0,
                 max_crashes: int | None = None):
        self.seed = seed
        self.p_crash = float(p_crash)
        self.max_crashes = max_crashes
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._schedule: dict[str, set[int]] = {}
        for point, hits in (crash_at or {}).items():
            if isinstance(hits, (int, np.integer)):
                hits = [int(hits)]
            self._schedule[point] = {int(h) for h in hits}
        self.hits: dict[str, int] = {}
        self.n_crashes = 0
        self.events: list[tuple[str, int]] = []  # (point, hit) per crash

    @property
    def crash_points_hit(self) -> set[str]:
        """Distinct points that actually delivered a crash (the bench's
        "≥3 injected crashes at distinct points" evidence)."""
        return {p for p, _ in self.events}

    def reached(self, point: str) -> None:
        """A component passed the named boundary; maybe die here."""
        with self._lock:
            hit = self.hits.get(point, 0) + 1
            self.hits[point] = hit
            fire = False
            if (self.max_crashes is None
                    or self.n_crashes < self.max_crashes):
                if hit in self._schedule.get(point, ()):
                    self._schedule[point].discard(hit)
                    fire = True
                elif self.p_crash > 0 and self._rng.random() < self.p_crash:
                    fire = True
            if not fire:
                return
            self.n_crashes += 1
            self.events.append((point, hit))
        tr = current_tracer()
        if tr.enabled:
            tr.instant("durability.crash", track="durability",
                       point=point, hit=hit)
        raise SimulatedCrash(point, hit)


class _NullInjector:
    """The no-op default: every crash point is one attribute load + call."""

    def reached(self, point: str) -> None:
        return None


NULL_INJECTOR = _NullInjector()


# ---- corruption modes (damage already-durable files) ---------------------


def truncate_at(path: str | pathlib.Path, size: int) -> int:
    """Truncate ``path`` to ``size`` bytes (negative: relative to the
    end) — the torn-write / lost-tail corruption mode.  Returns the new
    size."""
    path = pathlib.Path(path)
    n = path.stat().st_size
    size = max(0, n + size) if size < 0 else min(size, n)
    with open(path, "r+b") as f:
        f.truncate(size)
        f.flush()
        os.fsync(f.fileno())
    return size


def bit_flip(path: str | pathlib.Path, offset: int, bit: int = 0) -> None:
    """Flip one bit of the byte at ``offset`` (negative: from the end) —
    the silent-media-corruption mode checksums must catch."""
    path = pathlib.Path(path)
    n = path.stat().st_size
    if not n:
        raise ValueError(f"cannot bit-flip empty file {path}")
    if offset < 0:
        offset += n
    if not 0 <= offset < n:
        raise ValueError(f"offset {offset} outside {path} ({n} bytes)")
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([b ^ (1 << (bit % 8))]))
        f.flush()
        os.fsync(f.fileno())
