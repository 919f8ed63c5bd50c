"""Crash-consistent durability for the live mutation path (counterpart
of ``repro.durability``: a copy of the framework-free reference, so the
WAL frames, snapshot files, manifest and ``CURRENT`` pointer are the same
bytes layout in both packages and either package loads the other's).

Three pieces, composed by ``LiveIndex.save`` / ``LiveIndex.load``:

* :mod:`repro_torch.durability.wal` — a streaming write-ahead log; mutations
  are framed (length-prefixed, CRC32), appended, and group-commit
  fsync'd **before** in-memory state changes.
* :mod:`repro_torch.durability.snapshot` — atomic checksummed snapshots with
  a LevelDB-style ``CURRENT`` pointer flip as the single commit point,
  plus WAL-tail replay metadata (the manifest's high-water mark).
* :mod:`repro_torch.durability.crash` — a deterministic :class:`CrashInjector`
  (seeded crash points at every byte-level boundary, plus
  truncate/bit-flip corruption modes) so each recovery path is a pure
  test matrix.

This package is imported *by* ``repro_torch.live`` and must never import
it back (only ``repro_torch.telemetry`` below it).
"""

from .crash import CrashInjector, SimulatedCrash, bit_flip, truncate_at
from .errors import (DurabilityError, SnapshotCorruptionError,
                     WalCorruptionError)
from .snapshot import (SNAPSHOT_FORMAT_VERSION, load_manifest, save_snapshot)
from .wal import WalRecord, WriteAheadLog

__all__ = [
    "SNAPSHOT_FORMAT_VERSION",
    "CrashInjector",
    "DurabilityError",
    "SimulatedCrash",
    "SnapshotCorruptionError",
    "WalCorruptionError",
    "WalRecord",
    "WriteAheadLog",
    "bit_flip",
    "load_manifest",
    "save_snapshot",
    "truncate_at",
]
