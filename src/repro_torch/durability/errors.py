"""Durability error taxonomy (counterpart of
``repro/durability/errors.py``, a copy).

Every corruption the recovery paths refuse to silently absorb raises one
of these, and every one of them names the **file** and (where it means
anything) the **byte offset** of the damage — the corruption-matrix
contract is "recover, or fail loudly with the path and offset", never a
cryptic numpy/zipfile exception three frames below the real cause.
"""

from __future__ import annotations

import pathlib

__all__ = ["DurabilityError", "SnapshotCorruptionError",
           "WalCorruptionError"]


class DurabilityError(Exception):
    """Base class for durable-state failures (WAL / snapshot / manifest)."""


class WalCorruptionError(DurabilityError):
    """A WAL record that is provably damaged *before* the torn tail.

    A torn or corrupt **final** record is expected after a crash and is
    silently truncated on open; damage anywhere else means the log lied
    about history and recovery must stop."""

    def __init__(self, path, offset: int, reason: str):
        self.path = pathlib.Path(path)
        self.offset = int(offset)
        self.reason = reason
        super().__init__(
            f"corrupt WAL record in {self.path} at byte {self.offset}: "
            f"{reason}"
        )


class SnapshotCorruptionError(DurabilityError):
    """A snapshot artifact (segment / manifest / CURRENT) failed its
    checksum, size, or schema check."""

    def __init__(self, path, reason: str, offset: int | None = None):
        self.path = pathlib.Path(path)
        self.offset = offset
        self.reason = reason
        at = f" at byte {offset}" if offset is not None else ""
        super().__init__(
            f"corrupt snapshot file {self.path}{at}: {reason}"
        )
