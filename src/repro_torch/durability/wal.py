"""Streaming write-ahead log for live-index mutations (counterpart of
``repro/durability/wal.py``, a copy: same framing, payload and op codes,
so either package reads the other's log).

Every ``LiveIndex`` mutation is appended here **before** any in-memory
state changes, so a kill at any byte boundary loses at most the
un-fsync'd group-commit window — and replaying the log onto the last
snapshot deterministically reconstructs the exact pre-crash index
(mutations are pure functions of ``(state, args, config seeds)``).

Record framing (little-endian), one frame per logged mutation::

    +--------+----------------+---------------+------------------+
    | magic  | payload length | CRC32         | payload          |
    | 2 B    | uint32         | uint32        | npz bytes        |
    | "WA"   |                |               |                  |
    +--------+----------------+---------------+------------------+

The CRC covers the **length bytes plus the payload**, so a flipped bit
in either the length field or the body is caught before the payload is
handed to numpy.  The payload is an uncompressed ``.npz`` with a
``meta = int64 [seq, opcode]`` array plus the op's own arrays
(``vectors`` for insert, ``ids`` for delete, ``threshold`` for
consolidate).

Torn-tail policy (the standard etcd/rocksdb contract):

* an **incomplete or CRC-failing frame at EOF** is the expected residue
  of a crash mid-append — it is truncated away on open and counted in
  ``wal_torn_records_total``;
* the same damage **anywhere before EOF** means history itself is
  corrupt and raises :class:`WalCorruptionError` with the path and byte
  offset — recovery must not guess.

``fsync_interval`` is the group-commit knob, counted in records (not
wall time) so tests stay deterministic: ``1`` fsyncs every append;
``n`` fsyncs every n-th.  A crash between appends rolls the file back
to the last synced offset (power-loss semantics — acked-but-unsynced
records vanish; callers re-derive them from ``LiveIndex.wal_seq``).
"""

from __future__ import annotations

import dataclasses
import io
import os
import pathlib
import struct
import zlib

import numpy as np

from repro_torch.telemetry import current_registry, current_tracer

from .crash import NULL_INJECTOR, SimulatedCrash
from .errors import WalCorruptionError

__all__ = ["WalRecord", "WriteAheadLog", "OP_CODES"]

_MAGIC = b"WA"
_HEADER = struct.Struct("<2sII")  # magic, payload length, crc32
_MAX_RECORD_BYTES = 1 << 31  # anything larger is a lying length field

OP_CODES = {"insert": 1, "delete": 2, "consolidate": 3}
_CODE_OPS = {v: k for k, v in OP_CODES.items()}


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded mutation frame."""

    seq: int
    op: str
    arrays: dict[str, np.ndarray]
    offset: int  # byte offset of the frame in the log file


def _encode_payload(seq: int, op: str, arrays: dict[str, np.ndarray]) -> bytes:
    if op not in OP_CODES:
        raise ValueError(f"unknown WAL op {op!r}")
    if "meta" in arrays:
        raise ValueError("'meta' is a reserved WAL array name")
    buf = io.BytesIO()
    np.savez(buf, meta=np.array([seq, OP_CODES[op]], dtype=np.int64),
             **arrays)
    return buf.getvalue()


def _decode_payload(payload: bytes, path: pathlib.Path,
                    offset: int) -> tuple[int, str, dict[str, np.ndarray]]:
    try:
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as exc:  # the CRC passed, so this is an encoder bug
        raise WalCorruptionError(
            path, offset, f"undecodable npz payload ({exc})") from exc
    meta = arrays.pop("meta", None)
    if meta is None or meta.shape != (2,):
        raise WalCorruptionError(path, offset, "payload missing meta array")
    seq, code = int(meta[0]), int(meta[1])
    op = _CODE_OPS.get(code)
    if op is None:
        raise WalCorruptionError(path, offset, f"unknown opcode {code}")
    return seq, op, arrays


class WriteAheadLog:
    """Append-only mutation log with torn-tail recovery on open.

    Opening an existing file scans and validates every frame (available
    afterwards as ``.records``), truncates a torn tail, and positions
    the write cursor for appends.  ``injector`` is a
    :class:`~repro_torch.durability.crash.CrashInjector` hit at the
    ``wal.append.*`` crash points.
    """

    def __init__(self, path: str | pathlib.Path, *, fsync_interval: int = 1,
                 injector=None):
        if fsync_interval < 1:
            raise ValueError("fsync_interval must be >= 1")
        self.path = pathlib.Path(path)
        self.fsync_interval = int(fsync_interval)
        self._inj = injector if injector is not None else NULL_INJECTOR
        self.records: list[WalRecord] = []
        self.torn_bytes_dropped = 0
        self.n_fsyncs = 0
        self._pending = 0  # appends since the last fsync
        created = not self.path.exists()
        self._f = open(self.path, "w+b" if created else "r+b")
        if created:
            _fsync_dir(self.path.parent)
            self._offset = 0
        else:
            self._scan()
        self._synced_offset = self._offset

    @property
    def seq(self) -> int:
        """Highest sequence number durably in the log (0 if empty)."""
        return self.records[-1].seq if self.records else 0

    # ---- open-time scan --------------------------------------------------

    def _scan(self) -> None:
        buf = self._f.read()
        off = 0
        prev_seq = None
        while off < len(buf):
            rest = len(buf) - off
            if rest < _HEADER.size:
                break  # torn header at EOF
            magic, length, crc = _HEADER.unpack_from(buf, off)
            if magic != _MAGIC:
                raise WalCorruptionError(self.path, off, "bad record magic")
            if length > _MAX_RECORD_BYTES:
                raise WalCorruptionError(
                    self.path, off, f"implausible record length {length}")
            end = off + _HEADER.size + length
            if end > len(buf):
                break  # torn payload at EOF
            payload = buf[off + _HEADER.size:end]
            if zlib.crc32(buf[off + 2:off + 6] + payload) != crc:
                if end == len(buf):
                    break  # corrupt final record == torn tail
                raise WalCorruptionError(self.path, off, "CRC mismatch")
            seq, op, arrays = _decode_payload(payload, self.path, off)
            if prev_seq is not None and seq != prev_seq + 1:
                raise WalCorruptionError(
                    self.path, off,
                    f"sequence gap: {prev_seq} -> {seq}")
            prev_seq = seq
            self.records.append(WalRecord(seq, op, arrays, off))
            off = end
        torn = len(buf) - off
        if torn:
            self.torn_bytes_dropped = torn
            self._f.truncate(off)
            self._f.flush()
            os.fsync(self._f.fileno())
            current_registry().counter(
                "wal_torn_records_total",
                "Torn/corrupt WAL tail records truncated on open",
            ).inc()
        self._offset = off

    # ---- append path -----------------------------------------------------

    def append(self, seq: int, op: str, arrays: dict[str, np.ndarray]) -> None:
        """Frame, write, and (per group-commit policy) fsync one record.

        On a :class:`SimulatedCrash` the file is left exactly as the
        named boundary would after a real kill, then the crash
        re-raises for the caller's harness."""
        payload = _encode_payload(seq, op, arrays)
        frame = _HEADER.pack(
            _MAGIC, len(payload),
            zlib.crc32(struct.pack("<I", len(payload)) + payload),
        ) + payload
        tr = current_tracer()
        with tr.span("durability.wal_append", track="durability",
                     op=op, seq=seq, bytes=len(frame)):
            try:
                self._inj.reached("wal.append.begin")
            except SimulatedCrash:
                self._rollback_to_synced()
                raise
            self._f.seek(self._offset)
            half = len(frame) // 2
            self._f.write(frame[:half])
            try:
                self._inj.reached("wal.append.torn")
            except SimulatedCrash:
                # kill -9: written bytes survive in page cache — keep the
                # torn half on disk for recovery to truncate.
                self._f.flush()
                raise
            self._f.write(frame[half:])
            self._f.flush()
            self._offset += len(frame)
            self._pending += 1
            try:
                self._inj.reached("wal.append.pre_fsync")
            except SimulatedCrash:
                # power loss before fsync: the whole unsynced window is
                # gone, not just this record.
                self._rollback_to_synced()
                raise
            if self._pending >= self.fsync_interval:
                self.sync()
        self.records.append(WalRecord(seq, op, arrays, self._offset - len(frame)))
        reg = current_registry()
        reg.counter("wal_records_total", "WAL records appended").inc()
        reg.counter("wal_bytes_total", "WAL bytes appended").inc(len(frame))

    def sync(self) -> None:
        """fsync outstanding appends (the group-commit barrier)."""
        if self._pending == 0 and self._synced_offset == self._offset:
            return
        os.fsync(self._f.fileno())
        self._synced_offset = self._offset
        self._pending = 0
        self.n_fsyncs += 1
        current_registry().counter(
            "wal_fsyncs_total", "WAL fsync barriers").inc()

    def _rollback_to_synced(self) -> None:
        self._f.truncate(self._synced_offset)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._offset = self._synced_offset
        self._pending = 0

    def close(self) -> None:
        if self._f.closed:
            return
        self.sync()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fsync_dir(path: pathlib.Path) -> None:
    """fsync a directory so a just-created/renamed entry is durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
