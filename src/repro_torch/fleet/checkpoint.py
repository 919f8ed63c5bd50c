"""Round-grain shard-build checkpoints (paper §IV re-allocation, §VIII
checkpoint-resume future work — made real here; counterpart of
``repro/fleet/checkpoint.py``, a copy: the same envelope, npz keys and
``FORMAT_VERSION``, so either package loads and resumes the other's
checkpoints).

The batched Vamana build advances in insertion rounds, and a round boundary
is a complete, deterministic restart point: the graph rows plus the
``(pass_idx, next_start)`` cursor fully determine the remaining build (the
batch schedule replays from ``seed``).  :class:`ShardCheckpoint` freezes
that state together with the build parameters it must match on resume;
:class:`CheckpointStore` keeps the *serialized* bytes (optionally mirrored
to disk) so every resume exercises the same round-trip a real spot fleet
would — a checkpoint that only survives in process memory proves nothing
about surviving a preemption.

The serialized form is a checksummed envelope — 4-byte magic plus a
CRC32 over the npz payload — written tmp → fsync → rename, and a
corrupt or truncated on-disk checkpoint is **treated as missing** on
load (the task rebuilds from round 0 and
``fleet_checkpoint_corrupt_total`` ticks) rather than raising out of
the executor: on spot capacity a half-written checkpoint is an expected
preemption residue, not an operator error.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pathlib
import struct
import threading
import zlib

import numpy as np

from repro_torch.telemetry import current_registry

FORMAT_VERSION = 1

_ENVELOPE_MAGIC = b"SCKP"
_ENVELOPE = struct.Struct("<4sI")  # magic, crc32(payload)

_META_FIELDS = (
    "format_version", "shard", "pass_idx", "next_start",
    "n_distance_computations", "n", "R", "seed", "batch_size",
    "round_idx", "n_rounds_total",
)


class CheckpointCorruptError(ValueError):
    """The checkpoint envelope failed its magic/CRC/decode check.

    ``CheckpointStore.load`` converts this into "no checkpoint" for
    on-disk blobs; it only propagates when raised from bytes the caller
    handed in directly."""


@dataclasses.dataclass(frozen=True)
class ShardCheckpoint:
    """Everything a bit-compatible mid-build resume needs for one shard.

    Duck-type compatible with ``build_shard_index_vamana(resume=...)``
    (``pass_idx`` / ``next_start`` / ``graph`` / ``n_distance_computations``
    / ``n`` / ``R``); the extra fields pin the build parameters the resume
    must reuse and the provenance the fleet telemetry reports.
    """

    shard: int
    pass_idx: int
    next_start: int
    graph: np.ndarray  # [n, R] int64 — real rows only, no padding
    n_distance_computations: int
    n: int
    R: int
    seed: int
    batch_size: int
    round_idx: int
    n_rounds_total: int

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        meta = np.asarray(
            [FORMAT_VERSION, self.shard, self.pass_idx, self.next_start,
             self.n_distance_computations, self.n, self.R, self.seed,
             self.batch_size, self.round_idx, self.n_rounds_total],
            np.int64,
        )
        np.savez_compressed(
            buf, meta=meta, graph=np.asarray(self.graph, np.int64)
        )
        payload = buf.getvalue()
        return _ENVELOPE.pack(
            _ENVELOPE_MAGIC, zlib.crc32(payload) & 0xFFFFFFFF
        ) + payload

    @staticmethod
    def from_bytes(raw: bytes) -> "ShardCheckpoint":
        if len(raw) < _ENVELOPE.size:
            raise CheckpointCorruptError(
                f"checkpoint truncated to {len(raw)} bytes (envelope "
                f"needs {_ENVELOPE.size})")
        magic, crc = _ENVELOPE.unpack_from(raw)
        if magic != _ENVELOPE_MAGIC:
            raise CheckpointCorruptError(
                f"bad checkpoint magic {magic!r}")
        payload = raw[_ENVELOPE.size:]
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != crc:
            raise CheckpointCorruptError(
                f"checkpoint CRC mismatch (envelope says {crc:08x}, "
                f"payload is {got:08x})")
        try:
            with np.load(io.BytesIO(payload)) as z:
                meta = z["meta"]
                graph = z["graph"]
        except Exception as exc:  # CRC passed — still never leak zipfile
            raise CheckpointCorruptError(
                f"undecodable checkpoint payload ({exc})") from exc
        fields = dict(zip(_META_FIELDS, (int(v) for v in meta)))
        version = fields.pop("format_version")
        if version != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint format {version} "
                f"(expected {FORMAT_VERSION})"
            )
        return ShardCheckpoint(graph=graph, **fields)


class CheckpointStore:
    """Thread-safe latest-checkpoint-per-shard store.

    ``save`` serializes immediately; ``load`` deserializes from the stored
    bytes — so the serialize→deserialize round-trip is on the actual
    resume path, not just in a unit test.  Pass ``directory`` to also
    mirror each checkpoint to ``shard<id>.ckpt.npz`` (crash-durable
    variant; the in-memory copy stays authoritative for speed).
    """

    def __init__(self, directory: str | pathlib.Path | None = None):
        self._lock = threading.Lock()
        self._blobs: dict[int, bytes] = {}
        self.n_saves = 0
        self.directory = pathlib.Path(directory) if directory else None
        if self.directory:
            self.directory.mkdir(parents=True, exist_ok=True)

    def save(self, ckpt: ShardCheckpoint) -> None:
        raw = ckpt.to_bytes()
        with self._lock:
            self._blobs[ckpt.shard] = raw
            self.n_saves += 1
        if self.directory:
            path = self.directory / f"shard{ckpt.shard:05d}.ckpt.npz"
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())  # durable before it can shadow
            tmp.replace(path)  # atomic: a torn write never shadows a good one
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)  # the rename itself must survive power loss
            finally:
                os.close(fd)

    def load(self, shard: int) -> ShardCheckpoint | None:
        with self._lock:
            raw = self._blobs.get(shard)
        if raw is not None:
            return ShardCheckpoint.from_bytes(raw)
        if not self.directory:
            return None
        path = self.directory / f"shard{shard:05d}.ckpt.npz"
        if not path.exists():
            return None
        try:
            return ShardCheckpoint.from_bytes(path.read_bytes())
        except CheckpointCorruptError:
            # expected spot-preemption residue: rebuild from round 0
            current_registry().counter(
                "fleet_checkpoint_corrupt_total",
                "corrupt/truncated on-disk checkpoints treated as missing",
            ).inc()
            return None

    def discard(self, shard: int) -> None:
        with self._lock:
            self._blobs.pop(shard, None)
        if self.directory:
            path = self.directory / f"shard{shard:05d}.ckpt.npz"
            if path.exists():
                path.unlink()

    def __contains__(self, shard: int) -> bool:
        with self._lock:
            if shard in self._blobs:
                return True
        return bool(
            self.directory
            and (self.directory / f"shard{shard:05d}.ckpt.npz").exists()
        )
