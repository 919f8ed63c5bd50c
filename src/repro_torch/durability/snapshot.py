"""Atomic, checksummed on-disk snapshots (LevelDB-style commit protocol;
counterpart of ``repro/durability/snapshot.py``, a copy: same file names,
manifest keys and ``SNAPSHOT_FORMAT_VERSION``).

A snapshot directory holds immutable **generations**.  Saving generation
``N`` never touches a byte any older manifest references:

1. every segment is written as ``seg-<N>-<key>.npz`` via
   write-tmp → fsync → rename (fresh names — an interrupted save can
   only leave orphan ``*.tmp`` / unreferenced files, never damage the
   committed generation);
2. ``manifest-<N>.json`` records the schema version, the config pins a
   replay depends on, the WAL high-water mark, and a CRC32 + byte size
   for every segment file;
3. the ``CURRENT`` pointer file — one line,
   ``<manifest-name> <crc32-of-manifest-bytes>`` — is atomically
   replaced.  **This rename is the commit point**: before it, recovery
   sees the old generation intact; after it, the new one.

Loading walks the chain in reverse and verifies every link: CURRENT's
recorded CRC catches a bit-flipped manifest; the manifest's per-file
CRC + size catch truncated or flipped segments — each failure raises
:class:`SnapshotCorruptionError` naming the file (and offset where one
exists) instead of letting numpy's zip reader throw three frames down.

Old generations and orphaned tmp files are garbage-collected
best-effort *after* the CURRENT flip.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import re
import zlib

import numpy as np

from .crash import NULL_INJECTOR
from .errors import SnapshotCorruptionError

__all__ = [
    "SNAPSHOT_FORMAT_VERSION",
    "atomic_write_bytes",
    "gc_snapshot_dir",
    "load_manifest",
    "load_segment",
    "next_snapshot_id",
    "save_snapshot",
    "wal_name",
]

SNAPSHOT_FORMAT_VERSION = 1

_MANIFEST_RE = re.compile(r"^manifest-(\d{6})\.json$")


def wal_name(snapshot_id: int) -> str:
    return f"wal-{snapshot_id:06d}.log"


def _manifest_name(snapshot_id: int) -> str:
    return f"manifest-{snapshot_id:06d}.json"


def next_snapshot_id(root: pathlib.Path) -> int:
    """1 + the highest manifest id present (committed *or* orphaned) —
    guarantees a save never reuses file names an older manifest, or a
    crashed save, may still reference."""
    best = 0
    for p in root.iterdir():
        m = _MANIFEST_RE.match(p.name.removesuffix(".tmp"))
        if m:
            best = max(best, int(m.group(1)))
    return best + 1


def _fsync_dir(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: pathlib.Path, data: bytes, *,
                       injector=NULL_INJECTOR,
                       crash_point: str | None = None) -> None:
    """write-tmp → fsync → rename → fsync(dir).

    ``crash_point`` (if given) is hit *between* the tmp fsync and the
    rename — the "crash between tmp-write and rename" case: the tmp
    file is durable but the target name never appears."""
    tmp = path.parent / (path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if crash_point is not None:
        injector.reached(crash_point)
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def save_snapshot(root: str | pathlib.Path,
                  segments: dict[str, dict[str, np.ndarray]],
                  meta: dict, *, injector=NULL_INJECTOR) -> dict:
    """Write one new generation and commit it via the CURRENT flip.

    ``segments`` maps a short key (e.g. ``shard3``, ``global``) to the
    arrays stored in that file; ``meta`` is merged into the manifest
    (must already carry ``wal_seq`` and the replay config pins).
    Returns the committed manifest dict (with ``_name`` added)."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    sid = next_snapshot_id(root)
    files: dict[str, dict] = {}
    for key, arrays in segments.items():
        name = f"seg-{sid:06d}-{key}.npz"
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        raw = buf.getvalue()
        atomic_write_bytes(root / name, raw, injector=injector,
                           crash_point="snapshot.segment.pre_rename")
        files[name] = {"crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                       "bytes": len(raw)}
    manifest = dict(meta)
    manifest["format_version"] = SNAPSHOT_FORMAT_VERSION
    manifest["snapshot_id"] = sid
    manifest["wal_file"] = wal_name(sid)
    manifest["files"] = files
    mname = _manifest_name(sid)
    mbytes = json.dumps(manifest, indent=1, sort_keys=True).encode()
    atomic_write_bytes(root / mname, mbytes, injector=injector,
                       crash_point="snapshot.manifest.pre_rename")
    pointer = f"{mname} {zlib.crc32(mbytes) & 0xFFFFFFFF:08x}\n".encode()
    atomic_write_bytes(root / "CURRENT", pointer, injector=injector,
                       crash_point="snapshot.current.pre_rename")
    manifest["_name"] = mname
    return manifest


def _read_current(root: pathlib.Path) -> tuple[str, int]:
    cpath = root / "CURRENT"
    if not cpath.exists():
        raise SnapshotCorruptionError(cpath, "missing CURRENT pointer")
    parts = cpath.read_text().split()
    if len(parts) != 2:
        raise SnapshotCorruptionError(cpath, "malformed CURRENT pointer")
    name, crc_hex = parts
    try:
        crc = int(crc_hex, 16)
    except ValueError:
        raise SnapshotCorruptionError(
            cpath, f"malformed CURRENT checksum {crc_hex!r}") from None
    return name, crc


def load_manifest(root: str | pathlib.Path) -> dict:
    """Resolve CURRENT → manifest, verifying the pointer's CRC."""
    root = pathlib.Path(root)
    name, want_crc = _read_current(root)
    mpath = root / name
    if not mpath.exists():
        raise SnapshotCorruptionError(
            mpath, "CURRENT points at a missing manifest")
    raw = mpath.read_bytes()
    got_crc = zlib.crc32(raw) & 0xFFFFFFFF
    if got_crc != want_crc:
        raise SnapshotCorruptionError(
            mpath,
            f"manifest CRC mismatch (CURRENT says {want_crc:08x}, "
            f"file is {got_crc:08x})", offset=0)
    try:
        manifest = json.loads(raw)
    except ValueError as exc:
        raise SnapshotCorruptionError(
            mpath, f"unparseable manifest JSON ({exc})") from exc
    version = manifest.get("format_version")
    if version != SNAPSHOT_FORMAT_VERSION:
        raise SnapshotCorruptionError(
            mpath,
            f"unsupported snapshot format_version {version!r} "
            f"(supported: {SNAPSHOT_FORMAT_VERSION})")
    manifest["_name"] = name
    return manifest


def load_segment(root: str | pathlib.Path, manifest: dict,
                 name: str) -> dict[str, np.ndarray]:
    """Read + verify one segment file listed in ``manifest``."""
    root = pathlib.Path(root)
    entry = manifest["files"].get(name)
    if entry is None:
        raise SnapshotCorruptionError(
            root / name, f"segment not listed in {manifest['_name']}")
    path = root / name
    if not path.exists():
        raise SnapshotCorruptionError(
            path, f"segment listed in {manifest['_name']} is missing")
    raw = path.read_bytes()
    if len(raw) != entry["bytes"]:
        raise SnapshotCorruptionError(
            path,
            f"size mismatch (manifest says {entry['bytes']} bytes, "
            f"file has {len(raw)})",
            offset=min(len(raw), entry["bytes"]))
    got_crc = zlib.crc32(raw) & 0xFFFFFFFF
    if got_crc != entry["crc32"]:
        raise SnapshotCorruptionError(
            path,
            f"CRC mismatch (manifest says {entry['crc32']:08x}, "
            f"file is {got_crc:08x})")
    try:
        with np.load(io.BytesIO(raw)) as z:
            return {k: z[k] for k in z.files}
    except Exception as exc:  # CRC passed — an encoder bug, still name it
        raise SnapshotCorruptionError(
            path, f"undecodable npz segment ({exc})") from exc


def gc_snapshot_dir(root: str | pathlib.Path, manifest: dict) -> int:
    """Best-effort removal of files the committed ``manifest`` does not
    reference (older generations, orphaned tmp files).  Runs only after
    the CURRENT flip; failures are swallowed — GC can always retry on
    the next save.  Returns the number of files removed."""
    root = pathlib.Path(root)
    keep = set(manifest["files"])
    keep.update((manifest["_name"], manifest["wal_file"], "CURRENT"))
    removed = 0
    for p in root.iterdir():
        if p.name in keep or not (
                p.name.startswith(("seg-", "manifest-", "wal-"))
                or p.name.endswith(".tmp")):
            continue
        try:
            p.unlink()
            removed += 1
        except OSError:
            pass
    return removed
