"""BIGANN benchmark binary vector formats (counterpart of
``repro/data/formats.py``; paper §VI datasets).

All of Sift/Deep/MSTuring/Laion ship in the ``*bin`` family:

    <n: int32> <d: int32> <n*d values, row-major>

with the value dtype encoded in the extension: ``.fbin`` float32,
``.u8bin`` uint8, ``.i8bin`` int8, ``.ibin`` int32 (ground-truth ids).
This module reads/writes them with O(block) memory (memmap) so the
partitioner's one-disk-pass contract (§V-A) holds for datasets far larger
than RAM.  The files are byte-identical to the reference's.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

_DTYPES = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".ibin": np.int32,
}

HEADER_BYTES = 8


def _dtype_for(path: str) -> np.dtype:
    for ext, dt in _DTYPES.items():
        if path.endswith(ext):
            return np.dtype(dt)
    raise ValueError(f"unknown vector-file extension: {path}")


def write_bin(path: str, data: np.ndarray) -> None:
    """Write [N, D] array in bigann layout (dtype from the extension)."""
    dt = _dtype_for(path)
    data = np.ascontiguousarray(data, dtype=dt)
    n, d = data.shape
    with open(path, "wb") as f:
        np.asarray([n, d], np.int32).tofile(f)
        data.tofile(f)


def read_bin_header(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        n, d = np.fromfile(f, np.int32, 2)
    return int(n), int(d)


def read_bin(path: str, *, mmap: bool = True) -> np.ndarray:
    """[N, D] array; memmap'd by default (no RAM blow-up on 100M+ rows)."""
    n, d = read_bin_header(path)
    dt = _dtype_for(path)
    if mmap:
        return np.memmap(path, dtype=dt, mode="r", offset=HEADER_BYTES,
                         shape=(n, d))
    with open(path, "rb") as f:
        f.seek(HEADER_BYTES)
        return np.fromfile(f, dt).reshape(n, d)


def iter_bin_blocks(path: str, block_size: int) -> Iterator[np.ndarray]:
    """Stream [<=block_size, D] blocks — the §V-A single disk pass."""
    data = read_bin(path, mmap=True)
    for s in range(0, data.shape[0], block_size):
        yield np.asarray(data[s : s + block_size])


def append_rows(path: str, rows: np.ndarray) -> None:
    """Append rows to an existing bin file, fixing the header count (the
    partitioner's shard writers append in arrival order, §V-C)."""
    dt = _dtype_for(path)
    rows = np.ascontiguousarray(rows, dtype=dt)
    if not os.path.exists(path):
        write_bin(path, rows)
        return
    n, d = read_bin_header(path)
    if rows.shape[1] != d:
        raise ValueError(f"dim mismatch: file d={d}, rows d={rows.shape[1]}")
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        rows.tofile(f)
        f.seek(0)
        np.asarray([n + rows.shape[0], d], np.int32).tofile(f)


def write_ids(path: str, ids: np.ndarray) -> None:
    """Shard manifest: (local -> global id), one int32 row each."""
    write_bin(path, np.asarray(ids, np.int32).reshape(-1, 1))


def read_ids(path: str) -> np.ndarray:
    return np.asarray(read_bin(path, mmap=False)).reshape(-1)
