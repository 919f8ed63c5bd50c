"""``repro_torch.data.formats`` and ``PrefetchReader`` against the JAX
package's (``tests/test_data.py``'s cases): BIGANN ``*bin`` round trips,
memmapped block streaming, appends, id manifests and the prefetcher.  The
files the two packages write are byte-identical, so each reads the other's.
Every test writes its own small files."""

import os
import tempfile

import numpy as np
import pytest

from repro.data import formats as jformats
from repro.data.pipeline import PrefetchReader as JPrefetchReader
from repro_torch.data import formats
from repro_torch.data.pipeline import PrefetchReader


@pytest.mark.parametrize("ext,dtype", [(".fbin", np.float32),
                                       (".u8bin", np.uint8),
                                       (".i8bin", np.int8),
                                       (".ibin", np.int32)])
def test_bin_roundtrip_matches_reference(rng, ext, dtype):
    data = (rng.normal(size=(100, 16)) * 50).astype(dtype)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x" + ext)
        ref = os.path.join(d, "ref" + ext)
        formats.write_bin(path, data)
        jformats.write_bin(ref, data)
        with open(path, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
        assert formats.read_bin_header(path) == (100, 16)
        back = formats.read_bin(path)
        assert isinstance(back, np.memmap)
        assert np.array_equal(np.asarray(back), data)
        assert np.array_equal(formats.read_bin(path, mmap=False), data)
        assert np.array_equal(formats.read_bin(ref, mmap=False),
                              np.asarray(jformats.read_bin(path)))


def test_unknown_extension_raises():
    with pytest.raises(ValueError):
        formats.write_bin("x.npy", np.zeros((2, 2), np.float32))


def test_block_iteration(rng):
    data = rng.normal(size=(100, 8)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.fbin")
        formats.write_bin(path, data)
        blocks = list(formats.iter_bin_blocks(path, 32))
        want = list(jformats.iter_bin_blocks(path, 32))
        assert [len(b) for b in blocks] == [32, 32, 32, 4]
        for got, ref in zip(blocks, want, strict=True):
            assert np.array_equal(got, ref)
        assert np.array_equal(np.concatenate(blocks), data)


def test_append_rows(rng):
    a = rng.normal(size=(10, 4)).astype(np.float32)
    b = rng.normal(size=(5, 4)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.fbin")
        ref = os.path.join(d, "ref.fbin")
        for mod, p in ((formats, path), (jformats, ref)):
            mod.append_rows(p, a)
            mod.append_rows(p, b)
        back = np.asarray(formats.read_bin(path))
        assert back.shape == (15, 4)
        assert np.array_equal(back, np.concatenate([a, b]))
        with open(path, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read()
        with pytest.raises(ValueError):
            formats.append_rows(path, np.zeros((2, 3), np.float32))


def test_ids_manifest(rng):
    ids = rng.integers(0, 1_000_000, 50).astype(np.int64)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ids.ibin")
        formats.write_ids(path, ids)
        assert np.array_equal(formats.read_ids(path), ids.astype(np.int32))
        assert np.array_equal(jformats.read_ids(path), formats.read_ids(path))


@pytest.mark.parametrize("block,depth", [(128, 2), (1000, 1), (7, 4)])
def test_prefetch_reader_order(rng, block, depth):
    data = rng.normal(size=(1000, 4)).astype(np.float32)
    blocks = list(PrefetchReader(data, block, depth=depth))
    want = list(JPrefetchReader(data, block, depth=depth))
    assert [len(b) for b in blocks] == [len(b) for b in want]
    assert np.array_equal(np.concatenate(blocks), data)


def test_prefetch_reader_streams_a_memmap(rng):
    data = rng.normal(size=(300, 8)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.fbin")
        formats.write_bin(path, data)
        blocks = list(PrefetchReader(formats.read_bin(path), 64))
        assert [len(b) for b in blocks] == [64, 64, 64, 64, 44]
        assert np.array_equal(np.concatenate(blocks), data)
