"""The ``fused`` backend's queued split search, on the CPU.

* ``run_split`` queues every probed shard's search through
  ``fused_beam_search.launch`` and waits once; the ids and
  ``SearchStats`` equal those of the same loop calling the beam one shard
  at a time (a beam_fn without ``launch``), at f32 and uint8, routed and
  scattered, with and without tombstones.
* A search's entry tensor is uploaded once per (entries, point count),
  so K3's check of it reads the card once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.data.synthetic import make_clustered
from repro_torch.search import fused_backend
from repro_torch.search.types import run_split

CFG = IndexConfig(degree=16, build_degree=32, n_clusters=4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def split():
    ds = make_clustered(1200, 16, n_queries=40, seed=4, device="cpu")
    res = build_scalegann(ds.data, CFG, algo="vamana", device="cpu")
    return res.shard_topology(ds.data), ds.queries


def _one_by_one(*args, **kw):
    """The fused beam with no ``launch``: run_split's eager loop."""
    return fused_backend.fused_beam_search(*args, **kw)


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
@pytest.mark.parametrize("nprobe", [None, 2])
@pytest.mark.parametrize("tombstoned", [False, True])
def test_queued_split_search_equals_one_shard_at_a_time(split, dtype, nprobe,
                                                       tombstoned):
    topo, queries = split
    if tombstoned:
        tomb = np.zeros(len(topo.data), bool)
        tomb[::7] = True
        topo = dataclasses.replace(topo, tombstones=tomb)
    kw = dict(width=32, nprobe=nprobe, bucket=True, dtype=dtype, device=CPU)
    assert hasattr(fused_backend.fused_beam_search, "launch")
    ids_q, st_q = run_split(fused_backend.fused_beam_search, topo, queries,
                            10, **kw)
    ids_e, st_e = run_split(_one_by_one, topo, queries, 10, **kw)
    np.testing.assert_array_equal(ids_q, ids_e)
    assert st_q == st_e
    assert st_q.n_distance_computations > 0


def test_entry_tensor_uploaded_once_per_point_count():
    a = fused_backend._prep_entries(np.array([3, 1]), 8, CPU, 100)
    assert fused_backend._prep_entries(np.array([3, 1]), 8, CPU, 100) is a
    assert fused_backend._prep_entries([3, 1, 5], 2, CPU, 100) is a
    b = fused_backend._prep_entries(np.array([3, 1]), 8, CPU, 101)
    assert b is not a
    assert a.dtype == torch.int32 and a.tolist() == [3, 1]

