"""The frozen generator against the program's own, and the query stream."""

import numpy as np
import pytest
import torch

from annbench import datagen

CFG = {"dim": 16, "generator": {"n_true_clusters": 24, "spread": 0.35,
                                "data_seed": 3}}


@pytest.mark.parametrize("n,d,seed", [(500, 8, 0), (257, 33, 12345)])
def test_make_clustered_is_the_programs(n, d, seed):
    from repro_torch.data.synthetic import make_clustered

    want = make_clustered(n, d, n_queries=40, seed=seed, device="cpu")
    data, queries = datagen.make_clustered(n, d, n_queries=40, seed=seed)
    np.testing.assert_array_equal(data, want.data)
    np.testing.assert_array_equal(queries, want.queries)


def test_base_data_is_make_clustered_at_the_data_seed():
    from repro_torch.data.synthetic import make_clustered

    want = make_clustered(300, 16, n_queries=0, seed=3, device="cpu").data
    np.testing.assert_array_equal(datagen.base_data(CFG, 300), want)


def test_job_data_is_fixed_and_differs_by_job():
    a, b = datagen.job_data(CFG, 200, 0), datagen.job_data(CFG, 200, 1)
    np.testing.assert_array_equal(a, datagen.job_data(CFG, 200, 0))
    assert not np.array_equal(a, b)
    centers, _ = datagen.structure(16, rng=np.random.default_rng(3))
    for x in (a, b):  # every point lies in one of the base set's clusters
        near = np.sqrt(((x[:, None] - centers[None]) ** 2).sum(-1)).min(1)
        assert near.max() < 0.35 * np.sqrt(16) * 2


def test_query_stream_is_seeded_and_of_the_distribution():
    seq = datagen.sub_seed(2**40 + 7, "queries")
    s1 = datagen.QueryStream(CFG, 64, seq, "cpu")
    s2 = datagen.QueryStream(CFG, 64, datagen.sub_seed(2**40 + 7, "queries"),
                             "cpu")
    a = s1.next().copy()
    np.testing.assert_array_equal(a, s2.next())
    b = s1.next()
    assert a.shape == (64, 16) and not np.array_equal(a, b)
    centers, weights = datagen.structure(16, rng=np.random.default_rng(3))
    q = datagen.QueryStream(CFG, 1, seq, "cpu").take(4000)
    d = ((q[:, None] - centers[None]) ** 2).sum(-1)
    # each query is spread * N(0, 1) away from its centre
    assert np.sqrt(d.min(1)).mean() == pytest.approx(0.35 * 4, rel=0.05)
    share = np.bincount(d.argmin(1), minlength=24) / len(q)
    assert np.abs(share - weights).max() < 0.03


def test_sub_seeds_take_any_whole_number():
    big = 2**31 + 12345
    assert datagen.torch_seed(datagen.sub_seed(big, "x")) >= 0
    assert datagen.torch_seed(datagen.sub_seed(big, "x")) != \
        datagen.torch_seed(datagen.sub_seed(big, "y"))
    torch.Generator().manual_seed(datagen.torch_seed(datagen.sub_seed(-5)))
