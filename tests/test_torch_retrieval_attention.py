"""The port's ANN-retrieval attention against the JAX package's, on the CPU.

The reference's four cases (``tests/test_retrieval_attention.py``) run on
both packages over the same KV cache:

* over indexes the reference built (carried into the port by
  ``GlobalIndex.from_arrays``), exact selection gives equal outputs, and
  each port backend gives its reference backend's ids and distance counts
  (``numpy``/``numpy``, ``torch``/``jax``, ``fused``/``jax``) with outputs
  equal to f32 tolerance;
* over indexes the port built itself (``build_key_indexes(device="cpu")``),
  the reference's properties hold: exact when every key is selected, the
  error shrinking with top_t, the graph search as good a selector as exact
  top-k at a fraction of dense attention's distance computations, and a
  cost that grows with the search budget, not the cache.
"""

import numpy as np
import pytest
import torch

from repro.serve import retrieval_attention as jra
from repro_torch.core.merge import GlobalIndex
from repro_torch.serve import (KeyIndex, build_key_indexes,
                               full_decode_attention_ref,
                               retrieval_decode_attention)

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the cores, and torch's default of a thread a core oversubscribes
    them (bf16 steps here ran ~10x slower under the whole suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache():
    rng = np.random.default_rng(7)  # the reference test's cache
    b, hkv, t, dh = 1, 2, 1024, 32
    hot = rng.normal(size=(8, dh)).astype(np.float32)
    hot /= np.linalg.norm(hot, axis=1, keepdims=True)
    k = 0.3 * rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
    hot_ids = rng.choice(t, 64, replace=False)
    k[:, :, hot_ids] += 3.0 * hot[rng.integers(0, 8, 64)]
    v = rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
    q = (2.0 * dh ** 0.5 * hot[:2].reshape(1, 2, dh)
         + 0.1 * rng.normal(size=(1, 2, dh))).astype(np.float32)
    return q, k, v


@pytest.fixture(scope="module")
def ref_indexes(cache):
    _, k, v = cache
    return jra.build_key_indexes(k, v)


@pytest.fixture(scope="module")
def shared(ref_indexes):
    """The reference's indexes as the port's KeyIndexes."""
    return [[KeyIndex(keys=ki.keys, values=ki.values,
                      index=GlobalIndex.from_arrays(
                          np.asarray(ki.index.graph), ki.index.medoid,
                          ki.index.n_vectors))
             for ki in row] for row in ref_indexes]


@pytest.fixture(scope="module")
def indexes(cache):
    _, k, v = cache
    return build_key_indexes(k, v, **CPU)


def test_dense_reference_matches(cache):
    q, k, v = cache
    np.testing.assert_allclose(full_decode_attention_ref(q, k, v),
                               jra.full_decode_attention_ref(q, k, v),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_t", [32, 128, 1024])
def test_exact_selection_matches_reference(cache, ref_indexes, shared,
                                           top_t):
    q = cache[0]
    want, ws = jra.retrieval_decode_attention(q, ref_indexes, top_t=top_t,
                                              window=8, exact_search=True)
    got, gs = retrieval_decode_attention(q, shared, top_t=top_t, window=8,
                                         exact_search=True, **CPU)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert gs == ws


@pytest.mark.parametrize("ours,theirs", [("numpy", "numpy"),
                                         ("torch", "jax"),
                                         ("fused", "jax")])
def test_backends_match_reference(cache, ref_indexes, shared, ours, theirs):
    q = cache[0]
    kw = dict(top_t=64, window=16, width=96)
    want, ws = jra.retrieval_decode_attention(q, ref_indexes, backend=theirs,
                                              **kw)
    got, gs = retrieval_decode_attention(q, shared, backend=ours, **kw, **CPU)
    assert gs == ws
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the retrieved ids themselves, head by head
    from repro.search import search as jsearch
    from repro_torch.search import search
    for hi, (jk, pk) in enumerate(zip(ref_indexes[0], shared[0])):
        qv = q[0, hi][None]
        a, sa = jsearch(jk.topology(), qv, 64, backend=theirs, width=96,
                        n_entries=8)
        b, sb = search(pk.topology(), qv, 64, backend=ours, width=96,
                       n_entries=8, **CPU)
        np.testing.assert_array_equal(b, a)
        assert sb.n_distance_computations == sa.n_distance_computations


def test_selection_math_exact_when_all_keys_selected(cache, indexes):
    q, k, v = cache
    out, _ = retrieval_decode_attention(q, indexes, top_t=k.shape[2],
                                        window=8, exact_search=True, **CPU)
    ref = full_decode_attention_ref(q, k, v)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_error_shrinks_with_top_t(cache, indexes):
    q, k, v = cache
    ref = full_decode_attention_ref(q, k, v)
    errs = []
    for tt in (32, 128, 512):
        out, _ = retrieval_decode_attention(q, indexes, top_t=tt, window=16,
                                            exact_search=True, **CPU)
        errs.append(np.abs(out - ref).max() / np.abs(ref).max())
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 0.12, f"errs {errs}"


@pytest.mark.parametrize("backend", ["numpy", "torch", "fused"])
def test_graph_retrieval_matches_exact_selection(cache, indexes, backend):
    q, k, v = cache
    ref = full_decode_attention_ref(q, k, v)
    out_g, stats = retrieval_decode_attention(q, indexes, top_t=64,
                                              window=16, width=96,
                                              backend=backend, **CPU)
    out_e, _ = retrieval_decode_attention(q, indexes, top_t=64, window=16,
                                          exact_search=True, **CPU)
    rel_g = np.abs(out_g - ref).max() / np.abs(ref).max()
    rel_e = np.abs(out_e - ref).max() / np.abs(ref).max()
    assert rel_g <= rel_e + 0.05, f"graph {rel_g} vs exact {rel_e}"
    dense = q.shape[0] * q.shape[1] * k.shape[2]
    assert stats["n_distance_computations"] < 0.75 * dense


def test_retrieval_cost_scales_with_width_not_cache():
    rng = np.random.default_rng(3)
    b, hkv, dh = 1, 1, 16
    q = rng.normal(size=(b, hkv, dh)).astype(np.float32)
    counts = {}
    for t in (512, 2048):
        k = rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
        v = rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
        idx = build_key_indexes(k, v, **CPU)
        _, stats = retrieval_decode_attention(q, idx, top_t=16, window=8,
                                              width=32, backend="numpy",
                                              **CPU)
        counts[t] = stats["n_distance_computations"]
    assert counts[2048] < 4 * counts[512]


def test_entry_points_need_the_card_unless_asked(cache, shared):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    q, k, v = cache
    with pytest.raises(RuntimeError, match="CUDA"):
        build_key_indexes(k[:, :1, :256], v[:, :1, :256])
    with pytest.raises(RuntimeError, match="CUDA"):
        retrieval_decode_attention(q, shared)
