"""The port's kernel surface (``repro_torch.kernels``) against the JAX
package, on the CPU: the plain versions of K1–K4 that the card holds its
CUDA kernels against.

* ``ops`` distance tiles, uint8 tiles, kNN and the exact re-rank against
  ``repro.kernels.ref`` / ``repro.kernels.ops`` (f32 to 1e-5, uint8 L2
  bit-exact, kNN ids equal).
* The plain beam against ``repro.kernels.beam.fused_beam(lowering="xla")``
  on the reference suite's scruffy fixture (dangling -1 edges, duplicate
  neighbours, scattered entries): ids equal, distances to the reference
  suite's own tolerance (``atol=2e-3, rtol=1e-4``), and the per-query
  ``n_dist``/``hops``/``n_rerank`` counters equal.
* ``QuantSpec`` codes and the bf16 storage view bit-equal.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import beam as kb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.search import jax_backend as jb
from repro.search.types import QuantSpec as JQuantSpec
from repro_torch.kernels import beam as tbeam
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.search.types import QuantSpec, _to_bf16

N, D, R, Q = 500, 24, 10, 17
K, WIDTH = 10, 32


@pytest.fixture(scope="module")
def fix():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((N, D)).astype(np.float32)
    graph = rng.integers(0, N, (N, R)).astype(np.int32)
    graph[rng.random((N, R)) < 0.15] = -1  # dangling edges
    entries = np.array([3, 77, 200, 466], np.int64)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    return data, graph, entries, queries


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pairwise_distance_matches_reference(fix, dtype, metric):
    data, _, _, queries = fix
    if dtype == "bf16":
        jq = jnp.asarray(queries, jnp.bfloat16)
        jx = jnp.asarray(data, jnp.bfloat16)
        tq, tx = _t(queries).bfloat16(), _t(data).bfloat16()
    else:
        jq, jx, tq, tx = jnp.asarray(queries), jnp.asarray(data), \
            _t(queries), _t(data)
    want = np.asarray(jref.pairwise_distance(jq, jx, metric))
    got = tops.pairwise_distance(tq, tx, metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jops.pairwise_distance(
        jq, jx, metric)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_distance_u8_matches_reference(fix, metric):
    data, _, _, queries = fix
    spec = JQuantSpec.from_data(data)
    cq, cx = spec.quantize(queries), spec.quantize(data)
    want = np.asarray(jops.pairwise_distance_u8(
        cq, cx, spec.scale, spec.zero_point, metric))
    got = tops.pairwise_distance_u8(_t(cq), _t(cx), spec.scale,
                                    spec.zero_point, metric).numpy()
    if metric == "l2":  # integer-exact code distances, one f32 scaling
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knn_matches_reference(fix, metric):
    data, _, _, queries = fix
    wd, wi = jops.knn(jnp.asarray(queries), jnp.asarray(data), 12, metric)
    gd, gi = tops.knn(_t(queries), _t(data), 12, metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5,
                               atol=1e-4)


def _split_knn(dist: torch.Tensor, k: int, splits: int, tile: int = 16,
               cap: int = 16):
    """K4's decomposition of a top-k over the rows of ``dist``: each of
    ``splits`` column spans walks its columns in tiles, admits d <= tau (the
    k-th listed distance, +inf until the list holds k) into a buffer of
    ``cap`` entries, and merges buffer and list when a tile would overflow
    it and at the end; then the span lists merge.  Every sort is of
    (distance, index) tuples, i.e. lexicographic."""
    inf = float("inf")
    n = dist.shape[1]
    span = -(-n // splits)
    out_d, out_i = [], []
    for row in dist.tolist():
        merged = []
        for lo in range(0, n, span):
            hi = min(n, lo + span)
            listed, buf, tau = [], [], inf
            for c0 in range(lo, hi, tile):
                pairs = [(row[c], c) for c in range(c0, min(hi, c0 + tile))]
                if len(buf) + sum(d <= tau for d, _ in pairs) > cap:
                    listed, buf = sorted(listed + buf)[:k], []
                    tau = listed[-1][0] if len(listed) == k else inf
                buf += [p for p in pairs if p[0] <= tau]
            merged += sorted(listed + buf)[:k]
        best = sorted(merged)[:k]
        best += [(inf, -1)] * (k - len(best))
        out_d.append([d for d, _ in best])
        out_i.append([i for _, i in best])
    return torch.tensor(out_d), torch.tensor(out_i)


@pytest.mark.parametrize("splits", [1, 3, 9])
@pytest.mark.parametrize("kind,metric", [("ties", "l2"), ("ties", "ip"),
                                         ("random", "l2")])
def test_split_knn_decomposition_matches_reference(kind, metric, splits):
    """K4's split-N, threshold-filtered decomposition keeps the reference's
    (distance, index) order exactly, ties included, whatever the split:
    the argument of ``csrc/knn.cu`` run in torch ops on the CPU."""
    rng = np.random.default_rng(11)
    if kind == "ties":  # integer coordinates, every point twice: exact f32
        x = rng.integers(0, 3, (200, 8)).astype(np.float32)
        x = np.concatenate([x, x])
    else:
        x = rng.standard_normal((400, 8)).astype(np.float32)
    q = x[::37].copy()
    k = 60  # more than a span holds when splits = 9
    wd, wi = jops.knn(jnp.asarray(q), jnp.asarray(x), k, metric)
    gd, gi = _split_knn(tref.pairwise_distance(_t(q), _t(x), metric), k,
                        splits)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5,
                               atol=1e-4)


def test_knn_pads_short_rows():
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    d, i = tops.knn(x[:1], x, 5)
    assert i[0, :3].tolist() == [0, 1, 2]
    assert i[0, 3:].tolist() == [-1, -1]
    assert torch.isinf(d[0, 3:]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rerank_exact_matches_reference(fix, metric):
    data, _, _, queries = fix
    rng = np.random.default_rng(3)
    cand = rng.integers(-1, N, (Q, 20))
    wi, wd, wn = jops.rerank_exact(data, cand, queries, K, metric)
    gi, gd, gn = tops.rerank_exact(data, cand, queries, K, metric)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    assert gn == wn


def test_quant_codes_and_bf16_bit_equal(fix):
    data, _, _, queries = fix
    spec, jspec = QuantSpec.from_data(data), JQuantSpec.from_data(data)
    assert (spec.scale, spec.zero_point) == (jspec.scale, jspec.zero_point)
    np.testing.assert_array_equal(spec.quantize(queries),
                                  jspec.quantize(queries))
    np.testing.assert_array_equal(spec.dequantize(spec.quantize(data)),
                                  jspec.dequantize(jspec.quantize(data)))
    bf = _to_bf16(data * 3.7)
    want = np.asarray(data * 3.7, dtype=ml_dtypes.bfloat16)
    np.testing.assert_array_equal(bf.view(torch.int16).numpy(),
                                  want.view(np.int16))


def _stages(data, queries, qname):
    """(reference x, q, scale, zp) and (port x, q, scale, zp)."""
    if qname == "u8":
        spec = JQuantSpec.from_data(data)
        cx, cq = spec.quantize(data), spec.quantize(queries)
        s, z = np.float32(spec.scale), np.float32(spec.zero_point)
        return ((cx, cq, s, z), (_t(cx), _t(cq), float(s), float(z)))
    if qname == "bf16":
        return ((jnp.asarray(data, jnp.bfloat16),
                 jnp.asarray(queries, jnp.bfloat16), 0.0, 0.0),
                (_t(data).bfloat16(), _t(queries).bfloat16(), 0.0, 0.0))
    return ((data, queries, 0.0, 0.0), (_t(data), _t(queries), 0.0, 0.0))


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qname", ["f32", "bf16", "u8"])
def test_plain_beam_matches_xla_lowering(fix, qname, metric, rerank):
    data, graph, entries, queries = fix
    (jx, jq, js, jz), (tx, tq, ts, tz) = _stages(data, queries, qname)
    e = jb._prep_entries(entries, WIDTH)
    kq = min(4 * K, WIDTH) if rerank else K
    extra = dict(x_exact=data, q_exact=queries, rerank_k=K) if rerank else {}
    want = kb.fused_beam(jx, graph, e, jq, kq, width=WIDTH, metric=metric,
                         scale=js, zp=jz, lowering="xla", **extra)
    textra = dict(x_exact=_t(data), q_exact=_t(queries),
                  rerank_k=K) if rerank else {}
    got = tbeam.fused_beam(tx, _t(graph), _t(e), tq, kq, width=WIDTH,
                           metric=metric, scale=ts, zp=tz, **textra)
    wids, wds, wnd, whops, wnrr = (np.asarray(a) for a in want)
    gids, gds, gnd, ghops, gnrr = (a.numpy() for a in got)
    np.testing.assert_array_equal(gids, wids)
    np.testing.assert_allclose(np.where(np.isfinite(gds), gds, 0.0),
                               np.where(np.isfinite(wds), wds, 0.0),
                               atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(gnd, wnd)
    np.testing.assert_array_equal(ghops, whops)
    np.testing.assert_array_equal(gnrr, wnrr)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor must reach the kernel wrapper, whose checks raise here
    (no card); the plain version is only for CPU tensors."""
    calls = []
    monkeypatch.setattr(tops._distance, "pairwise_distance_cuda",
                        lambda *a, **k: calls.append("kernel"))
    fake = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError):
        tops.pairwise_distance(fake, torch.empty(3, 4))
    monkeypatch.setattr(tops, "_on_cuda", lambda a, b: True)
    tops.pairwise_distance(fake, fake)
    assert calls == ["kernel"]
