"""K1/K2's kernel choice and K3's re-rank summation order, on the CPU.

* ``distance_plan`` picks the skinny kernel (16-byte or element loads) or
  the tiled one: literal plans at the shapes callers send and at the
  edges of the rules, and properties across N, D, dtype and alignment.
* The plain K1/K2 agree with the JAX reference, its Pallas kernels run in
  interpret mode, at the skinny shapes (N = 16, ragged M, D = 100 and 128):
  f32/bf16 to the port suite's tolerance, uint8 L2 exactly.
* K3's exact re-rank (``beam._rerank``) sums each distance in the kernel's
  order (lane sums over ``i, i+32, ...``, then an xor butterfly), equal bit
  for bit to a numpy emulation of that order, and within 1e-6 of a float64
  sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.search.types import QuantSpec as JQuantSpec
from repro_torch.kernels import beam as tbeam
from repro_torch.kernels import ops as tops
from repro_torch.kernels.distance import distance_plan

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}


# (M, N, D, dtype, both operands 16-byte aligned) -> (kernel, vec)
LITERAL_PLANS = [
    # the main path: partition blocks, k-means, routing, a tail
    ((8192, 16, 128, "f32", True), ("skinny", 4)),
    ((65536, 16, 128, "f32", True), ("skinny", 4)),
    ((10000, 16, 128, "f32", True), ("skinny", 4)),
    ((94, 16, 128, "f32", True), ("skinny", 4)),
    ((10000, 16, 128, "u8", True), ("skinny", 16)),
    ((10000, 16, 128, "bf16", True), ("skinny", 8)),
    ((1000, 1, 128, "f32", True), ("skinny", 4)),
    # D = 100: 400 bytes of f32 are whole chunks, 200 of bf16 and 100 of
    # uint8 are not
    ((1000, 16, 100, "f32", True), ("skinny", 4)),
    ((1000, 16, 100, "bf16", True), ("skinny", 1)),
    ((1000, 16, 100, "u8", True), ("skinny", 1)),
    # a view at element offset 1
    ((513, 16, 128, "f32", False), ("skinny", 1)),
    ((513, 16, 128, "u8", False), ("skinny", 1)),
    # more than 16 centroids
    ((1000, 17, 128, "f32", True), ("tiled", 1)),
    ((1000, 64, 128, "bf16", True), ("tiled", 1)),
    ((1000, 65, 128, "u8", True), ("tiled", 1)),
    ((4096, 65536, 128, "f32", True), ("tiled", 1)),
    # the 48 KB budget: 16 f32 rows of 704 fit, of 960 do not (bf16 is
    # kept as f32); 960 uint8 codes do
    ((100, 16, 704, "f32", True), ("skinny", 4)),
    ((100, 16, 960, "f32", True), ("tiled", 1)),
    ((100, 16, 960, "bf16", True), ("tiled", 1)),
    ((100, 16, 960, "u8", True), ("skinny", 16)),
    # past the tiled kernel's grid, which the skinny kernel walks
    ((5_000_000, 16, 128, "f32", True), ("skinny", 4)),
]


@pytest.mark.parametrize("args,want", LITERAL_PLANS,
                         ids=[f"{m}x{n}x{d}-{dt}-{'al' if al else 'mis'}"
                              for (m, n, d, dt, al), _ in LITERAL_PLANS])
def test_distance_plan_literal(args, want):
    m, n, d, dt, aligned = args
    assert tuple(distance_plan(m, n, d, DTYPES[dt], aligned)) == want


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16", "u8"])
@pytest.mark.parametrize("d", [100, 128])
@pytest.mark.parametrize("n", [1, 16, 17, 64, 65, 4096])
def test_distance_plan_picks_kernel(n, d, dt, aligned):
    dtype = DTYPES[dt]
    plan = distance_plan(8192, n, d, dtype, aligned)
    assert plan.kernel == ("skinny" if n <= 16 else "tiled")
    if plan.kernel == "skinny":
        # 16-byte loads only for aligned rows of whole 16-byte chunks,
        # and then a load carries 16 bytes of elements
        whole = d * dtype.itemsize % 16 == 0
        assert (plan.vec > 1) == (aligned and whole)
        assert plan.vec in (1, 16 // dtype.itemsize)
    else:
        assert plan.vec == 1


def test_distance_plan_limits():
    # the tiled kernel's grid takes 65535 tiles of 64 rows; skinny any M
    with pytest.raises(ValueError):
        distance_plan(65535 * 64 + 1, 17, 128, torch.float32, True)
    assert distance_plan(65535 * 64, 17, 128, torch.float32,
                         True).kernel == "tiled"


@pytest.fixture
def interpret():
    jops.set_pallas_mode("force_interpret")
    yield
    jops.set_pallas_mode("auto")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,d", [(1, 128), (37, 100), (300, 128)])
def test_plain_k1_matches_reference_at_skinny_shapes(interpret, m, d, dt,
                                                     metric):
    rng = np.random.default_rng(m + d)
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((16, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    jq, jx = jnp.asarray(q, jdt), jnp.asarray(x, jdt)
    got = tops.pairwise_distance(_t(q).to(DTYPES[dt]), _t(x).to(DTYPES[dt]),
                                 metric).numpy()
    assert got.shape == (m, 16)
    for want in (jref.pairwise_distance(jq, jx, metric),
                 jops.pairwise_distance(jq, jx, metric)):  # Pallas, interpret
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("m,d", [(1, 128), (37, 100), (300, 128)])
def test_plain_k2_matches_reference_at_skinny_shapes(interpret, m, d, metric):
    rng = np.random.default_rng(m + d + 1)
    data = rng.standard_normal((400, d)).astype(np.float32)
    spec = JQuantSpec.from_data(data)
    cq, cx = spec.quantize(data[:m]), spec.quantize(data[-16:])
    got = tops.pairwise_distance_u8(_t(cq), _t(cx), spec.scale,
                                    spec.zero_point, metric).numpy()
    want = np.asarray(jops.pairwise_distance_u8(
        cq, cx, spec.scale, spec.zero_point, metric))  # Pallas, interpret
    plain = np.asarray(jref.pairwise_distance_u8(
        jnp.asarray(cq), jnp.asarray(cx), spec.scale, spec.zero_point, metric))
    if metric == "l2":  # integer-exact code distances, one f32 scaling
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
        return
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-4)
    # the Pallas kernel adds the affine terms in XLA's order: a few f32
    # roundings, each within half an ulp of the largest term
    s, z = np.float64(spec.scale), np.float64(spec.zero_point)
    cq64, cx64 = cq.astype(np.float64), cx.astype(np.float64)
    terms = (np.abs(s * s * (cq64 @ cx64.T))
             + np.abs(s * z * (cq64.sum(1)[:, None] + cx64.sum(1)[None, :]))
             + abs(d * z * z))
    assert (np.abs(got - want) <= 4 * np.finfo(np.float32).eps * terms).all()


def _lane_sum_numpy(terms):
    """K3's order, one scalar f32 operation at a time."""
    out = np.empty(terms.shape[:-1], np.float32)
    for idx in np.ndindex(*terms.shape[:-1]):
        t = terms[idx]
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            for i in range(lane, t.shape[0], 32):
                lanes[lane] = np.float32(lanes[lane] + t[i])
        for off in (16, 8, 4, 2, 1):
            lanes = np.array([np.float32(lanes[l] + lanes[l ^ off])
                              for l in range(32)], np.float32)
        assert (lanes == lanes[0]).all()  # every lane ends with the sum
        out[idx] = lanes[0]
    return out


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dx", [1, 31, 32, 100, 128, 960])
def test_rerank_sums_in_kernel_order(dx, metric):
    rng = np.random.default_rng(dx)
    nq, k, n = 3, 5, 50
    x = (rng.standard_normal((n, dx)) * 3).astype(np.float32)
    q = (rng.standard_normal((nq, dx)) * 3).astype(np.float32)
    ids = rng.integers(-1, n, (nq, k)).astype(np.int32)
    ids[:, 0] = rng.integers(0, n, nq)  # every query has a valid candidate
    r_ids, r_d, n_rr = tbeam._rerank(_t(ids), _t(x), _t(q), k, metric)
    rows = x[np.maximum(ids, 0)]  # [Q, k, Dx]
    if metric == "l2":
        diff = rows - q[:, None, :]
        terms = diff * diff  # f32 subtract, then f32 multiply
        exact = ((rows.astype(np.float64) - q[:, None, :]) ** 2)
    else:
        terms = rows * q[:, None, :]
        exact = rows.astype(np.float64) * q[:, None, :]
    want = _lane_sum_numpy(terms)
    if metric == "ip":
        want = -want
    valid = ids >= 0
    assert (n_rr.numpy() == valid.sum(1)).all()
    r_ids, r_d = r_ids.numpy(), r_d.numpy()
    for qi in range(nq):
        for pos in range(k):
            cid = r_ids[qi, pos]
            if cid < 0:
                assert np.isinf(r_d[qi, pos])
                continue
            col = int(np.flatnonzero(ids[qi] == cid)[0])
            # bit for bit the emulated order
            assert r_d[qi, pos].view(np.int32) == \
                want[qi, col].view(np.int32)
            ref = exact[qi, col].sum() * (1 if metric == "l2" else -1)
            assert abs(float(r_d[qi, pos]) - ref) <= \
                1e-6 * np.abs(exact[qi, col]).sum()
    # sorted by (distance, id)
    for qi in range(nq):
        keys = [(d, i) for d, i in zip(r_d[qi], r_ids[qi]) if i >= 0]
        assert keys == sorted(keys)
