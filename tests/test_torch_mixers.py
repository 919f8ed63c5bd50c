"""The port's sequence mixers and new layers (``repro_torch.models.moe``,
``ssm``, ``rwkv6``, ``attention``, ``layers``) against the JAX package's,
on the CPU, with the same numpy-seeded inputs and parameters, in f32.

Tolerances: ``1e-5`` (rtol and atol) for the mixer units — the same f32
operations, rounded in another order by the two frameworks' kernels — and
``1e-4`` for the scans (Mamba's chunked scan, WKV6), whose states sum
hundreds of terms; the attention paths go through K5/K6's plain versions,
which compute in f32 like the reference's ``flash_attention_jnp`` and
``decode_attention``.  The reference runs compiled (``jax.jit``).  A bf16
case holds Mamba's mixer to the reference compiled with XLA's excess
precision off (both round to bf16 after each operation): every output
within one bf16 rounding, 99% of them bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.params import init_params as jinit_params
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv
from repro.models import ssm as jssm
from repro_torch.models import attention, layers, moe, rwkv6, ssm
from repro_torch.models.model import _rope

MIXER = dict(rtol=1e-5, atol=1e-5)
SCAN = dict(rtol=1e-4, atol=1e-4)
J = jax.jit


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _params(spec, seed, rng=None, fill=()):
    """The reference's init of ``spec`` as numpy; leaves named in ``fill``
    (zero-initialised in the reference) get seeded values instead, so the
    paths they gate are exercised."""
    p = jax.tree.map(np.asarray, jinit_params(spec, jax.random.PRNGKey(seed)))
    for name in fill:
        p[name] = _rand(rng, p[name].shape, 0.1)
    return p


def _both(tree):
    """numpy tree → (jax tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x, scale, bias = _rand(rng, (2, 9, 64), 3.0), _rand(rng, (64,)), \
        _rand(rng, (64,))
    _close(layers.layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5),
           jlayers.layer_norm(*map(jnp.asarray, (x, scale, bias)), 1e-5),
           MIXER)


def test_gelu_mlp_matches_reference():
    """The tanh approximation, as ``jax.nn.gelu``'s default: the exact erf
    GELU differs by up to ~1e-3 at these inputs, far beyond 1e-5."""
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 9, 64), 2.0)
    p = {"w_in": _rand(rng, (64, 96), 0.3), "b_in": _rand(rng, (96,)),
         "w_out": _rand(rng, (96, 64), 0.1), "b_out": _rand(rng, (64,))}
    jp, tp = _both(p)
    want = J(jlayers.gelu_mlp)(jnp.asarray(x), jp)
    _close(layers.gelu_mlp(torch.from_numpy(x), tp), want, MIXER)
    h = torch.from_numpy(x) @ tp["w_in"] + tp["b_in"]
    erf = torch.nn.functional.gelu(h) @ tp["w_out"] + tp["b_out"]
    assert float((erf - torch.from_numpy(np.asarray(want))).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# Attention: whisper's biases, no RoPE, cross-attention
# ---------------------------------------------------------------------------


def _attn_dims(bias: bool, theta: float):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              rope_theta=theta, bias=bias)
    return jattn.AttnDims(**kw), attention.AttnDims(**kw)


def _attn_params(jdims, rng):
    p = _params(jattn.attn_p(jdims), 2)
    for name in ("bq", "bv", "bo"):  # zero-initialised; exercise them
        if name in p:
            p[name] = _rand(rng, p[name].shape, 0.5)
    return p


@pytest.mark.parametrize("bias,theta", [(True, 0.0), (False, 0.0),
                                        (True, 1e4)])
@pytest.mark.parametrize("causal", [True, False])
def test_attn_forward_and_prefill_match_reference(bias, theta, causal):
    rng = np.random.default_rng(3)
    jdims, tdims = _attn_dims(bias, theta)
    jp, tp = _both(_attn_params(jdims, rng))
    x = _rand(rng, (2, 24, 64))
    rope = _rope(tdims, torch.arange(24))
    assert (rope is None) == (theta == 0)
    want = J(jattn.attn_forward, static_argnums=2,
              static_argnames="causal")(jnp.asarray(x), jp, jdims,
                                         causal=causal)
    got = attention.attn_forward(torch.from_numpy(x), tp, tdims, rope,
                                 causal=causal)
    _close(got, want, MIXER)
    want, jkv = J(jattn.attn_prefill, static_argnums=2,
                  static_argnames="causal")(jnp.asarray(x), jp, jdims,
                                             causal=causal)
    got, kv = attention.attn_prefill(torch.from_numpy(x), tp, tdims, rope,
                                     causal=causal)
    _close(got, want, MIXER)
    for name in ("k", "v"):
        _close(kv[name], jkv[name], MIXER)


@pytest.mark.parametrize("bias", [True, False])
def test_attn_decode_with_bias_and_no_rope_matches_reference(bias):
    rng = np.random.default_rng(4)
    jdims, tdims = _attn_dims(bias, 0.0)
    jp, tp = _both(_attn_params(jdims, rng))
    cache = {n: _rand(rng, (2, 2, 20, 16)) for n in ("k", "v")}
    x = _rand(rng, (2, 64))
    pos = 13
    want, jc = J(jattn.attn_decode, static_argnums=4)(
        jnp.asarray(x), jp, jax.tree.map(jnp.asarray, cache), jnp.int32(pos),
        jdims)
    tc = jax.tree.map(torch.from_numpy, cache)
    got, tc = attention.attn_decode(
        torch.from_numpy(x), tp, tc, pos, tdims, None,
        torch.full((2,), pos + 1, dtype=torch.int32))
    _close(got, want, MIXER)
    for name in ("k", "v"):
        _close(tc[name], jc[name], MIXER)


@pytest.mark.parametrize("bias", [True, False])
def test_cross_attention_matches_reference(bias):
    """cross_attn_kv, cross_attn_forward (S != F, non-causal) and
    cross_attn_decode (every frame valid)."""
    rng = np.random.default_rng(5)
    jdims, tdims = _attn_dims(bias, 0.0)
    jp, tp = _both(_attn_params(jdims, rng))
    memory = _rand(rng, (2, 30, 64))
    jkv = J(jattn.cross_attn_kv, static_argnums=2)(jnp.asarray(memory), jp,
                                                    jdims)
    kv = attention.cross_attn_kv(torch.from_numpy(memory), tp, tdims)
    for name in ("k", "v"):
        assert kv[name].is_contiguous()
        _close(kv[name], jkv[name], MIXER)
    x = _rand(rng, (2, 11, 64))
    _close(attention.cross_attn_forward(torch.from_numpy(x), tp, kv, tdims),
           J(jattn.cross_attn_forward, static_argnums=3)(
               jnp.asarray(x), jp, jkv, jdims), MIXER)
    x1 = _rand(rng, (2, 64))
    _close(attention.cross_attn_decode(torch.from_numpy(x1), tp, kv, tdims,
                                       torch.full((2,), 30)),
           J(jattn.cross_attn_decode, static_argnums=3)(
               jnp.asarray(x1), jp, jkv, jdims), MIXER)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor,shared,groups", [
    (1.25, 0, 1),   # the default capacity
    (0.5, 0, 1),    # overflow: choices past capacity are dropped
    (1.25, 1, 1),   # a shared expert beside the routed ones
    (0.75, 2, 4),   # dispatch groups, each with its capacity, + shared
    (1.25, 0, 5),   # groups that do not divide the tokens: one group
])
def test_moe_forward_matches_reference(capacity_factor, shared, groups):
    rng = np.random.default_rng(6)
    kw = dict(d_model=64, d_ff=32, n_experts=6, top_k=2,
              capacity_factor=capacity_factor, n_shared_experts=shared,
              n_dispatch_groups=groups)
    jdims, tdims = jmoe.MoEDims(**kw), moe.MoEDims(**kw)
    p = _params(jmoe.moe_p(jdims), 7)
    p["router"] = _rand(rng, p["router"].shape, 0.5)
    jp, tp = _both(p)
    x = _rand(rng, (2, 24, 64))
    want, jaux = J(jmoe.moe_forward, static_argnums=2)(jnp.asarray(x), jp,
                                                       jdims)
    got, aux = moe.moe_forward(torch.from_numpy(x), tp, tdims)
    _close(got, want, MIXER)
    assert set(aux) == set(jaux)
    for name in aux:
        _close(aux[name], jaux[name], MIXER)
    if capacity_factor < 1:
        assert float(aux["dropped_fraction"]) > 0
    assert moe.capacity(48 // (groups if 48 % groups == 0 else 1), tdims) \
        == jmoe.capacity(48 // (groups if 48 % groups == 0 else 1), jdims)


def test_moe_single_token_rows():
    """Decode's shape: [B, 1, D], capacity top_k (every choice kept)."""
    rng = np.random.default_rng(8)
    kw = dict(d_model=64, d_ff=32, n_experts=8, top_k=2, capacity_factor=1.25)
    jdims, tdims = jmoe.MoEDims(**kw), moe.MoEDims(**kw)
    jp, tp = _both(_params(jmoe.moe_p(jdims), 9))
    x = _rand(rng, (3, 1, 64))
    want, jaux = J(jmoe.moe_forward, static_argnums=2)(jnp.asarray(x), jp,
                                                       jdims)
    got, aux = moe.moe_forward(torch.from_numpy(x), tp, tdims)
    _close(got, want, MIXER)
    _close(aux["dropped_fraction"], jaux["dropped_fraction"], MIXER)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

SSM_KW = dict(d_model=32, d_state=8, d_conv=4, expand=2, dt_rank=0, chunk=8)


def _ssm(seed=10):
    jdims, tdims = jssm.SSMDims(**SSM_KW), ssm.SSMDims(**SSM_KW)
    return jdims, tdims, _params(jssm.ssm_p(jdims), seed)


def test_ssm_init_rules():
    """a_log = log(1..d_state) on every row, b_dt = softplus⁻¹ of a step
    in [1e-3, 0.1], d_skip ones: the reference's callable inits."""
    jdims, tdims, p = _ssm()
    spec = ssm.ssm_p(tdims)
    gen = torch.Generator().manual_seed(0)
    a_log = spec["a_log"].init(gen, (3, 64, 8), torch.float32, "cpu")
    np.testing.assert_allclose(a_log.numpy(),
                               np.broadcast_to(p["a_log"][0], (3, 64, 8)))
    b_dt = spec["b_dt"].init(gen, (4096,), torch.float32, "cpu")
    dt = torch.nn.functional.softplus(b_dt)
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    assert spec["a_log"].dtype == spec["d_skip"].dtype == torch.float32


@pytest.mark.parametrize("t", [8, 24])
def test_ssm_scan_chunked_matches_reference(t):
    rng = np.random.default_rng(11)
    u, dt = _rand(rng, (2, t, 16)), np.abs(_rand(rng, (2, t, 16), 0.1))
    bm, cm = _rand(rng, (2, t, 4)), _rand(rng, (2, t, 4))
    a_log = np.log(np.tile(np.arange(1, 5, dtype=np.float32), (16, 1)))
    h0 = _rand(rng, (2, 16, 4))
    args = (u, dt, bm, cm, a_log)
    want, jh = J(jssm._ssm_scan_chunked, static_argnums=5)(
        *map(jnp.asarray, args), 8, h0=jnp.asarray(h0))
    got, h = ssm._ssm_scan_chunked(*map(torch.from_numpy, args), 8,
                                   h0=torch.from_numpy(h0))
    _close(got, want, SCAN)
    _close(h, jh, SCAN)


def test_ssm_scan_rejects_ragged_lengths():
    """T must be a multiple of the chunk (or at most one), as in the
    reference."""
    for mod, arr in ((jssm, jnp.zeros), (ssm, torch.zeros)):
        z = arr((1, 12, 4))
        with pytest.raises(ValueError, match="must divide chunk"):
            mod._ssm_scan_chunked(z, z, z, z, arr((4, 4)), 8)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_the_reference_order(n):
    """Bit for bit against ``jax.lax.associative_scan`` at even and odd
    lengths."""
    rng = np.random.default_rng(12)
    a, b = np.exp(-np.abs(_rand(rng, (2, n, 3, 4)))), _rand(rng, (2, n, 3, 4))
    want = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = ssm._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ssm_forward_and_decode_match_reference():
    rng = np.random.default_rng(13)
    jdims, tdims, p = _ssm()
    jp, tp = _both(p)
    x = _rand(rng, (2, 16, 32))
    _close(ssm.ssm_forward(torch.from_numpy(x), tp, tdims),
           J(jssm.ssm_forward, static_argnums=2)(jnp.asarray(x), jp, jdims),
           SCAN)
    # decode three tokens from a random cache
    cache = {"conv": _rand(rng, (2, 3, 64)), "h": _rand(rng, (2, 64, 8))}
    jc = jax.tree.map(jnp.asarray, cache)
    tc = jax.tree.map(torch.from_numpy, cache)
    for _ in range(3):
        x1 = _rand(rng, (2, 32))
        want, jc = J(jssm.ssm_decode, static_argnums=3)(jnp.asarray(x1),
                                                        jp, jc, jdims)
        got, tc = ssm.ssm_decode(torch.from_numpy(x1), tp, tc, tdims)
        _close(got, want, MIXER)
        _close(tc["conv"], jc["conv"], MIXER)
        _close(tc["h"], jc["h"], MIXER)


def test_ssm_prefill_state_continues_in_decode():
    """The prefill cache (last d_conv - 1 inputs, final state) decodes the
    next token exactly as the full sequence computes it."""
    rng = np.random.default_rng(14)
    jdims, tdims, p = _ssm()
    tp = jax.tree.map(torch.from_numpy, p)
    x = torch.from_numpy(_rand(rng, (2, 17, 32)))
    dims1 = dataclasses.replace(tdims, chunk=17)
    full = ssm.ssm_forward(x, tp, dims1)
    _, cache = ssm.ssm_prefill(x[:, :16], tp, tdims)
    nxt, _ = ssm.ssm_decode(x[:, 16], tp, cache, tdims)
    _close(nxt, full[:, 16], SCAN)


def test_ssm_bf16_matches_reference_rounding_each_op():
    """bf16: every operation rounds to bf16 in both packages, so the mixer
    agrees to one bf16 rounding (f32 sums before a rounding run in another
    order), 99% of it bit for bit."""
    rng = np.random.default_rng(15)
    jdims, tdims, p = _ssm()
    kept = ("a_log", "d_skip")
    jp = {k: jnp.asarray(v) if k in kept else
          jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) if k in kept else
          torch.from_numpy(v).bfloat16() for k, v in p.items()}
    x = _rand(rng, (2, 16, 32))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = J(jssm.ssm_forward, static_argnums=2).lower(xj, jp, jdims) \
        .compile(compiler_options={"xla_allow_excess_precision": False})(
            xj, jp)
    got, want = _np(ssm.ssm_forward(torch.from_numpy(x).bfloat16(), tp,
                                    tdims)), _np(want)
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=0)  # 1 ulp
    assert np.mean(got == want) >= 0.99


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

RWKV_KW = dict(d_model=32, n_heads=2, head_dim=16, chunk=8, lora_rank=32,
               decay_lora_rank=32)


def _rwkv(rng, seed=16):
    jdims, tdims = jrwkv.RWKVDims(**RWKV_KW), rwkv6.RWKVDims(**RWKV_KW)
    p = _params(jrwkv.time_mix_p(jdims), seed, rng,
                fill=("lora_b", "w_lora_b"))
    return jdims, tdims, p


@pytest.mark.parametrize("chunk,t", [(4, 32), (8, 32), (32, 32), (8, 30),
                                     (64, 23)])
def test_wkv6_matches_reference(chunk, t):
    """Chunks of 4, 8 and 32, and ragged T (the chunk falls to the largest
    divisor of T no larger than it: 6 for 30, 1 for the prime 23)."""
    rng = np.random.default_rng(17)
    r, k, v = (_rand(rng, (2, 2, t, 8)) for _ in range(3))
    logw = -np.exp(_rand(rng, (2, 2, t, 8), 0.5))
    u, s0 = _rand(rng, (2, 8)), _rand(rng, (2, 2, 8, 8))
    args = (r, k, v, logw, u)
    want, js = J(jrwkv.wkv6, static_argnames="chunk")(
        *map(jnp.asarray, args), chunk=chunk, s0=jnp.asarray(s0))
    got, s = rwkv6.wkv6(*map(torch.from_numpy, args), chunk=chunk,
                        s0=torch.from_numpy(s0))
    _close(got, want, SCAN)
    _close(s, js, SCAN)


def test_time_mix_forward_and_decode_match_reference():
    rng = np.random.default_rng(18)
    jdims, tdims, p = _rwkv(rng)
    jp, tp = _both(p)
    x, prev = _rand(rng, (2, 12, 32)), _rand(rng, (2, 32))
    s0 = _rand(rng, (2, 2, 16, 16), 0.1)
    want, jlast, js = J(jrwkv.time_mix_forward, static_argnums=2,
                        static_argnames="return_state")(
        jnp.asarray(x), jp, jdims, prev_x=jnp.asarray(prev),
        s0=jnp.asarray(s0), return_state=True)
    got, last, s = rwkv6.time_mix_forward(
        torch.from_numpy(x), tp, tdims, prev_x=torch.from_numpy(prev),
        s0=torch.from_numpy(s0), return_state=True)
    _close(got, want, SCAN)
    _close(last, jlast, MIXER)
    _close(s, js, SCAN)
    jc = {"tm_x": jlast, "s": js}
    tc = {"tm_x": last, "s": s}
    for _ in range(3):
        x1 = _rand(rng, (2, 32))
        want, jc = J(jrwkv.time_mix_decode, static_argnums=3)(
            jnp.asarray(x1), jp, jc, jdims)
        got, tc = rwkv6.time_mix_decode(torch.from_numpy(x1), tp, tc, tdims)
        _close(got, want, SCAN)
        _close(tc["s"], jc["s"], SCAN)
        _close(tc["tm_x"], jc["tm_x"], MIXER)


def test_channel_mix_forward_and_decode_match_reference():
    rng = np.random.default_rng(19)
    jdims, tdims = jrwkv.RWKVDims(**RWKV_KW), rwkv6.RWKVDims(**RWKV_KW)
    jp, tp = _both(_params(jrwkv.channel_mix_p(jdims, 48), 20))
    x, prev = _rand(rng, (2, 9, 32)), _rand(rng, (2, 32))
    _close(rwkv6.channel_mix_forward(torch.from_numpy(x), tp,
                                     prev_x=torch.from_numpy(prev)),
           J(jrwkv.channel_mix_forward)(jnp.asarray(x), jp,
                                        prev_x=jnp.asarray(prev)), MIXER)
    x1 = _rand(rng, (2, 32))
    want, jx = J(jrwkv.channel_mix_decode)(jnp.asarray(x1), jp,
                                           jnp.asarray(prev))
    got, tx = rwkv6.channel_mix_decode(torch.from_numpy(x1), tp,
                                       torch.from_numpy(prev))
    _close(got, want, MIXER)
    _close(tx, jx, MIXER)


def test_rwkv_cache_shapes_match_reference():
    jdims, tdims = jrwkv.RWKVDims(**RWKV_KW), rwkv6.RWKVDims(**RWKV_KW)
    jc = jrwkv.init_rwkv_cache(3, jdims, 32, jnp.bfloat16)
    tc = rwkv6.init_rwkv_cache(3, tdims, 32, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["s"].dtype == torch.float32 and tc["tm_x"].dtype == torch.bfloat16
