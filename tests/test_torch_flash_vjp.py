"""The port's training attention on the CPU: K5's plain version with its
log-sum-exp as the forward, the FA2 recompute backward in torch ops.

* Gradients equal the reference's ``flash_attention_fa2`` (``jax.vjp``)
  and autograd through the port's plain ``ref.mha_attention``, causal and
  not, GQA groups 1, 4 and 7, S ≠ T, head dims 64 and 96, chunks that
  divide the sequence and ragged ones (the port's), f32 to 1e-5.
* The plain ``lse`` equals the reference forward's residual.
* K5's serving call and K6 refuse to run under grad; the model's
  attention goes through the autograd function exactly when a gradient is
  wanted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_vjp as jfv
from repro_torch.kernels import flash_vjp, ops, ref
from repro_torch.models import attention

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the cores, and torch's default of a thread a core oversubscribes
    them (bf16 steps here ran ~10x slower under the whole suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, h, hkv, s, t, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, t, dh)).astype(np.float32)
    do = rng.normal(size=(b, h, s, dh)).astype(np.float32)
    return q, k, v, do


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def _port_grads(q, k, v, do, fn):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


CASES = [  # (causal, group, s, t, dh)
    (True, 1, 48, 80, 64),
    (False, 1, 48, 80, 64),
    (True, 4, 64, 64, 64),
    (True, 7, 32, 96, 96),
    (False, 4, 96, 32, 96),
]


@pytest.mark.parametrize("causal,group,s,t,dh", CASES)
def test_fa2_gradients_match_reference(causal, group, s, t, dh):
    q, k, v, do = _inputs(s + t + dh, 2, 2 * group, 2, s, t, dh)
    qc, kc = 16, 16  # divide S and T: the reference's condition

    def jfn(q_, k_, v_):
        return jfv.flash_attention_fa2(q_, k_, v_, causal=causal,
                                       q_chunk=qc, kv_chunk=kc)

    want_out, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    out, got = _port_grads(q, k, v, do, lambda a, b, c: (
        flash_vjp.flash_attention_fa2(a, b, c, causal=causal, q_chunk=qc,
                                      kv_chunk=kc)))
    _close(out, want_out)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("chunks", [(512, 1024), (20, 36)])
@pytest.mark.parametrize("causal,group,s,t,dh", CASES)
def test_fa2_gradients_match_autograd_through_plain(causal, group, s, t,
                                                    dh, chunks):
    q, k, v, do = _inputs(7 * s + t, 1, 2 * group, 2, s, t, dh)
    out_r, want = _port_grads(q, k, v, do, lambda a, b, c: (
        ref.mha_attention(a, b, c, causal=causal)))
    out, got = _port_grads(q, k, v, do, lambda a, b, c: (
        flash_vjp.flash_attention_fa2(a, b, c, causal=causal,
                                      q_chunk=chunks[0],
                                      kv_chunk=chunks[1])))
    _close(out, out_r)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,group,s,t,dh", CASES)
def test_plain_lse_matches_reference_residual(causal, group, s, t, dh):
    q, k, v, _ = _inputs(3 * s + t, 2, 2 * group, 2, s, t, dh)
    out, lse = ref.mha_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    want_out, want_lse = jfv._fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=dh ** -0.5, q_chunk=16, kv_chunk=16)
    _close(out.numpy(), want_out)
    _close(lse.numpy(), np.asarray(want_lse).reshape(lse.shape))


def test_serving_kernels_refuse_grad():
    q, k, v, _ = _inputs(0, 1, 4, 2, 8, 8, 16)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(qt, kt, vt)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(qt[:, :, 0], kt, vt, torch.tensor([8]))
    with torch.no_grad():
        ops.flash_attention(qt, kt, vt)
        ops.flash_decode(qt[:, :, 0], kt, vt, torch.tensor([8]))
    d = attention.AttnDims(d_model=16, n_heads=4, n_kv_heads=2, head_dim=16,
                           rope_theta=0.0)
    p = {name: torch.randn(16 if name != "wo" else 64,
                           64 if name in ("wq", "wo") else 32)
         for name in ("wq", "wk", "wv", "wo")}
    p["wo"] = torch.randn(64, 16)
    cache = attention.init_kv_cache(1, 8, d, torch.float32)
    x = torch.randn(1, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.attn_decode(x, p, cache, 0, d, None, torch.tensor([1]))


def test_model_attention_takes_the_autograd_function_under_grad():
    d = attention.AttnDims(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                           rope_theta=10000.0)
    g = torch.Generator().manual_seed(0)
    p = {"wq": torch.randn(32, 64, generator=g),
         "wk": torch.randn(32, 32, generator=g),
         "wv": torch.randn(32, 32, generator=g),
         "wo": torch.randn(64, 32, generator=g)}
    x = torch.randn(2, 12, 32, generator=g)
    rope = attention.layers.rope_cos_sin(torch.arange(12), 16, 10000.0)
    plain = attention.attn_forward(x, p, d, rope)
    assert plain.grad_fn is None or "FlashAttention" not in str(
        plain.grad_fn)
    xg = x.clone().requires_grad_()
    out = attention.attn_forward(xg, p, d, rope)
    seen, stack = set(), [out.grad_fn]
    while stack:  # walk the graph for the FA2 node
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    assert any("FlashAttentionFA2" in type(f).__name__ for f in seen)
    torch.testing.assert_close(out.detach(), plain, rtol=1e-6, atol=1e-6)
    out.sum().backward()
    assert torch.isfinite(xg.grad).all()
