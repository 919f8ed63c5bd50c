"""The serving and model branches that wait for a mesh: ``serve_step_fn``
(one decode step over a full cache), ``ops.flash_attention_chunked``
against the reference's ``flash_attention_jnp`` (outputs and gradients),
and the models' sharding constraints (``attn_seq_shard``, MoE dispatch),
which are identities on one card under a mesh context."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.serve import serve_step_fn


def test_serve_step_equals_decode_fn():
    lm = build_model(smoke_config(get_arch("tinyllama_1_1b")))
    params = lm.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, 256, (2, 9)), dtype=torch.long)
    outs = []
    for step in (lm.decode_fn, serve_step_fn(lm)):
        _, cache = lm.prefill_fn(params, {"tokens": tokens}, 16)
        logits, cache = step(params, cache, tokens[:, -1], 9)
        outs.append((logits, cache))
    (a, ca), (b, cb) = outs
    assert torch.equal(a, b)
    for la, lb in zip(ca["layers"], cb["layers"]):
        assert torch.equal(la["k"], lb["k"]) and torch.equal(la["v"], lb["v"])


CASES = [  # b, h, hkv, s, t, causal, port chunks (q, kv), reference chunks
    (2, 4, 4, 64, 64, True, (24, 40), (32, 32)),
    (2, 4, 4, 64, 64, False, (24, 40), (16, 64)),
    (1, 8, 2, 48, 96, True, (20, 36), (16, 32)),  # GQA, S < T offset
    (1, 4, 1, 32, 80, False, (32, 80), (32, 16)),  # GQA 4, one chunk
]


@pytest.mark.parametrize("b,h,hkv,s,t,causal,chunks,jchunks", CASES)
def test_flash_attention_chunked_matches_reference(b, h, hkv, s, t, causal,
                                                   chunks, jchunks):
    rng = np.random.default_rng(s + t + h)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, h, s, 16), (b, hkv, t, 16), (b, hkv, t, 16), (b, h, s, 16)))

    def jf(q, k, v):
        return jops.flash_attention_jnp(q, k, v, causal=causal,
                                        q_chunk=jchunks[0],
                                        kv_chunk=jchunks[1])

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention_chunked(tq, tk, tv, causal=causal,
                                      q_chunk=chunks[0], kv_chunk=chunks[1])
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max())
    # and the plain attention of the serving path
    with torch.no_grad():
        plain = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture
def counted_constraints(monkeypatch):
    calls = []
    resolve = shd.resolve_spec

    def spy(axes, shape, mesh, rules=None):
        calls.append(axes)
        return resolve(axes, shape, mesh, rules)

    monkeypatch.setattr(shd, "resolve_spec", spy)
    return calls


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "kimi_k2_1t_a32b"])
def test_constraints_are_identities_under_a_mesh(arch, counted_constraints):
    """``attn_seq_shard=True`` and the MoE dispatch under a host mesh's
    (and a production mesh's) rules give the outputs of no context."""
    cfg = dataclasses.replace(smoke_config(get_arch(arch)),
                              attn_seq_shard=True)
    lm = build_model(cfg)
    params = lm.init(seed=0, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
    with torch.no_grad():
        want, _ = lm.forward_fn(params, batch)
        assert not counted_constraints
        for mesh in (make_host_mesh("cpu"), make_production_mesh()):
            with shd.use_mesh_rules(mesh):
                got, _ = lm.forward_fn(params, batch)
                got_prefill, _ = lm.prefill_fn(params, batch, 16)
            assert torch.equal(got, want)
            assert torch.equal(got_prefill, lm.prefill_fn(params, batch,
                                                          16)[0])
    seen = set(counted_constraints)
    assert ("batch", "act_heads", "seq_attn", None) in seen
    if cfg.moe is not None:
        assert ("dispatch", None, None) in seen
        assert ("dispatch", "act_experts", None, None) in seen
