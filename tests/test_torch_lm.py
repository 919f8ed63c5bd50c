"""The port's LM serving path (``repro_torch.models``, ``repro_torch.serve``)
against the JAX package, on the CPU, with the same numpy-seeded inputs and
the same weights (carried over by ``params_from_jax``).

* K5/K6 plain versions against the Pallas kernels in interpret mode and
  against ``repro.kernels.ref``, at the reference suite's shapes and
  tolerance (``rtol=atol=2e-3``, ``tests/test_kernels.py``), and at head
  dim 96 and GQA group 7.  Both sides
  compute in f32; the slack covers the online softmax's summation order.
* ``rms_norm``, ``apply_rope``, ``swiglu`` in f32 to 1e-5 (f32 rounding of
  the same operations in another order).
* ``prefill`` logits and cache, then 4 ``decode_step``s, in f32 to
  ``rtol=atol=1e-4`` (summation order through two layers), and in bf16 to
  2e-2 × max|logit| (bf16 rounds at other places in the two frameworks), on
  ``smoke_config(tinyllama)`` and a GQA-8 variant at head_dim 64, with
  left-padded prompts.
* ``ServeEngine(device="cpu")``: the four behaviours of
  ``tests/test_serve.py`` and the reference engine's greedy tokens on that
  file's fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import (flash_attention_pallas,
                                           flash_decode_pallas)
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.common import params as par
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 flash_decode_cuda,
                                                 flash_decode_plain)
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeConfig, ServeEngine

GQA8 = dict(n_layers=2, d_model=256, n_heads=8, n_kv_heads=1, head_dim=64)


def _configs(name):
    """(reference config, port config) of one test model."""
    jcfg = jsmoke_config(jget_arch("tinyllama_1_1b"))
    cfg = smoke_config(get_arch("tinyllama_1_1b"))
    if name == "gqa8":
        jcfg = dataclasses.replace(jcfg, **GQA8)
        cfg = dataclasses.replace(cfg, **GQA8)
    return jcfg, cfg


@pytest.fixture(scope="module", params=["smoke", "gqa8"])
def pair(request):
    """Both packages' models on the same weights (the reference's init)."""
    jcfg, cfg = _configs(request.param)
    jm = jmodel.build_model(jcfg, max_seq_len=96)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, cfg, model.build_model(cfg, max_seq_len=96), tp


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# K5 / K6 plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_reference(h, hkv, causal):
    rng = np.random.default_rng(10)
    b, s, dh = 2, 512, 64
    q, k, v = (_rand(rng, (b, n, s, dh)) for n in (h, hkv, hkv))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    interpret=True)
    want = jref.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_head_dim_96_gqa_7(causal):
    """phi3-mini's head dim (96, the default scale not a power of two) at
    arctic's GQA group of 7 (14 heads over 2 KV heads)."""
    rng = np.random.default_rng(16)
    b, s, dh = 2, 200, 96
    q, k, v = (_rand(rng, (b, n, s, dh)) for n in (14, 2, 2))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    interpret=True)
    want = jref.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,t", [(77, 77), (50, 130)])
def test_flash_attention_plain_ragged_and_offset(s, t):
    """Lengths off any tile, and T > S (query i attends keys <= i + T - S)."""
    rng = np.random.default_rng(11)
    q, k, v = _rand(rng, (1, 4, s, 32)), _rand(rng, (1, 2, t, 32)), \
        _rand(rng, (1, 2, t, 32))
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale=0.3)
    want = jref.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("lens", [[512, 512], [100, 317]])
def test_flash_decode_plain_matches_reference(lens):
    rng = np.random.default_rng(12)
    b, h, hkv, t, dh = 2, 8, 4, 512, 64
    q, k, v = _rand(rng, (b, h, dh)), _rand(rng, (b, hkv, t, dh)), \
        _rand(rng, (b, hkv, t, dh))
    cl = np.asarray(lens, np.int32)
    got = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(cl))
    pallas = flash_decode_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(cl),
                                 interpret=True)
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dh,h", [(96, 8), (128, 14)])
def test_flash_decode_plain_head_dim_96_and_gqa_7(dh, h):
    """Head dim 96 (phi3-mini) and a GQA group of 7 (arctic, 14 heads
    over 2 KV heads) against the Pallas kernel and the reference."""
    rng = np.random.default_rng(17)
    b, hkv, t = 2, 2, 512
    q, k, v = _rand(rng, (b, h, dh)), _rand(rng, (b, hkv, t, dh)), \
        _rand(rng, (b, hkv, t, dh))
    cl = np.asarray([512, 131], np.int32)
    got = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(cl))
    pallas = flash_decode_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(cl),
                                 interpret=True)
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


def test_flash_decode_plain_empty_cache_gives_zero():
    """cache_len 0 attends nothing: a zero row, as the TPU kernel gives
    (its accumulator stays 0 and the denominator is clamped), never NaN."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(_rand(rng, (3, 4, 16))).bfloat16()
    k = torch.from_numpy(_rand(rng, (3, 2, 40, 16))).bfloat16()
    out = flash_decode_plain(q, k, k, torch.tensor([0, 1, 40]))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out.float()).all()
    # a single valid key returns that key's value row for every head
    np.testing.assert_array_equal(out[1].float().numpy(),
                                  k[1, [0, 0, 1, 1], 0].float().numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    q = torch.zeros(1, 4, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(q[:, :, 0], k, k, torch.ones(1))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_layers_match_reference():
    rng = np.random.default_rng(14)
    x = _rand(rng, (2, 9, 64))
    scale = _rand(rng, (64,))
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        1e-5).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        rtol=1e-5, atol=1e-5)
    xr = _rand(rng, (2, 4, 9, 16))
    pos = np.tile(np.arange(100, 109), (2, 4, 1))
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos),
                          1e4).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    p = {name: _rand(rng, shape) / shape[0]**0.5 for name, shape in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    np.testing.assert_allclose(
        layers.swiglu(torch.from_numpy(x),
                      {k: torch.from_numpy(a) for k, a in p.items()}).numpy(),
        np.asarray(jlayers.swiglu(jnp.asarray(x),
                                  {k: jnp.asarray(a) for k, a in p.items()})),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _stacked(tp):
    """The port's parameters back in the reference's layout: the period-1
    dense stack's layers stacked along a leading axis."""
    tree = model.param_tree(tp)
    tree["blocks"] = [par.tree_map(lambda *xs: torch.stack(xs),
                                   *tree["blocks"])]
    return tree


def test_params_from_jax_round_trip(pair):
    jcfg, jm, jp, cfg, tm, tp = pair
    jtree = jax.tree.map(np.asarray, jp)
    back = _stacked(tp)
    jleaves = dict(par.leaves_with_paths(jtree))
    tleaves = dict(par.leaves_with_paths(back))
    assert set(jleaves) == set(tleaves)
    for path, a in jleaves.items():
        assert tuple(tleaves[path].shape) == a.shape, path
        np.testing.assert_array_equal(tleaves[path].numpy(), a)
    assert tm.n_params == jm.n_params == \
        sum(p.numel() for p in tp.parameters())
    spec_shapes = {k: p.shape for k, p in par.leaves_with_paths(tm.spec)}
    assert spec_shapes == {k: a.shape for k, a in jleaves.items()}


def test_init_follows_the_spec_rules():
    cfg = dataclasses.replace(smoke_config(get_arch("tinyllama_1_1b")),
                              d_model=256, d_ff=512)
    tm = model.build_model(cfg)
    tp = tm.init(seed=3, device="cpu")
    again = tm.init(seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tp.parameters(), again.parameters()))
    blk = tp["blocks"][0]
    assert torch.equal(blk["ln1"]["scale"], torch.ones(256))
    # scaled_normal: std 1/sqrt(fan_in); embed: std 0.02 (4-sigma slack)
    for w, std in ((blk["mlp"]["w_down"], 512**-0.5),
                   (blk["attn"]["wq"], 256**-0.5),
                   (tp["embed"]["table"], 0.02)):
        n = w.numel()
        assert abs(float(w.std()) / std - 1) < 4 * (2 * n) ** -0.5
        assert abs(float(w.mean())) < 4 * std / n**0.5
    assert tm.n_params == sum(p.numel() for p in tp.parameters())


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    """Every field of the port's config equals the reference's, in full and
    in its smoke size."""
    jcfg, cfg = jget_arch("tinyllama_1_1b"), get_arch("tinyllama_1_1b")
    if smoke:
        jcfg, cfg = jsmoke_config(jcfg), smoke_config(cfg)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim


# ---------------------------------------------------------------------------
# Prefill + decode against the reference model
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(15)
    toks = rng.integers(1, vocab, (3, 37)).astype(np.int32)
    toks[0, :11] = 0  # left padding, attended as the reference does
    toks[2, :30] = 0
    return toks


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(pair, dtype):
    jcfg, jm, jp, cfg, tm, tp = pair
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    max_len = 48
    toks = _prompts(cfg.vocab_size)

    def close(got, want):
        got, want = _np(got), _np(want)
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            tol = 2e-2 * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, max_len,
                           dtype=jdt)
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, max_len,
                           dtype=tdt)
    assert tl.dtype == tdt and tuple(tl.shape) == jl.shape
    close(tl, jl)
    for name in ("k", "v"):
        port = torch.stack([lc[name] for lc in tc["layers"]])
        assert tuple(port.shape) == jc["layers"][0][name].shape
        close(port, jc["layers"][0][name])
    pos = toks.shape[1]
    for _ in range(4):
        tok = np.array(jnp.argmax(jl[:, :cfg.vocab_size], axis=-1), np.int32)
        jl, jc = jm.decode_fn(jp, jc, jnp.asarray(tok), jnp.int32(pos),
                              dtype=jdt)
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), pos, dtype=tdt)
        close(tl, jl)
        pos += 1
    for name in ("k", "v"):
        close(torch.stack([lc[name] for lc in tc["layers"]]),
              jc["layers"][0][name])


def test_prefill_truncates_cache_past_max_len(pair):
    _, _, _, cfg, tm, tp = pair
    toks = _prompts(cfg.vocab_size)
    _, cache = tm.prefill_fn(tp, {"tokens": toks}, 20, dtype=torch.float32)
    full_logits, full = tm.prefill_fn(tp, {"tokens": toks}, 37,
                                      dtype=torch.float32)
    for lc, lf in zip(cache["layers"], full["layers"]):
        assert lc["k"].shape[2] == 20
        assert torch.equal(lc["k"], lf["k"][:, :, :20])


# ---------------------------------------------------------------------------
# Serving engine (tests/test_serve.py's behaviours and fixture)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = _configs("smoke")
    jm = jmodel.build_model(jcfg, max_seq_len=96)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, model.build_model(cfg, max_seq_len=96), tp, jm, jp


def _reqs(n, rng, max_new=6, cls=Request):
    return [
        cls(rid=i, prompt=rng.integers(0, 200, 5 + i, dtype=np.int32),
            max_new_tokens=max_new)
        for i in range(n)
    ]


def _engine(served, **kw):
    cfg, tm, tp = served[:3]
    return ServeEngine(tm, tp, ServeConfig(max_len=96, **kw), device="cpu")


def test_serve_all_requests_complete(served):
    cfg = served[0]
    eng = _engine(served, n_slots=2)
    reqs = _reqs(5, np.random.default_rng(0))
    eng.generate(reqs)
    assert all(r.done for r in reqs)
    assert all(len(r.output) == r.max_new_tokens for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
    assert [w.batch for w in eng.waves] == [2, 2, 1]
    assert all(w.decode_steps == 5 and w.decode_tokens == 5 * w.batch
               for w in eng.waves)


def test_serve_greedy_is_deterministic(served):
    outs = []
    for _ in range(2):
        eng = _engine(served, n_slots=2, temperature=0.0)
        reqs = _reqs(3, np.random.default_rng(1))
        eng.generate(reqs)
        outs.append([tuple(r.output) for r in reqs])
    assert outs[0] == outs[1]


def test_serve_greedy_independent_of_batch_composition(served):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 200, 8, dtype=np.int32) for _ in range(3)]

    def run(slots, subset):
        eng = _engine(served, n_slots=slots)
        reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=5)
                for i in subset]
        eng.generate(reqs)
        return {r.rid: tuple(r.output) for r in reqs}

    together = run(3, [0, 1, 2])
    alone = {**run(1, [0]), **run(1, [1]), **run(1, [2])}
    assert together == alone


def test_serve_eos_stops_generation(served):
    eng = _engine(served, n_slots=1)
    reqs = _reqs(1, np.random.default_rng(3), max_new=20)
    eng.generate(reqs)
    first = reqs[0].output[0]
    eng2 = _engine(served, n_slots=1, eos_id=first)
    reqs2 = _reqs(1, np.random.default_rng(3), max_new=20)
    eng2.generate(reqs2)
    assert len(reqs2[0].output) == 1


def test_serve_temperature_sampling_is_seeded(served):
    outs = []
    for seed in (4, 4, 5):
        eng = _engine(served, n_slots=2, temperature=1.0, seed=seed)
        reqs = _reqs(3, np.random.default_rng(6), max_new=8)
        eng.generate(reqs)
        outs.append([tuple(r.output) for r in reqs])
    assert outs[0] == outs[1] != outs[2]
    assert all(0 <= t < served[0].vocab_size for o in outs for r in o
               for t in r)


def test_serve_greedy_tokens_equal_reference_engine(served):
    """Same weights, same requests: the reference engine's bf16 greedy
    tokens, token for token."""
    cfg, tm, tp, jm, jp = served
    jeng = JServeEngine(jm, jp, JServeConfig(max_len=96, n_slots=2))
    jreqs = _reqs(5, np.random.default_rng(0), cls=JRequest)
    jeng.generate(jreqs)
    reqs = _reqs(5, np.random.default_rng(0))
    _engine(served, n_slots=2).generate(reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
