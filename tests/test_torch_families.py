"""Every model family of the port (``repro_torch.models.model``) against the
JAX package's, on the CPU, parametrised over the nine configs beside
TinyLlama: the same numpy-seeded inputs at ``smoke_config`` size, the same
weights (the reference's init, carried over by ``params_from_jax``).  This
file holds the configs, parameters and ``forward``, and the helpers that
``test_torch_families_decode.py`` (prefill and decode) and
``test_torch_families_engine.py`` (the serving engine) share; the three
files run on separate workers.

* Configs, layer plans and the *full* configs' ``n_params`` and
  ``n_active_params`` (abstract specs, nothing allocated): equal.
* ``params_from_jax``: every leaf carried across unchanged.
* ``forward`` logits and aux, ``prefill`` logits and caches, then 4
  ``decode_step``s (logits, and every cache leaf after the last):
  - f32, the reference compiled as it runs: ``1e-4 × max|x|`` (the scans'
    and reductions' summation order);
  - bf16: ``2e-2 × max|x|``, as ``tests/test_torch_lm.py``, against the
    reference compiled with XLA's ``xla_allow_excess_precision`` off, so
    that both packages round to bf16 after each operation as the code is
    written (by default XLA's CPU fusions keep bf16 intermediates in f32:
    RWKV6's forward then differs by 2.4e-2 × max|logit|, and greedy tokens
    flip on near-ties).  Jamba's random 16-layer smoke model amplifies the
    packages' 1-ulp differences (the f32 router logits' summation order)
    about 20-fold through its layers and meets router near-ties (ROADMAP.md
    queue C), so its bf16 path is held layer by layer instead: each layer's
    forward and decode output, and its cache, from the reference's own
    input and cache.
* ``ServeEngine(device="cpu")``'s greedy tokens equal the reference
  engine's on the moe (both), hybrid and ssm smoke configs, the
  reference engine's prefill and decode compiled as above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke_config
from repro.models import model as jmodel
from repro_torch.common import params as par
from repro_torch.configs.base import ARCH_IDS, all_archs, get_arch, smoke_config
from repro_torch.models import attention, model, ssm
from repro_torch.models.convert import params_from_jax

ARCHS = [a for a in ARCH_IDS if a != "tinyllama_1_1b"]
LAYER_BY_LAYER = {"jamba_v0_1_52b"}  # in bf16 (see the docstring)
MAX_SEQ = 96
T = 16  # prompt tokens (a multiple of the smoke SSM chunk)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages' smoke models on the same weights."""
    jcfg = jsmoke_config(jget_arch(request.param))
    cfg = smoke_config(get_arch(request.param))
    jm = jmodel.build_model(jcfg, max_seq_len=MAX_SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, cfg, model.build_model(cfg, max_seq_len=MAX_SEQ), tp


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = (1e-4 if dtype == "f32" else 2e-2) * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=max(tol, 1e-30))


def _batch(cfg, seed=0):
    """numpy inputs: left-padded tokens, frames or patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (2, T)).astype(np.int32)
    toks[0, :5] = 0
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (2, cfg.n_patches, model.VIT_D)).astype(np.float32)
    return batch


class _Compiled:
    """``fn`` compiled by XLA once per input signature; with
    ``exact_bf16``, every bf16 operation rounds its result (excess
    precision off)."""

    def __init__(self, fn, exact_bf16: bool):
        self.fn = jax.jit(fn)
        self.opts = ({"xla_allow_excess_precision": False} if exact_bf16
                     else None)
        self.by_sig = {}

    def __call__(self, *args):
        sig = tuple((a.shape, str(a.dtype)) for a in jax.tree.leaves(args))
        if sig not in self.by_sig:
            self.by_sig[sig] = self.fn.lower(*args).compile(
                compiler_options=self.opts)
        return self.by_sig[sig](*args)


def _reference(fn, dtype):
    return _Compiled(fn, exact_bf16=dtype == "bf16")


def _per_layer_caches(cfg, jcache):
    """The reference's block-stacked layer caches as the port's list of one
    entry per layer."""
    plans = model.layer_plan(cfg)
    n = len(plans)
    return [jax.tree.map(lambda a, j=i // n: a[j], jcache["layers"][i % n])
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Configs and parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_layer_plan_match_reference(arch, smoke):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    if smoke:
        jcfg, cfg = jsmoke_config(jcfg), smoke_config(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert [dataclasses.asdict(p) for p in model.layer_plan(cfg)] == \
        [dataclasses.asdict(p) for p in jmodel.layer_plan(jcfg)]
    for i in range(cfg.n_layers):
        assert cfg.is_moe_layer(i) == jcfg.is_moe_layer(i)
        assert cfg.is_attn_layer(i) == jcfg.is_attn_layer(i)


def test_registry_matches_reference():
    assert list(all_archs()) == ARCH_IDS
    from repro.configs.base import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_counts_match_reference(arch):
    """The full configs' spec (nothing allocated): the same leaves, shapes,
    dtypes kept, and counts."""
    jm = jmodel.build_model(jget_arch(arch))
    tm = model.build_model(get_arch(arch))
    assert tm.n_params == jm.n_params
    assert tm.n_active_params() == jm.n_active_params()
    jspec = dict(par.leaves_with_paths(jm.spec))
    tspec = dict(par.leaves_with_paths(tm.spec))
    assert set(jspec) == set(tspec)
    for path, p in tspec.items():
        assert p.shape == jspec[path].shape, path
        assert (p.dtype is None) == (jspec[path].dtype is None), path


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _restacked(cfg, tp):
    """The port's per-layer parameters back in the reference's stacked
    layout."""
    tree = model.param_tree(tp)
    for key in ("blocks", "enc_blocks"):
        if key in tree:
            n = len(model.param_spec(cfg)[key])
            tree[key] = [par.tree_map(lambda *xs: torch.stack(xs),
                                      *tree[key][pos::n]) for pos in range(n)]
    return tree


def test_params_from_jax_round_trip(pair):
    jcfg, jm, jp, cfg, tm, tp = pair
    jleaves = dict(par.leaves_with_paths(jax.tree.map(np.asarray, jp)))
    tleaves = dict(par.leaves_with_paths(_restacked(cfg, tp)))
    assert set(jleaves) == set(tleaves)
    for path, a in jleaves.items():
        np.testing.assert_array_equal(tleaves[path].numpy(), a)
    assert tm.n_params == jm.n_params == \
        sum(p.numel() for p in tp.parameters())


def test_cast_keeps_declared_dtypes(pair):
    """Leaves whose spec fixes a dtype stay f32 through a bf16 cast and a
    bf16 init, as in the reference's ``cast_params``."""
    jcfg, jm, jp, cfg, tm, tp = pair
    jcast = jax.tree.map(np.asarray,
                         jmodel.cast_params(jcfg, jp, jnp.bfloat16))
    def dtypes(params):
        return {path: t.dtype for path, t in
                par.leaves_with_paths(model.param_tree(params))}

    want = dtypes(params_from_jax(cfg, jcast, device="cpu"))
    assert torch.float32 in want.values() or cfg.family not in ("moe",
                                                                 "hybrid")
    cast = model.cast_params(cfg, tp, torch.bfloat16)
    init = tm.init(seed=0, device="cpu", dtype=torch.bfloat16)
    assert dtypes(cast) == dtypes(init) == want
    assert model.cast_params(cfg, init, torch.bfloat16) is init


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_reference(pair, dtype):
    jcfg, jm, jp, cfg, tm, tp = pair
    if dtype == "bf16" and cfg.name in LAYER_BY_LAYER:
        return _layer_by_layer(pair, decode=False)
    jdt, tdt = DTYPES[dtype]
    batch = _batch(cfg)
    jl, jaux = _reference(lambda p, b: jm.forward_fn(p, b, dtype=jdt), dtype)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux = tm.forward_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, dtype=tdt)
    assert tl.dtype == tdt
    _close(tl, jl, dtype)
    assert set(taux) == set(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(_np(torch.as_tensor(taux[k])), _np(v),
                                   rtol=1e-3 if dtype == "f32" else 2e-2,
                                   atol=1e-6)


def _torch(a):
    dtype = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dtype)


def _layer_by_layer(pair, decode: bool):
    """bf16, each port layer against the reference's on the reference's
    own input: the forward's layers over the prompt, or (``decode``) after
    the reference's prefill, each layer's decode of the next token against
    the reference's cache, with the new cache."""
    jcfg, jm, jp, cfg, tm, tp = pair
    jpc = jmodel.cast_params(jcfg, jp, jnp.bfloat16)
    tpc = model.cast_params(cfg, tp, torch.bfloat16)
    jplans, jdims = jmodel.layer_plan(jcfg), jmodel._dims(jcfg)
    plans, dims, n = model.layer_plan(cfg), model._dims(cfg), len(jplans)
    batch = {k: jnp.asarray(v)
             for k, v in _batch(cfg, seed=int(decode)).items()}
    if decode:
        jl, jc = _reference(lambda p, b: jm.prefill_fn(p, b, 48), "bf16")(
            jp, batch)
        jcaches = _per_layer_caches(cfg, jc)
        tok = jnp.argmax(jl[:, :cfg.vocab_size], axis=-1).astype(jnp.int32)
        rope = model._rope(dims.attn, torch.full((1,), T))
        lens = torch.full((2,), T + 1, dtype=torch.int32)
    else:
        tok = batch["tokens"]
        rope = model._rope(dims.attn, torch.arange(T))
    x = jmodel.layers.embed(tok, jpc["embed"], jnp.bfloat16)

    def mixer(plan, lp, h):
        if plan.mixer == "attn":
            return attention.attn_forward(h, lp["attn"], dims.attn,
                                          rope), None
        return ssm.ssm_forward(h, lp["ssm"], dims.ssm), None

    # the reference's layer at each position of the period, compiled once
    if decode:
        ref = [_reference(lambda x, lp, lc, plan=plan: jmodel._block_decode(
            jcfg, [plan], jdims, x, [lp], [lc], jnp.int32(T)), "bf16")
            for plan in jplans]
    else:
        ref = [_reference(lambda x, lp, plan=plan: jmodel._block_forward(
            jcfg, [plan], jdims, x, [lp]), "bf16") for plan in jplans]
    for i in range(cfg.n_layers):
        plan, lp = plans[i % n], tpc["blocks"][i]
        jlp = jax.tree.map(lambda a: a[i // n], jpc["blocks"][i % n])
        if decode:
            want, (jnc,) = ref[i % n](x, jlp, jcaches[i])
            lc = {k: _torch(v) for k, v in jcaches[i].items()}
            got, nc = model._layer_decode(cfg, dims, plan, lp, lc,
                                          _torch(x), T, rope, lens)
            for name, a in nc.items():
                _close(a, jnc[name], "bf16")
        else:
            want, _ = ref[i % n](x, jlp)
            got, _, _ = model._layer_forward(cfg, dims, plan, lp, _torch(x),
                                             mixer)
        _close(got, want, "bf16")
        x = want
