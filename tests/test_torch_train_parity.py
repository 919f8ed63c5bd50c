"""The port's training pieces held number for number to the JAX package's,
on the CPU.

* One step's loss and gradients in f32 (``loss_fn(..., dtype=float32)``)
  on the TinyLlama and kimi (MoE) smoke configs from the same parameters:
  loss to 1e-5 relative, each leaf's gradient to 1e-4 × its max |g|; the
  port's ``remat`` modes give the same gradients as none.
* AdamW and Adafactor fed the *same* gradients (numpy, not each
  package's own: at step 1 Adam's update is about sign(g), and a gradient
  near 0 could flip between packages): parameters and state after three
  steps to 1e-6.
* int8 compression: quantized codes, scales and the feedback state equal,
  half-way ties included (both round half to even).
* A checkpoint written by either package restored by the other.
* ``TokenPipeline`` batches equal element for element, after ``seek``.
"""

import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.pipeline import TokenPipelineConfig as JTokenPipelineConfig
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import compression as jcompression
from repro.train import optimizer as jopt
from repro_torch.common import params as par
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train.optimizer import adafactor, adamw

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the cores, and torch's default of a thread a core oversubscribes
    them (bf16 steps here ran ~10x slower under the whole suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(tree) -> dict:
    return {p: np.asarray(a) for p, a in par.leaves_with_paths(tree)}


@pytest.fixture(scope="module", params=["tinyllama_1_1b", "kimi_k2_1t_a32b"])
def f32_step(request):
    """Both packages' f32 loss, metrics and gradients on one batch."""
    arch = request.param
    jcfg = jsmoke_config(jget_arch(arch))
    cfg = smoke_config(get_arch(arch))
    jparams = jmodel.build_model(jcfg).init(KEY)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, :3] = -1  # masked labels count no token
    batch = {"tokens": toks, "labels": labels}
    jloss = functools.partial(jmodel.loss_fn, jcfg, dtype=jnp.float32)
    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, _np(jparams), batch, float(jl), _np(jmet), _np(jg)


def _port_grads(cfg, np_params, batch, remat="none"):
    cfg = dataclasses.replace(cfg, remat=remat)
    params = params_from_jax(cfg, np_params, device="cpu",
                             requires_grad=True)
    loss, met = model.loss_fn(cfg, params, batch, dtype=torch.float32)
    leaves = par.leaves(model.param_tree(params))
    grads = torch.autograd.grad(loss, leaves)
    tree = par.unflatten(model.param_tree(params), list(grads))
    return float(loss.detach()), met, model.stacked_tree(cfg, tree)


def test_f32_loss_and_gradients_match_reference(f32_step):
    cfg, np_params, batch, jl, jmet, jg = f32_step
    loss, met, grads = _port_grads(cfg, np_params, batch)
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(torch.as_tensor(met[k]).detach()),
                                   float(jmet[k]),
                                   rtol=1e-5, atol=1e-7)
    want, got = _by_path(jg), _by_path(grads)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=path)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(f32_step, remat):
    cfg, np_params, batch, *_ = f32_step
    loss0, _, g0 = _port_grads(cfg, np_params, batch, "none")
    loss1, _, g1 = _port_grads(cfg, np_params, batch, remat)
    assert loss1 == loss0
    for path, a in _by_path(g0).items():
        np.testing.assert_allclose(_by_path(g1)[path], a, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(a).max(), 1e-30))


def _opt_tree(rng):
    return {"b": rng.normal(size=(3, 5)).astype(np.float32),
            "a": [rng.normal(size=(4,)).astype(np.float32),
                  rng.normal(size=(2, 6, 3)).astype(np.float32)]}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_reference_on_the_same_gradients(name):
    rng = np.random.default_rng(9)
    p0 = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    jo = getattr(jopt, name)()
    po = {"adamw": adamw, "adafactor": adafactor}[name]()
    jp = jax.tree.map(jnp.asarray, p0)
    pp = par.tree_map(torch.from_numpy, p0)
    js, ps = jo.init(jp), po.init(pp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.float32(lr))
        pp, ps = po.update(par.tree_map(torch.from_numpy, g), ps, pp,
                           torch.tensor(lr, dtype=torch.float32))
    for want, got in ((jp, pp), (js, ps)):
        w, g = _by_path(_np(want)), _by_path(got)
        assert set(w) == set(g)
        for path in w:
            np.testing.assert_allclose(g[path], w[path], rtol=1e-6,
                                       atol=1e-6, err_msg=path)


def test_compression_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64,)).astype(np.float32)
    x[:8] = (np.arange(8) - 3.5) * (2.0 / 127.0)  # k + 0.5 quantization steps
    x[8] = 2.0  # the absmax: scale 2/127, so the first eight are ties
    jq, js = jcompression.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    g = {"w": rng.normal(size=(5, 7)).astype(np.float32) * 1e-3,
         "v": [rng.normal(size=(9,)).astype(np.float32)]}
    je = jcompression.init_error_state(jax.tree.map(jnp.asarray, g))
    pe = compression.init_error_state(par.tree_map(torch.from_numpy, g))
    for _ in range(3):
        jg, je = jcompression.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), je)
        pg, pe = compression.compress_with_feedback(
            par.tree_map(torch.from_numpy, g), pe)
        for want, got in ((jg, pg), (je, pe)):
            w, o = _by_path(_np(want)), _by_path(got)
            for path in w:
                np.testing.assert_array_equal(o[path], w[path])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_restore_across_packages(writer):
    jcfg = jsmoke_config(jget_arch("tinyllama_1_1b"))
    cfg = smoke_config(get_arch("tinyllama_1_1b"))
    jparams = jmodel.build_model(jcfg).init(KEY)
    ptree = model.stacked_tree(cfg, model.param_tree(
        params_from_jax(cfg, _np(jparams), device="cpu")))
    with tempfile.TemporaryDirectory() as d:
        if writer == "ref":
            jckpt.save(d, 5, jparams, metadata={"by": writer})
            tree, man = ckpt.restore(d, 5, ptree)
            got, want = _by_path(tree), _by_path(_np(jparams))
        else:
            ckpt.save(d, 5, ptree, metadata={"by": writer})
            tree, man = jckpt.restore(d, 5, jparams)
            got, want = _by_path(_np(tree)), _by_path(ptree)
        assert man["metadata"] == {"by": writer} and man["step"] == 5
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(want[path]))
        assert [m["path"] for m in man["leaves"]] == [
            "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]


def test_bf16_checkpoint_round_trip():
    t = {"w": torch.randn(4, 3).to(torch.bfloat16), "n": torch.arange(3)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, t)
        back, man = ckpt.restore(d, 1, t)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], t["w"]) and torch.equal(back["n"], t["n"])
    assert [m["dtype"] for m in man["leaves"]] == ["int64", "bfloat16"]


def test_token_pipeline_matches_reference_after_seek():
    kw = dict(vocab_size=32000, seq_len=64, global_batch=6, seed=3,
              n_hosts=2, host_id=1)
    a, b = JTokenPipeline(JTokenPipelineConfig(**kw)), TokenPipeline(
        TokenPipelineConfig(**kw))
    for p in (a, b):
        p.seek(4)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(y[k], x[k])
    assert a.step == b.step == 7
