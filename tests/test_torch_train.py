"""``tests/test_train.py``'s cases on both packages, on the CPU.

Each case starts both packages from the same parameters (the reference's
init, carried over by ``convert.params_from_jax``) and feeds them the same
numpy batches; the reference's assertions must hold for each, and where
both compute the same number it is compared (bf16 compute, as the
reference's ``loss_fn`` defaults to, so to bf16's tolerance).
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.pipeline import TokenPipelineConfig as JTokenPipelineConfig
from repro.models.model import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro.train import compression as jcompression
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, param_tree, stacked_tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train.optimizer import (adafactor, adamw, clip_by_global_norm,
                                         optimizer_state_bytes)
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

KEY = jax.random.PRNGKey(0)
ARCH = "tinyllama_1_1b"


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
def setup():
    jcfg = jsmoke_config(jget_arch(ARCH))
    jm = jbuild_model(jcfg)
    jparams = jm.init(KEY)
    cfg = smoke_config(get_arch(ARCH))
    return jcfg, jm, jparams, cfg, build_model(cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_state(setup, opt, tcfg):
    _, _, jparams, cfg, m = setup
    params = params_from_jax(cfg, _np(jparams), device="cpu",
                             requires_grad=True)
    return init_train_state(m, opt, tcfg=tcfg, params=params)


def make_batch(cfg, rng, b=4, s=32):
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _run(setup, opt_fn, tcfg, batch, steps):
    """Both packages' losses over ``steps`` steps on one batch, and the
    final states."""
    jcfg, jm, jparams, cfg, m = setup
    jstate = jts.init_train_state(jm, opt_fn[0](), KEY, tcfg[0])
    jstep = jax.jit(jts.make_train_step(jm, opt_fn[0](), tcfg[0]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = opt_fn[1]()
    state = port_state(setup, opt, tcfg[1])
    step = make_train_step(m, opt, tcfg[1])
    jl, pl = [], []
    for _ in range(steps):
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, batch)
        jl.append(float(jmet["loss"]))
        pl.append(float(met["loss"]))
    return jl, pl, jstate, state


def _tcfg(**kw):
    return jts.TrainConfig(**kw), TrainConfig(**kw)


def test_loss_decreases(setup):
    rng = np.random.default_rng(0)
    batch = make_batch(setup[3], rng)
    jl, pl, jstate, state = _run(
        setup, (jopt.adamw, adamw),
        _tcfg(learning_rate=1e-3, warmup_steps=2, microbatch=2), batch, 15)
    for losses in (jl, pl):
        assert losses[-1] < losses[0] - 0.2
    assert abs(pl[0] - jl[0]) < 1e-2 * jl[0]  # same init, bf16 compute
    assert int(jstate.step) == int(state.step) == 15


def test_grad_accumulation_equivalence(setup):
    """microbatch=2 over B=4 must equal microbatch=0 (same mean grads)."""
    rng = np.random.default_rng(1)
    batch = make_batch(setup[3], rng)
    outs = []
    for mb in (0, 2):
        _, _, jstate, state = _run(
            setup, (jopt.adamw, adamw),
            _tcfg(learning_rate=1e-2, microbatch=mb, warmup_steps=0),
            batch, 1)
        outs.append((jax.tree.leaves(jstate.params),
                     [t.detach().numpy() for t in
                      jax.tree.leaves(stacked_tree(setup[3], param_tree(
                          state.params)))]))
    for pkg in (0, 1):
        for a, b in zip(outs[0][pkg], outs[1][pkg]):
            assert_allclose(np.asarray(a, np.float32),
                            np.asarray(b, np.float32), rtol=2e-3, atol=2e-4)


def test_adafactor_steps_and_memory(setup):
    rng = np.random.default_rng(2)
    batch = make_batch(setup[3], rng)
    jl, pl, _, _ = _run(setup, (jopt.adafactor, adafactor),
                        _tcfg(learning_rate=1e-3), batch, 10)
    for losses in (jl, pl):
        assert losses[-1] < losses[0]
    jm, m = setup[1], setup[4]
    for pkg, (af, aw) in {
        "ref": (jopt.optimizer_state_bytes(jm.spec, "adafactor"),
                jopt.optimizer_state_bytes(jm.spec, "adamw")),
        "port": (optimizer_state_bytes(m.spec, "adafactor"),
                 optimizer_state_bytes(m.spec, "adamw")),
    }.items():
        assert af < 0.2 * aw, pkg
    assert optimizer_state_bytes(m.spec, "adafactor") == \
        jopt.optimizer_state_bytes(jm.spec, "adafactor")
    assert optimizer_state_bytes(m.spec, "adamw") == \
        jopt.optimizer_state_bytes(jm.spec, "adamw")


def test_clip_by_global_norm():
    for clip, ones in ((jopt.clip_by_global_norm, jnp.ones),
                       (clip_by_global_norm, torch.ones)):
        tree = {"a": ones((4,)) * 3.0, "b": ones((4,)) * 4.0}
        clipped, norm = clip(tree, 1.0)
        assert float(norm) == pytest.approx(10.0)
        _, norm2 = clip(clipped, 1e9)
        assert float(norm2) == pytest.approx(1.0, rel=1e-5)


def test_compression_error_feedback():
    rng = np.random.default_rng(4)
    g0 = rng.normal(size=(256,)).astype(np.float32) * 1e-3
    for pkg, g, zeros in (("ref", jnp.asarray(g0), jnp.zeros_like),
                          ("port", torch.from_numpy(g0), torch.zeros_like)):
        mod = jcompression if pkg == "ref" else compression
        err = mod.init_error_state(g)
        acc = zeros(g)
        for _ in range(50):
            cg, err = mod.compress_with_feedback(g, err)
            acc = acc + cg
        resid = np.abs(np.asarray(acc - 50 * g))
        q_step = float(np.abs(np.asarray(g + err)).max()) / 127.0
        assert resid.max() <= q_step * 1.5, pkg


def test_compressed_training_still_converges(setup):
    rng = np.random.default_rng(5)
    batch = make_batch(setup[3], rng)
    jl, pl, jstate, state = _run(
        setup, (jopt.adamw, adamw),
        _tcfg(learning_rate=1e-3, warmup_steps=0, compress_grads=True),
        batch, 12)
    for losses in (jl, pl):
        assert losses[-1] < losses[0] - 0.1
    assert jstate.error_state is not None and state.error_state is not None


def test_checkpoint_roundtrip_and_crash_consistency(setup):
    jcfg, _, jparams, cfg, _ = setup
    params = stacked_tree(cfg, param_tree(params_from_jax(
        cfg, _np(jparams), device="cpu")))
    for mod, tree, arch in ((jckpt, jparams, jcfg.name),
                            (ckpt, params, cfg.name)):
        with tempfile.TemporaryDirectory() as d:
            mod.save(d, 3, tree, metadata={"arch": arch})
            mod.save(d, 7, tree)
            assert mod.latest_step(d) == 7
            restored, manifest = mod.restore(d, 3, tree)
            for a, b in zip(jax.tree.leaves(tree),
                            jax.tree.leaves(restored)):
                assert np.array_equal(np.asarray(a), np.asarray(b))
            assert manifest["metadata"]["arch"] == arch
            os.makedirs(os.path.join(d, "tmp_step_00000009"))
            assert mod.latest_step(d) == 7


def test_checkpoint_shape_mismatch_rejected(setup):
    jcfg, jm, jparams, cfg, m = setup
    small = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16)
    jother = jbuild_model(dataclasses.replace(jcfg, **small)).init(KEY)
    other = stacked_tree(cfg, param_tree(build_model(dataclasses.replace(
        cfg, **small)).init(0, device="cpu")))
    params = stacked_tree(cfg, param_tree(m.init(0, device="cpu")))
    for mod, tree, like in ((jckpt, jparams, jother), (ckpt, params, other)):
        with tempfile.TemporaryDirectory() as d:
            mod.save(d, 0, tree)
            with pytest.raises(ValueError):
                mod.restore(d, 0, like)


def test_data_pipeline_seek_determinism():
    for pipe, conf in ((JTokenPipeline, JTokenPipelineConfig),
                       (TokenPipeline, TokenPipelineConfig)):
        cfg = conf(vocab_size=100, seq_len=16, global_batch=4)
        p1 = pipe(cfg)
        batches = [p1.next_batch() for _ in range(5)]
        p2 = pipe(cfg)
        p2.seek(3)
        b3 = p2.next_batch()
        assert np.array_equal(b3["tokens"], batches[3]["tokens"])
        ca = conf(vocab_size=100, seq_len=16, global_batch=4, n_hosts=2,
                  host_id=0)
        cb = dataclasses.replace(ca, host_id=1)
        a = pipe(ca).next_batch()
        b = pipe(cb).next_batch()
        full = pipe(cfg).next_batch()
        assert np.array_equal(np.concatenate([a["tokens"], b["tokens"]]),
                              full["tokens"])
