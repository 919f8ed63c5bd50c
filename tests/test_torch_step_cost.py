"""The step-cost counter (``repro_torch.launch.step_cost``) against
``tests/test_roofline.py``'s checks and tolerances: loops counted as many
times as they run, grad steps 3× / 4× the analytic forward, remat
visible, the reference's HLO count of the same grad step; attention
counted by the work it needs (the causal triangle, decode's ``lens``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke_config
from repro.launch.hlo_cost import analyze as janalyze
from repro.models.model import build_model as jbuild_model
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_vjp import flash_attention_fa2
from repro_torch.launch.step_cost import analyze
from repro_torch.models.model import build_model, padded_vocab, params_module


def test_loop_counted_each_time():
    def f(x, w):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    r = analyze(f, torch.empty(256, 512), torch.empty(512, 512))
    assert r["flops"] == pytest.approx(8 * 2 * 256 * 512 * 512, rel=0.05)
    assert r["collective_bytes"] == {} and r["n_collectives"] == 0
    assert r["bytes"] > 0


def test_nested_loops():
    def g(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    r = analyze(g, torch.empty(128, 256), torch.empty(256, 256))
    assert r["flops"] == pytest.approx(12 * 2 * 128 * 256 * 256, rel=0.05)


def test_bytes_count_materialized_ops_only():
    x = torch.empty(64, 32)
    r = analyze(lambda a: a.t().reshape(-1) * 2, x)
    # t() is a view, reshape of it copies (read + write), mul reads + writes
    assert r["bytes"] == 4 * 64 * 32 * 4


def _analytic_fwd_flops(cfg, b, s):
    d, h, kvh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh, ff = cfg.resolved_head_dim, cfg.d_ff
    v = padded_vocab(cfg.vocab_size)
    t = b * s
    per_layer = (2 * t * d * (h * dh) + 2 * 2 * t * d * (kvh * dh)
                 + 2 * t * (h * dh) * d + 3 * 2 * t * d * ff)
    attn = 2 * 2 * t * s * (h * dh)
    return cfg.n_layers * (per_layer + attn) + 2 * t * d * v


def _grad_flops(remat: str) -> float:
    cfg = dataclasses.replace(smoke_config(get_arch("tinyllama_1_1b")),
                              n_layers=4, remat=remat)
    m = build_model(cfg)
    params = params_module(cfg, m.abstract_params(), requires_grad=True)
    batch = {"tokens": torch.ones(2, 64, dtype=torch.int32),
             "labels": torch.ones(2, 64, dtype=torch.int32)}

    def g(bt):
        loss, _ = m.loss_fn(params, bt)
        torch.autograd.grad(loss, list(params.parameters()))

    return analyze(g, batch)["flops"], cfg


@pytest.mark.parametrize("remat,mult", [("none", 3.0), ("full", 4.0)])
def test_grad_flops_match_analytic(remat, mult):
    flops, cfg = _grad_flops(remat)
    assert flops == pytest.approx(mult * _analytic_fwd_flops(cfg, 2, 64),
                                  rel=0.2)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_grad_flops_match_reference_hlo_count(remat):
    """The reference's loop-aware HLO count of the same grad step, within
    20% (it counts elementwise flops and the whole S×S attention)."""
    flops, _ = _grad_flops(remat)
    cfg = dataclasses.replace(jsmoke_config(jget_arch("tinyllama_1_1b")),
                              n_layers=4, remat=remat)
    m = jbuild_model(cfg)
    params = m.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.ones((2, 64), jnp.int32),
             "labels": jnp.ones((2, 64), jnp.int32)}
    g = lambda p, bt: jax.grad(lambda pp: m.loss_fn(pp, bt)[0])(p)
    want = janalyze(jax.jit(g).lower(params, batch).compile().as_text())
    assert flops == pytest.approx(want["flops"], rel=0.2)


def test_remat_visible_in_flops():
    assert _grad_flops("full")[0] > _grad_flops("none")[0] * 1.1


def _qkv(b, h, hkv, s, t, dh):
    return (torch.empty(b, h, s, dh, dtype=torch.bfloat16),
            torch.empty(b, hkv, t, dh, dtype=torch.bfloat16),
            torch.empty(b, hkv, t, dh, dtype=torch.bfloat16))


@pytest.mark.parametrize("s,t", [(64, 64), (48, 128)])
def test_attention_counted_by_its_work(s, t):
    b, h, hkv, dh = 2, 4, 2, 16
    q, k, v = _qkv(b, h, hkv, s, t, dh)
    causal = analyze(lambda *a: ops.flash_attention(*a, causal=True), q, k, v)
    full = analyze(lambda *a: ops.flash_attention(*a, causal=False), q, k, v)
    tri = sum(min(t, i + t - s + 1) for i in range(s))  # with the diagonal
    assert causal["flops"] == 4 * dh * b * h * tri
    assert full["flops"] == 4 * dh * b * h * s * t
    if s == t:
        assert tri == s * (s + 1) // 2
    io = 2 * (2 * b * h * s * dh + 2 * b * hkv * t * dh)  # q, out, k, v
    assert causal["bytes"] == io
    assert causal["kernels"]["flash_attention"]["calls"] == 1


def test_fa2_backward_counted_by_its_work():
    b, h, hkv, s, dh = 1, 4, 2, 64, 16
    q, k, v = (x.requires_grad_() for x in _qkv(b, h, hkv, s, s, dh))

    def step(q, k, v):
        out = flash_attention_fa2(q, k, v, causal=True)
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    r = analyze(step, q, k, v)
    tri = s * (s + 1) // 2
    assert r["kernels"]["flash_attention_lse"]["flops"] == 4 * dh * b * h * tri
    assert r["kernels"]["flash_attention_bwd"]["flops"] == \
        10 * dh * b * h * tri


def test_decode_counts_lens_keys():
    b, h, hkv, t, dh = 3, 4, 2, 96, 16
    q = torch.empty(b, h, dh, dtype=torch.bfloat16)
    kc = torch.empty(b, hkv, t, dh, dtype=torch.bfloat16)
    lens = torch.tensor([5, 96, 200], dtype=torch.int32)  # clamped to T
    meta_lens = analyze(ops.flash_decode, q, kc, kc, lens)
    real = ops._meta_decode(q.to("meta"), kc.to("meta"), kc.to("meta"), lens)
    assert real.shape == q.shape
    # analyze moves lens to meta too: every row counts its whole cache
    assert meta_lens["flops"] == 4 * dh * h * b * t
    seen = []
    ops.WORK_LISTENERS.append(lambda *a: seen.append(a))
    try:
        ops._meta_decode(q.to("meta"), kc.to("meta"), kc.to("meta"), lens)
    finally:
        ops.WORK_LISTENERS.pop()
    keys = 5 + 96 + 96
    assert seen[0][1] == 4 * dh * h * keys
    assert seen[0][2] == (2 * b * h * dh * 2 + b * 4
                          + 2 * hkv * keys * dh * 2)


def test_meta_step_allocates_nothing():
    """A TinyLlama-1.1B train microbatch at 8 x 4096 counts on meta."""
    cfg = get_arch("tinyllama_1_1b")
    m = build_model(cfg)
    params = params_module(cfg, m.abstract_params(), requires_grad=True)
    batch = {"tokens": torch.empty(8, 4096, dtype=torch.int32,
                                   device="meta"),
             "labels": torch.empty(8, 4096, dtype=torch.int32,
                                   device="meta")}

    def g(bt):
        loss, _ = m.loss_fn(params, bt)
        torch.autograd.grad(loss, list(params.parameters()))

    r = analyze(g, batch)
    n = 8 * 4096
    assert r["flops"] > 6 * m.n_params * n * 0.9
    assert np.isfinite(r["bytes"])


@pytest.mark.parametrize("n_micro,compress", [(2, False), (4, False),
                                              (4, True)])
def test_train_count_is_the_full_step_but_accumulation(n_micro, compress):
    """The dry-run counts a train step on one microbatch and adds the other
    microbatches' gradients: the same FLOPs as the whole multi-microbatch
    step counted at once, and its bytes less the f32 accumulation's (a
    zeros, ``n`` adds and a division a parameter, and the metrics'
    means)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as lspecs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import for_config

    cfg = dataclasses.replace(smoke_config(get_arch("tinyllama_1_1b")),
                              n_layers=4, remat="full")
    shape = ShapeConfig("t", 64, 2 * n_micro, "train", microbatch=2)
    cell = lspecs.make_cell(cfg, shape)
    mesh = make_production_mesh(multi_pod=False)
    extra = {"compress_grads": compress}
    got, _ = dryrun._count_train(cell.model, cfg, shape, cell.batch_specs,
                                 mesh, None, extra)

    opt = for_config(cfg.optimizer)
    tcfg = ts.TrainConfig(microbatch=2, **extra)
    params = params_module(cfg, cell.model.abstract_params(torch.float32),
                           requires_grad=True)
    state = ts.init_train_state(cell.model, opt, tcfg=tcfg, params=params)
    step = ts.make_train_step(cell.model, opt, tcfg)

    def full(state, batch):
        with shd.use_mesh_rules(mesh):
            step(state, batch)

    want = analyze(full, state, cell.batch_specs)
    assert got["flops"] == want["flops"]
    assert got["kernels"] == want["kernels"]
    n_par = sum(p.numel() for p in params.parameters())
    accumulation = (4 + 8 * n_micro + 8) * n_par
    assert 0 <= want["bytes"] - got["bytes"] - accumulation <= 64 * n_micro
