"""The training branches that wait for a mesh, held to the reference: the
optimizers' and the train step's ``state_spec`` leaf by leaf,
``optimizer_state_bytes`` for every arch, ``sharded_train_step`` on a
one-device host mesh against ``make_train_step``, and
``checkpoint.restore(..., shardings=)``."""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.params import P as JP
from repro.configs.base import ARCH_IDS, get_arch as jget_arch
from repro.models.model import build_model as jbuild_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.common import params as par
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import build_model, param_tree, stacked_tree
from repro_torch.train import (TrainConfig, adafactor, adamw, checkpoint,
                               init_train_state, make_train_step,
                               optimizer_state_bytes, sharded_train_step,
                               state_spec)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_leaves(state) -> list:
    """``[(path, P)]`` of a TrainState of declarations in jax's order
    (its data fields in order, dict keys sorted)."""
    out = []
    for f in ("params", "opt_state", "step", "error_state"):
        tree = getattr(state, f)
        if tree is not None:
            out += [(f"{f}.{p}".rstrip("."), leaf)
                    for p, leaf in par.flatten_with_paths(tree)]
    return out


def _jax_leaves(state) -> list:
    flat = jax.tree_util.tree_flatten_with_path(
        state, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in flat]


_DT = {"float32": torch.float32, "int32": torch.int32}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_spec_equals_reference(arch, compress):
    model = build_model(get_arch(arch))
    jmodel = jbuild_model(jget_arch(arch))
    for opt, jo in ((adamw(), jopt.adamw()), (adafactor(), jopt.adafactor())):
        got = _port_leaves(state_spec(model, opt, TrainConfig(
            compress_grads=compress)))
        want = _jax_leaves(jts.state_spec(jmodel, jo, jts.TrainConfig(
            compress_grads=compress)))
        assert len(got) == len(want), opt.name
        for (path, p), (jpath, jp) in zip(got, want):
            assert (p.shape, p.axes) == (tuple(jp.shape), tuple(jp.axes)), \
                (path, jpath)
            jd = jp.dtype
            want_dt = None if jd is None else _DT[jnp.dtype(jd).name]
            assert p.dtype == want_dt, (path, jpath)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_bytes_equal_reference(arch):
    spec = build_model(get_arch(arch)).spec
    jspec = jbuild_model(jget_arch(arch)).spec
    for name in ("adamw", "adafactor"):
        assert optimizer_state_bytes(spec, name) == \
            jopt.optimizer_state_bytes(jspec, name)


def _batches(cfg, n, b=4, s=16):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    return out


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_train_step_on_host_mesh_equals_train_step(compress):
    cfg = dataclasses.replace(smoke_config(get_arch("tinyllama_1_1b")),
                              attn_seq_shard=True)
    lm = build_model(cfg)
    opt = adamw()
    tcfg = TrainConfig(warmup_steps=1, microbatch=2, compress_grads=compress)
    batches = _batches(cfg, 2)
    mesh = make_host_mesh("cpu")
    states = []
    for sharded in (False, True):
        state = init_train_state(lm, opt, 0, tcfg, device="cpu")
        step = (sharded_train_step(lm, opt, tcfg, mesh, batches[0])
                if sharded else make_train_step(lm, opt, tcfg))
        for b in batches:
            state, _ = step(state, b)
        states.append(state)
    plain, shard = states
    for a, b in zip(par.leaves(param_tree(plain.params)),
                    par.leaves(param_tree(shard.params))):
        assert torch.equal(a, b)
    for a, b in zip(par.leaves(plain.opt_state), par.leaves(shard.opt_state)):
        assert torch.equal(a, b)
    assert int(shard.step) == 2
    step = sharded_train_step(lm, opt, tcfg, mesh, batches[0])
    # every leaf resolved (on axes of size 1: one device holds it whole)
    info = shd.shard_info(step.state_shardings)
    assert sum(info.values()) == len(_port_leaves(state_spec(lm, opt, tcfg)))
    assert "PartitionSpec('data', 'model')" in info
    with pytest.raises(ValueError, match="batch"):
        step(init_train_state(lm, opt, 0, tcfg, device="cpu"),
             _batches(cfg, 1, b=2)[0])


def test_sharded_train_step_refuses_a_mesh_of_many_devices():
    lm = build_model(smoke_config(get_arch("tinyllama_1_1b")))
    batch = _batches(lm.cfg, 1)[0]
    for multi in (False, True):
        with pytest.raises(NotImplementedError, match="one card"):
            sharded_train_step(lm, adamw(), TrainConfig(),
                               make_production_mesh(multi_pod=multi), batch)


def test_restore_with_shardings():
    cfg = smoke_config(get_arch("tinyllama_1_1b"))
    lm = build_model(cfg)
    tree = stacked_tree(cfg, param_tree(lm.init(seed=0, device="cpu")))
    host = make_host_mesh("cpu")
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, tree)
        plain, _ = checkpoint.restore(d, 1, tree)
        sh = shd.param_shardings(lm.spec, host)
        placed, _ = checkpoint.restore(d, 1, tree, shardings=sh)
        for a, b in zip(par.leaves(plain), par.leaves(placed)):
            assert torch.equal(a, b) and b.device.type == "cpu"
        step, back, _ = checkpoint.restore_latest(d, tree, shardings=sh)
        assert step == 1
        for a, b in zip(par.leaves(plain), par.leaves(back)):
            assert torch.equal(a, b)
        prod = shd.param_shardings(lm.spec, make_production_mesh())
        with pytest.raises(ValueError, match="holds no device"):
            checkpoint.restore(d, 1, tree, shardings=prod)
        two = shd.Mesh(("data", "model"), (1, 2),
                       (torch.device("cpu"), torch.device("cpu")))
        split = shd.param_shardings(lm.spec, two)
        with pytest.raises(ValueError, match="splits it"):
            checkpoint.restore(d, 1, tree, shardings=split)
