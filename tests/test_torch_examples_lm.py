"""The port's LM entry points (``repro_torch.examples.lm_embed_index``,
``train_lm``, ``serve_lm``) run as a user runs them: ``python -m
repro_torch.examples.<name> --device cpu`` in a subprocess with no card
visible, with the arguments and markers of ``tests/test_examples.py``.
``train_lm`` resumes from its own checkpoint, and its checkpoints and the
reference's restore in the other package; resumed from a reference
checkpoint it prints the reference's loss of those parameters.  From the
reference's init, ``lm_embed_index`` trains to the reference's loss and
table, and its index over that table prints what the reference's does.
The six example modules import neither ``jax`` nor ``repro``, and without
``--device cpu`` each refuses to run."""

import dataclasses
import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import IndexConfig, get_arch, smoke_config
from repro.core.builder import build_scalegann
from repro.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro.data.synthetic import exact_ground_truth, recall_at
from repro.models.model import build_model, loss_fn
from repro.search import search
from repro.train import checkpoint as ref_ckpt
from repro.train.optimizer import for_config
from repro.train.train_step import (TrainConfig, init_train_state,
                                    make_train_step)

REPO = Path(__file__).resolve().parents[1]
# torch threads of an example's process: the suite runs files on
# several workers at once, and a process per core each would
# oversubscribe the host many times over
THREADS = "2"
EXAMPLES = ("quickstart", "serve_ann", "build_spot_index", "lm_embed_index",
            "train_lm", "serve_lm")


ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="",
           OMP_NUM_THREADS=THREADS)


def start(name, *args):
    """``python -m repro_torch.examples.<name> *args`` with no card
    visible, started (the caller collects it)."""
    return subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=REPO)


def run(name, *args, timeout=300):
    """``start`` and wait: (exit code, stdout, stderr)."""
    p = start(name, *args)
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        p.kill()
    return p.returncode, out, err


def reference_hundred_m_config(arch: str):
    """``hundred_m_config`` of the reference script ``examples/train_lm.py``
    (loaded from its file: ``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", REPO / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.hundred_m_config(arch)


def final_loss(out: str) -> float:
    return float(out.split("done: final loss")[1].split()[0])


def test_lm_embed_index():
    rc, out, err = run("lm_embed_index", "--device", "cpu")
    assert rc == 0, err[-3000:]
    assert "LM trained 60 steps" in out
    assert "embedding table: (4096, 128)" in out
    assert "recall@10" in out
    recall = float(out.split("recall@10 = ")[1].split()[0])
    assert recall > 0.8, out


def test_train_lm_resumes(tmp_path):
    args = ("--device", "cpu", "--batch", "2", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3")
    rc, out, err = run("train_lm", "--steps", "6", *args)
    assert rc == 0, err[-3000:]
    assert "checkpoint →" in out
    assert "done: final loss" in out
    assert "resumed" not in out
    rc, out, err = run("train_lm", "--steps", "9", *args)
    assert rc == 0, err[-3000:]
    assert "resumed from step 6" in out
    assert f"checkpoint → {tmp_path / 'step_00000009'}" in out
    assert math.isfinite(final_loss(out))

    # the port's checkpoint is the reference's layout: the reference's
    # restore takes it into its own model's tree, leaf paths and all
    like = build_model(
        reference_hundred_m_config("tinyllama_1_1b")).abstract_params()
    step, tree, manifest = ref_ckpt.restore_latest(str(tmp_path), like)
    assert step == 9
    assert ([m["path"] for m in manifest["leaves"]]
            == [p for p, _ in ref_ckpt._leaf_paths(like)])
    assert all(m["dtype"] == "float32" for m in manifest["leaves"])
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(like)


def test_train_lm_resumes_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference wrote (its model's parameters at step 3)
    resumes the port's training: the loss the port prints for step 4 is
    the reference's loss of those parameters on the pipeline's batch 3
    (two microbatches of one row, averaged, as the step takes them), to
    2e-3.  Both compute in bf16 and differ by ~1e-4 here, and the print
    rounds to 5e-5; a copy that skipped the checkpoint, swapped the gate
    and up projections or reversed the layers moves the loss by 0.09 to
    0.46."""
    cfg = reference_hundred_m_config("tinyllama_1_1b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    ref_ckpt.save(str(tmp_path), 3, params,
                  metadata={"arch": "tinyllama_1_1b"})
    port = start("train_lm", "--device", "cpu", "--steps", "4",
                 "--batch", "2", "--seq", "64", "--ckpt-dir", str(tmp_path))
    try:
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=64, global_batch=2))
        pipe.seek(3)
        batch = pipe.next_batch()
        loss = jax.jit(lambda p, mb: loss_fn(cfg, p, mb)[0])
        want = sum(float(loss(params, {k: jnp.asarray(v[i:i + 1])
                                       for k, v in batch.items()}))
                   for i in range(2)) / 2
        out, err = port.communicate(timeout=300)
    finally:
        port.kill()
    assert port.returncode == 0, err[-3000:]
    assert "resumed from step 3" in out
    assert abs(final_loss(out) - want) <= 2e-3, (final_loss(out), want)


# lm_embed_index with two entry points of its module replaced: the LM
# starts from the checkpoint in argv[1] (the reference's init) instead of
# the port's seed-0 init, and the table handed to the index build is also
# saved to argv[2]; the rest of the module runs as it is
FROM_REFERENCE_INIT = """
import sys

import numpy as np

from repro_torch.examples import lm_embed_index as ex
from repro_torch.models.model import param_tree, params_module, stacked_tree
from repro_torch.train import checkpoint as ckpt

ckpt_dir, table_path = sys.argv[1:3]
init_train_state, build_scalegann = ex.init_train_state, ex.build_scalegann


def from_checkpoint(model, opt, seed, tcfg, *, device):
    state = init_train_state(model, opt, seed, tcfg, device=device)
    like = stacked_tree(model.cfg, param_tree(state.params))
    _, tree, _ = ckpt.restore_latest(ckpt_dir, like)
    return init_train_state(model, opt, tcfg=tcfg, params=params_module(
        model.cfg, tree, requires_grad=True))


def build_and_keep(table, *args, **kwargs):
    np.save(table_path, table)
    return build_scalegann(table, *args, **kwargs)


ex.init_train_state, ex.build_scalegann = from_checkpoint, build_and_keep
raise SystemExit(ex.main(["--device", "cpu"]))
"""


def reference_lm_embed_training():
    """The reference script's steps 1-2: its init, and the loss and
    embedding table after its 60 steps."""
    cfg = dataclasses.replace(
        smoke_config(get_arch("granite_3_2b")), vocab_size=4096,
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    )
    model = build_model(cfg)
    opt = for_config(cfg.optimizer)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, microbatch=4)
    state = init_train_state(model, opt, jax.random.PRNGKey(0), tcfg)
    init = state.params
    step = jax.jit(make_train_step(model, opt, tcfg))
    pipe = TokenPipeline(TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                             seq_len=128, global_batch=8))
    for _ in range(60):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                      pipe.next_batch().items()})
    table = np.asarray(state.params["embed"]["table"], np.float32)
    return (cfg, init, float(metrics["loss"]), table[: cfg.vocab_size],
            np.asarray(init["embed"]["table"], np.float32)[: cfg.vocab_size])


def reference_index_lines(table: np.ndarray) -> list[str]:
    """The reference script's steps 3-4 on ``table``, as it prints them."""
    icfg = IndexConfig(n_clusters=6, degree=16, build_degree=32,
                       block_size=1024)
    res = build_scalegann(table, icfg, n_workers=2)
    rng = np.random.default_rng(0)
    probe_ids = rng.choice(len(table), 32, replace=False)
    queries = table[probe_ids] + 0.005 * rng.normal(
        size=(32, table.shape[1])).astype(np.float32)
    gt = exact_ground_truth(table, queries, 10)
    ids, stats = search(res.index, queries, 10, data=table, backend="jax",
                        width=96)
    hit1 = np.mean([probe_ids[i] in ids[i] for i in range(32)])
    return [f"replicas {res.stats['replica_proportion']:.1%}",
            f"recall@10 = {recall_at(ids, gt, 10):.3f} "
            f"({stats.n_distance_computations/32:.0f} dists/query)",
            f"self-token found for {hit1:.0%} of probes"]


def test_lm_embed_index_from_the_reference_init(tmp_path):
    """From the reference's init, the port's 60 steps end at the
    reference's loss (printed to 3 decimals; the two differ by ~1e-4 here,
    bf16 compute) and table: the table's distance from the reference's is
    at most 2% of how far training moved it (~0.3% here).  The index over
    the port's table then prints what the reference's index over that
    same table prints: replica share, recall, distances, self-token
    hits."""
    table_path = tmp_path / "table.npy"
    cfg, init, want_loss, want_table, init_table = \
        reference_lm_embed_training()
    ref_ckpt.save(str(tmp_path / "init"), 0, init)
    p = subprocess.Popen(
        [sys.executable, "-c", FROM_REFERENCE_INIT, str(tmp_path / "init"),
         str(table_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=ENV, cwd=REPO)
    try:
        out, err = p.communicate(timeout=300)
    finally:
        p.kill()
    assert p.returncode == 0, err[-3000:]
    loss = float(out.split("LM trained 60 steps, loss ")[1].split()[0])
    assert abs(loss - want_loss) <= 2e-3, (loss, want_loss)
    table = np.load(table_path)
    assert table.shape == want_table.shape == (cfg.vocab_size, 128)
    moved = np.linalg.norm(want_table - init_table)
    assert moved > 0
    assert np.linalg.norm(table - want_table) <= 0.02 * moved
    for line in reference_index_lines(table):
        assert line in out, f"missing {line!r} in\n{out}"


def test_serve_lm():
    rc, out, err = run("serve_lm", "--device", "cpu", "--requests", "2",
                       "--max-new", "4")
    assert rc == 0, err[-3000:]
    assert "served 2 requests" in out
    assert out.count("→ 4 tokens") == 2


def test_examples_import_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {EXAMPLES!r}:\n"
        "    importlib.import_module('repro_torch.examples.' + name)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["lm_embed_index", "train_lm", "serve_lm"])
def test_refuses_to_run_without_a_card(name):
    """The default ``--device cuda`` raises when no card is visible: no
    line of the example is printed and the exit code is non-zero."""
    rc, out, err = run(name, timeout=120)
    assert rc != 0
    assert out == ""
    assert "CUDA" in err
