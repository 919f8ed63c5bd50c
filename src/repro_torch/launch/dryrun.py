"""Dry-run: count every (arch × shape) cell's step and resolve its
shardings on both production meshes (counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step against 512
placeholder CPU devices and reads XLA's analyses.  The port has no
compiler and one card, so for each cell this script:

  1. builds the model and its abstract inputs as ``meta`` tensors
     (shapes and dtypes, nothing allocated — as the reference lowers a
     1T-parameter step on a 1-CPU host); for ``train``, the state of
     ``train_step.state_spec`` (f32 parameters, the optimizer's state);
  2. resolves the state's, batch's and cache's shardings from the
     logical-axis rules on the 16×16 single-pod and the (2, 16, 16)
     multi-pod mesh specs (:mod:`repro_torch.launch.mesh`);
  3. counts the step once with :func:`repro_torch.launch.step_cost.analyze`
     (``make_train_step``, ``prefill_fn`` or ``serve_step_fn`` run on
     ``meta`` under the single-pod mesh's rules; the global count does not
     depend on the mesh; a train step is counted on one microbatch and
     the other microbatches' gradients added, as the reference's count
     multiplies a scan body by its trip count), and writes one row per
     mesh to ``--out``.

It is the one entry point of the port with no device: it runs on the
``meta`` device, needs no card and sets no ``XLA_FLAGS``.

Each row keeps the reference's keys where a counterpart exists: ``arch``,
``shape``, ``mesh``, ``kind``, ``n_devices``, ``n_params``,
``n_active_params``, ``flops`` and ``bytes_accessed`` (the global step's
count; the reference's are per device), ``per_device_flops`` (``flops /
n_devices``), ``status``, ``lower_s`` (model, abstract inputs and
shardings) and ``analyze_s`` (the count, shared by a cell's two rows).
``memory.argument_bytes`` / ``output_bytes`` are each argument's / output's
leaf bytes divided by its shard factor under the resolved specs, per
device (outputs without a sharding of their own, logits, are counted
whole).  These are null, since nothing here compiles or runs on the
meshes: ``collectives`` and ``n_collective_ops`` (one card lowers no
collective; ``step_cost`` says why), ``xla_flops`` / ``xla_bytes`` (no
XLA), ``compile_s`` (no compile), and ``memory.temp_bytes`` /
``peak_bytes`` (no buffer assignment to read them from).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out PATH] [--quiet] [--append]
        [--set KEY=VALUE] [--tag T] [--jobs N]

``--jobs N`` counts N cells at once in processes of their own (the rows
keep the cells' order).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback

import torch

from repro_torch.common import params as par
from repro_torch.configs.base import (SHAPES, SUBQUADRATIC_FAMILIES,
                                     ModelConfig, cells, get_arch)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import step_cost
from repro_torch.launch import specs as lspecs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import param_tree, params_module
from repro_torch.serve.engine import serve_step_fn
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import for_config


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v in ("true", "True"):
        v = True
    elif v in ("false", "False"):
        v = False
    else:
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
    return k, v


def per_device_bytes(tree, shardings=None, dtype=torch.float32) -> int:
    """Leaf bytes over each leaf's shard factor (whole without
    ``shardings``); ``tree`` and ``shardings`` share one structure.  A
    ``P`` declaration that names no dtype takes ``dtype``, as
    ``abstract_params`` makes it."""
    leaves = par.leaves(tree)
    factors = ([s.shard_factor() for s in par.leaves(shardings)]
               if shardings is not None else [1] * len(leaves))
    if len(factors) != len(leaves):
        raise ValueError(f"{len(factors)} shardings for {len(leaves)} leaves")
    return sum(math.prod(x.shape) * (x.dtype or dtype).itemsize // f
               for x, f in zip(leaves, factors))


def _scaled_sum(rest: dict, each: dict, n: int) -> dict:
    """``rest`` plus ``n`` times ``each`` (two ``step_cost`` counts)."""
    kernels = {k: dict(v) for k, v in rest["kernels"].items()}
    for name, k in each["kernels"].items():
        acc = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        for f in acc:
            acc[f] += n * k[f]
    return {"flops": rest["flops"] + n * each["flops"],
            "bytes": rest["bytes"] + n * each["bytes"],
            "collective_bytes": {}, "n_collectives": 0, "kernels": kernels}


def _count_train(model, cfg: ModelConfig, shape, batch_specs: dict, mesh,
                 rules, extra):
    """The train step's count, microbatches counted once: the real step
    (``make_train_step``: splitting, one microbatch's loss, backward and
    remat, compression, clipping, the optimizer) on one microbatch's
    batch, plus ``n - 1`` times one microbatch's
    ``train_step.microbatch_grads`` — the reference's cost model likewise
    counts the scan body once and multiplies it by the trip count.  The
    f32 accumulation of the microbatches' gradients (a zeros, ``n`` adds
    and a division a parameter) is left out of the bytes."""
    opt = for_config(cfg.optimizer)
    tcfg = ts.TrainConfig(microbatch=shape.resolved_microbatch,
                          **(extra or {}))
    params = params_module(cfg, model.abstract_params(torch.float32),
                           requires_grad=True)
    state = ts.init_train_state(model, opt, tcfg=tcfg, params=params)
    mb = tcfg.microbatch
    n_micro = shape.global_batch // mb
    one = {k: torch.empty((mb, *v.shape[1:]), dtype=v.dtype, device="meta")
           for k, v in batch_specs.items()}
    step = ts.make_train_step(model, opt, tcfg)
    got = {}

    def fn(state, batch):
        with shd.use_mesh_rules(mesh, rules):
            got["out"] = step(state, batch)

    first = step_cost.analyze(fn, state, one)
    if n_micro == 1:
        return first, got["out"]
    leaves = par.leaves(param_tree(params))

    def grads(batch):
        with shd.use_mesh_rules(mesh, rules):
            ts.microbatch_grads(model, params, leaves, batch)

    each = step_cost.analyze(grads, one)
    return _scaled_sum(first, each, n_micro - 1), got["out"]


def count_step(cell, cfg: ModelConfig, shape, mesh=None, rules=None,
               extra=None):
    """(step_cost of the cell's step, its outputs, seconds), counted on
    ``meta`` under ``mesh``'s rules (the single-pod mesh by default)."""
    mesh = mesh or make_production_mesh(multi_pod=False)
    model = cell.model
    out = {}
    t0 = time.perf_counter()
    if cell.kind == "train":
        cost, out["value"] = _count_train(model, cfg, shape, cell.batch_specs,
                                          mesh, rules, extra)
    else:
        params = params_module(cfg, model.abstract_params(torch.bfloat16))
        if cell.kind == "prefill":
            def fn(params, batch):
                with torch.no_grad(), shd.use_mesh_rules(mesh, rules):
                    out["value"] = model.prefill_fn(params, batch,
                                                    shape.seq_len)

            cost = step_cost.analyze(fn, params, cell.batch_specs)
        else:
            serve_step = serve_step_fn(model)
            tokens, _ = cell.token_specs

            def fn(params, cache, tokens):
                with torch.no_grad(), shd.use_mesh_rules(mesh, rules):
                    out["value"] = serve_step(params, cache, tokens,
                                              shape.seq_len - 1)

            cost = step_cost.analyze(fn, params, cell.cache_specs, tokens)
    return cost, out["value"], time.perf_counter() - t0


def run_cell(arch_id: str, shape_id: str, *, multi_pod: bool,
             quiet: bool = False, rules=None, extra: dict | None = None,
             overrides: dict | None = None, counted=None):
    """One result row.  ``counted`` is a dict shared by a cell's rows: the
    first row counts the step into it, the others reuse the count."""
    cfg: ModelConfig = get_arch(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_id]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules or shd.DEFAULT_RULES
    t0 = time.perf_counter()
    cell = lspecs.make_cell(cfg, shape)
    model = cell.model

    if cell.kind == "train":
        opt = for_config(cfg.optimizer)
        tcfg = ts.TrainConfig(microbatch=shape.resolved_microbatch,
                              **(extra or {}))
        sspec = ts.state_spec(model, opt, tcfg)
        state_sh = shd.param_shardings(sspec, mesh, rules)
        batch_sh = lspecs.batch_shardings(cell.batch_specs, mesh, rules)
        args_bytes = (per_device_bytes(sspec, state_sh)
                      + per_device_bytes(cell.batch_specs, batch_sh))
        out_bytes = per_device_bytes(sspec, state_sh)
    else:
        params_sh = shd.param_shardings(model.spec, mesh, rules)
        params_bytes = per_device_bytes(model.spec, params_sh,
                                        torch.bfloat16)
        if cell.kind == "prefill":
            batch_sh = lspecs.batch_shardings(cell.batch_specs, mesh, rules)
            args_bytes = params_bytes + per_device_bytes(cell.batch_specs,
                                                         batch_sh)
        else:
            cache_sh = lspecs.cache_shardings(cell.cache_specs, mesh, rules)
            tok_spec, pos_spec = cell.token_specs
            tok_sh = shd.batch_sharding(mesh, tuple(tok_spec.shape), rules)
            args_bytes = (params_bytes
                          + per_device_bytes(cell.cache_specs, cache_sh)
                          + per_device_bytes(tok_spec, tok_sh)
                          + per_device_bytes(pos_spec))
    lower_s = time.perf_counter() - t0

    if counted is None:
        counted = {}
    if "cost" not in counted:
        counted["cost"], counted["out"], counted["s"] = count_step(
            cell, cfg, shape, rules=rules, extra=extra)
    cost = counted["cost"]
    if cell.kind != "train":
        logits, cache = counted["out"]
        out_bytes = (per_device_bytes(logits)
                     + per_device_bytes(cache, lspecs.cache_shardings(
                         cache, mesh, rules)))

    n_dev = mesh.size
    result = {
        "arch": arch_id,
        "shape": shape_id,
        "mesh": "multi" if multi_pod else "single",
        "kind": cell.kind,
        "n_devices": n_dev,
        "n_params": model.n_params,
        "n_active_params": model.n_active_params(),
        # the global step's count (launch/step_cost.py)
        "flops": cost["flops"],
        "per_device_flops": cost["flops"] / n_dev,
        "bytes_accessed": cost["bytes"],
        "kernels": cost["kernels"],
        "collectives": None,
        "n_collective_ops": None,
        "xla_flops": None,
        "xla_bytes": None,
        "memory": {
            "argument_bytes": args_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "peak_bytes": None,
        },
        "lower_s": round(lower_s, 2),
        "compile_s": None,
        "analyze_s": round(counted["s"], 2),
        "status": "ok",
    }
    if not quiet:
        print(
            f"[dryrun] {arch_id:20s} {shape_id:12s} "
            f"{'multi' if multi_pod else 'single':6s} "
            f"flops={result['flops']:.3e} "
            f"args/dev={args_bytes:.3e}B "
            f"lower={lower_s:.1f}s count={counted['s']:.1f}s"
        )
    return result


def _cell_rows(arch_id: str, shape_id: str, meshes: list, quiet: bool,
               overrides: dict, tag) -> list:
    """The rows of one runnable cell, one per mesh (an error row when a
    mesh's row fails); the step is counted once for both."""
    rows = []
    counted: dict = {}
    for multi in meshes:
        try:
            res = run_cell(arch_id, shape_id, multi_pod=multi, quiet=quiet,
                           overrides=overrides, counted=counted)
            if tag:
                res["tag"] = tag
            rows.append(res)
        except Exception as e:
            traceback.print_exc()
            rows.append(
                {"arch": arch_id, "shape": shape_id,
                 "mesh": "multi" if multi else "single",
                 "status": "error", "error": f"{type(e).__name__}: {e}"}
            )
    return rows


def _cell_rows_star(task) -> list:
    return _cell_rows(*task)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing results file")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE",
                    help="ModelConfig overrides, e.g. "
                         "--set attn_seq_shard=true")
    ap.add_argument("--tag", default=None,
                    help="variant tag recorded in the result rows")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, each in a process of its "
                         "own (the counts run on the host's cores)")
    args = ap.parse_args(argv)
    overrides = dict(_parse_override(kv) for kv in args.overrides)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]
    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag")) for r in results
            if r.get("status") == "ok"}

    plan = []  # ("skip", row) or ("cell", task), in the cells' order
    for arch_id, shape_id, runnable, reason in cells():
        if args.arch and arch_id != args.arch:
            continue
        if args.shape and shape_id != args.shape:
            continue
        if not runnable:
            plan.append(("skip", {"arch": arch_id, "shape": shape_id,
                                  "status": "skipped", "reason": reason}))
            continue
        todo = [m for m in meshes if (arch_id, shape_id,
                                      "multi" if m else "single",
                                      args.tag) not in done]
        if todo:
            plan.append(("cell", (arch_id, shape_id, todo, args.quiet,
                                  overrides, args.tag)))
    tasks = [item for kind, item in plan if kind == "cell"]

    with contextlib.ExitStack() as stack:
        if args.jobs > 1 and len(tasks) > 1:
            pool = stack.enter_context(multiprocessing.get_context(
                "spawn").Pool(min(args.jobs, len(tasks))))
            # the slowest counts first (train steps, then the chunked
            # scans of the sub-quadratic families), read back in order
            slow = sorted(range(len(tasks)), key=lambda i: (
                SHAPES[tasks[i][1]].kind != "train",
                get_arch(tasks[i][0]).family not in SUBQUADRATIC_FAMILIES))
            pending = {i: pool.apply_async(_cell_rows_star, (tasks[i],))
                       for i in slow}
            rows_of = (pending[i].get() for i in range(len(tasks)))
        else:
            rows_of = map(_cell_rows_star, tasks)
        for kind, item in plan:
            if kind == "skip":
                results.append(item)
                if not args.quiet:
                    print(f"[dryrun] {item['arch']:20s} {item['shape']:12s} "
                          f"SKIP ({item['reason'][:60]}…)")
            else:
                results.extend(next(rows_of))
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(r.get("status") == "ok" for r in results)
    n_err = sum(r.get("status") == "error" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_err} errors, {n_skip} skipped "
          f"→ {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
