"""One run of one cell: find its configuration, traffic mix, limits and
metric readers by the names in ``BENCHMARK.json``, set up from the seed,
measure the window, judge what it produced against the reference, and
assemble the result line."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from annbench import devtrace, drivers
from repro_torch import kernels
from repro_torch.telemetry import NULL_TRACER, Tracer, use_tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or of the file of
    the name's part before its first dot: a quantity split by the
    end-to-end metric it moves (``idle_share.build``) has one reader."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"annbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {metric!r}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def judged(values: dict, lims: dict) -> tuple:
    """``(all within their limits, {name: {value, limit, ok}})``; every
    number judged needs a limit."""
    out, ok = {}, True
    for name, value in values.items():
        lim = lims[name]
        if "max" in lim:
            good = value <= lim["max"]
            shown = {"value": value, "max": lim["max"], "ok": good}
        else:
            good = value >= lim["min"]
            shown = {"value": value, "min": lim["min"], "ok": good}
        out[name] = shown
        ok = ok and good
    return ok, out


def finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             bench: dict | None = None, cfg: dict | None = None,
             mix: dict | None = None) -> dict:
    """Run cell ``name`` once and return its result line as a dict.
    ``cfg`` and ``mix`` stand in for the cell's configuration and traffic
    files (the tests run cells at tiny sizes on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark() if bench is None else bench
    cell = workload(bench, name)
    cfg = config(bench, cell["config"]) if cfg is None else cfg
    mix = traffic(cell["traffic"]) if mix is None else mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tracer = Tracer(clock=time.monotonic) if trace else None
    drv = drivers.KINDS[mix["kind"]](cfg, mix, seed, dev, tracer=tracer)
    drv.setup(seconds)
    drivers.sync(dev)
    setup_s = time.perf_counter() - t_start

    kernels.reset_counts()
    offset = devtrace.wall_minus_monotonic_ns()
    with use_tracer(tracer or NULL_TRACER), \
            devtrace.profiled(trace and cuda) as prof:
        t0 = time.time_ns()
        window = drv.window(seconds, tracer or NULL_TRACER)
        t1 = time.time_ns()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    readings = drv.readings
    if trace:
        spans = devtrace.tracer_spans(tracer, offset)
        readings["spans"] = [s for s in spans if s[2] > t0 and s[1] < t1]
        readings["event_s"] = drv.events.seconds()
        if prof is not None:
            readings["device"] = devtrace.summarize(prof, t0, t1,
                                                    readings["spans"])
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = drv.judge()
    ok, checks = judged(values, limits(name))
    correct = bool(ok and drv.failed == 0 and drv.attempted > 0)

    metrics = {}
    for m in metrics_of(bench, name, trace):
        if trace:
            v = reader(m["name"])(readings)
        elif m["name"] == "setup_s":
            v = setup_s
        elif m["name"] in values:
            v = values[m["name"]]
        else:
            v = window.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    info = {k: v for k, v in window.items() if k not in metrics}
    info["setup_s"] = setup_s
    result = {
        "correct": correct, "attempted": drv.attempted,
        "failed": drv.failed, "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": peak,
        },
    }
    summary = readings.get("device")
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        info["profiler_events"] = summary["n_events"]
        info["beam_kernels_traced"] = summary["beam_kernels"]
        info["launches_counted"] = launches
    if readings.get("event_s"):
        info["cuda_event_s"] = sum(readings["event_s"])
    result["info"] = info
    result["checks"] = checks
    return finite(result)
