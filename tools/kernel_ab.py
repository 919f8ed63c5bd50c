#!/usr/bin/env python3
"""Time K1 and K2 (distance tiles), K3 (fused beam search) and K6 (flash
decode) of this checkout against the same kernels of other checkouts, on
one NVIDIA H100.

    python3 tools/kernel_ab.py --base NAME=DIR [--base NAME=DIR ...]
                               [--kernels k1,k2,k3,k6]
                               [--n 1000000] [--queries 10000]

Each DIR is the root of another checkout of the repo (a commit unpacked
with ``git archive`` into an ignored directory, say).  Its
``distance.cu``, ``attention.cu`` and ``beam.cu`` are built with this
checkout's ``nvcc`` flags into its own ``build/repro_torch_kernels``, and
its wrappers (``kernels/distance.py``, ``kernels/beam.py``,
``kernels/flash_attention.py``) are loaded beside this checkout's and
bound to those libraries.  All variants run in one process on one card, in
the order a, b, ..., b, a, and each figure is printed as its two readings.

This checkout's ANN main path (``chip_smoke.main_path``) runs once first,
with K1's and K3's launches tallied by shape, when K1 or K3 is asked for.

K1 and K2: at the main path's shapes (K1: every operand shape of that run,
with its launches there; K2: the [10000,128] x [16,128] uint8 routing
tile, L2 and IP): device time per launch from a CUDA graph whose
launches cycle through fresh operands totalling more than the 50 MB L2
(cold, as the partition's blocks are), and time per call from CUDA events
around 50 calls back to back (the wrapper's host work included); an empty
kernel's graph time is printed as the launch floor, and at M >= 8192 a
library reduction over the same operands (``q.sum(dim=1)``) as a yardstick
of the read bandwidth such a pass reaches.  Launches x graph time are
summed over K1's shapes.

K6: bf16 q [8,32,64] against a [8,4,2048,64] cache with every row at 1043
(the LM path's longest length) and at 2048: device time per launch from a
CUDA graph of 50 launches, time per call from CUDA events around 50 calls
back to back (the wrapper's host work included), and the kernel's own
time from CUDA events recorded around the library call alone.

K3: every variant runs each launch shape of the main path's run
on the inputs of its first launch: time per call from CUDA events (the
wrapper included, with any check it makes on the host), the kernel's own
time from CUDA events around the library call alone, and its ids and
counters against this checkout's.  Sums of launches x kernel time are
printed by range of Q.  This checkout is loaded and built the same way as
the others, so every variant runs the same path.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = "src/repro_torch/kernels"


def log(msg: str) -> None:
    print(msg, flush=True)


class _Timed:
    """A kernel's entry point in a variant's library.  While ``on`` is set,
    each call is bracketed by CUDA events on the current stream (the stream
    the wrapper launches on), so the pair times the launch alone."""

    def __init__(self, fn, torch):
        self.__dict__.update(_fn=fn, _torch=torch, on=False, events=[])

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        if name in ("on", "events"):
            self.__dict__[name] = value
        else:
            setattr(self._fn, name, value)  # argtypes, restype

    def __call__(self, *args):
        if not self.on:
            return self._fn(*args)
        start = self._torch.cuda.Event(enable_timing=True)
        end = self._torch.cuda.Event(enable_timing=True)
        start.record()
        rc = self._fn(*args)
        end.record()
        self.events.append((start, end))
        return rc


ENTRY = {"attention": "repro_flash_decode", "beam": "repro_fused_beam"}
SOURCES = ("distance", "attention", "beam")
WRAPPERS = {"distance": "distance", "attention": "flash_attention",
            "beam": "beam"}


class _Library:
    def __init__(self, path: Path, name: str, torch):
        self._lib = ctypes.CDLL(str(path))
        self._entry = ENTRY.get(name)
        self.timed = (_Timed(getattr(self._lib, self._entry), torch)
                      if self._entry else None)

    def __getattr__(self, attr):
        return self.timed if attr == self._entry else getattr(self._lib, attr)


class _Libraries:
    """Stands in for ``repro_torch.kernels._build`` inside a loaded
    wrapper: the libraries come from the variant's build, and launches are
    not counted."""

    def __init__(self, paths: dict, check, torch):
        self.libs = {name: _Library(path, name, torch)
                     for name, path in paths.items()}
        self.check = check

    def library(self, name: str):
        return self.libs[name]

    def count(self, name: str) -> None:
        pass


def start_build(root: Path, build):
    """Start one ``nvcc`` per source of K1/K2, K3 and K6 of the checkout
    at ``root``; returns [(name, output, process)]."""
    out_dir = root / "build" / "repro_torch_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = out_dir / f"lib{name}-ab.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
               str(root / KERNELS / "csrc" / f"{name}.cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def load_variant(tag: str, root: Path, procs, build, torch):
    """The variant's distance, beam and flash_attention modules, bound to
    its freshly built libraries, and the timed entry points of K3 and K6."""
    paths = {}
    for name, out, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {root}/{name}.cu:\n{text}")
        paths[name] = out
    shim = _Libraries(paths, build.check, torch)
    mods = {}
    for name in WRAPPERS.values():
        spec = importlib.util.spec_from_file_location(
            f"_ab_{tag}_{name}", root / KERNELS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._build = shim
        mods[name] = mod
    mods["k6"] = shim.libs["attention"].timed
    mods["k3"] = shim.libs["beam"].timed
    return mods


def kernel_ms(torch, fn, timed: _Timed, reps: int = 3) -> float:
    """Mean time of the library call alone over ``reps`` calls of ``fn``,
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    timed.on, timed.events = True, []
    try:
        for _ in range(reps):
            fn()
    finally:
        timed.on = False
    torch.cuda.synchronize()
    if len(timed.events) != reps:
        raise RuntimeError(f"{len(timed.events)} launches timed, {reps} calls")
    return sum(a.elapsed_time(b) for a, b in timed.events) / reps


def pair(vals) -> str:
    return " / ".join(f"{v:.5f}" for v in vals)


def k12_ab(torch, smoke, variants, which, k1_shapes):
    """K1 at each operand shape of the main path's run and K2 at the
    routing tile, every variant: graph time over cold operands, time a
    call, agreement with this checkout's plain version."""
    names = list(variants)
    g = torch.Generator(device="cuda").manual_seed(9)
    log(f"launch floor (empty kernel, CUDA graph): "
        f"{smoke.launch_floor_ms(torch):.5f} ms")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "uint8": torch.uint8}
    cases = []
    if "k1" in which:
        cases += [("K1", m, n, d, dt, metric, launches) for
                  (m, n, d, dt, metric, _), launches in
                  k1_shapes.most_common()]
    if "k2" in which:
        cases += [("K2", 10000, 16, 128, "uint8", metric, 0)
                  for metric in ("l2", "ip")]
    sums = {n: 0.0 for n in names}
    plain = variants["this"]["distance"]
    for kern, m, n_x, d, dt, metric, launches in cases:
        dtype = dtypes[dt]
        u8 = dtype == torch.uint8

        def make(rows, u8=u8, d=d, dtype=dtype):
            if u8:
                return torch.randint(0, 256, (rows, d), device="cuda",
                                     generator=g, dtype=torch.uint8)
            return torch.randn(rows, d, device="cuda",
                               generator=g).to(dtype)

        x = make(n_x)
        qs, cold = smoke.copies_for(torch, lambda: make(m),
                                    m * d * dtype.itemsize)
        got = {n: {"graph": [], "call": []} for n in names}
        errs = {}
        for n in names + names[::-1]:
            mod = variants[n]["distance"]
            if u8:
                def fn(a, mod=mod):
                    return mod.pairwise_distance_u8_cuda(a, x, 0.0371, -4.25,
                                                         metric)
                want = plain.pairwise_distance_u8_plain(qs[0], x, 0.0371,
                                                        -4.25, metric)
            else:
                def fn(a, mod=mod):
                    return mod.pairwise_distance_cuda(a, x, metric)
                want = plain.pairwise_distance_plain(qs[0], x, metric)
            errs[n] = float((fn(qs[0]) - want).abs().max())
            got[n]["graph"].append(smoke.cold_graph_ms(
                torch, fn, [(a,) for a in qs]))
            got[n]["call"].append(smoke.events_ms(torch, lambda: fn(qs[0]),
                                                  reps=50))
        if not u8 and m >= 8192:
            # a read-bandwidth yardstick on the same operands: one library
            # reduction that reads each row once (not K1's function)
            ys = smoke.cold_graph_ms(torch, lambda a: a.sum(dim=1),
                                     [(a,) for a in qs])
            log(f"yardstick q.sum(dim=1) [{m},{d}] {dt}: graph_ms={ys:.5f} "
                f"({m * d * dtype.itemsize / ys / 1e9:.2f} TB/s)")
        for n in names:
            r = got[n]
            graph = sum(r["graph"]) / len(r["graph"])
            sums[n] += launches * graph
            log(f"{kern} {dt} {metric} [{m},{d}]x[{n_x},{d}] "
                f"launches={launches} {n}: "
                f"graph_ms={pair(r['graph'])} ({'cold' if cold else 'warm'} "
                f"L2) per_call_ms={pair(r['call'])} "
                f"max_abs_err={errs[n]:.3e}")
        del qs
    if "k1" in which:
        for n in names:
            log(f"K1 main path all {n}: launches="
                f"{sum(k1_shapes.values())} sum_graph_ms={sums[n]:.4f}")


def k6_ab(torch, smoke, variants):
    names = list(variants)
    g = torch.Generator(device="cuda").manual_seed(2)
    b, h, hkv, t, dh = 8, 32, 4, 2048, 64
    q = torch.randn(b, h, dh, device="cuda", generator=g).bfloat16()
    kc = torch.randn(b, hkv, t, dh, device="cuda", generator=g).bfloat16()
    vc = torch.randn(b, hkv, t, dh, device="cuda", generator=g).bfloat16()
    for fill in (1043, 2048):
        lens = torch.full((b,), fill, dtype=torch.int32, device="cuda")
        want = variants["this"]["flash_attention"].flash_decode_plain(
            q, kc, vc, lens).float()
        got = {n: {"graph": [], "call": [], "kernel": []} for n in names}
        errs = {}
        for n in names + names[::-1]:
            dec = variants[n]["flash_attention"].flash_decode_cuda

            def fn(dec=dec):
                return dec(q, kc, vc, lens)

            errs[n] = float((fn().float() - want).abs().max())
            got[n]["graph"].append(smoke.graph_ms(torch, fn))
            got[n]["call"].append(smoke.events_ms(torch, fn, reps=50))
            got[n]["kernel"].append(kernel_ms(torch, fn, variants[n]["k6"],
                                              reps=20))
        for n in names:
            r = got[n]
            log(f"K6 bf16 q[{b},{h},{dh}] cache[{b},{hkv},{t},{dh}] "
                f"lens={fill} {n}: graph_ms={pair(r['graph'])} "
                f"per_call_ms={pair(r['call'])} "
                f"kernel_ms={pair(r['kernel'])} max_abs_err={errs[n]:.2e}")


def k3_ab(torch, smoke, variants, shapes, first):
    names = list(variants)
    sums = {}
    for key in sorted(shapes, key=lambda k: (*k[:3], k[3] or 0)):
        launches = shapes[key]
        largs, kw = first[key]
        want = variants["this"]["beam"].fused_beam_cuda(*largs, **kw)
        got = {n: {"call": [], "kernel": []} for n in names}
        agree = {}
        for n in names + names[::-1]:
            run = variants[n]["beam"].fused_beam_cuda

            def fn(run=run):
                return run(*largs, **kw)

            out = fn()
            ids = float((out[0] == want[0]).float().mean())
            stats = float(((out[2] == want[2]) & (out[3] == want[3])
                           & (out[4] == want[4])).float().mean())
            agree[n] = (ids, stats)
            got[n]["call"].append(smoke.events_ms(torch, fn, reps=3))
            got[n]["kernel"].append(kernel_ms(torch, fn, variants[n]["k3"]))
        q_n = key[0]
        rng = ("Q <= 64" if q_n <= 64 else "64 < Q <= 512" if q_n <= 512
               else "512 < Q <= 2560" if q_n <= 2560 else f"Q = {q_n}")
        for n in names:
            r = got[n]
            kern = sum(r["kernel"]) / len(r["kernel"])
            acc = sums.setdefault((rng, n), [0, 0.0])
            acc[0] += launches
            acc[1] += launches * kern
            log(f"K3 Q={q_n} {key[1]} k={key[2]} rerank={key[3]} "
                f"launches={launches} {n}: per_call_ms={pair(r['call'])} "
                f"kernel_ms={pair(r['kernel'])} ids_equal={agree[n][0]:.6f} "
                f"stats_equal={agree[n][1]:.6f}")
    for (rng, n), (launches, total) in sums.items():
        log(f"K3 main path {rng} {n}: launches={launches} "
            f"sum_kernel_ms={total:.3f}")
    for n in names:
        total = sum(t for (_, m), (_, t) in sums.items() if m == n)
        log(f"K3 main path all {n}: sum_kernel_ms={total:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout to compare")
    ap.add_argument("--kernels", default="k1,k2,k3,k6",
                    help="comma-separated subset of k1,k2,k3,k6")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as smoke
    from repro_torch.kernels import _build

    bases = [("this", ROOT)]
    for spec in args.base:
        tag, _, path = spec.partition("=")
        root = Path(path).resolve()
        if not tag or tag in dict(bases) or not (root / KERNELS).is_dir():
            ap.error(f"--base {spec}: NAME=DIR of another checkout")
        bases.append((tag, root))
    t0 = time.perf_counter()
    builds = [(tag, root, start_build(root, _build)) for tag, root in bases]
    smoke.environment(torch)  # builds the main path's kernels meanwhile
    variants = {tag: load_variant(tag, root, procs, _build, torch)
                for tag, root, procs in builds}
    log(f"variants {list(variants)} built in "
        f"{time.perf_counter() - t0:.1f} s")
    which = set(args.kernels.split(","))
    if which - {"k1", "k2", "k3", "k6"}:
        ap.error(f"--kernels {args.kernels}: a subset of k1,k2,k3,k6")
    k1_shapes = k3_shapes = k3_first = None
    if which & {"k1", "k3"}:
        with smoke.k1_tally() as k1_shapes, \
                smoke.k3_tally() as (k3_shapes, k3_first):
            smoke.main_path(torch, args)
    if which & {"k1", "k2"}:
        k12_ab(torch, smoke, variants, which, k1_shapes)
    if "k6" in which:
        k6_ab(torch, smoke, variants)
    if "k3" in which:
        k3_ab(torch, smoke, variants, k3_shapes, k3_first)
    return 0


if __name__ == "__main__":
    sys.exit(main())
