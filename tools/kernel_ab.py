#!/usr/bin/env python3
"""Time K3 (fused beam search) and K6 (flash decode) of this checkout
against the same kernels of other checkouts, on one NVIDIA H100.

    python3 tools/kernel_ab.py --base NAME=DIR [--base NAME=DIR ...]
                               [--n 1000000] [--queries 10000]

Each DIR is the root of another checkout of the repo (a commit unpacked
with ``git archive`` into an ignored directory, say).  Its ``attention.cu``
and ``beam.cu`` are built with this checkout's ``nvcc`` flags into its own
``build/repro_torch_kernels``, and its wrappers (``kernels/beam.py``,
``kernels/flash_attention.py``) are loaded beside this checkout's and bound
to those libraries.  All variants run in one process on one card, in the
order a, b, ..., b, a, and each figure is printed as its two readings.

K6: bf16 q [8,32,64] against a [8,4,2048,64] cache with every row at 1043
(the LM path's longest length) and at 2048: device time per launch from a
CUDA graph of 50 launches, time per call from CUDA events around 50 calls
back to back (the wrapper's host work included), and the kernel's own
time from CUDA events recorded around the library call alone.

K3: this checkout's ANN main path (``chip_smoke.main_path``) runs once with
K3's launches tallied by shape; then every variant runs each launch shape
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


class _Library:
    def __init__(self, path: Path, name: str, torch):
        self._lib = ctypes.CDLL(str(path))
        self._entry = ENTRY[name]
        self.timed = _Timed(getattr(self._lib, self._entry), torch)

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
    """Start one ``nvcc`` per source of K3 and K6 of the checkout at
    ``root``; returns [(name, output, process)]."""
    out_dir = root / "build" / "repro_torch_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in ("attention", "beam"):
        out = out_dir / f"lib{name}-ab.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
               str(root / KERNELS / "csrc" / f"{name}.cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def load_variant(tag: str, root: Path, procs, build, torch):
    """The variant's beam and flash_attention modules, bound to its
    freshly built libraries, and the timed entry points of K3 and K6."""
    paths = {}
    for name, out, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {root}/{name}.cu:\n{text}")
        paths[name] = out
    shim = _Libraries(paths, build.check, torch)
    mods = {}
    for name in ("beam", "flash_attention"):
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


def k3_ab(torch, smoke, variants, args):
    names = list(variants)
    with smoke.k3_tally() as (shapes, first):
        smoke.main_path(torch, args)
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
    k6_ab(torch, smoke, variants)
    k3_ab(torch, smoke, variants, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
