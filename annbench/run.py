#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card and print its result.

    python3 annbench/run.py --workload sift.search --seed 12345 \
        --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is the
result (one JSON object); the last lines of standard error are the numbers
judged for ``correct``, each beside its limit.  Without a card, or with
fewer cards than the cell asks for, or outside a checkout that holds the
program, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program at {ROOT / 'src' / 'repro_torch'}: run from a "
              "checkout of the repository", file=sys.stderr)
        return 4
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cache = ROOT / "annbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from annbench import harness

    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: neither JAX nor the JAX package may "
              "run beside the port", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        side = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        print(f"check {name} {c['value']} {side} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
