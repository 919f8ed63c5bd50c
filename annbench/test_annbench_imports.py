"""What the benchmark loads: neither JAX nor the JAX package, whole
top-level names compared; and a reference that loads nothing of the
program."""

import json
import subprocess
import sys

from annbench import harness

RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(2)
import annbench.calibrate, annbench.run  # noqa: F401
from annbench import harness, tiny
for m in harness.load_benchmark()["per_layer"]:
    harness.reader(m["name"])
for cell in tiny.CELLS:
    assert tiny.run(cell, seconds=0.3)["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    tops = loaded(RUN_TINY.format(root=str(harness.ROOT),
                                  src=str(harness.ROOT / "src")))
    assert "repro_torch" in tops and "annbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded(
        f"import json, sys; sys.path[:0] = [{str(harness.ROOT)!r}]\n"
        "import annbench.reference.exact, annbench.reference.graph\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "annbench" in tops
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
