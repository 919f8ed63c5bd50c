"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``) in a
subprocess with no card, as ``tests/test_dryrun.py`` runs the reference's:
two cells counted on both production meshes, the skip rule, and no JAX
loaded; parameter counts held to the reference's models."""

import json
import os
import subprocess
import sys
import tempfile

import pytest

from repro.configs.base import get_arch as jget_arch
from repro.models.model import build_model as jbuild_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("XLA_FLAGS", None)
    return env


def _run(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=REPO,
    )


@pytest.mark.parametrize("arch,shape", [
    ("tinyllama_1_1b", "decode_32k"),   # dense serve_step
    ("rwkv6_1_6b", "long_500k"),        # recurrent-state 500k decode
])
def test_dryrun_cell_counts(arch, shape):
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "r.json")
        p = _run(["--arch", arch, "--shape", shape, "--mesh", "both",
                  "--out", out, "--quiet"])
        assert p.returncode == 0, p.stderr[-2000:]
        results = json.load(open(out))
    ok = [r for r in results if r.get("status") == "ok"]
    assert len(ok) == 2  # single + multi pod
    jm = jbuild_model(jget_arch(arch), max_seq_len=1)
    for r in ok:
        assert r["n_devices"] in (256, 512)
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert r["per_device_flops"] == r["flops"] / r["n_devices"]
        assert r["n_params"] == jm.n_params
        assert r["n_active_params"] == jm.n_active_params()
        assert r["memory"]["argument_bytes"] > 0
        assert r["collectives"] is None and r["compile_s"] is None
    single, multi = sorted(ok, key=lambda r: r["n_devices"])
    assert single["flops"] == multi["flops"]  # one global count a cell
    # the 512-device mesh holds each sharded leaf in half the bytes or less
    assert multi["memory"]["argument_bytes"] <= \
        single["memory"]["argument_bytes"]


def test_dryrun_skip_rule():
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "r.json")
        p = _run(["--arch", "phi3_mini_3_8b", "--shape", "long_500k",
                  "--mesh", "single", "--out", out, "--quiet"])
        assert p.returncode == 0, p.stderr[-2000:]
        results = json.load(open(out))
    assert results[0]["status"] == "skipped"
    assert "sub-quadratic" in results[0]["reason"]


def test_dryrun_loads_no_jax():
    script = (
        "import sys, tempfile, os\n"
        "from repro_torch.launch import dryrun\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    rc = dryrun.main(['--arch', 'jamba_v0_1_52b', '--shape',\n"
        "                      'long_500k', '--mesh', 'single', '--out',\n"
        "                      os.path.join(d, 'r.json'), '--quiet'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print('RC', rc, 'FOREIGN', bad)\n")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, env=_env(), cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "RC 0 FOREIGN []" in p.stdout, p.stdout[-2000:]
