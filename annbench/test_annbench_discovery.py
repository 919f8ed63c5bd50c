"""Every configuration, traffic mix, limit and metric reader that
``BENCHMARK.json`` names is found by its name, and the file keeps to the
benchmark's contract."""

import re
import shutil
import subprocess
import sys

import pytest

from annbench import drivers, harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_stays_inside_paths():
    cmd = BENCH["command"]
    assert len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and ".." not in word
        assert not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (harness.ROOT / word).exists()


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_found_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and len(c["source"]) <= 200
    assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    cfg = harness.config(BENCH, c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert NAME.match(key) and cfg[key] != cfg["published"][key]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_is_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    harness.config(BENCH, w["config"])
    mix = harness.traffic(w["traffic"])
    assert mix["kind"] in drivers.KINDS
    lims = harness.limits(w["name"])
    assert {"invalid_ids", "order_gap", "recall_at_10"} <= set(lims)
    for lim in lims.values():
        assert len(lim) == 1 and set(lim) <= {"max", "min"}
    e2e = [m["name"] for m in harness.metrics_of(BENCH, w["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, w["name"], True)


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert callable(harness.reader(m["name"]))
    moved = E2E[m["moves"]]
    for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        assert cell in moved.get("workloads", [cell])
    # a reader that finds nothing to read returns nothing
    assert harness.reader(m["name"])({"spans": []}) is None


def test_run_refuses_without_a_card_or_a_program(tmp_path):
    """Here there is no card: no result, a non-zero exit.  A directory
    holding only BENCHMARK.json and the benchmark's paths has no program:
    no result, a non-zero exit."""
    import torch

    args = ["--workload", BENCH["workloads"][0]["name"], "--seed",
            str(2**31 + 9), "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "annbench/run.py", *args],
                             cwd=harness.ROOT, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == ""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(harness.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      ".cache"))
    out = subprocess.run([sys.executable, "annbench/run.py", *args],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
