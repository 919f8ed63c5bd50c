"""Each cell's traffic at a tiny size through the program's plain paths on
the CPU: the whole run but the card, judged by the cell's own limits."""

import pytest

from annbench import harness
from annbench.tiny import BENCH, CELLS, run


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace, few_threads):
    r = run(cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"  # the judged numbers come last
    want = {m["name"] for m in harness.metrics_of(BENCH, cell, trace)}
    got = set(r["metrics"])
    if trace:  # the device's readers find nothing to read on the CPU
        want = {m for m in want
                if not m.startswith(("idle_share", "search_roofline"))}
    assert got == want
    for v in r["metrics"].values():
        assert v["value"] > 0

