"""Cells cut to a size the CPU runs in a second, for the tests: the same
files, traffic kinds, limits and judging, with fewer and narrower points,
and as many rows judged a batch and a job as the cell judges."""

from annbench import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell: str) -> tuple:
    """``(cfg, mix)`` of ``cell`` at a tiny size."""
    w = harness.workload(BENCH, cell)
    cfg = harness.config(BENCH, w["config"])
    cfg = dict(cfg, n=3000, dim=32, index_config=dict(
        cfg["index_config"], n_clusters=4, degree=16, build_degree=32,
        kmeans_sample=3000, block_size=512))
    mix = dict(harness.traffic(w["traffic"]))
    mix.update(job_n=2000, jobs_drawn=2, recall_queries=200, batch=128)
    mix["search"] = dict(mix["search"], width=32)
    return cfg, mix


def run(cell: str, *, trace: bool = False, seconds: float = 0.5,
        seed: int = 2**31 + 77) -> dict:
    cfg, mix = tiny(cell)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            bench=BENCH, cfg=cfg, mix=mix)
