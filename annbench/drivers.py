"""The two kinds of traffic the benchmark drives, one class each, chosen
by the ``kind`` of a traffic file.  A driver sets up from the seed
(:meth:`setup`), runs the measured window (:meth:`window`), hands over what
the per-layer readers read (:attr:`readings`), frees the program's state
(:meth:`release`) and judges what the window produced against the
reference (:meth:`judge`).  Everything of one configuration, traffic mix or
metric comes in as data; nothing here names a cell."""

from __future__ import annotations

import time

import numpy as np
import torch

from annbench import datagen
from annbench.reference import exact, graph


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class CudaSpans:
    """CUDA events recorded on the current stream around calls, read once
    the window has closed: each call's device-timeline seconds.  Off, a
    call passes straight through."""

    def __init__(self, device, on: bool):
        self.on = on and torch.device(device).type == "cuda"
        self.pairs: list = []

    def around(self, fn, *a, **kw):
        if not self.on:
            return fn(*a, **kw)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        try:
            return fn(*a, **kw)
        finally:
            t1.record()
            self.pairs.append((t0, t1))

    def seconds(self) -> list:
        if self.pairs:
            self.pairs[-1][1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in self.pairs]


class Driver:
    """What the kinds share: the cell's data, the index build and the
    judging of answer lists."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *,
                 tracer=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.tracer = tracer  # the program's tracer in a traced run
        self.trace = tracer is not None
        self.k = int(cfg["k"])
        self.search_kw = dict(traffic["search"])
        self.readings: dict = {"kind": traffic["kind"], "spans": []}
        self.events = CudaSpans(self.device, self.trace)
        self.attempted = self.failed = 0
        self.entries = None  # the last index's search entries
        self.judged = None  # (data, queries, ids) the reference judged

    def build(self, data: np.ndarray):
        from repro_torch.configs.base import IndexConfig
        from repro_torch.core.builder import build_scalegann

        return build_scalegann(data, IndexConfig(**self.cfg["index_config"]),
                               algo=self.traffic.get("algo", "cagra"),
                               device=self.device)

    def search(self, topo, queries: np.ndarray):
        import repro_torch.search as rts

        return rts.search(topo, queries, self.k, device=self.device,
                          **self.search_kw)

    def judge_answers(self, data: np.ndarray, queries: np.ndarray,
                      ids: np.ndarray) -> dict:
        """The reference's numbers for answers ``ids`` to ``queries``."""
        self.judged = (data, queries, ids)
        truth = exact.exact_knn(data, queries, self.k, device=self.device)
        return {
            "invalid_ids": exact.invalid_ids(ids, len(data)),
            "order_gap": exact.order_gap(data, queries, ids,
                                         device=self.device),
            "recall_at_10": exact.recall(ids, truth, self.k),
        }

    def sample_rows(self, n: int, cap: int) -> np.ndarray:
        """A seeded uniform sample of at most ``cap`` of ``n`` rows."""
        if n <= cap:
            return np.arange(n)
        rng = np.random.default_rng(datagen.sub_seed(self.seed, "check"))
        return np.sort(rng.choice(n, cap, replace=False))

    def release(self) -> None:
        pass


class BuildJobs(Driver):
    """A closed loop of whole ``build_scalegann`` jobs, back to back; no job
    starts once the window's seconds have passed, and the window lasts
    until the last job ends.  Set-up draws the vectors of ``jobs_drawn``
    jobs, the configuration's fixed draws 0, 1, ...; job ``j`` of the window
    builds draw ``j`` modulo their number.  Recall is read on the first
    job's index, the one every run builds whatever the number of jobs; the
    partition and graph of every job are checked, and a seeded sample of
    ``check_rows`` rows of each is rebuilt by the reference."""

    def setup(self, seconds: float, *, warm: bool = True) -> None:
        self.n = int(self.traffic["job_n"])
        self.pool = [datagen.job_data(self.cfg, self.n, j)
                     for j in range(int(self.traffic["jobs_drawn"]))]
        if warm:  # the window's shapes: builds, captures, kernels
            self.build(datagen.job_data(self.cfg, self.n, "warm"))
        sync(self.device)

    def window(self, seconds: float, tracer) -> dict:
        self.jobs: list = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            data = self.pool[len(self.jobs) % len(self.pool)]
            self.jobs.append(self.events.around(self.build, data))
        sync(self.device)
        wall = time.perf_counter() - t0
        self.attempted = len(self.jobs)
        return {"build_vps": self.n * len(self.jobs) / wall,
                "window_s": wall}

    def release(self) -> None:
        first = self.jobs[0]
        q = datagen.QueryStream(
            self.cfg, 1, datagen.sub_seed(self.seed, "recall"), self.device)
        self.queries = q.take(int(self.traffic["recall_queries"]))
        self.ids, _ = self.search(first.topology(self.pool[0]), self.queries)
        self.entries = first.index.entry_points(self.search_kw.get(
            "n_entries", 16))
        self.built = [([s.ids for s in r.shards], r.shard_graphs,
                       r.index.graph) for r in self.jobs]
        del self.jobs, first

    def build_gaps(self, seed: int) -> dict:
        """:func:`graph.build_gap` summed over every job, each on its own
        seeded sample of rows."""
        ic = self.cfg["index_config"]
        total: dict = {}
        for j, (shards, graphs, merged) in enumerate(self.built):
            rng = np.random.default_rng(datagen.sub_seed(seed, "rows", j))
            rows = np.sort(rng.choice(
                self.n, min(self.n, int(self.traffic["check_rows"])),
                replace=False))
            gap = graph.build_gap(
                self.pool[j % len(self.pool)], shards, graphs, merged, rows,
                build_degree=int(ic["build_degree"]),
                degree=int(ic["degree"]), device=self.device)
            for key, v in gap.items():
                total[key] = total.get(key, 0) + v
        return total

    def judge(self) -> dict:
        omega = int(self.cfg["index_config"]["omega"])
        degree = int(self.cfg["index_config"]["degree"])
        gap = self.build_gaps(self.seed)
        out = {
            "partition_violations": sum(
                graph.partition_violations(s, self.n, omega)
                for s, _, _ in self.built),
            "graph_violations": sum(
                graph.graph_violations(m, self.n, degree)
                for _, _, m in self.built),
            "build_gap": gap["differ"] / gap["slots"],
        }
        out.update(self.judge_answers(self.pool[0], self.queries, self.ids))
        return out


class SearchBatches(Driver):
    """Batches of fresh queries searched back to back through ``search()``
    over the index of the configuration's ``n`` fixed vectors, built
    through ``build_scalegann`` in set-up; no batch starts once the
    window's seconds have passed.  The window keeps each batch's answers,
    clipped to int32, in a buffer that set-up fills for a quarter more
    batches than its timed warm call says the window holds, and
    ``check_per_batch`` of each batch's rows, at positions drawn in
    set-up, for the reference."""

    def build_index(self, index=None) -> tuple:
        """Build the configuration's index, or take ``index`` (``(data,
        topo)`` of the same configuration) as it is."""
        if index is None:
            data = datagen.base_data(self.cfg, int(self.cfg["n"]))
            index = (data, self.build(data).topology(data))
        self.data, self.topo = index
        g = self.topo.index.graph
        self.readings["shape"] = {"n": g.shape[0], "r": g.shape[1],
                                  "d": self.data.shape[1], "k": self.k}
        self.entries = self.topo.index.entry_points(self.search_kw.get(
            "n_entries", 16))
        return index

    def setup(self, seconds: float, *, index=None) -> None:
        self.build_index(index)
        self.batch = int(self.traffic["batch"])
        self.stream = datagen.QueryStream(
            self.cfg, self.batch, datagen.sub_seed(self.seed, "queries"),
            self.device)
        self.search(self.topo, self.stream.next())  # the window's shape
        sync(self.device)
        t0 = time.perf_counter()
        self.search(self.topo, self.stream.next())
        sync(self.device)
        calls = int(1.25 * seconds / (time.perf_counter() - t0)) + 16
        self.answers = np.full((calls, self.batch, self.k), -1, np.int32)
        rng = np.random.default_rng(datagen.sub_seed(self.seed, "sample"))
        per = int(self.traffic["check_per_batch"])
        self.positions = np.stack([rng.choice(self.batch, per, replace=False)
                                   for _ in range(64)])

    def window(self, seconds: float, tracer) -> dict:
        from repro_torch.search import SearchStats

        n = len(self.data)
        picked_q, picked_ids, calls, spill = [], [], [], []
        stats = SearchStats()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with tracer.span("annbench.next_queries", track="annbench"):
                q = self.stream.next()
            ids, st = self.events.around(self.search, self.topo, q)
            b = len(calls)
            if b < len(self.answers):
                out = self.answers[b]
            else:  # more calls than set-up made room for
                spill.append(np.full((self.batch, self.k), -1, np.int32))
                out = spill[-1]
            np.clip(ids, -1, n, out=out[:len(ids)], casting="unsafe")
            rows = self.positions[b % len(self.positions)]
            picked_q.append(q[rows])
            picked_ids.append(out[rows])
            calls.append((len(q), st.n_distance_computations, st.n_hops))
            stats += st
        sync(self.device)
        wall = time.perf_counter() - t0
        self.attempted = len(calls) * self.batch
        self.spill = spill
        self.calls = len(calls)
        self.picked = (np.concatenate(picked_q), np.concatenate(picked_ids))
        self.readings.update(search_calls=calls, search_stats=stats)
        return {"search_qps": self.attempted / wall, "window_s": wall}

    def release(self) -> None:
        del self.topo, self.stream

    def judge(self) -> dict:
        n = len(self.data)
        kept = self.answers[:min(self.calls, len(self.answers))]
        invalid = sum(exact.invalid_ids(b, n) for b in kept)
        invalid += sum(exact.invalid_ids(b, n) for b in self.spill)
        del self.answers, self.spill
        q, ids = self.picked
        keep = self.sample_rows(len(q), int(self.traffic["check_max"]))
        out = self.judge_answers(self.data, q[keep], ids[keep])
        out["invalid_ids"] = invalid
        return out


KINDS = {"build_jobs": BuildJobs, "search_batches": SearchBatches}
