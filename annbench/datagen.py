"""Frozen data and query generator of the benchmark.

``make_clustered`` is a copy of ``repro_torch.data.synthetic.make_clustered``
without its ground truth (the reference computes that): a mixture of 24
Gaussian clusters with Pareto weights and spread 0.35, drawn with numpy from
the seed in the same order, so at ``structure_seed=None`` it gives the same
vectors and queries.  With ``structure_seed`` the clusters' centres and
weights come from that seed, and only the points and queries from ``seed``.

A configuration's vectors are fixed, as a published dataset is: the index
of the search cells holds ``make_clustered(n, dim,
seed=data_seed)``, and the build cell's job ``j`` a fixed draw of the same
distribution.  The run's seed draws the queries.  Fresh vectors from the
run's seed would change the work itself: one build's partition replicates
18% to 51% of a draw's points, and its recall@10 reads 0.53 to 0.73.

:class:`QueryStream` draws fresh queries of the same distribution on the
device with a ``torch.Generator``, two batches ahead in pinned host memory,
so a search window never waits for the host to draw its queries.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> np.random.SeedSequence:
    """An independent stream of ``seed`` for each tag (a name or a number)."""
    keys = [zlib.crc32(str(t).encode()) for t in tags]
    return np.random.SeedSequence([int(seed) % 2**64, *keys])


def torch_seed(seq: np.random.SeedSequence) -> int:
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def structure(d: int, *, n_true_clusters: int = 24, rng) -> tuple:
    """``(centers [C, d] f32, weights [C])``: the first two draws of
    ``make_clustered``."""
    centers = rng.normal(size=(n_true_clusters, d)).astype(np.float32)
    weights = rng.pareto(1.5, n_true_clusters) + 0.2
    weights /= weights.sum()
    return centers, weights


def make_clustered(n: int, d: int, *, n_queries: int = 100,
                   n_true_clusters: int = 24, spread: float = 0.35,
                   seed=0, structure_seed: int | None = None) -> tuple:
    """``(data [n, d] f32, queries [n_queries, d] f32)``."""
    rng = np.random.default_rng(seed)
    src = rng if structure_seed is None else np.random.default_rng(
        structure_seed)
    centers, weights = structure(d, n_true_clusters=n_true_clusters, rng=src)
    assign = rng.choice(n_true_clusters, size=n, p=weights)
    data = centers[assign] + spread * rng.normal(size=(n, d)).astype(
        np.float32)
    q_assign = rng.choice(n_true_clusters, size=n_queries, p=weights)
    queries = centers[q_assign] + spread * rng.normal(
        size=(n_queries, d)).astype(np.float32)
    return data, queries


def base_data(cfg: dict, n: int) -> np.ndarray:
    """The configuration's index vectors: ``make_clustered(n, dim,
    seed=data_seed)``."""
    g = cfg["generator"]
    return make_clustered(n, cfg["dim"], n_queries=0,
                          n_true_clusters=g["n_true_clusters"],
                          spread=g["spread"], seed=g["data_seed"])[0]


def job_data(cfg: dict, n: int, job) -> np.ndarray:
    """Build job ``job``'s vectors: a fixed draw of the configuration's
    distribution (``job`` a number or a name)."""
    g = cfg["generator"]
    return make_clustered(n, cfg["dim"], n_queries=0,
                          n_true_clusters=g["n_true_clusters"],
                          spread=g["spread"],
                          seed=sub_seed(g["data_seed"], "job", job),
                          structure_seed=g["data_seed"])[0]


class QueryStream:
    """Batches of ``batch`` fresh queries of a configuration's distribution,
    drawn on ``device`` from ``seed`` (a ``SeedSequence``).

    On the card the next batch is drawn and copied to pinned host memory
    on a side stream while the caller searches the current one; a batch
    returned by :meth:`next` stays valid until the next call."""

    def __init__(self, cfg: dict, batch: int, seed, device):
        g = cfg["generator"]
        centers, weights = structure(
            cfg["dim"], n_true_clusters=g["n_true_clusters"],
            rng=np.random.default_rng(g["data_seed"]))
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.centers = torch.from_numpy(centers).to(self.device)
        self.weights = torch.from_numpy(weights).to(self.device)
        self.spread = float(g["spread"])
        self.batch, self.dim = int(batch), int(cfg["dim"])
        self.gen = torch.Generator(self.device)
        self.gen.manual_seed(torch_seed(seed))
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.bufs = [torch.empty((self.batch, self.dim),
                                 pin_memory=self.cuda) for _ in range(2)]
        self.ready = [None, None]
        self.i = 0
        self._fill(0)

    def draw(self, m: int) -> torch.Tensor:
        """``m`` queries on the device (on the current stream)."""
        assign = torch.multinomial(self.weights, m, replacement=True,
                                   generator=self.gen)
        noise = torch.randn((m, self.dim), generator=self.gen,
                            device=self.device)
        return self.centers[assign] + self.spread * noise

    def _fill(self, slot: int) -> None:
        if not self.cuda:
            self.bufs[slot].copy_(self.draw(self.batch))
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.bufs[slot].copy_(self.draw(self.batch), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.ready[slot] = ev

    def next(self) -> np.ndarray:
        slot = self.i % 2
        if self.cuda:
            self.ready[slot].synchronize()
        self.i += 1
        self._fill(self.i % 2)
        return self.bufs[slot].numpy()

    def take(self, m: int) -> np.ndarray:
        """``m`` queries at once, on the host (a set-up call)."""
        out = self.draw(m)
        return out.cpu().numpy() if self.cuda else out.numpy()
