"""End-to-end index construction (counterpart of ``repro/core/builder.py``)
for the four compared systems (paper §VI).

:func:`build_scalegann` is the paper's system: selective-replication
partition → per-shard CAGRA (or Vamana) builds → edge-union merge.
:func:`build_diskann` is the DiskANN baseline: uniform replication →
per-shard Vamana → merge.  :func:`build_split_only` is the
replication-free split of Extended CAGRA (k-means shards) or GGNN
(contiguous blocks), served without a merge.  All run their distance work
on ``device`` — the card unless ``"cpu"`` is given — and report the
paper's timing metrics: ``partition_s``, ``build_only_s`` (Σ shard
builds), ``wall_build_s`` and ``merge_s``.  ``reference=True`` runs the
seed-loop shard builds and merge (host loops; the baseline the batched
paths are held to).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.configs.base import IndexConfig
from repro_torch.core import cagra, vamana
from repro_torch.core.merge import GlobalIndex, merge_shard_indexes
from repro_torch.core.partition import PartitionResult, Shard, partition
from repro_torch.device import resolve_device
from repro_torch.telemetry import current_tracer


class ShardBuildError(RuntimeError):
    """One or more shard builds failed after exhausting their retries.
    ``errors`` maps shard index → the final exception, ``attempts`` maps
    shard index → the attempts it consumed."""

    def __init__(self, errors: dict, attempts: dict):
        self.errors = dict(errors)
        self.attempts = dict(attempts)
        detail = "; ".join(
            f"shard {i}: {type(e).__name__}: {e} "
            f"(after {attempts.get(i, '?')} attempts)"
            for i, e in sorted(errors.items())
        )
        super().__init__(
            f"{len(errors)} shard build(s) failed after retries — {detail}"
        )


def _sequential_vamana(vectors, cfg, *, device=None) -> cagra.ShardIndex:
    del device  # the paper-faithful sequential build runs on the host
    return vamana.build_shard_index_vamana_sequential(vectors, cfg)


BUILDERS = {
    "cagra": cagra.build_shard_index,
    "vamana": vamana.build_shard_index_vamana,
}

# seed-loop baselines: the pre-vectorization hot loops, kept for the
# parity tests and as the baseline the batched builds are measured against
REFERENCE_BUILDERS = {
    "cagra": functools.partial(cagra.build_shard_index, reference=True),
    "vamana": _sequential_vamana,
}


@dataclasses.dataclass
class BuildResult:
    name: str
    index: GlobalIndex | None  # merged systems only
    shards: list[Shard]
    shard_graphs: list[np.ndarray]
    partition_s: float
    build_only_s: float  # Σ shard build time (1-worker equivalent)
    wall_build_s: float  # elapsed with n_workers
    merge_s: float
    per_shard_s: list[float]
    n_distance_computations: int
    stats: dict
    centroids: np.ndarray | None = None  # [n_shards, D] partition centroids
    shard_attempts: list[int] | None = None  # per-shard build attempts
    shard_errors: list[str] | None = None  # per-shard last retried error

    @property
    def overall_s(self) -> float:
        return self.partition_s + self.wall_build_s + self.merge_s

    def topology(self, data: np.ndarray, *, metric: str = "l2"):
        """The search topology this build serves: the merged graph, or the
        centroid-routed shards of a split-only build."""
        from repro_torch.search.types import MergedTopology

        if self.index is not None:
            return MergedTopology(data=data, index=self.index, metric=metric)
        return self.shard_topology(data, metric=metric)

    def shard_topology(self, data: np.ndarray, *, metric: str = "l2"):
        """The pre-merge routed serving view: the partition's (replicated)
        shards + centroids as a :class:`ShardTopology`."""
        from repro_torch.search.types import ShardTopology

        return ShardTopology(
            data=data,
            shard_ids=[s.ids for s in self.shards],
            shard_graphs=self.shard_graphs,
            metric=metric,
            centroids=self.centroids,
        )

    def search(self, data: np.ndarray, queries: np.ndarray, k: int, *,
               backend: str = "fused", width: int = 64, n_entries: int = 16,
               nprobe=None, metric: str = "l2", device=None):
        """Serve queries on this build through
        :func:`repro_torch.search.search`: the merged graph, or the routed
        shards of a split-only build (``nprobe``)."""
        from repro_torch.search import search

        return search(
            self.topology(data, metric=metric), queries, k,
            backend=backend, width=width, n_entries=n_entries, nprobe=nprobe,
            device=device,
        )


def _build_shards(data, shards, cfg, *, algo, n_workers, device,
                  reference=False, max_retries=2, retry_backoff_s=0.05):
    build = (REFERENCE_BUILDERS if reference else BUILDERS)[algo]
    per_shard_s = [0.0] * len(shards)
    results: list = [None] * len(shards)
    attempts = [0] * len(shards)
    last_error: list[str | None] = [None] * len(shards)
    failures: dict[int, BaseException] = {}
    tr = current_tracer()

    def one(i: int):
        """One shard, with bounded retry and capped exponential backoff; the
        final failure is recorded, so every shard gets its full budget
        before the build raises one error."""
        vecs = np.asarray(data[shards[i].ids])
        t0 = time.perf_counter()
        for attempt in range(max_retries + 1):
            attempts[i] = attempt + 1
            try:
                with tr.span("build.shard", shard=i, algo=algo,
                             n=len(shards[i].ids), attempt=attempt + 1):
                    results[i] = build(vecs, cfg, device=device)
                break
            except Exception as e:  # noqa: BLE001 — recorded + re-raised
                last_error[i] = f"{type(e).__name__}: {e}"
                if attempt == max_retries:
                    failures[i] = e
                else:
                    time.sleep(min(retry_backoff_s * (2 ** attempt), 2.0))
        per_shard_s[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tr.span("build.shards", track="build", n_shards=len(shards),
                 n_workers=n_workers):
        if n_workers <= 1:
            for i in range(len(shards)):
                one(i)
        else:
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                list(pool.map(one, range(len(shards))))
    wall = time.perf_counter() - t0
    if failures:
        raise ShardBuildError(failures, {i: attempts[i] for i in failures})
    return results, per_shard_s, wall, attempts, last_error


def build_scalegann(
    data: np.ndarray,
    cfg: IndexConfig,
    *,
    algo: str = "cagra",
    n_workers: int = 1,
    selective: bool = True,
    reference: bool = False,
    max_retries: int = 2,
    retry_backoff_s: float = 0.05,
    device=None,
) -> BuildResult:
    """The paper's system: selective-replication partition → shard builds
    → edge-union merge.  ``selective=False`` gives DiskANN's uniform
    replication; ``reference=True`` the seed-loop shard builds and merge.
    A shard build that raises is retried up to ``max_retries`` times; one
    that exhausts its budget raises :class:`ShardBuildError`."""
    if algo not in BUILDERS:
        raise ValueError(f"algo must be one of {sorted(BUILDERS)}, "
                         f"got {algo!r}")
    dev = resolve_device(device)
    tr = current_tracer()
    t0 = time.perf_counter()
    with tr.span("build.partition", track="build", n=len(data)):
        part: PartitionResult = partition(data, cfg, selective=selective,
                                          device=dev)
    partition_s = time.perf_counter() - t0

    idxs, per_shard_s, wall, attempts, errors = _build_shards(
        data, part.shards, cfg, algo=algo, n_workers=n_workers, device=dev,
        reference=reference, max_retries=max_retries,
        retry_backoff_s=retry_backoff_s,
    )

    t0 = time.perf_counter()
    with tr.span("build.merge", track="build", n_shards=len(part.shards)):
        merged = merge_shard_indexes(
            part.shards, idxs, len(data), cfg.degree, data=data,
            reference=reference,
        )
    merge_s = time.perf_counter() - t0
    return BuildResult(
        name=f"scalegann[{algo}]",
        index=merged,
        shards=part.shards,
        shard_graphs=[i.graph for i in idxs],
        partition_s=partition_s,
        build_only_s=sum(per_shard_s),
        wall_build_s=wall,
        merge_s=merge_s,
        per_shard_s=per_shard_s,
        n_distance_computations=sum(i.n_distance_computations for i in idxs),
        stats=dict(part.stats),
        centroids=part.centroids,
        shard_attempts=attempts,
        shard_errors=errors,
    )


def build_diskann(data: np.ndarray, cfg: IndexConfig, *, n_workers: int = 1,
                  reference: bool = False, device=None) -> BuildResult:
    """DiskANN baseline: uniform ≥1 replication + Vamana shard builds +
    merge.  The shard builds run batched rounds on ``device`` (K3 searches,
    prune and reverse edges on the card); ``reference=True`` runs the
    paper-faithful sequential CPU algorithm end to end."""
    res = build_scalegann(
        data, cfg, algo="vamana", n_workers=n_workers, selective=False,
        reference=reference, device=device,
    )
    return dataclasses.replace(res, name="diskann")


def _split_partition(data, cfg: IndexConfig, *, kmeans: bool, device):
    """Replication-free split: k-means shards (Extended CAGRA) or contiguous
    blocks (GGNN's naive split), each with routing centroids."""
    t0 = time.perf_counter()
    n = len(data)
    if kmeans:
        part = partition(data, dataclasses.replace(cfg, omega=1),
                         selective=True, device=device)
        shards = part.shards
        centroids = part.centroids
    else:
        per = -(-n // cfg.n_clusters)
        shards = [
            Shard(
                ids=np.arange(s, min(s + per, n), dtype=np.int64),
                is_replica=np.zeros(min(per, n - s), bool),
            )
            for s in range(0, n, per)
        ]
        centroids = np.stack([
            np.asarray(data[s.ids], np.float32).mean(axis=0) for s in shards
        ])
    return shards, centroids, time.perf_counter() - t0


def build_split_only(
    data: np.ndarray,
    cfg: IndexConfig,
    *,
    name: str,
    kmeans_split: bool,
    n_workers: int = 1,
    device=None,
) -> BuildResult:
    """Extended CAGRA (``kmeans_split=True``) / GGNN (False): no
    replication, no merge; queries search the shards directly, routed by
    the carried centroids when ``nprobe`` is set."""
    dev = resolve_device(device)
    shards, centroids, partition_s = _split_partition(
        data, cfg, kmeans=kmeans_split, device=dev
    )
    idxs, per_shard_s, wall, attempts, errors = _build_shards(
        data, shards, cfg, algo="cagra", n_workers=n_workers, device=dev
    )
    return BuildResult(
        name=name,
        index=None,
        shards=shards,
        shard_graphs=[i.graph for i in idxs],
        partition_s=partition_s,
        build_only_s=sum(per_shard_s),
        wall_build_s=wall,
        merge_s=0.0,
        per_shard_s=per_shard_s,
        n_distance_computations=sum(i.n_distance_computations for i in idxs),
        stats={"n": len(data), "replica_proportion": 0.0},
        centroids=centroids,
        shard_attempts=attempts,
        shard_errors=errors,
    )


def build_extended_cagra(data, cfg, *, n_workers: int = 1,
                         device=None) -> BuildResult:
    return build_split_only(
        data, cfg, name="extended_cagra", kmeans_split=True,
        n_workers=n_workers, device=device,
    )


def build_ggnn(data, cfg, *, n_workers: int = 1, device=None) -> BuildResult:
    return build_split_only(
        data, cfg, name="ggnn", kmeans_split=False, n_workers=n_workers,
        device=device,
    )
