"""Adaptive vector partitioning with selective replication (counterpart of
``repro/core/partition.py``; paper §V).

The dataset is streamed in blocks (one disk pass, §V-A).  Per block:

  1. **Originals** — every vector goes to its nearest cluster *with free
     space* (dataset completeness + locality).  Within a block this is
     resolved order-independently: if a cluster would overflow, the closest
     vectors win and the rest fall through to their next-nearest cluster.
  2. **Distribution update** — cluster sizes, radii (running max original
     distance) and the per-cluster replica thresholds θ_c are updated from
     the observed assignments (§V-A "blockwise runtime adaptive adjustment");
     dense clusters get smaller θ_c to preserve space for later originals.
  3. **Replicas (Algorithm 1)** — a vector v with original distance d may be
     replicated to cluster c' at distance d' only if

         d' < ε·d              (distance constraint)
         d' < ε·τ(block)·r_c'  (radius constraint, τ: dynamic correction)

     subject to the per-vector cap ω and the per-cluster replica quota
     θ_c·capacity.  Within a block, candidate (v, c') pairs are admitted in
     ascending d' order per cluster (order-independent, strictly fairer than
     a thread-racy sequential scan).

Invariants (as in the reference):
  I1  every vector lands in ≥1 cluster (exactly one original);
  I2  a vector appears in ≤ ω clusters, no cluster twice;
  I3  every replica satisfies the ε/τ constraints at admission time;
  I4  no cluster exceeds its capacity.

One departure from the reference, where its result is degenerate: a
vector whose only cluster holds it alone (k-means re-seeds an empty
cluster at the farthest point, and in high dimensions such a centre can
keep that one point) would get no edge from its shard's graph, so the
merge would leave its row empty.  Where ω allows it, it also gets a
replica in its nearest other non-empty cluster with space
(:func:`_rescue_lone_vectors`; outside I3's rule and θ's quota; counted
among ``stats["n_replicas"]`` and, alone, in
:attr:`PartitionResult.n_rescued`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core import kmeans as _kmeans
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

THETA_MIN, THETA_MAX = 0.02, 0.90


@dataclasses.dataclass
class PartitionState:
    """Mutable blockwise state (the paper's 'data distribution information')."""

    centroids: np.ndarray  # [k, D]
    capacity: int
    sizes: np.ndarray  # [k] total members
    replica_sizes: np.ndarray  # [k] replica members
    radii: np.ndarray  # [k] running max original distance (squared-L2 domain -> sqrt'd)
    theta: np.ndarray  # [k] replica-space fraction of capacity
    original_counts: np.ndarray  # [k] originals so far (density estimate)
    n_seen: int = 0

    @classmethod
    def create(cls, centroids: np.ndarray, capacity: int, theta0: float):
        k = centroids.shape[0]
        return cls(
            centroids=np.asarray(centroids, np.float32),
            capacity=int(capacity),
            sizes=np.zeros(k, np.int64),
            replica_sizes=np.zeros(k, np.int64),
            radii=np.zeros(k, np.float32),
            theta=np.full(k, theta0, np.float32),
            original_counts=np.zeros(k, np.int64),
        )

    def replica_quota(self) -> np.ndarray:
        """Remaining replica slots per cluster (θ_c·capacity − used)."""
        limit = np.floor(self.theta * self.capacity).astype(np.int64)
        return np.maximum(limit - self.replica_sizes, 0)

    def update_theta(self, theta0: float) -> None:
        """Dense clusters shrink θ (paper §V-A): θ_c = θ0·(mean density / density_c)."""
        total = max(1, self.original_counts.sum())
        k = len(self.theta)
        share = self.original_counts / total  # sums to 1
        rel_density = share * k  # 1.0 == uniform
        self.theta = np.clip(
            theta0 / np.maximum(rel_density, 1e-6), THETA_MIN, THETA_MAX
        ).astype(np.float32)


@dataclasses.dataclass
class BlockAssignment:
    original_cluster: np.ndarray  # [B] cluster id per vector
    original_dist: np.ndarray  # [B] distance to it (L2, not squared)
    replicas: np.ndarray  # [n_replicas, 2] (vector_row_in_block, cluster)
    replica_dist: np.ndarray  # [n_replicas]


def cluster_capacity(cfg: IndexConfig, n_total: int) -> int:
    """Capacity such that k·capacity comfortably holds ω-fold assignment
    (DiskANN's uniform-duplication sizing; the GPU/TPU HBM cap in vectors
    would further upper-bound this — see core.scheduler.shard_task_bytes)."""
    per = cfg.capacity_slack * cfg.omega * n_total / cfg.n_clusters
    return int(np.ceil(per))


def _distances_to_centroids(block: np.ndarray, centroids: np.ndarray,
                            device: torch.device) -> np.ndarray:
    """The [B, k] distance tile of a block (K1 on the card), L2 not squared."""
    d2 = ops.pairwise_distance(
        torch.from_numpy(np.ascontiguousarray(block, np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(centroids, np.float32)).to(device),
        "l2",
    )
    return np.sqrt(np.maximum(d2.cpu().numpy(), 0.0))


def _assign_originals(
    dists: np.ndarray, state: PartitionState
) -> tuple[np.ndarray, np.ndarray]:
    """Order-independent nearest-available assignment with capacity.

    Iteratively: everyone picks their nearest non-full cluster; overflowing
    clusters keep their closest `free` vectors; losers retry with that
    cluster masked.  Terminates in ≤ k rounds.
    """
    b, k = dists.shape
    masked = dists.copy()
    full = state.sizes >= state.capacity
    masked[:, full] = np.inf
    assign = np.full(b, -1, np.int64)
    free = (state.capacity - state.sizes).copy()
    pending = np.arange(b)
    for _ in range(k):
        if pending.size == 0:
            break
        choice = np.argmin(masked[pending], axis=1)
        choice_d = masked[pending, choice]
        if not np.isfinite(choice_d).all():
            raise RuntimeError(
                "partitioner ran out of cluster capacity for originals; "
                "increase capacity_slack or n_clusters"
            )
        next_pending = []
        for c in np.unique(choice):
            rows = pending[choice == c]
            if free[c] >= rows.size:
                assign[rows] = c
                free[c] -= rows.size
            else:
                order = np.argsort(dists[rows, c], kind="stable")
                win = rows[order[: free[c]]]
                lose = rows[order[free[c]:]]
                assign[win] = c
                free[c] = 0
                masked[lose, c] = np.inf
                next_pending.append(lose)
        pending = (
            np.concatenate(next_pending) if next_pending else np.empty(0, np.int64)
        )
    odist = dists[np.arange(b), assign]
    return assign, odist


def _candidate_replicas(
    dists: np.ndarray,
    assign: np.ndarray,
    odist: np.ndarray,
    state: PartitionState,
    cfg: IndexConfig,
    tau: float,
):
    """All (vector, cluster) pairs passing Algorithm-1's pruning, capped at
    ω−1 nearest per vector; returns flat candidate (row, cluster) arrays."""
    b, k = dists.shape
    eps = cfg.epsilon
    ok = dists < eps * np.maximum(odist, 1e-30)[:, None]  # distance constraint
    ok &= dists < eps * tau * np.maximum(state.radii, 0.0)[None, :]  # radius
    ok[np.arange(b), assign] = False  # not the original cluster
    ok &= (state.sizes < state.capacity)[None, :]  # hard size check
    ok &= (state.replica_quota() > 0)[None, :]  # θ quota not exhausted
    # per-vector cap: keep the ω−1 nearest passing clusters
    max_rep = cfg.omega - 1
    if max_rep <= 0:
        return np.empty((0, 2), np.int64), np.empty(0, np.float32)
    masked = np.where(ok, dists, np.inf)
    order = np.argsort(masked, axis=1, kind="stable")[:, :max_rep]  # [B, ω−1]
    rows = np.repeat(np.arange(b), max_rep)
    cols = order.reshape(-1)
    keep = np.isfinite(masked[rows, cols])
    rows, cols = rows[keep], cols[keep]
    return np.stack([rows, cols], axis=1), dists[rows, cols].astype(np.float32)


def _admit_replicas(
    cand: np.ndarray, cand_d: np.ndarray, state: PartitionState
) -> np.ndarray:
    """Admit candidates per cluster in ascending-d' order up to quota and
    remaining capacity. Returns a bool keep-mask over candidates."""
    keep = np.zeros(len(cand), bool)
    quota = state.replica_quota()
    space = state.capacity - state.sizes
    budget = np.minimum(quota, np.maximum(space, 0))
    order = np.argsort(cand_d, kind="stable")
    for i in order:
        c = cand[i, 1]
        if budget[c] > 0:
            keep[i] = True
            budget[c] -= 1
    return keep


def assign_block(
    block: np.ndarray, state: PartitionState, cfg: IndexConfig, tau: float,
    device: torch.device,
) -> BlockAssignment:
    """Vectorized production path (order-independent within the block)."""
    dists = _distances_to_centroids(block, state.centroids, device)
    assign, odist = _assign_originals(dists, state)
    # --- update distribution info BEFORE replica admission (§V-A: originals
    # first, then stats/θ update, then replicas — one disk read per block) ---
    np.add.at(state.sizes, assign, 1)
    np.add.at(state.original_counts, assign, 1)
    np.maximum.at(state.radii, assign, odist.astype(np.float32))
    state.update_theta(cfg.theta)
    state.n_seen += len(block)

    cand, cand_d = _candidate_replicas(dists, assign, odist, state, cfg, tau)
    keep = _admit_replicas(cand, cand_d, state)
    replicas, rd = cand[keep], cand_d[keep]
    np.add.at(state.sizes, replicas[:, 1], 1)
    np.add.at(state.replica_sizes, replicas[:, 1], 1)
    return BlockAssignment(assign, odist, replicas, rd)


def assign_block_sequential(
    block: np.ndarray, state: PartitionState, cfg: IndexConfig, tau: float,
    device: torch.device,
) -> BlockAssignment:
    """Literal Algorithm 1: ordered scan over the block (reference)."""
    dists = _distances_to_centroids(block, state.centroids, device)
    assign = np.full(len(block), -1, np.int64)
    odist = np.zeros(len(block), np.float32)
    reps, rds = [], []
    # Phase 1: originals in block order (nearest available cluster).
    for i in range(len(block)):
        order = np.argsort(dists[i], kind="stable")
        for c in order:
            if state.sizes[c] < state.capacity:
                assign[i] = c
                odist[i] = dists[i, c]
                state.sizes[c] += 1
                state.original_counts[c] += 1
                state.radii[c] = max(state.radii[c], float(dists[i, c]))
                break
        else:
            raise RuntimeError("out of capacity")
    state.update_theta(cfg.theta)
    state.n_seen += len(block)
    # Phase 2: replicas in block order (Algorithm 1 lines 5–11).
    quota = state.replica_quota()
    for i in range(len(block)):
        assigned = 1
        d = odist[i]
        for c in np.argsort(dists[i], kind="stable"):
            if assigned > cfg.omega - 1:
                break
            if c == assign[i]:
                continue
            if state.sizes[c] >= state.capacity or quota[c] <= 0:
                continue  # checkSizeLimit(c', θ)
            dprime = dists[i, c]
            if (dprime < cfg.epsilon * d
                    and dprime < cfg.epsilon * tau * state.radii[c]):
                reps.append((i, c))
                rds.append(dprime)
                state.sizes[c] += 1
                state.replica_sizes[c] += 1
                quota[c] -= 1
                assigned += 1
    replicas = np.asarray(reps, np.int64).reshape(-1, 2)
    return BlockAssignment(assign, odist, replicas, np.asarray(rds, np.float32))


def split_shard_rows(
    rows: np.ndarray, *, iters: int = 12, seed: int = 0, device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """2-means re-centering for a shard that outgrew its centroid (the
    live mutation layer, ``repro_torch.live``): train two centroids on the
    shard's rows with the partitioner's kmeans machinery and assign each
    row to its nearest (both tiles K1 on the card unless ``device`` is
    ``"cpu"``).  Returns ``(assign [n] in {0, 1}, centroids [2, D] f32)``.
    No capacity/replica logic — a live split is a local re-partition of
    one shard's residents, not a re-run of Algorithm 1."""
    dev = resolve_device(device)
    rows = np.asarray(rows, np.float32)
    cent = _kmeans.train_centroids(
        rows, 2, iters=iters, sample=len(rows), seed=seed, device=dev
    )
    d = _distances_to_centroids(rows, cent, dev)
    return np.argmin(d, axis=1).astype(np.int64), np.asarray(cent, np.float32)


# ---------------------------------------------------------------------------
# Full-dataset pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Shard:
    """One data shard: global ids in *arbitrary* order (parallel assignment
    makes intra-shard order non-deterministic, §V-C) + replica flags.
    The (local→global) manifest IS `ids` — the merge path never assumes
    original-dataset order (the paper's buffer-state-check property)."""

    ids: np.ndarray  # [n] global vector ids
    is_replica: np.ndarray  # [n] bool


@dataclasses.dataclass
class PartitionResult:
    shards: list[Shard]
    state: PartitionState
    stats: dict
    n_rescued: int = 0  # lone vectors given a replica outside I3 (above)

    @property
    def replica_proportion(self) -> float:
        return self.stats["replica_proportion"]

    @property
    def centroids(self) -> np.ndarray:
        """[n_clusters, D] kmeans centroids the shards were assigned by.
        Carried through the builder into serving so split-topology queries
        can be routed to their nearest shards instead of broadcast."""
        return self.state.centroids


def iter_blocks(
    data: np.ndarray | Iterable[np.ndarray], block_size: int
) -> Iterator[np.ndarray]:
    if isinstance(data, np.ndarray):
        for s in range(0, len(data), block_size):
            yield data[s : s + block_size]
    else:
        yield from data


def _rescue_lone_vectors(shards: list[Shard], data, state: PartitionState,
                         omega: int, device: torch.device) -> int:
    """Replicate each vector whose every shard holds it alone, and which is
    in fewer than ``omega`` shards, into its nearest other cluster (by
    centroid) that holds points and has space, in place; returns how many.
    A one-point shard's graph has no neighbour to give its vector, and the
    merge builds a row only from shard rows."""
    lone = {int(s.ids[0]) for s in shards if len(s.ids) == 1}
    sizes = np.array([len(s.ids) for s in shards])
    for s in shards:
        if len(s.ids) >= 2 and lone:
            lone -= set(np.intersect1d(s.ids, list(lone)).tolist())
    rescued = 0
    for v in sorted(lone):
        d = _distances_to_centroids(np.asarray(data[v:v + 1]),
                                    state.centroids, device)[0]
        d[(sizes < 1) | (state.sizes >= state.capacity)] = np.inf
        held = [c for c, s in enumerate(shards) if v in s.ids]
        d[held] = np.inf
        c = int(np.argmin(d))
        if len(held) >= omega or not np.isfinite(d[c]):
            continue  # no cluster can take it: its row stays empty
        shards[c].ids = np.append(shards[c].ids, v)
        shards[c].is_replica = np.append(shards[c].is_replica, True)
        sizes[c] += 1
        state.sizes[c] += 1
        state.replica_sizes[c] += 1
        rescued += 1
    return rescued


def partition(
    data: np.ndarray,
    cfg: IndexConfig,
    *,
    centroids: np.ndarray | None = None,
    sequential: bool = False,
    selective: bool = True,
    device=None,
) -> PartitionResult:
    """End-to-end partitioning of an in-memory / memmap'd dataset.

    ``selective=False`` reproduces DiskANN's uniform policy (every vector
    replicated to its next-nearest clusters up to ω, no ε/τ/θ pruning) — the
    'Original' column of paper Table IV.  ``sequential=True`` runs the
    literal ordered scan of Algorithm 1 (:func:`assign_block_sequential`)
    instead of the order-independent block assignment.  Distance tiles run
    on ``device`` (the card unless ``"cpu"`` is given).
    """
    dev = resolve_device(device)
    n = len(data)
    if centroids is None:
        centroids = _kmeans.train_centroids(
            data, cfg.n_clusters, iters=cfg.kmeans_iters,
            sample=cfg.kmeans_sample, seed=cfg.seed, device=dev,
        )
    eff_cfg = cfg if selective else dataclasses.replace(
        cfg, epsilon=np.inf, tau0=np.inf, theta=1.0
    )
    state = PartitionState.create(
        centroids, cluster_capacity(cfg, n), eff_cfg.theta
    )
    if not selective:
        state.radii[:] = np.inf

    assign_fn = assign_block_sequential if sequential else assign_block
    n_blocks = max(1, -(-n // cfg.block_size))
    per_cluster: list[list[np.ndarray]] = [[] for _ in range(cfg.n_clusters)]
    per_cluster_rep: list[list[np.ndarray]] = [[] for _ in range(cfg.n_clusters)]
    n_replicas = 0
    nearest_ok = 0
    for b_idx, block in enumerate(iter_blocks(data, cfg.block_size)):
        base = b_idx * cfg.block_size
        tau = eff_cfg.tau(b_idx, n_blocks)
        ba = assign_fn(np.asarray(block, np.float32), state, eff_cfg, tau,
                       dev)
        gids = base + np.arange(len(block))
        for c in np.unique(ba.original_cluster):
            rows = gids[ba.original_cluster == c]
            per_cluster[c].append(rows)
            per_cluster_rep[c].append(np.zeros(len(rows), bool))
        if len(ba.replicas):
            for c in np.unique(ba.replicas[:, 1]):
                rows = base + ba.replicas[ba.replicas[:, 1] == c, 0]
                per_cluster[c].append(rows)
                per_cluster_rep[c].append(np.ones(len(rows), bool))
            n_replicas += len(ba.replicas)
        # fairness stat: originals that got their true nearest cluster
        true_nearest = np.argmin(
            _distances_to_centroids(np.asarray(block, np.float32),
                                    state.centroids, dev), axis=1
        )
        nearest_ok += int((true_nearest == ba.original_cluster).sum())

    shards = [
        Shard(
            ids=np.concatenate(per_cluster[c]) if per_cluster[c] else np.empty(0, np.int64),
            is_replica=np.concatenate(per_cluster_rep[c]) if per_cluster_rep[c] else np.empty(0, bool),
        )
        for c in range(cfg.n_clusters)
    ]
    n_rescued = _rescue_lone_vectors(shards, data, state, cfg.omega, dev)
    n_replicas += n_rescued
    stats = {
        "n": n,
        "n_replicas": int(n_replicas),
        "replica_proportion": n_replicas / max(1, n),
        "total_assignments": n + int(n_replicas),
        "fairness_nearest_fraction": nearest_ok / max(1, n),
        "max_shard": max((len(s.ids) for s in shards), default=0),
        "capacity": state.capacity,
    }
    return PartitionResult(shards=shards, state=state, stats=stats,
                           n_rescued=n_rescued)
