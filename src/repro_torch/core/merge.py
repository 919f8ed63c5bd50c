"""Shard-index merge into one global graph (a numpy copy of
``repro/core/merge.py``; paper §IV step 3, §V-C).

Replicated vectors appear in multiple shards; their per-shard neighbor lists
are *unioned* (DiskANN's merge) and the result is degree-capped to R keeping
the closest neighbors.  The merge is the only stage that touches every shard
index, so it is written as a streaming pass over (graph, manifest) pairs.
Every edge is translated through the shard's (local → global) manifest, so
the merge output is a pure function of the edge *set*, never of row order.
``BufferedShardReader`` is the paper's buffered disk path with its state
check; ``reference=True`` runs the per-gid seed loop; ``connectivity_stats``
measures what the merge is for, global reachability.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cagra import ShardIndex
from repro_torch.core.partition import Shard


@dataclasses.dataclass
class GlobalIndex:
    """Merged graph over the full dataset, global coordinates, -1 padded."""

    graph: np.ndarray  # [N, R] int32
    medoid: int  # DiskANN-style single entry point
    n_vectors: int

    @classmethod
    def from_arrays(cls, graph, medoid, n_vectors) -> "GlobalIndex":
        """An index from plain arrays, e.g. another package's merged graph
        (``graph`` [N, R] int, ``medoid`` int, ``n_vectors`` int)."""
        graph = np.ascontiguousarray(graph, np.int32)
        if graph.ndim != 2 or graph.shape[0] != int(n_vectors):
            raise ValueError(f"graph {graph.shape} does not hold "
                             f"{n_vectors} rows")
        if not 0 <= int(medoid) < int(n_vectors):
            raise ValueError(f"medoid {medoid} out of range")
        return cls(graph=graph, medoid=int(medoid), n_vectors=int(n_vectors))

    def entry_points(self, n: int = 16) -> np.ndarray:
        """Medoid + a stratified sample — CAGRA-style multi-entry seeds (a
        merged kNN graph has only local edges; multiple entries restore
        navigability; deterministic so serving replicas agree).

        Always exactly ``min(n + 1, n_vectors)`` unique seeds: the medoid
        regularly collides with one of the ``linspace`` samples, and before
        the deterministic top-up below a collision silently shrank the seed
        set — replicas agreed with each other but not with the documented
        contract, and searches seeded one entry short."""
        want = min(n + 1, self.n_vectors)
        seeds = np.unique(np.concatenate(
            [[self.medoid], np.linspace(0, self.n_vectors - 1, n,
                                        dtype=np.int64)]
        ))
        if len(seeds) < want:
            # top up with the smallest ids not already chosen — ids in
            # [0, want + len(seeds)) suffice by pigeonhole, so the scan
            # stays O(n), not O(n_vectors)
            fresh = np.setdiff1d(
                np.arange(min(want + len(seeds), self.n_vectors),
                          dtype=np.int64), seeds,
                assume_unique=True,
            )
            seeds = np.unique(np.concatenate(
                [seeds, fresh[: want - len(seeds)]]
            ))
        return seeds

    @property
    def degree(self) -> int:
        return self.graph.shape[1]

    def out_degrees(self) -> np.ndarray:
        return (self.graph >= 0).sum(axis=1)


class BufferedShardReader:
    """Sequential-friendly buffered reader with the paper's state check.

    Wraps a [n, D] shard-data array (or memmap).  ``get(local_id)`` serves
    from an in-memory block buffer; an id outside the buffered window (an
    out-of-order read) refills it, so any order is correct and sorted
    order is fast.  ``hits`` / ``misses`` count the buffer's efficiency.
    """

    def __init__(self, rows: np.ndarray, buffer_rows: int = 4096):
        self._rows = rows
        self._buf_rows = int(buffer_rows)
        self._lo = 0
        self._hi = 0
        self._buf: np.ndarray | None = None
        self.hits = 0
        self.misses = 0

    def get(self, local_id: int) -> np.ndarray:
        # --- buffer state check (paper §V-C) ---
        if self._buf is None or not (self._lo <= local_id < self._hi):
            self.misses += 1
            self._lo = local_id
            self._hi = min(local_id + self._buf_rows, len(self._rows))
            self._buf = np.asarray(self._rows[self._lo : self._hi])
        else:
            self.hits += 1
        return self._buf[local_id - self._lo]


def _translate(graph: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Local neighbor ids -> global ids; -1 stays -1."""
    safe = np.maximum(graph, 0)
    out = ids[safe].astype(np.int64)
    out[graph < 0] = -1
    return out


def _edge_list(
    shards: list[Shard], indexes: list[ShardIndex]
) -> tuple[np.ndarray, np.ndarray]:
    """Flatten every shard graph into one global ``(gid, neighbor)`` edge
    list, in shard → row → slot order (the order the sequential scatter
    appended edges in, which is what "first seen" means downstream).
    Self-loops and -1 pads are dropped."""
    gid_parts, nbr_parts = [], []
    for shard, idx in zip(shards, indexes):
        g = _translate(idx.graph, shard.ids)  # [n, R] global
        gid_parts.append(
            np.repeat(shard.ids.astype(np.int64), g.shape[1])
        )
        nbr_parts.append(g.reshape(-1))
    gids = np.concatenate(gid_parts) if gid_parts else np.empty(0, np.int64)
    nbrs = np.concatenate(nbr_parts) if nbr_parts else np.empty(0, np.int64)
    ok = (nbrs >= 0) & (nbrs != gids)
    return gids[ok], nbrs[ok]


def _segment_distances(
    data: np.ndarray, gids: np.ndarray, nbrs: np.ndarray,
    block: int = 1 << 18,
) -> np.ndarray:
    """Squared L2 between each edge's endpoints, blocked so the gather never
    materializes more than ``2 · block · D`` f32 elements (``data`` may be a
    memmap at the 10^5+ scale)."""
    d = np.empty(len(gids), np.float32)
    for s in range(0, len(gids), block):
        sl = slice(s, s + block)
        diff = (np.asarray(data[nbrs[sl]], np.float32)
                - np.asarray(data[gids[sl]], np.float32))
        d[sl] = np.einsum("ed,ed->e", diff, diff)
    return d


def _union_dedup_cap(
    shards: list[Shard],
    indexes: list[ShardIndex],
    n_total: int,
    degree: int,
    data: np.ndarray | None,
) -> np.ndarray:
    """Vectorized edge-union: one global ``(gid, neighbor)`` sort with
    segment-wise dedup and degree cap.

    Per gid: duplicate ``(gid, neighbor)`` pairs collapse to their first
    appearance; the cap keeps the ``degree`` closest neighbors when
    ``data`` is given (ties broken by first-seen order) and the first-seen
    ``degree`` otherwise.  The output is a pure function of the edge *set*
    (§V-C's permutation invariance).
    """
    graph = np.full((n_total, degree), -1, np.int32)
    gids, nbrs = _edge_list(shards, indexes)
    if gids.size == 0:
        return graph
    # dedup: stable (gid, nbr) sort keeps the earliest appended copy first
    order = np.lexsort((nbrs, gids))
    sg, sn = gids[order], nbrs[order]
    first = np.ones(len(sg), bool)
    first[1:] = (sg[1:] != sg[:-1]) | (sn[1:] != sn[:-1])
    ug, un, upos = sg[first], sn[first], order[first]
    # cap: order each gid's unique neighbors by (distance, first-seen) or
    # (first-seen) alone, then keep ranks < degree
    if data is not None:
        d = _segment_distances(data, ug, un)
        sel = np.lexsort((upos, d, ug))
    else:
        sel = np.lexsort((upos, ug))
    g2, n2 = ug[sel], un[sel]
    idx = np.arange(len(sel))
    seg_start = np.ones(len(sel), bool)
    seg_start[1:] = g2[1:] != g2[:-1]
    rank = idx - np.maximum.accumulate(np.where(seg_start, idx, 0))
    keep = rank < degree
    graph[g2[keep], rank[keep]] = n2[keep].astype(np.int32)
    return graph


def _union_dedup_cap_loop(
    shards: list[Shard],
    indexes: list[ShardIndex],
    n_total: int,
    degree: int,
    data: np.ndarray | None,
) -> np.ndarray:
    """Seed-loop edge union: presized union buffers + one python iteration
    per global id (the reference's passes 2–3)."""
    # Pass 1: count edges per global id to presize the union buffers.
    counts = np.zeros(n_total, np.int64)
    for shard, idx in zip(shards, indexes):
        valid = (idx.graph >= 0).sum(axis=1)
        np.add.at(counts, shard.ids, valid)
    slots = np.maximum(counts, 1)
    offsets = np.zeros(n_total + 1, np.int64)
    np.cumsum(slots, out=offsets[1:])
    edge_buf = np.full(offsets[-1], -1, np.int64)
    fill = np.zeros(n_total, np.int64)

    # Pass 2: translate + scatter each shard's edges (order-free).
    for shard, idx in zip(shards, indexes):
        g = _translate(idx.graph, shard.ids)  # [n, R] global
        for row, gid in enumerate(shard.ids):
            nbrs = g[row]
            nbrs = nbrs[nbrs >= 0]
            s = offsets[gid] + fill[gid]
            edge_buf[s : s + len(nbrs)] = nbrs
            fill[gid] += len(nbrs)

    # Pass 3: dedup + cap per vector.
    graph = np.full((n_total, degree), -1, np.int32)
    for gid in range(n_total):
        nbrs = edge_buf[offsets[gid] : offsets[gid] + fill[gid]]
        nbrs = nbrs[(nbrs >= 0) & (nbrs != gid)]
        if nbrs.size == 0:
            continue
        # stable unique preserving first-seen order
        uniq, first = np.unique(nbrs, return_index=True)
        uniq = uniq[np.argsort(first, kind="stable")]
        if uniq.size > degree:
            if data is not None:
                v = np.asarray(data[gid], np.float32)
                cand = np.asarray(data[uniq], np.float32)
                d = ((cand - v) ** 2).sum(axis=1)
                uniq = uniq[np.argsort(d, kind="stable")[:degree]]
            else:
                uniq = uniq[:degree]
        graph[gid, : uniq.size] = uniq
    return graph


def merge_shard_indexes(
    shards: list[Shard],
    indexes: list[ShardIndex],
    n_total: int,
    degree: int,
    *,
    data: np.ndarray | None = None,
    centroid_of: np.ndarray | None = None,
    reference: bool = False,
) -> GlobalIndex:
    """Edge-union merge with degree cap.

    For each global vector, collect the union of its neighbor lists over all
    shards containing it.  Cap at ``degree``: if ``data`` is given, keep the
    *closest* neighbors (distance-ordered, DiskANN behavior); otherwise keep
    shard order (replicas append after originals).

    ``centroid_of`` ([N] shard id of the original assignment) is only used
    for the medoid choice; the medoid is the vector closest to the global
    mean when ``data`` is given, else vector 0.

    ``reference=True`` runs the per-gid seed loop instead of the global
    segment sort (same edge sets; under-capacity rows keep first-seen
    order there).
    """
    if len(shards) != len(indexes):
        raise ValueError("shards and indexes must align")
    union = _union_dedup_cap_loop if reference else _union_dedup_cap
    graph = union(shards, indexes, n_total, degree, data)

    medoid = 0
    if data is not None:
        # one stratified gather serves both the mean and the medoid probe
        probe_ids = np.linspace(0, n_total - 1, min(n_total, 8192)).astype(int)
        probe = np.asarray(data[probe_ids], np.float32)
        mean = probe.mean(axis=0)
        medoid = int(probe_ids[((probe - mean) ** 2).sum(axis=1).argmin()])
    return GlobalIndex(graph=graph, medoid=medoid, n_vectors=n_total)


def connectivity_stats(index: GlobalIndex, *, sample: int = 2048,
                       seed: int = 0):
    """BFS reachability from the medoid — the merge exists for global
    connectivity (§IV), so it is measured."""
    n = index.n_vectors
    seen = np.zeros(n, bool)
    frontier = [index.medoid]
    seen[index.medoid] = True
    while frontier:
        nxt = index.graph[frontier].reshape(-1)
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt)
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt.tolist()
    degs = index.out_degrees()
    return {
        "reachable_fraction": float(seen.mean()),
        "mean_degree": float(degs.mean()),
        "min_degree": int(degs.min()),
        "isolated": int((degs == 0).sum()),
    }
