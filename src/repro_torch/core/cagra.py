"""CAGRA-style shard index build (counterpart of ``repro/core/cagra.py``;
paper §II-A, integrated algorithm §IV).

CAGRA builds a dense k-NN graph (degree L), then prunes it to degree R with
rank-based detour counting and reverse-edge augmentation.  The kNN graph
runs through :func:`repro_torch.kernels.ops.knn` (K4 on the card); the
detour counts are a batched ``torch.matmul`` on the same device, as the
reference leaves them to XLA outside any Pallas kernel; the pruning and
the reverse-edge fill are numpy, as in the reference.  ``reference=True``
runs the reference's per-node seed loops for the reverse fill and the row
dedup instead (bit-identical output; the seed-loop baseline).  Under an
enabled tracer a shard build records ``shard.knn`` and ``shard.prune``, and
the prune its three steps (``prune.detour``, ``prune.select``,
``prune.dedup``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.telemetry import current_tracer
from repro_torch.telemetry.trace import NULL_SPAN


@dataclasses.dataclass
class ShardIndex:
    """Graph over one shard, in *local* coordinates (row i of `graph` is the
    neighbor list of local vector i; -1 pads)."""

    graph: np.ndarray  # [n, R] int32 local ids
    n_distance_computations: int  # build-cost proxy (paper's GPU work)


def build_knn_graph(
    vectors: np.ndarray, L: int, *, metric: str = "l2", row_block: int = 4096,
    device=None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Exact kNN graph: returns (nbrs [n, L], dists [n, L], n_dist_comps).

    Row-blocked so peak memory is O(row_block · n); each block is one kNN
    kernel launch (brute force, CAGRA's choice for in-memory shards).
    """
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
    n = x.shape[0]
    k = min(L + 1, n)  # +1: the self-match is removed below
    nbrs, dists = [], []
    for s in range(0, n, row_block):
        q = x[s: s + row_block]
        d, i = ops.knn(q, x, k, metric)
        rows = torch.arange(s, s + q.shape[0], device=dev)[:, None]
        d = torch.where(i == rows, torch.inf, d)
        order = torch.sort(d, dim=1, stable=True).indices[:, :L]
        nbrs.append(i.gather(1, order).cpu().numpy())
        dists.append(d.gather(1, order).cpu().numpy())
    nbrs = np.concatenate(nbrs)
    dists = np.concatenate(dists)
    if n <= L:  # degenerate tiny shard: pad
        pad = L - (n - 1)
        nbrs = np.pad(nbrs[:, : n - 1], ((0, 0), (0, pad)), constant_values=-1)
        dists = np.pad(
            dists[:, : n - 1], ((0, 0), (0, pad)), constant_values=np.inf
        )
    return nbrs.astype(np.int32), dists.astype(np.float32), n * n


def _detour_counts(nbr_vecs: torch.Tensor, nbr_dists: torch.Tensor,
                   metric: str = "l2"):
    """CAGRA rank: edge (u, v_j) is 'detourable' through v_i (i<j, i.e. a
    closer neighbor) when d(v_i, v_j) < d(u, v_j).  Returns [C, L] counts.

    nbr_vecs: [C, L, D]; nbr_dists: [C, L] ascending.
    """
    cross = torch.matmul(nbr_vecs, nbr_vecs.transpose(1, 2))  # [C, L, L]
    if metric == "l2":
        nn_ = (nbr_vecs * nbr_vecs).sum(dim=-1)
        d_ij = torch.sqrt((nn_[:, :, None] + nn_[:, None, :] - 2 * cross)
                          .clamp_min(0.0))
    else:
        d_ij = -cross
    L = nbr_dists.shape[1]
    ar = torch.arange(L, device=nbr_dists.device)
    rank_lt = ar[:, None] < ar[None, :]  # i < j
    detour = (d_ij < nbr_dists[:, None, :]) & rank_lt[None]
    valid = torch.isfinite(nbr_dists)
    counts = detour.sum(dim=1) + torch.where(valid, 0, 10**6)
    return counts, d_ij.shape[0] * L * L


def _fill_reverse_loop(
    src_s: np.ndarray, starts: np.ndarray, ends: np.ndarray, n: int, half: int
) -> np.ndarray:
    """Seed-loop reverse-edge fill, one python iteration per node."""
    rev = np.full((n, half), -1, np.int32)
    for v in range(n):
        cnt = min(ends[v] - starts[v], half)
        if cnt > 0:
            rev[v, :cnt] = src_s[starts[v] : starts[v] + cnt]
    return rev


def _fill_reverse(
    src_s: np.ndarray, starts: np.ndarray, ends: np.ndarray, n: int, half: int
) -> np.ndarray:
    """Reverse-edge fill over the searchsorted segment layout: each
    destination's first ``half`` sources, in stable-sort order."""
    rev = np.full((n, half), -1, np.int32)
    if half == 0 or src_s.size == 0:
        return rev
    cnt = np.minimum(ends - starts, half)  # [n]
    cols = np.arange(half)
    take = np.minimum(starts[:, None] + cols[None, :], src_s.size - 1)
    vals = src_s[take]
    return np.where(cols[None, :] < cnt[:, None], vals, -1).astype(np.int32)


def _dedup_refill_loop(
    graph: np.ndarray, leftover: np.ndarray, R: int
) -> np.ndarray:
    """Seed-loop per-row dedup + leftover refill (python sets, one
    iteration per node)."""
    out_rows = graph.copy()
    for i in range(len(graph)):
        seen, out = set(), []
        for v in graph[i]:
            if v >= 0 and v != i and v not in seen:
                seen.add(v)
                out.append(v)
        if len(out) < R:
            for v in leftover[i]:
                if len(out) >= R:
                    break
                if v >= 0 and v != i and v not in seen:
                    seen.add(v)
                    out.append(v)
        out_rows[i] = out + [-1] * (R - len(out))
    return out_rows


def _dedup_refill_rows(
    graph: np.ndarray, leftover: np.ndarray, R: int
) -> np.ndarray:
    """Per-row dedup of ``graph ∪ leftover`` keeping first-seen order,
    truncated to ``R`` (sort-based, bit-identical to the reference)."""
    n = len(graph)
    ext = np.concatenate([graph, leftover], axis=1).astype(np.int64)
    if ext.shape[1] < R:  # degenerate L < R/2 configs: pad so the cap fits
        ext = np.pad(ext, ((0, 0), (0, R - ext.shape[1])),
                     constant_values=-1)
    c = ext.shape[1]
    big = np.iinfo(np.int64).max
    rows = np.arange(n)[:, None]
    key = np.where((ext < 0) | (ext == rows), big, ext)
    pos = np.broadcast_to(np.arange(c), (n, c))
    order = np.lexsort((pos, key), axis=1)  # by id, then first-seen pos
    sid = np.take_along_axis(key, order, axis=1)
    spos = np.take_along_axis(pos, order, axis=1)
    dup = np.zeros_like(sid, bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    keep = (sid != big) & ~dup
    back = np.argsort(np.where(keep, spos, c), axis=1, kind="stable")[:, :R]
    out = np.take_along_axis(np.where(keep, sid, -1), back, axis=1)
    return out.astype(graph.dtype)


def optimize_graph(
    vectors: np.ndarray,
    nbrs: np.ndarray,
    dists: np.ndarray,
    R: int,
    *,
    metric: str = "l2",
    node_block: int = 2048,
    reference: bool = False,
    device=None,
) -> tuple[np.ndarray, int]:
    """Prune the degree-L kNN graph to degree R: keep the R/2 forward edges
    with the fewest detours, then fill with reverse edges (CAGRA §4.2).
    ``reference=True`` takes the per-node seed loops (same output)."""
    dev = resolve_device(device)
    tr = current_tracer()
    on = tr.enabled
    n, L = nbrs.shape
    fwd_keep = R - R // 2
    n_dist = 0
    with tr.span("prune.detour") if on else NULL_SPAN:
        x = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
        counts = np.empty((n, L), np.int64)
        safe_nbrs = torch.from_numpy(
            np.maximum(nbrs, 0).astype(np.int64)).to(dev)
        dists_t = torch.from_numpy(
            np.ascontiguousarray(dists, np.float32)).to(dev)
        for s in range(0, n, node_block):
            e = min(s + node_block, n)
            c, nd = _detour_counts(x[safe_nbrs[s:e]], dists_t[s:e], metric)
            counts[s:e] = c.cpu().numpy()
            n_dist += int(nd)
    with tr.span("prune.select") if on else NULL_SPAN:
        # stable: prefer fewer detours, break ties by distance rank
        order = np.argsort(counts, axis=1, kind="stable")
        fwd = np.take_along_axis(nbrs, order[:, :fwd_keep], axis=1)

        # reverse edges: v gains u for every kept forward edge u→v
        src = np.repeat(np.arange(n), fwd_keep)
        dst = fwd.reshape(-1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        order2 = np.argsort(dst, kind="stable")
        dst_s, src_s = dst[order2], src[order2]
        starts = np.searchsorted(dst_s, np.arange(n), side="left")
        ends = np.searchsorted(dst_s, np.arange(n), side="right")
        fill_rev = _fill_reverse_loop if reference else _fill_reverse
        rev = fill_rev(src_s, starts, ends, n, R // 2)

    with tr.span("prune.dedup") if on else NULL_SPAN:
        graph = np.concatenate([fwd, rev], axis=1)  # [n, R]
        # dedup per row (forward ∪ reverse may overlap); refill from the
        # leftover kNN
        leftover = np.take_along_axis(nbrs, order[:, fwd_keep:], axis=1)
        dedup = _dedup_refill_loop if reference else _dedup_refill_rows
        graph = dedup(graph, leftover, R).astype(np.int32)
    return graph, n_dist


def build_shard_index(vectors: np.ndarray, cfg: IndexConfig, *,
                      reference: bool = False, device=None) -> ShardIndex:
    """Full CAGRA-style build of one shard; ``reference=True`` routes
    :func:`optimize_graph` through its seed loops (same graph)."""
    tr = current_tracer()
    on = tr.enabled
    n = len(vectors)
    with (tr.span("shard.knn", n=n, k=min(cfg.build_degree + 1, n))
          if on else NULL_SPAN):
        nbrs, dists, nd1 = build_knn_graph(
            vectors, cfg.build_degree, metric=cfg.metric, device=device
        )
    with tr.span("shard.prune") if on else NULL_SPAN:
        graph, nd2 = optimize_graph(
            vectors, nbrs, dists, cfg.degree, metric=cfg.metric,
            reference=reference, device=device
        )
    return ShardIndex(graph=graph, n_distance_computations=nd1 + nd2)
