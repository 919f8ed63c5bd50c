"""The ``numpy`` search backend (counterpart of
``repro/search/numpy_backend.py``): per-query best-first beam search on the
host.

Faithful to DiskANN's GreedySearch (the paper's unified query algorithm for
all four compared systems, §VI-A2): expand the closest unexpanded candidate,
add its neighbors, keep the best ``width``.  Its exact semantics and exact
``SearchStats`` accounting make it the ground truth the batched backends
are held to, and the user names it: it is host numpy by nature, not a
fallback.  The shared search loops still run their routing tiles on
``device`` (K1/K2 on the card).

Supports squared L2 and ``ip`` (negative inner product).
"""

from __future__ import annotations

import functools
import heapq

import numpy as np
import torch

from repro_torch.search.types import (DEFAULT_RERANK, MergedTopology,
                                      NprobeSpec, QuantSpec, SearchStats,
                                      ShardTopology, is_live, run_merged,
                                      run_split)


def _host(a) -> np.ndarray:
    """A host numpy view of ``a``; a torch tensor (the bf16 storage views,
    a build's device tensors) comes back as f32 or its integer dtype —
    bf16 widens to f32 exactly."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.detach().cpu().numpy()
    return a


def _score_rows(
    data: np.ndarray, ids: np.ndarray, q: np.ndarray, metric: str
) -> np.ndarray:
    """Distances (smaller == closer) between ``q`` and ``data[ids]``."""
    rows = np.asarray(data[ids], np.float32)
    if metric == "ip":
        return -(rows @ q)
    d = rows - q[None, :]
    return np.einsum("nd,nd->n", d, d)


def _round_bf16(q: np.ndarray) -> np.ndarray:
    """``q`` rounded to bfloat16 (nearest even) and widened back to f32."""
    return torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(
        torch.bfloat16).float().numpy()


def _make_scorer(data: np.ndarray, query: np.ndarray, metric: str, quant):
    """``score(ids) -> [n] f32`` closure for one query over one storage.

    ``quant`` selects the distance stage: ``None`` — exact f32 over
    whatever ``data`` holds (cast per gather); ``"bf16"`` — ``data`` holds
    bfloat16 values, the query rounds to bf16 and products accumulate in
    f32; a :class:`QuantSpec` — ``data`` is uint8 codes and distances are
    integer-accumulated in the code domain.
    """
    if isinstance(quant, QuantSpec):
        cq = quant.quantize(query).astype(np.int64)
        s, zp = quant.scale, quant.zero_point
        d_real = cq.shape[0]
        cqn = int(cq @ cq)
        cqs = int(cq.sum())

        def score(ids):
            rows = np.asarray(data[ids], np.int64)
            dots = rows @ cq
            if metric == "ip":
                return np.asarray(
                    -(s * s * dots
                      + s * zp * (cqs + rows.sum(axis=1))
                      + d_real * zp * zp),
                    np.float32,
                )
            rn = np.einsum("nd,nd->n", rows, rows)
            return np.asarray(
                (s * s) * (rn - 2 * dots + cqn), np.float32
            )

        return score
    q = np.asarray(query, np.float32)
    if quant == "bf16":
        q = _round_bf16(q)
    return lambda ids: _score_rows(data, ids, q, metric)


def beam_search(
    data: np.ndarray,
    graph: np.ndarray,
    entry: int | np.ndarray,
    query: np.ndarray,
    k: int,
    *,
    width: int = 64,
    max_hops: int = 10_000,
    metric: str = "l2",
    quant=None,
) -> tuple[np.ndarray, SearchStats]:
    """Best-first graph search with a candidate list of ``width`` (>= k).

    Returns (ids [k], stats).  ``entry`` is one id (DiskANN's medoid) or an
    array of ids (CAGRA-style multi-entry seeding); ``quant`` (see
    :func:`_make_scorer`) swaps the scoring stage without changing the
    traversal order or the stats' meaning.
    """
    data = _host(data)
    graph = _host(graph)
    stats = SearchStats()
    score_ids = _make_scorer(data, query, metric, quant)
    entries = np.atleast_1d(np.asarray(entry, np.int64))
    visited: set[int] = set(entries.tolist())
    d0s = score_ids(entries)
    stats.n_distance_computations += len(entries)
    # candidate list: (dist, id)
    cand: list[tuple[float, int]] = list(
        zip(d0s.tolist(), entries.tolist())
    )
    expanded: set[int] = set()
    best: list[tuple[float, int]] = list(cand)
    while stats.n_hops < max_hops:
        # closest unexpanded candidate within the best `width`
        cand.sort()
        cand = cand[:width]
        nxt = None
        for d, v in cand:
            if v not in expanded:
                nxt = v
                break
        if nxt is None:
            break
        expanded.add(nxt)
        stats.n_hops += 1
        nbrs = graph[nxt]
        nbrs = nbrs[(nbrs >= 0)]
        fresh = np.asarray([v for v in nbrs.tolist() if v not in visited],
                           np.int64)
        if fresh.size:
            visited.update(fresh.tolist())
            ds = score_ids(fresh)
            stats.n_distance_computations += int(fresh.size)
            cand.extend(zip(ds.tolist(), fresh.tolist()))
            best.extend(zip(ds.tolist(), fresh.tolist()))
    best = heapq.nsmallest(k, set(best))
    ids = np.asarray([v for _, v in best], np.int64)
    if quant is not None:  # every score above ran in the cheap dtype
        stats.n_quantized_distance_computations = (
            stats.n_distance_computations)
    return ids, stats


def _serial_batch_beam(
    data,
    graph,
    entry,
    queries,
    k: int,
    *,
    width: int = 64,
    n_iters: int | None = None,  # unused: the reference runs to convergence
    metric: str = "l2",
    n_real: int | None = None,
    quant=None,
    need_dists: bool = True,
    device: torch.device | None = None,  # where a live build's output goes
) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """Batched adapter over :func:`beam_search` for the shared
    ``run_merged`` / ``run_split`` loops and ``beam_pool``.  Padding rows
    (``n_real``) are skipped outright.  The beam is host numpy; a build's
    live state in (:func:`is_live`) gives tensors out on ``device``."""
    live = is_live(graph)
    data, graph = _host(data), _host(graph)
    qs = np.asarray(_host(queries), np.float32)[:n_real]
    out = np.full((len(qs), k), -1, np.int64)
    dists = np.full((len(qs), k), np.inf, np.float32)
    stats = SearchStats()
    for i, q in enumerate(qs):
        ids, s = beam_search(data, graph, entry, q, k, width=width,
                             metric=metric, quant=quant)
        stats += s
        out[i, : len(ids)] = ids
        if len(ids) and need_dists:
            # stage-matched scores for the split loop's pool merge (and
            # the build's prune); bookkeeping, not new distance work
            dists[i, : len(ids)] = _make_scorer(data, q, metric, quant)(ids)
    if live:
        return (torch.from_numpy(out).to(device),
                torch.from_numpy(dists).to(device), stats)
    return out, dists, stats


# raw batched-beam hook for build-time searches (`beam_pool`)
beam_fn = _serial_batch_beam


def search_merged(
    topo: MergedTopology,
    queries: np.ndarray,
    k: int,
    *,
    width: int = 64,
    n_entries: int = 16,
    dtype: str = "f32",
    rerank: int = DEFAULT_RERANK,
    device: torch.device,
) -> tuple[np.ndarray, SearchStats]:
    """Serve a query batch on the merged index.  The merged loop never
    reads the adapter's bookkeeping dists, so they are switched off."""
    return run_merged(
        functools.partial(_serial_batch_beam, need_dists=False),
        topo, queries, k, width=width, n_entries=n_entries, dtype=dtype,
        rerank=rerank, device=device,
    )


def search_split(
    topo: ShardTopology,
    queries: np.ndarray,
    k: int,
    *,
    width: int = 64,
    n_entries: int = 16,  # unused: shards seed from their centroid entry
    nprobe: NprobeSpec = None,
    dtype: str = "f32",
    rerank: int = DEFAULT_RERANK,
    device: torch.device,
) -> tuple[np.ndarray, SearchStats]:
    """Split-only query path: route each query to its ``nprobe`` nearest
    shards (all shards when ``nprobe=None``), search them independently,
    then merge and re-rank the per-shard top-k."""
    return run_split(_serial_batch_beam, topo, queries, k, width=width,
                     nprobe=nprobe, dtype=dtype, rerank=rerank, device=device)
