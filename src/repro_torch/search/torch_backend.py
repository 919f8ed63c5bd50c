"""The ``torch`` search backend (counterpart of
``repro/search/jax_backend.py``): the batched multi-query beam search as
plain torch ops on the tensors' device, the CPU or the card.

It keeps the reference's semantics step for step:

  * **Multi-entry seeding** from ``GlobalIndex.entry_points`` (E <= width).
  * **Wavefront expansion**: each trip expands the ``expand`` (default 8)
    closest unexpanded candidates, ties to the lower list position.
  * **Exact dedup by tags**: a per-query visited tag array marks seen ids;
    a tagged scatter resolves duplicates inside one wavefront, the last
    occurrence winning (``scatter_reduce`` with ``amax`` over increasing
    slot tags, which is deterministic on the card as well).
  * **Early exit** per query once nothing is left to expand or its
    ``n_iters`` expansion budget is spent.
  * Scores are ``‖x‖² − 2·q·x`` for L2 (``‖q‖²`` added back at the end) and
    ``−q·x`` for ip; the uint8 stage is exact integer code math turned into
    absolute f32 scores with the spec's ``scale`` and ``zp``.

The visited tags take ``4·(N + 1)`` bytes a query, so a batch runs in
chunks of queries under a byte budget (:data:`CHUNK_BYTES`).  Queries are
independent: chunking changes no id and no counter.

This backend launches no hand-written kernel; the card's engine is
``fused`` (K3).  Stats: hops = nodes expanded, distance computations =
seed scores + fresh neighbor scores.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import beam as _beam
from repro_torch.kernels.ref import topk_smallest
from repro_torch.search.fused_backend import _prep_queries, _prepared
from repro_torch.search.types import (DEFAULT_RERANK, MergedTopology,
                                      NprobeSpec, SearchStats, ShardTopology,
                                      is_live, run_merged, run_split)

# working memory one chunk of queries may take (tags, gathered rows)
CHUNK_BYTES = 1 << 30

default_n_iters = _beam.default_n_iters


def _chunk_queries(n: int, d: int, width: int, n_new: int,
                   budget: int) -> int:
    """Queries a chunk holds: visited tags (int32, N + 1 each) plus the
    trip's gathered rows as f64 and the list state, under ``budget``."""
    per_query = 4 * (n + 1) + 16 * n_new * d + 32 * (width + n_new)
    return max(1, budget // per_query)


def _batch_beam(x, aux, graph, entries, queries, k: int, width: int,
                n_iters: int, expand: int, metric: str, scale: float,
                zp: float):
    """One chunk of queries.  ``x`` [N, D] f32 / bf16 / uint8 codes,
    ``aux`` = :func:`repro_torch.kernels.beam.beam_aux` of ``x``,
    ``graph`` [N, R] int32 or int64, ``entries`` [E] int, ``queries``
    [Q, D] in the stage's type (uint8 codes for the uint8 stage).
    Returns (ids [Q, k] int64 with -1 padding, dists [Q, k] f32,
    n_dist [Q], hops [Q])."""
    n, d_real = x.shape
    r = graph.shape[1]
    nq = queries.shape[0]
    ne = entries.shape[0]
    n_new = expand * r
    dev = x.device
    sentinel = n  # spill id: gathers and scatters of masked slots
    entries = entries.long()
    if x.dtype == torch.uint8:
        _, xi_n, xi_s = (a.long() for a in aux)
        qi = queries.long()
        qd = queries.double()[:, :, None]
        cqn = (qi * qi).sum(dim=1, keepdim=True)
        cqs = qi.sum(dim=1, keepdim=True)
        s = torch.tensor(scale, dtype=torch.float32, device=dev)
        z = torch.tensor(zp, dtype=torch.float32, device=dev)

        def score(ids):
            """Absolute quantized distance from exact integer code dot
            products (every partial sum is an integer below 2^53)."""
            dots = torch.bmm(x[ids].double(), qd)[..., 0].round().long()
            if metric == "ip":
                return -(s * s * dots.float()
                         + s * z * (cqs + xi_s[ids]).float()
                         + d_real * z * z)
            d_codes = (xi_n[ids] + cqn - 2 * dots).float()
            return d_codes.clamp_min(0.0) * (s * s)
    else:
        xn = aux[0]
        qf = queries.float()
        qcol = qf[:, :, None]

        def score(ids):
            """‖x‖² − 2·q·x (L2 ranking without the per-query constant) or
            −q·x for inner product."""
            dots = torch.bmm(x[ids].float(), qcol)[..., 0]
            if metric == "ip":
                return -dots
            return xn[ids] - 2.0 * dots

    pad = width - ne
    seeds = entries[None, :].expand(nq, ne)
    ids = torch.cat([seeds, seeds.new_full((nq, pad), sentinel)], 1)
    ds = torch.cat([score(seeds),
                    torch.full((nq, pad), torch.inf, device=dev)], 1)
    # padding marked expanded so it is never selected
    exp = torch.cat([torch.zeros((nq, ne), dtype=torch.bool, device=dev),
                     torch.ones((nq, pad), dtype=torch.bool, device=dev)], 1)
    # visited tags: 0 = never seen; column N is a spill for masked writes
    tags = torch.zeros((nq, n + 1), dtype=torch.int32, device=dev)
    tags[:, entries] = 1
    n_dist = torch.full((nq,), ne, dtype=torch.long, device=dev)
    hops = torch.zeros((nq,), dtype=torch.long, device=dev)
    done = torch.zeros((nq,), dtype=torch.bool, device=dev)
    lanes = torch.arange(n_new, dtype=torch.int32, device=dev)
    it = 0
    while bool(((~done) & (hops < n_iters)).any()):
        # wavefront: the `expand` closest unexpanded candidates
        sel_v, sel = topk_smallest(torch.where(exp, torch.inf, ds), expand)
        live = torch.isfinite(sel_v)
        converged = ~live[:, 0]  # nothing left to expand at all
        # finished lanes, newly converged lanes and lanes whose budget is
        # spent pass through unchanged
        halt = done | converged | (hops >= n_iters)
        exp_u = exp.scatter(1, sel, True)
        v = ids.gather(1, sel)
        nbrs = graph[v.clamp(0, n - 1)].long()  # [Q, expand, R]
        valid = (nbrs >= 0) & live[:, :, None] & ~halt[:, None, None]
        nbrs = nbrs.reshape(nq, n_new)
        valid = valid.reshape(nq, n_new)
        safe = torch.where(valid, nbrs, sentinel)

        # ---- exact dedup: visited gather + tagged scatter ----
        seen = tags.gather(1, safe) != 0
        slot_tag = (2 + it * n_new + lanes).expand(nq, n_new)
        write_at = torch.where(valid & ~seen, nbrs, sentinel)
        # unseen ids hold tag 0, so the largest slot tag, the last
        # occurrence, wins; halted lanes only write the spill column
        tags.scatter_reduce_(1, write_at, slot_tag, reduce="amax")
        fresh = valid & ~seen & (tags.gather(1, safe) == slot_tag)

        nd = torch.where(fresh, score(torch.where(fresh, nbrs, 0)),
                         torch.inf)
        # bounded beam: the best `width` of (candidates ∪ fresh)
        all_ids = torch.cat([ids, torch.where(fresh, nbrs, sentinel)], 1)
        all_d = torch.cat([ds, nd], 1)
        all_exp = torch.cat([exp_u, torch.zeros_like(fresh)], 1)
        keep_v, keep = topk_smallest(all_d, width)
        new_ids = torch.where(torch.isfinite(keep_v),
                              all_ids.gather(1, keep), sentinel)
        h = halt[:, None]
        ids = torch.where(h, ids, new_ids)
        ds = torch.where(h, ds, keep_v)
        exp = torch.where(h, exp, all_exp.gather(1, keep))
        n_dist = n_dist + torch.where(halt, 0, fresh.sum(dim=1))
        hops = hops + torch.where(halt, 0, live.sum(dim=1))
        done = done | converged
        it += 1
    top_v, top = topk_smallest(ds, k)
    top_ids = ids.gather(1, top)
    out_ids = torch.where(torch.isfinite(top_v) & (top_ids != sentinel),
                          top_ids, -1)
    out_d = top_v
    if metric != "ip" and x.dtype != torch.uint8:
        # restore the true squared-L2 value (uint8 scores are absolute)
        out_d = out_d + (qf * qf).sum(dim=1, keepdim=True)
    return out_ids, out_d, n_dist, hops


def batch_beam_search(
    data,
    graph,
    entries,
    queries,
    k: int,
    *,
    width: int = 64,
    n_iters: int | None = None,
    expand: int = 8,
    metric: str = "l2",
    n_real: int | None = None,
    quant=None,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """The beam_fn protocol: stats summed over the first ``n_real``
    queries (all when None).  numpy in, numpy out; a build's live state in
    (:func:`is_live`), tensors out on ``device``.
    Queries run in chunks of at most :data:`CHUNK_BYTES` of working
    memory."""
    n_iters = default_n_iters(width) if n_iters is None else n_iters
    prep = _prepared(data, graph, quant, device)
    x, g = prep.x, prep.graph
    aux = prep.aux if prep.aux is not None else _beam.beam_aux(x)
    q, scale, zp = _prep_queries(queries, quant, device)
    e = np.atleast_1d(np.asarray(entries, np.int64))[:width]
    e = torch.from_numpy(e).to(x.device)
    step = _chunk_queries(x.shape[0], x.shape[1], width, expand * g.shape[1],
                          CHUNK_BYTES)
    parts = [_batch_beam(x, aux, g, e, q[lo:lo + step], k, width, n_iters,
                         expand, metric, scale, zp)
             for lo in range(0, q.shape[0], step)]
    ids, ds, n_dist, hops = (torch.cat(p) for p in zip(*parts))
    nd = int(n_dist[:n_real].sum())
    stats = SearchStats(
        n_distance_computations=nd,
        n_hops=int(hops[:n_real].sum()),
        n_quantized_distance_computations=nd if quant is not None else 0,
    )
    if is_live(graph):
        return ids, ds, stats
    return ids.cpu().numpy(), ds.cpu().numpy(), stats


# raw batched-beam hook for build-time searches (`beam_pool`)
beam_fn = batch_beam_search


def search_merged(topo: MergedTopology, queries: np.ndarray, k: int, *,
                  width: int = 64, n_entries: int = 16,
                  n_iters: int | None = None, dtype: str = "f32",
                  rerank: int = DEFAULT_RERANK, device: torch.device):
    return run_merged(batch_beam_search, topo, queries, k, width=width,
                      n_entries=n_entries, n_iters=n_iters, dtype=dtype,
                      rerank=rerank, device=device)


def search_split(topo: ShardTopology, queries: np.ndarray, k: int, *,
                 width: int = 64, n_entries: int = 16,
                 n_iters: int | None = None, nprobe: NprobeSpec = None,
                 dtype: str = "f32", rerank: int = DEFAULT_RERANK,
                 device: torch.device):
    del n_entries  # shards seed from their centroid entry
    return run_split(batch_beam_search, topo, queries, k, width=width,
                     n_iters=n_iters, nprobe=nprobe, bucket=True,
                     dtype=dtype, rerank=rerank, device=device)
