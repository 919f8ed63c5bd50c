"""Vamana graph build, the DiskANN baseline (counterpart of
``repro/core/vamana.py``; paper §II-A, compared §VI).

DiskANN end to end is uniform ≥1-replica partitioning + a Vamana build per
shard + merge.  Vamana (Subramanya et al. 2019):

  1. start from a random regular graph of degree R;
  2. for each point p (two passes, α=1 then α>1): greedy-search the current
     graph for p, collect the visited set V, and set N(p) = RobustPrune(p, V,
     α, R); add reverse edges p→q for q ∈ N(p), re-pruning q when it
     overflows R.

Two implementations share that schedule:

  * :func:`build_shard_index_vamana` runs **batched insertion rounds** with
    its whole state on ``device``: each round searches a batch of points at
    once through :func:`repro_torch.search.beam_pool` (``fused`` by
    default: K3 on the card), prunes the batch with
    :func:`robust_prune_batch`, and applies the reverse edges grouped by
    destination (:func:`_apply_reverse_edges`), all as torch ops on the
    build's ``store`` and ``graph`` tensors.  The beam reads the live graph
    every round (the backends cache nothing for device tensors).  The
    distance counter stays on the device and is read once a round.
  * :func:`build_shard_index_vamana_sequential` is the paper-faithful
    one-point-at-a-time host numpy build, kept as the seed-loop baseline.

Randomness is numpy ``default_rng(seed)``, drawn exactly as the reference
draws it (start graph, insertion order), so on data whose distances are
exact (integer points) the batched build reproduces the reference's graph
and distance count.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core.cagra import ShardIndex
from repro_torch.device import resolve_device
from repro_torch.telemetry import current_tracer, record_stage, stage_active

# working memory one prune chunk may take ([b, C, C] distances, [b, C, D]
# candidate vectors): a round's overflow re-prune (thousands of rows) fits
# one chunk, whose 64 steps cost launches, not bytes; rows are independent,
# so chunking changes nothing
PRUNE_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass
class VamanaRoundState:
    """Snapshot handed to ``round_hook`` after every completed insertion
    round — the checkpoint grain of the batched build.

    A round is a pure function of (graph, batch, data), and the batch
    schedule is derived from ``seed``, so this snapshot is everything a
    bit-compatible resume needs: restore ``graph`` and the
    ``(pass_idx, next_start)`` cursor and the remaining rounds replay
    exactly.  ``graph`` is a host copy of the real rows (padding excluded).
    """

    round_idx: int  # completed rounds so far, across both α passes
    n_rounds_total: int
    pass_idx: int  # which α pass (0: α=1 pass, 1: α pass)
    next_start: int  # batch offset the *next* round would start at
    graph: np.ndarray  # [n, R] int64 copy
    n_distance_computations: int
    n: int = 0
    R: int = 0


def _dists(data: np.ndarray, ids: np.ndarray, p: np.ndarray) -> np.ndarray:
    rows = data[ids].astype(np.float32)
    d = rows - p[None, :]
    return np.einsum("nd,nd->n", d, d)


def robust_prune(
    p_id: int,
    cand: np.ndarray,
    cand_d: np.ndarray,
    data: np.ndarray,
    alpha: float,
    R: int,
    counter: list,
) -> np.ndarray:
    """RobustPrune(p, V, α, R) on the host: repeatedly keep the closest
    candidate p*, and drop every candidate v with α·d(p*, v) <= d(p, v)."""
    keep_ids: list[int] = []
    order = np.argsort(cand_d, kind="stable")
    cand = cand[order]
    cand_d = cand_d[order]
    alive = np.ones(len(cand), bool)
    alive &= cand != p_id
    while alive.any() and len(keep_ids) < R:
        i = int(np.argmax(alive))  # first alive == closest alive
        v = int(cand[i])
        keep_ids.append(v)
        alive[i] = False
        if not alive.any():
            break
        rest = np.nonzero(alive)[0]
        d_vs = _dists(data, cand[rest], data[v].astype(np.float32))
        counter[0] += len(rest)
        occluded = alpha * d_vs <= cand_d[rest]
        alive[rest[occluded]] = False
    return np.asarray(keep_ids, np.int64)


def _rows_per_chunk(c: int, d: int) -> int:
    return max(1, PRUNE_CHUNK_BYTES // (4 * c * (c + d + 8)))


def _prune_rows(p_ids, cand, cand_d, vecs, alpha: float, R: int):
    """One chunk of :func:`robust_prune_batch`: ``(keep [b, R], count)``
    with the count a device scalar.  Each step is ten small ops, none of
    them advanced indexing, so the loop costs what its launches cost."""
    nb, c = cand.shape
    invalid = (cand < 0) | (cand == p_ids[:, None]) | ~torch.isfinite(cand_d)
    d_key = torch.where(invalid, torch.inf, cand_d)
    sd, order = torch.sort(d_key, dim=1, stable=True)
    sid = cand.gather(1, order)
    alive = torch.isfinite(sd)
    vecs = vecs.gather(1, order[:, :, None].expand_as(vecs))
    # α·d(v_i, v_j) for every pair of a row's candidates at once, so each
    # selection step below is a row gather and no [b, C, D] pass
    nn_ = (vecs * vecs).sum(dim=2)
    pair = (nn_[:, :, None] + nn_[:, None, :]
            - 2.0 * torch.bmm(vecs, vecs.transpose(1, 2))).clamp_min(0.0)
    apair = alpha * pair
    cols, counts = [], []
    for t in range(R):
        if t % 16 == 0 and not bool(alive.any()):
            break  # a host read every 16 steps, not every step
        i = alive.to(torch.uint8).argmax(dim=1, keepdim=True)  # first alive
        active = alive.gather(1, i)  # rows with anything left to keep
        cols.append(torch.where(active, sid.gather(1, i), -1))
        alive.scatter_(1, i, False)
        counts.append(alive.sum())  # masked lanes are not counted
        # a row with nothing alive stays so: no `active` mask is needed
        alive &= apair.gather(1, i[:, :, None].expand(nb, 1, c))[:, 0] > sd
    keep = torch.full((nb, R), -1, dtype=torch.long, device=cand.device)
    if cols:
        keep[:, :len(cols)] = torch.cat(cols, dim=1)
    count = torch.stack(counts).sum() if counts else keep.new_zeros(())
    return keep, count


def robust_prune_batch(
    p_ids,  # [B] point ids being pruned
    cand,  # [B, C] candidate ids (-1 = pad)
    cand_d,  # [B, C] d(p, candidate) (inf = pad)
    data: torch.Tensor,  # [n, D] f32 on the build's device
    alpha: float,
    R: int,
    counter: list,
    vecs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched RobustPrune as torch ops on ``data``'s device: ``[B, R]``
    kept ids (int64, -1 padded, compacted to the front of each row).

    Per row the algorithm and its tie rules are :func:`robust_prune`'s:
    candidates sort stably by (distance, input position); each of up to R
    steps keeps the closest alive candidate p* (the first alive) and kills
    every alive v with ``α·d(p*, v) <= d(p, v)``.  Masked (dead, padding)
    lanes are not counted, so ``counter[0]`` (an int or a device scalar)
    advances exactly as the sequential prune's per-row ``len(rest)``.
    ``d(p*, v)`` comes from one ``‖a‖² + ‖b‖² − 2·a·b`` tile per row
    (exact on integer points, like every distance here).  ``vecs``
    optionally holds the ``[B, C, D]`` candidate vectors already gathered.
    """
    dev = data.device
    p_ids = torch.as_tensor(p_ids, device=dev).long()
    cand = torch.as_tensor(cand, device=dev).long()
    cand_d = torch.as_tensor(cand_d, device=dev).float()
    nb, c = cand.shape
    keep = torch.full((nb, R), -1, dtype=torch.long, device=dev)
    step = _rows_per_chunk(c, data.shape[1])
    for lo in range(0, nb, step):
        hi = min(lo + step, nb)
        v = (vecs[lo:hi].float() if vecs is not None
             else data[cand[lo:hi].clamp_min(0)].float())
        keep[lo:hi], count = _prune_rows(p_ids[lo:hi], cand[lo:hi],
                                         cand_d[lo:hi], v, alpha, R)
        counter[0] = counter[0] + count
    return keep


def _greedy_search_visited(
    data: np.ndarray,
    graph: np.ndarray,
    entry: int,
    q: np.ndarray,
    L: int,
    counter: list,
) -> tuple[np.ndarray, np.ndarray]:
    """GreedySearch returning the visited (expanded) set and its distances
    (host numpy, the sequential build's search)."""
    visited: dict[int, float] = {}
    d0 = float(_dists(data, np.asarray([entry]), q)[0])
    counter[0] += 1
    cand = {int(entry): d0}
    expanded: set[int] = set()
    while True:
        un = [(d, v) for v, d in cand.items() if v not in expanded]
        if not un:
            break
        un.sort()
        d, v = un[0]
        expanded.add(v)
        visited[v] = d
        nbrs = graph[v]
        nbrs = nbrs[nbrs >= 0]
        fresh = [u for u in nbrs.tolist() if u not in cand]
        if fresh:
            ds = _dists(data, np.asarray(fresh), q)
            counter[0] += len(fresh)
            for u, du in zip(fresh, ds.tolist()):
                cand[u] = du
        if len(cand) > L:  # keep closest L
            keep = sorted(cand.items(), key=lambda kv: kv[1])[:L]
            cand = dict(keep)
    ids = np.asarray(list(visited.keys()), np.int64)
    return ids, np.asarray([visited[int(i)] for i in ids], np.float32)


def _random_regular_init(
    n: int, R: int, rng: np.random.Generator
) -> np.ndarray:
    """Random start graph: one ``[n, R]`` integer draw with the self-loop
    shift (a row may repeat a neighbor; both passes overwrite every row)."""
    if n <= 1:
        return np.full((n, R), -1, np.int64)
    graph = rng.integers(0, n - 1, size=(n, R))
    graph[graph >= np.arange(n)[:, None]] += 1
    return graph.astype(np.int64)


def _apply_reverse_edges(
    batch: torch.Tensor,  # [B] the just-(re)pruned point ids
    pruned: torch.Tensor,  # [B, R] their new neighbor lists (-1 pad)
    graph: torch.Tensor,  # [n, R] int32, mutated in place
    data: torch.Tensor,  # [n, D] f32
    alpha: float,
    R: int,
    counter: list,
) -> None:
    """Grouped reverse-edge update as torch ops on the graph's device:
    every q ∈ pruned[b] gains the edge q → batch[b].  An edge already
    present is skipped; new sources group by destination with one stable
    sort; destinations with room take one scatter into their free tail
    (rows stay compacted), and the destinations that would overflow R are
    re-pruned together over ``row ∪ new sources``."""
    dev = graph.device
    src_p = batch.long().repeat_interleave(pruned.shape[1])
    dst_q = pruned.reshape(-1).long()
    ok = dst_q >= 0
    src_p, dst_q = src_p[ok], dst_q[ok]
    if dst_q.numel() == 0:
        return
    # skip pairs already present (sequential: `if p in row: continue`)
    present = (graph[dst_q] == src_p[:, None]).any(dim=1)
    src_p, dst_q = src_p[~present], dst_q[~present]
    if dst_q.numel() == 0:
        return
    o = torch.sort(dst_q, stable=True).indices
    qs, ps = dst_q[o], src_p[o]
    uq, cnt_new = torch.unique_consecutive(qs, return_counts=True)
    start = torch.cumsum(cnt_new, 0) - cnt_new
    seg = torch.repeat_interleave(torch.arange(len(uq), device=dev), cnt_new)
    rank = torch.arange(len(qs), device=dev) - start[seg]
    fill = (graph[uq] >= 0).sum(dim=1)  # rows are kept compacted
    fits = fill + cnt_new <= R

    # in-capacity destinations: scatter new sources into the free tail
    m_fit = fits[seg]
    graph[qs[m_fit], fill[seg[m_fit]] + rank[m_fit]] = ps[m_fit].to(
        graph.dtype)

    # overflowing destinations: batched re-prune over row ∪ new sources
    ovf = uq[~fits]
    n_ovf = len(ovf)
    if n_ovf == 0:
        return
    max_new = int(cnt_new[~fits].max())
    cand = torch.full((n_ovf, R + max_new), -1, dtype=torch.long, device=dev)
    cand[:, :R] = graph[ovf]
    ovf_pos = torch.full((len(uq),), -1, dtype=torch.long, device=dev)
    ovf_pos[~fits] = torch.arange(n_ovf, device=dev)
    m_ovf = ~m_fit
    cand[ovf_pos[seg[m_ovf]], R + rank[m_ovf]] = ps[m_ovf]
    pruned_q = torch.empty((n_ovf, R), dtype=torch.long, device=dev)
    step = _rows_per_chunk(cand.shape[1], data.shape[1])
    for lo in range(0, n_ovf, step):
        c = cand[lo:lo + step]
        valid = c >= 0
        cvecs = data[c.clamp_min(0)]
        diff = cvecs - data[ovf[lo:lo + step]][:, None, :]
        cand_d = torch.where(valid, (diff * diff).sum(dim=2), torch.inf)
        counter[0] = counter[0] + valid.sum()  # scoring q's candidates
        pruned_q[lo:lo + step] = robust_prune_batch(
            ovf[lo:lo + step], c, cand_d, data, alpha, R, counter,
            vecs=cvecs)
    graph[ovf] = pruned_q.to(graph.dtype)


DEFAULT_BUILD_BATCH = 256


def build_shard_index_vamana(
    vectors: np.ndarray,
    cfg: IndexConfig,
    *,
    alpha: float = 1.2,
    seed: int = 0,
    backend: str = "fused",
    batch_size: int | None = None,
    round_hook: Optional[Callable[[VamanaRoundState], None]] = None,
    resume: object | None = None,
    device=None,
) -> ShardIndex:
    """Batched Vamana build of one shard (degree R = cfg.degree, search
    width L = cfg.build_degree) with its state on ``device`` (the card
    unless ``"cpu"`` is given).

    Each insertion round searches a batch of ``batch_size`` points through
    :func:`repro_torch.search.beam_pool` on ``backend`` (``"fused"``: K3
    on the card; ``"torch"``; ``"numpy"``, the host reference) over the
    live ``store`` and ``graph`` tensors, then prunes and applies the
    reverse edges on the device; the two-pass (α=1, then α) schedule is
    the paper's.  The last round of a pass cycles real points to fill its
    batch (they are not counted).

    ``round_hook`` fires after every completed round with a
    :class:`VamanaRoundState` (the graph copied to the host only then); a
    hook that raises aborts the build at the round boundary.  ``resume``
    is any object with ``pass_idx`` / ``next_start`` / ``graph`` /
    ``n_distance_computations``: the build restores the graph and the
    round cursor and continues bit-compatibly (same ``seed`` /
    ``batch_size`` / ``alpha`` as the original build).  Per-round wall
    times go to any enclosing :func:`repro_torch.telemetry.collect_stages`
    block as ``vamana.beam`` (the search, up to its stats) and
    ``vamana.prune`` (prune + reverse edges, up to the counter's read).
    """
    from repro_torch.search import beam_pool  # deferred: core imports light

    dev = resolve_device(device)
    data = np.ascontiguousarray(vectors, np.float32)
    n = len(data)
    R = min(cfg.degree, max(1, n - 1))
    if n <= 1:
        # degenerate shard: no medoid to argmin and no round to run
        return ShardIndex(
            graph=np.full((n, R), -1, np.int32), n_distance_computations=0
        )
    L = cfg.build_degree
    rng = np.random.default_rng(seed)
    host_graph = _random_regular_init(n, R, rng).astype(np.int64)
    medoid = int(((data - data.mean(0)) ** 2).sum(1).argmin())
    order = rng.permutation(n)
    nb = batch_size or DEFAULT_BUILD_BATCH
    pool = max(L, R + 1)  # the visited pool RobustPrune consumes
    rounds_per_pass = max(1, math.ceil(n / nb))
    n_rounds_total = 2 * rounds_per_pass
    counted = 0

    start_pass, start_off = 0, 0
    if resume is not None:
        ck_n = getattr(resume, "n", n) or n
        ck_r = getattr(resume, "R", R) or R
        if ck_n != n or ck_r != R:
            raise ValueError(
                f"resume checkpoint shape mismatch: checkpoint n={ck_n} "
                f"R={ck_r} vs build n={n} R={R}"
            )
        host_graph = np.asarray(resume.graph, np.int64)
        counted = int(resume.n_distance_computations)
        start_pass = int(resume.pass_idx)
        start_off = int(resume.next_start)
        if start_off >= n:  # checkpoint taken at a pass boundary
            start_pass += 1
            start_off = 0

    store = torch.from_numpy(data).to(dev)
    graph = torch.from_numpy(host_graph.astype(np.int32)).to(dev)
    order_t = torch.from_numpy(order).to(dev)
    counter = [torch.tensor(counted, dtype=torch.long, device=dev)]
    timed = stage_active()
    tr = current_tracer()
    for pi, a in enumerate((1.0, alpha)):  # two passes per the paper
        if pi < start_pass:
            continue
        s0 = start_off if pi == start_pass else 0
        for s in range(s0, n, nb):
            t0 = time.perf_counter()
            before = counted
            m = min(nb, n - s)
            rows = order_t[s:s + nb]
            if m < nb:  # cycle real points: one batch shape for the build
                rows = torch.from_numpy(np.resize(order[s:s + nb],
                                                  nb)).to(dev)
            batch = rows[:m]
            ridx = pi * rounds_per_pass + (s // nb) + 1
            with tr.span("vamana.round", round=ridx, of=n_rounds_total,
                         pass_idx=pi) as span:
                # expansion budget = pool size: a bounded best-first search
                # saturates its list after ~pool expansions
                pool_ids, pool_d, p_stats = beam_pool(
                    store, graph, medoid, store[rows], pool,
                    backend=backend, metric="l2", n_iters=pool,
                    n_real=m if m < nb else None, device=dev,
                )
                t1 = time.perf_counter()
                counter[0] = counter[0] + p_stats.n_distance_computations
                pruned = robust_prune_batch(batch, pool_ids[:m],
                                            pool_d[:m], store, a, R, counter)
                graph[batch] = pruned.to(graph.dtype)
                _apply_reverse_edges(batch, pruned, graph, store, a, R,
                                     counter)
                counted = int(counter[0])  # the round's one counter read
                span.set(dist=counted - before, hops=p_stats.n_hops)
            if timed:
                record_stage("vamana.beam", t1 - t0)
                record_stage("vamana.prune", time.perf_counter() - t1)
            if round_hook is not None:
                round_hook(VamanaRoundState(
                    round_idx=ridx,
                    n_rounds_total=n_rounds_total,
                    pass_idx=pi,
                    next_start=s + nb,
                    graph=graph.cpu().numpy().astype(np.int64),
                    n_distance_computations=counted,
                    n=n,
                    R=R,
                ))
    return ShardIndex(
        graph=graph.cpu().numpy().astype(np.int32),
        n_distance_computations=int(counter[0]),
    )


def build_shard_index_vamana_sequential(
    vectors: np.ndarray, cfg: IndexConfig, *, alpha: float = 1.2,
    seed: int = 0,
) -> ShardIndex:
    """Sequential (paper-faithful) Vamana build of one shard on the host —
    the one-point-at-a-time CPU algorithm, kept as the seed-loop baseline
    the batched build is held to."""
    data = np.asarray(vectors, np.float32)
    n = len(data)
    R = min(cfg.degree, max(1, n - 1))
    if n <= 1:  # degenerate shard: same early return as the batched build
        return ShardIndex(
            graph=np.full((n, R), -1, np.int32), n_distance_computations=0
        )
    L = cfg.build_degree
    rng = np.random.default_rng(seed)
    counter = [0]
    # random R-regular start
    graph = np.full((n, R), -1, np.int64)
    for i in range(n):
        choices = rng.choice(n - 1, size=min(R, n - 1), replace=False)
        choices[choices >= i] += 1
        graph[i, : len(choices)] = choices
    medoid = int(((data - data.mean(0)) ** 2).sum(1).argmin())
    order = rng.permutation(n)
    for a in (1.0, alpha):  # two passes per the paper
        for p in order:
            vis, vis_d = _greedy_search_visited(
                data, graph, medoid, data[p], L, counter
            )
            pruned = robust_prune(int(p), vis, vis_d, data, a, R, counter)
            graph[p, :] = -1
            graph[p, : len(pruned)] = pruned
            # reverse edges with overflow re-prune
            for q in pruned:
                row = graph[q]
                if int(p) in row:
                    continue
                slot = np.nonzero(row < 0)[0]
                if slot.size:
                    graph[q, slot[0]] = p
                else:
                    cand = np.concatenate([row, [p]])
                    cd = _dists(data, cand, data[q].astype(np.float32))
                    counter[0] += len(cand)
                    pq = robust_prune(int(q), cand, cd, data, a, R, counter)
                    graph[q, :] = -1
                    graph[q, : len(pq)] = pq
    return ShardIndex(
        graph=graph.astype(np.int32), n_distance_computations=counter[0]
    )
