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
    distance counter stays on the device and is read once a round.  On
    the card a prune chunk of narrow rows (a round's prune and its
    overflow re-prune) replays CUDA graphs from its builder thread's
    :class:`PruneGraphs`: such a chunk is ~600 small launches whose host
    calls, not their device time, set a round's pace, the more so beside
    a server's thread.  Chunks of wide rows (consolidation's 2-hop
    candidates) run the same ops eagerly: there each op's device time
    covers its launch, and 64 rows' graph would not fit the budget.
  * :func:`build_shard_index_vamana_sequential` is the paper-faithful
    one-point-at-a-time host numpy build, kept as the seed-loop baseline.

Randomness is numpy ``default_rng(seed)``, drawn exactly as the reference
draws it (start graph, insertion order), so on data whose distances are
exact (integer points) the batched build reproduces the reference's graph
and distance count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common.backpressure import yield_point
from repro_torch.configs.base import IndexConfig
from repro_torch.core.cagra import ShardIndex
from repro_torch.device import resolve_device
from repro_torch.telemetry import current_tracer, record_stage, stage_active

# working memory one prune chunk may take ([b, C, C] distances, [b, C, D]
# candidate vectors): a round's overflow re-prune (thousands of rows) fits
# one chunk, and consolidation's re-prune of ~125k rows at 1M takes few
# slices; a slice's steps cost launches, not bytes, whatever its rows, so
# the chunks are large (4 GB of the card's 80); rows are independent, so
# chunking changes nothing
PRUNE_CHUNK_BYTES = 4 << 30
# on the card: a prune chunk replays CUDA graphs when 64 of its rows, lanes
# padded to 32, fit PRUNE_GRAPH_CHUNK_BYTES of working memory (its rows
# then cut to a power of two that fits); a thread's graphs take about
# PRUNE_GRAPHS_BYTES of the card at most (see PruneGraphs)
PRUNE_GRAPH_CHUNK_BYTES = 256 << 20
PRUNE_GRAPHS_BYTES = 3 << 30


@dataclasses.dataclass
class VamanaRoundState:
    """Snapshot handed to ``round_hook`` after every completed insertion
    round — the checkpoint grain of the batched build.

    A round is a pure function of (graph, batch, data), and the batch
    schedule is derived from ``seed``, so this snapshot is everything a
    bit-compatible resume needs: restore ``graph`` and the
    ``(pass_idx, next_start)`` cursor and the remaining rounds replay
    exactly.

    The state holds ``device_graph``, a clone of the round's graph on the
    build's device (a device-to-device copy), and makes ``graph``, the
    reference's ``[n, R]`` int64 host array, on its first read: a hook
    that reads no graph this round (the fleet's, between checkpoints)
    costs no host copy.  A state kept after the hook returns still reads
    its own round's graph.  The host copy is made on ``stream``, the
    stream the build ran on, whichever thread reads it.
    """

    round_idx: int  # completed rounds so far, across both α passes
    n_rounds_total: int
    pass_idx: int  # which α pass (0: α=1 pass, 1: α pass)
    next_start: int  # batch offset the *next* round would start at
    device_graph: torch.Tensor  # [n, R] int32 clone of the round's graph
    n_distance_computations: int
    n: int = 0
    R: int = 0
    stream: Optional[torch.cuda.Stream] = None  # None: not on a card

    @functools.cached_property
    def graph(self) -> np.ndarray:
        """``[n, R]`` int64 host copy of the round's graph."""
        with torch.cuda.stream(self.stream):  # None: a no-op
            return self.device_graph.cpu().numpy().astype(np.int64)


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


def _graph_rows(c: int, d: int) -> int:
    """Rows of a card prune chunk that replays CUDA graphs: the largest
    power of two whose working memory at ``C`` rounded up to 32 lanes fits
    :data:`PRUNE_GRAPH_CHUNK_BYTES`; 0 when 64 rows do not (the chunk runs
    eagerly)."""
    c = _lanes(c)
    rows = PRUNE_GRAPH_CHUNK_BYTES // (4 * c * (c + d + 8))
    return 0 if rows < 64 else 1 << (rows.bit_length() - 1)


def _lanes(c: int) -> int:
    return 32 * -(-c // 32)


PRUNE_SEGMENT = 16  # prune steps between the host's reads of `alive`
# one thread's prune graphs at a time in the process, captured or
# replayed: two threads capturing at once (two fleet workers, each on its
# own stream) invalidated a capture on the H100
# (cudaErrorStreamCaptureInvalidated); the builds that still failed now
# and then captured on a side stream that was another worker's stream
# (:func:`_capture_stream` says why it no longer can be); launches of
# threads that use no graph (a server's) run beside a capture
# (thread_local mode)
_GRAPH_LOCK = threading.RLock()


@dataclasses.dataclass
class _PruneState:
    """What a prune chunk's steps read and update: sorted distances and
    ids, the alive mask (updated in place), α·d(v_i, v_j), and the outputs
    ``keep`` [b, R] and ``count`` (written in place)."""

    sd: torch.Tensor
    sid: torch.Tensor
    alive: torch.Tensor
    apair: torch.Tensor
    keep: torch.Tensor
    count: torch.Tensor


def _prune_setup(p_ids, cand, cand_d, vecs, alpha: float,
                 keep: torch.Tensor, count: torch.Tensor) -> _PruneState:
    """A chunk's sort and pair tile; resets ``keep`` to -1 and ``count``
    to 0."""
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
    keep.fill_(-1)
    count.zero_()
    return _PruneState(sd, sid, alive, alpha * pair, keep, count)


def _prune_segment(st: _PruneState, t0: int, t1: int) -> None:
    """Steps ``t0 .. t1 - 1``: each keeps every row's first alive
    candidate in column t and kills the alive v it occludes.  Each step is
    a few small ops, none of them advanced indexing."""
    nb, c = st.sid.shape
    for t in range(t0, t1):
        i = st.alive.to(torch.uint8).argmax(dim=1, keepdim=True)
        active = st.alive.gather(1, i)  # rows with anything left to keep
        st.keep[:, t:t + 1] = torch.where(active, st.sid.gather(1, i), -1)
        st.alive.scatter_(1, i, False)
        st.count += st.alive.sum()  # masked lanes are not counted
        # a row with nothing alive stays so: no `active` mask is needed
        st.alive &= (st.apair.gather(1, i[:, :, None].expand(nb, 1, c))[:, 0]
                     > st.sd)


def _prune_rows(p_ids, cand, cand_d, vecs, alpha: float, R: int):
    """One chunk of :func:`robust_prune_batch`: ``(keep [b, R], count)``
    with the count a device scalar.  Segments of :data:`PRUNE_SEGMENT`
    steps, the host reading before each whether any row has a candidate
    left; the loop costs what its launches cost."""
    keep = torch.full((len(cand), R), -1, dtype=torch.long,
                      device=cand.device)
    count = keep.new_zeros(())
    st = _prune_setup(p_ids, cand, cand_d, vecs, alpha, keep, count)
    for t0 in range(0, R, PRUNE_SEGMENT):
        if not bool(st.alive.any()):
            break
        yield_point()
        _prune_segment(st, t0, min(t0 + PRUNE_SEGMENT, R))
    return keep, count


class _CapturedPrune:
    """:func:`_prune_rows` at one ``(rows, C, D, R, alpha)`` as CUDA graphs:
    the setup and each segment of steps, replayed in :func:`_prune_rows`'s
    order with its host reads between the segments, so a chunk's ~600
    launches become a few replays and its results are the eager loop's.
    Static input buffers feed it; the outputs are static too.  Captured on
    a side stream after one warm-up run there (cuBLAS and the sort's
    scratch exist before the capture), in ``thread_local`` mode, so the
    launches another thread (the server's) makes meanwhile on its own
    stream are neither part of, nor refused by, the capture."""

    def __init__(self, nb: int, c: int, d: int, alpha: float, R: int,
                 dev: torch.device, pool=None):
        self.p_ids = torch.zeros(nb, dtype=torch.long, device=dev)
        self.cand = torch.full((nb, c), -1, dtype=torch.long, device=dev)
        self.cand_d = torch.full((nb, c), torch.inf, device=dev)
        self.vecs = torch.zeros((nb, c, d), device=dev)
        self.keep = torch.full((nb, R), -1, dtype=torch.long, device=dev)
        self.count = torch.zeros((), dtype=torch.long, device=dev)
        spans = [(t0, min(t0 + PRUNE_SEGMENT, R))
                 for t0 in range(0, R, PRUNE_SEGMENT)]

        def setup():
            return _prune_setup(self.p_ids, self.cand, self.cand_d,
                                self.vecs, alpha, self.keep, self.count)

        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with _GRAPH_LOCK, torch.cuda.stream(side):
            st = setup()  # warm-up
            for t0, t1 in spans:
                _prune_segment(st, t0, t1)
            self.setup = torch.cuda.CUDAGraph()
            with _capture(self.setup, pool):
                self.state = setup()
            self.segments = []
            for t0, t1 in spans:
                g = torch.cuda.CUDAGraph()
                with _capture(g, self.setup.pool()):
                    _prune_segment(self.state, t0, t1)
                self.segments.append(g)
        torch.cuda.current_stream(dev).wait_stream(side)
        # the static buffers (the state and intermediates are in the pool)
        self.nbytes = sum(t.numel() * t.element_size() for t in (
            self.p_ids, self.cand, self.cand_d, self.vecs, self.keep))

    def __call__(self, p_ids, cand, cand_d, vecs):
        """Replay on the current stream over the first ``len(cand)`` rows
        and ``cand.shape[1]`` lanes (the rest padding: candidate -1 at
        distance inf, nothing alive); the outputs are copies, so the next
        replay cannot overwrite them."""
        n, c = cand.shape
        self.p_ids[:n].copy_(p_ids)
        self.cand[:n, :c].copy_(cand)
        self.cand[:n, c:].fill_(-1)
        self.cand[n:].fill_(-1)
        self.cand_d[:n, :c].copy_(cand_d)
        self.cand_d[:n, c:].fill_(torch.inf)
        self.cand_d[n:].fill_(torch.inf)
        self.vecs[:n, :c].copy_(vecs)
        self.setup.replay()
        for g in self.segments:
            if not bool(self.state.alive.any()):
                break
            g.replay()
        return self.keep[:n].clone(), self.count.clone()


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream a prune capture runs on: one of torch's
    high-priority pool.  Every other stream the port makes (a fleet
    worker's) comes from the default-priority pool, which hands its 32
    streams out round-robin; a side stream from there is in time another
    worker's stream, and that worker's launches then go into the capture
    instead of running (its results unwritten, its host syncs refused).
    Captures hold :data:`_GRAPH_LOCK`, so no two use a side stream at
    once."""
    return torch.cuda.Stream(dev, priority=-1)


@contextlib.contextmanager
def _capture(graph, pool):
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        yield
    finally:
        graph.capture_end()


class PruneGraphs:
    """One thread's CUDA graphs of prune chunks, captured on first use for
    each ``(rows, C, D, R, alpha)``, rows rounded up to a power of two (at
    least 64) and C to a multiple of 32, the padding dead, so a builder
    replays a few shapes.  A graph's static buffers serve every replay, so
    a set is used by one thread, one chunk at a time
    (:func:`thread_prune_graphs`).  The graphs share one memory pool, so
    their intermediates take about one shape's room, not the sum: a graph
    may then reuse blocks another one's replay writes, which is safe
    because the set replays one graph at a time on one stream and copies
    its outputs before the next chunk.  The set's card memory
    (:meth:`card_bytes`: the static buffers, and the pool with the
    graphs' state and their captures' intermediates) is held near
    ``max_bytes``: a capture that would start past it first drops every
    graph and the pool (``resets``), which the allocator frees when it
    next needs the room, so the set ends at most one capture over."""

    def __init__(self, max_bytes: int = PRUNE_GRAPHS_BYTES):
        self.max_bytes = max_bytes
        self.captures = 0
        self.resets = 0
        self._graphs: dict[tuple, _CapturedPrune] = {}
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def pool_bytes(self) -> int:
        """Bytes the set's memory pool holds on the card."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def card_bytes(self) -> int:
        """The set's static buffers and its pool, in bytes."""
        return (sum(g.nbytes for g in self._graphs.values())
                + self.pool_bytes())

    def __call__(self, p_ids, cand, cand_d, vecs, alpha: float, R: int):
        nb, c = cand.shape
        key = (_bucket(nb), _lanes(c), vecs.shape[2], R, float(alpha))
        with _GRAPH_LOCK:
            g = self._graphs.get(key)
            if g is None:
                if self._graphs and self.card_bytes() > self.max_bytes:
                    self._graphs, self._pool = {}, None
                    self.resets += 1
                g = self._graphs[key] = _CapturedPrune(
                    *key[:3], alpha, R, cand.device, self._pool)
                self._pool = g.setup.pool()
                self.captures += 1
            return g(p_ids, cand, cand_d, vecs)


_THREAD = threading.local()


def thread_prune_graphs() -> PruneGraphs:
    """The calling thread's :class:`PruneGraphs`, made on first use: each
    builder thread (a live index's writer, each fleet worker) replays its
    own graphs, and no graph is shared across threads."""
    graphs = getattr(_THREAD, "graphs", None)
    if graphs is None:
        graphs = _THREAD.graphs = PruneGraphs()
    return graphs


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
    On the card, rows narrow enough (:func:`_graph_rows`) go in chunks
    that replay the calling thread's CUDA graphs: the same ops over
    padding that is dead, so the same kept ids and count.
    """
    dev = data.device
    p_ids = torch.as_tensor(p_ids, device=dev).long()
    cand = torch.as_tensor(cand, device=dev).long()
    cand_d = torch.as_tensor(cand_d, device=dev).float()
    nb, c = cand.shape
    keep = torch.full((nb, R), -1, dtype=torch.long, device=dev)
    step = _rows_per_chunk(c, data.shape[1])
    prune = _prune_rows
    g_rows = _graph_rows(c, data.shape[1]) if dev.type == "cuda" else 0
    if g_rows:
        step, prune = min(step, g_rows), thread_prune_graphs()
    for lo in range(0, nb, step):
        yield_point()  # to a backlogged server in this process
        hi = min(lo + step, nb)
        v = (vecs[lo:hi].float() if vecs is not None
             else data[cand[lo:hi].clamp_min(0)].float())
        keep[lo:hi], count = prune(p_ids[lo:hi], cand[lo:hi],
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


def _bucket(n: int) -> int:
    """``n`` rounded up to a power of two, at least 64 (a prune chunk's
    rows on the card)."""
    return max(64, 1 << max(0, n - 1).bit_length())


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
    re-pruned together over ``row ∪ new sources``, ``R + max_new`` lanes
    wide (-1 padded).  On the card :class:`PruneGraphs` pads the chunk's
    rows to a power of two and its lanes to a multiple of 16, so a build
    replays a few CUDA graphs and captures no new one each round."""
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
    width = R + max_new
    cand = torch.full((n_ovf, width), -1, dtype=torch.long, device=dev)
    cand[:, :R] = graph[ovf]
    ovf_pos = torch.full((len(uq),), -1, dtype=torch.long, device=dev)
    ovf_pos[~fits] = torch.arange(n_ovf, device=dev)
    m_ovf = ~m_fit
    cand[ovf_pos[seg[m_ovf]], R + rank[m_ovf]] = ps[m_ovf]
    pruned_q = torch.empty((n_ovf, R), dtype=torch.long, device=dev)
    step = _rows_per_chunk(width, data.shape[1])
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
    :class:`VamanaRoundState` (a device clone of the graph, copied to the
    host only when the hook reads it); a hook that raises aborts the
    build at the round boundary.  ``resume`` is any object with
    ``pass_idx`` / ``next_start`` / ``graph`` /
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
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    for pi, a in enumerate((1.0, alpha)):  # two passes per the paper
        if pi < start_pass:
            continue
        s0 = start_off if pi == start_pass else 0
        for s in range(s0, n, nb):
            yield_point()  # to a backlogged server in this process
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
                    device_graph=graph.clone(),
                    n_distance_computations=counted,
                    n=n,
                    R=R,
                    stream=stream,
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
