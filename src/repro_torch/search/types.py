"""Shared types and search loops of the engine (counterpart of
``repro/search/types.py``).

The engine serves three query topologies behind one API (paper §IV: CPUs own
"long-running, latency-sensitive query serving"; §VI-A2: all four compared
systems answer queries with the same beam search):

  * :class:`MergedTopology`   — one global graph (ScaleGANN / DiskANN after
                                 the edge-union merge).
  * :class:`ShardTopology`    — split-only shards + global re-rank (GGNN /
                                 Extended CAGRA, or ScaleGANN's pre-merge
                                 replicated shards); queries are routed to
                                 their ``nprobe`` nearest shard centroids,
                                 or scattered to every shard by default.

Both carry their vectors and metric so a backend gets everything it needs
from a single object; ``as_topology`` adapts the loose ``(data, index)`` /
``(data, shard_ids, shard_graphs)`` calling conventions, and
:func:`topology_from_arrays` carries another package's index state across
as plain arrays.  The routing tiles run on the search's ``device`` through
:mod:`repro_torch.kernels.ops` (K1, and K2 for the uint8 tile).
"""

from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.telemetry import record_stage, stage_active

if typing.TYPE_CHECKING:  # import-time independence from repro_torch.core
    from repro_torch.core.merge import GlobalIndex


def _rerank_exact_timed(data, cand, queries, k, metric):
    """The shared exact-f32 epilogue, reporting its wall time to any
    enclosing :func:`repro_torch.telemetry.collect_stages` block.  With no
    collector active this is a plain call — not even a clock read."""
    if not stage_active():
        return ops.rerank_exact(data, cand, queries, k, metric)
    t0 = time.perf_counter()
    out = ops.rerank_exact(data, cand, queries, k, metric)
    record_stage("search.rerank", time.perf_counter() - t0)
    return out


@dataclasses.dataclass
class SearchStats:
    """The paper's latency/QPS proxy (Fig. 5): distance computations + hops.

    ``n_queries`` is stamped by :func:`repro_torch.search.search` on every
    call so aggregating consumers can merge per-call stats with ``+=`` and
    still recover per-query averages.

    ``n_distance_computations`` stays the *total* (every scored pair, any
    precision — routing tiles included).  The dtype-staged path
    (``search(..., dtype="bf16"|"uint8")``) additionally splits that total:
    ``n_quantized_distance_computations`` are beam-traversal scores done in
    the cheap dtype, ``n_rerank_distance_computations`` the exact f32
    epilogue scores — the two sides of the staged memory-traffic trade.
    Both stay 0 on the f32 path.
    """

    n_distance_computations: int = 0
    n_hops: int = 0
    n_queries: int = 0
    n_quantized_distance_computations: int = 0
    n_rerank_distance_computations: int = 0

    def __iadd__(self, other: "SearchStats"):
        self.n_distance_computations += other.n_distance_computations
        self.n_hops += other.n_hops
        self.n_queries += other.n_queries
        self.n_quantized_distance_computations += (
            other.n_quantized_distance_computations)
        self.n_rerank_distance_computations += (
            other.n_rerank_distance_computations)
        return self

    def per_query(self) -> dict:
        """Mean distance computations / hops per query (0 when empty)."""
        q = max(self.n_queries, 1)
        return {
            "distance_computations": self.n_distance_computations / q,
            "hops": self.n_hops / q,
            "quantized_distance_computations":
                self.n_quantized_distance_computations / q,
            "rerank_distance_computations":
                self.n_rerank_distance_computations / q,
        }


SEARCH_DTYPES = ("f32", "bf16", "uint8")
DEFAULT_RERANK = 4


def parse_dtype(dtype: str) -> str:
    """Validate a ``search(..., dtype=...)`` spec.

    ``"f32"`` — today's full-precision path, bit-identical to not passing
    ``dtype`` at all; ``"bf16"`` — vectors stored/streamed as bfloat16 and
    accumulated in f32; ``"uint8"`` — affine uint8 codes with
    integer-accumulated distances (:class:`QuantSpec`).  Both staged dtypes
    finish with the exact-f32 re-rank epilogue.
    """
    if dtype not in SEARCH_DTYPES:
        raise ValueError(
            f"dtype must be one of {SEARCH_DTYPES}, got {dtype!r}"
        )
    return dtype


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Affine uint8 quantization of one vector population.

    ``value ≈ zero_point + scale · code`` with ``code ∈ [0, 255]``.
    Derivation is one min/max data pass (:meth:`from_data`):
    ``zero_point = min(x)`` and ``scale = (max(x) − min(x)) / 255``, i.e.
    the code book spans exactly the population's range, so encoding the
    population it was learned from never clips and the round-off error is
    at most ``scale / 2`` per element.  For split topologies the spec is
    learned *per shard* from the vectors the partitioner assigned to that
    shard (:meth:`ShardTopology.shard_quant`): shards are spatial clusters,
    so a per-shard range is much tighter — hence more accurate — than one
    global range, and the exact-f32 re-rank epilogue restores cross-shard
    comparability before pools merge.

    Because query and data codes share one spec, the zero-point cancels in
    L2 — ``‖q − x‖² ≈ scale²·‖cq − cx‖²`` — which is what makes the uint8
    kernel a pure integer-accumulated matmul over 1-byte panels.
    """

    scale: float
    zero_point: float

    @classmethod
    def from_data(cls, data: np.ndarray) -> "QuantSpec":
        """Learn scale/zero-point from one pass over ``data`` (min/max)."""
        x = np.asarray(data, np.float32)
        if x.size == 0:
            return cls(scale=1.0, zero_point=0.0)
        lo = float(x.min())
        hi = float(x.max())
        scale = (hi - lo) / 255.0
        return cls(scale=scale if scale > 0 else 1.0, zero_point=lo)

    def quantize(self, x: np.ndarray) -> np.ndarray:
        """f32 → uint8 codes (values outside the learned range clip)."""
        c = np.round((np.asarray(x, np.float32) - self.zero_point)
                     / self.scale)
        return np.clip(c, 0, 255).astype(np.uint8)

    def dequantize(self, codes: np.ndarray) -> np.ndarray:
        return (self.zero_point
                + self.scale * np.asarray(codes, np.float32))


def _to_bf16(x: np.ndarray) -> torch.Tensor:
    """The bf16 storage view, a CPU tensor rounded to nearest even (the
    rounding ``ml_dtypes`` applies in the reference)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16)


@dataclasses.dataclass
class MergedTopology:
    """Merged global graph + its vectors (ScaleGANN / DiskANN serving).

    ``tombstones`` ([N] bool, optional) marks deleted vectors: tombstoned ids still participate in
    traversal — their rows and edges keep the graph navigable until a
    consolidation pass physically removes them — but are masked out of the
    re-rank and the final top-k, so a search can never *return* one.
    """

    data: np.ndarray  # [N, D]
    index: GlobalIndex
    metric: str = "l2"
    tombstones: np.ndarray | None = None  # [N] bool, True == deleted
    # cached quantized storage views (derived, rebuilt on dataclasses.replace)
    _quant_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def quant_view(self, dtype: str):
        """``(storage, QuantSpec | None)`` for a staged dtype — the uint8
        code array (one global spec from a min/max data pass) or the bf16
        copy.  Quantization is index-time work, cached per topology, so
        steady-state serving pays only the cheaper memory traffic."""
        if dtype not in self._quant_cache:
            if dtype == "uint8":
                spec = QuantSpec.from_data(self.data)
                self._quant_cache[dtype] = (spec.quantize(self.data), spec)
            elif dtype == "bf16":
                self._quant_cache[dtype] = (_to_bf16(self.data), None)
            else:
                raise ValueError(f"no quantized view for dtype {dtype!r}")
        return self._quant_cache[dtype]


@dataclasses.dataclass
class ShardTopology:
    """Split-only shards + optional partition centroids.

    Without ``centroids`` every query searches every shard (scatter).  With
    them — the partitioner already computed them, ``BuildResult.topology``
    carries them through — queries can be *routed* to their ``nprobe``
    nearest shards (``search(..., nprobe=...)``), and each
    shard search seeds from the local vector nearest its centroid instead of
    local row 0.
    """

    data: np.ndarray  # [N, D] global vectors
    shard_ids: list  # list of [n_i] int64 global ids
    shard_graphs: list  # list of [n_i, R] int32 local graphs
    metric: str = "l2"
    centroids: np.ndarray | None = None  # [n_shards, D] partition centroids
    # [N] bool, True == deleted (see MergedTopology.tombstones): dead ids
    # keep their graph rows/edges for navigability but are masked out of
    # the merged pools and the final top-k
    tombstones: np.ndarray | None = None
    # cached per-shard entry points (derived, rebuilt on dataclasses.replace)
    _entries: np.ndarray | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    # cached per-shard quantized storage views (derived, like _entries)
    _quant_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    # cached quantized routing centroids (derived, like _entries)
    _centroid_quant: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    # cached per-shard f32 row slices (derived, like _entries)
    _store_cache: list | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def shard_store(self) -> list:
        """Cached per-shard f32 row slices, ``[n_i, D]`` per shard.

        ``data[ids]`` fancy-indexing materializes a *fresh* array on every
        call, which defeats any backend that caches device buffers by
        storage identity (the ``fused`` engine keys its host→device cache
        on ``id(storage)``).  Slicing once per topology
        gives every search over a shard the same host object — the f32
        analogue of :meth:`shard_quant`'s cached views, and the same
        memory the per-call slices were allocating transiently.
        """
        if self._store_cache is None:
            self._store_cache = [
                np.asarray(self.data[ids], np.float32)
                for ids in self.shard_ids
            ]
        return self._store_cache

    def shard_quant(self, dtype: str) -> list:
        """Per-shard ``(storage, QuantSpec | None)`` views for a staged
        dtype.

        uint8 specs are learned *per shard* from the vectors the
        partitioner assigned there (:class:`QuantSpec` explains why a
        per-shard range beats a global one); bf16 needs no spec.  Cached:
        quantization is an index-time pass, not per-query work, and does
        not count toward ``SearchStats``.
        """
        if dtype not in self._quant_cache:
            views = []
            for ids in self.shard_ids:
                rows = np.asarray(self.data[ids], np.float32)
                if dtype == "uint8":
                    spec = QuantSpec.from_data(rows)
                    views.append((spec.quantize(rows), spec))
                elif dtype == "bf16":
                    views.append((_to_bf16(rows), None))
                else:
                    raise ValueError(
                        f"no quantized view for dtype {dtype!r}"
                    )
            self._quant_cache[dtype] = views
        return self._quant_cache[dtype]

    def centroid_quant(self) -> tuple:
        """``(codes [S, D] uint8, spec, resid [S, D] f32)`` for the routing
        centroids — one affine spec over the centroid set, derived once and
        cached; ``resid`` is the exact per-element magnitude of the
        centroid rounding error, ``|c − dequantize(codes)|`` — index-time
        knowledge the tile's certified error bounds use (the query-side
        residual is computed per call; see
        :func:`_query_centroid_distances_u8`).

        The centroids themselves are tiny index-time metadata, but the
        query×centroid routing *tile* is per-query work (``Q·S`` scored
        pairs on every routed call), so the uint8 distance stage scores it
        on codes too: queries quantize with the same spec, the zero-point
        cancels in L2, and the tile runs through the integer-accumulated
        uint8 kernel.  One spec spans all centroids (unlike the per-shard
        data specs) because the tile compares distances *across* shards —
        per-centroid specs would break that comparability.

        The spec's range is learned from the topology's *data*, not the
        centroids: the tile's other operand is the query, and centroids —
        being means — span a much narrower range than the queries the tile
        will score, so a centroid-range spec clips nearly every query and
        forces the certified-exact fallback (see
        :func:`_query_centroid_distances_u8`) to eat the whole tile.  The
        data range is the index-time proxy for the query distribution, the
        same choice :meth:`MergedTopology.quant_view` makes for its global
        spec.
        """
        if self.centroids is None:
            raise ValueError("topology has no routing centroids")
        if self._centroid_quant is None:
            spec = QuantSpec.from_data(self.data)
            cent = np.asarray(self.centroids, np.float32)
            codes = spec.quantize(cent)
            resid = np.abs(cent - spec.dequantize(codes)).astype(np.float32)
            self._centroid_quant = (codes, spec, resid)
        return self._centroid_quant

    def shard_entries(self) -> np.ndarray:
        """Local entry index per shard: the vector nearest the shard's
        centroid, or local row 0 when no centroids are known.

        This is an index-time precomputation (cached, query-independent), so
        it does not count toward per-query ``SearchStats`` — the per-query
        seed scoring inside the beam search still does.
        """
        if self._entries is None:
            ent = np.zeros(len(self.shard_ids), np.int64)
            if self.centroids is not None:
                for s, ids in enumerate(self.shard_ids):
                    if len(ids) == 0:
                        continue
                    rows = np.asarray(self.data[ids], np.float32)
                    c = np.asarray(self.centroids[s], np.float32)
                    if self.metric == "ip":
                        scores = -(rows @ c)
                    else:
                        diff = rows - c[None, :]
                        scores = np.einsum("nd,nd->n", diff, diff)
                    ent[s] = int(np.argmin(scores))
            self._entries = ent
        return self._entries


Topology = MergedTopology | ShardTopology


def as_topology(index_or_shards, data=None, *, metric: str = "l2") -> Topology:
    """Adapt the accepted input forms to a topology object.

    ``index_or_shards`` may already be a topology, a :class:`GlobalIndex`
    (requires ``data``), or a ``(shard_ids, shard_graphs)`` pair (requires
    ``data``).
    """
    from repro_torch.core.merge import GlobalIndex  # deferred: core
    # imports this module's package through the builder

    if isinstance(index_or_shards, (MergedTopology, ShardTopology)):
        return index_or_shards
    if isinstance(index_or_shards, GlobalIndex):
        if data is None:
            raise ValueError("data is required with a bare GlobalIndex")
        return MergedTopology(data=data, index=index_or_shards, metric=metric)
    if (
        isinstance(index_or_shards, tuple)
        and len(index_or_shards) == 2
        and isinstance(index_or_shards[0], (list, tuple))
    ):
        ids, graphs = index_or_shards
        if data is None:
            raise ValueError("data is required with a (ids, graphs) pair")
        return ShardTopology(
            data=data, shard_ids=list(ids), shard_graphs=list(graphs),
            metric=metric,
        )
    raise TypeError(
        f"cannot interpret {type(index_or_shards).__name__} as a search "
        "topology; pass a MergedTopology, ShardTopology, GlobalIndex, or "
        "(shard_ids, shard_graphs)"
    )


def drop_tombstones(ids: np.ndarray, tombstones: np.ndarray,
                    k: int) -> np.ndarray:
    """Filter deleted ids out of beam-ordered candidate rows.

    ``ids`` rows come back from a beam search already sorted ascending by
    distance, so compacting live entries left (a stable sort on the dead
    mask) preserves that order without needing the distances — which the
    merged f32 path may not even have (``need_dists=False`` backends
    return inf placeholders).  Returns the first ``k`` live ids per row,
    -1-padded.
    """
    ids = np.asarray(ids, np.int64)
    dead = (ids >= 0) & tombstones[np.maximum(ids, 0)]
    order = np.argsort(dead, axis=1, kind="stable")  # live first, in order
    sid = np.take_along_axis(ids, order, axis=1)
    sdead = np.take_along_axis(dead, order, axis=1)
    return np.where(sdead, -1, sid)[:, :k]


def run_merged(beam_fn, topo: MergedTopology, queries, k: int, *,
               width: int, n_entries: int, n_iters: int | None = None,
               dtype: str = "f32", rerank: int = DEFAULT_RERANK,
               device: torch.device):
    """Shared merged-topology search loop for all backends.

    ``beam_fn(data, graph, entries, queries, k, *, width, n_iters, metric,
    quant, device)`` must return ``(ids, dists, SearchStats)``.

    ``dtype="f32"`` is the full-precision path, unchanged.  A staged dtype
    swaps the beam's storage for the topology's cached quantized view, asks
    it for the top ``min(rerank·k, width)`` candidates by quantized
    distance, and finishes with the shared exact-f32 re-rank epilogue
    (:func:`repro_torch.kernels.ops.rerank_exact`) — counted separately in
    the stats.

    A backend whose beam carries a ``fused_merged`` attribute (the
    ``fused`` engine) gets the whole staged search handed
    back to it instead: it runs traversal *and* the exact re-rank in one
    device dispatch, with the same candidate widening (``kq``), the same
    ``(distance, id)`` tie-break, and the same stats accounting as the
    host epilogue below.
    """
    entries = (
        topo.index.entry_points(n_entries) if n_entries > 1
        else np.asarray([topo.index.medoid])
    )
    tomb = topo.tombstones
    if dtype == "f32":
        # with tombstones, widen the request so masking dead candidates
        # still leaves k live ones (the beam returns rows sorted by
        # distance, so compaction preserves f32's exact ordering)
        kq = k if tomb is None else min(rerank * k, width)
        ids, _, stats = beam_fn(
            topo.data, topo.index.graph, entries, queries, kq,
            width=width, n_iters=n_iters, metric=topo.metric, device=device,
        )
        if tomb is not None:
            ids = drop_tombstones(ids, tomb, k)
        return ids, stats
    kq = min(rerank * k, width)
    fused = getattr(beam_fn, "fused_merged", None)
    if fused is not None and tomb is None:
        # the fused device dispatch has no tombstone mask — deletes fall
        # back to the host epilogue below, which masks before re-ranking
        return fused(topo, entries, queries, k, kq, width=width,
                     n_iters=n_iters, dtype=dtype, device=device)
    store, spec = topo.quant_view(dtype)
    cand, _, stats = beam_fn(
        store, topo.index.graph, entries, queries, kq,
        width=width, n_iters=n_iters, metric=topo.metric,
        quant=spec if spec is not None else dtype, device=device,
    )
    if tomb is not None:
        # rerank_exact tolerates -1 candidates (scored at inf, emitted as
        # -1 pad), so masking here keeps dead ids out of the final top-k
        cand = np.where(
            (np.asarray(cand, np.int64) >= 0)
            & tomb[np.maximum(cand, 0)], -1, cand,
        )
    ids, _, n_scored = _rerank_exact_timed(
        topo.data, cand, np.asarray(queries, np.float32), k, topo.metric,
    )
    stats.n_distance_computations += n_scored
    stats.n_rerank_distance_computations += n_scored
    return ids, stats


def _on(device, a: np.ndarray, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _query_centroid_distances(
    queries: np.ndarray, centroids: np.ndarray, metric: str, device
) -> np.ndarray:
    """One batched [Q, S] query×centroid tile (K1 on the card)."""
    d = ops.pairwise_distance(_on(device, queries), _on(device, centroids),
                              metric)
    return d.cpu().numpy()


def _query_centroid_distances_u8(
    queries: np.ndarray, codes: np.ndarray, spec: QuantSpec,
    resid: np.ndarray, metric: str, device
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The routing tile on uint8 codes (K2 on the card): queries quantize with the shared centroid spec and the [Q, S] tile runs
    through the integer-accumulated uint8 kernel — 1 byte per streamed
    element instead of 4 on the per-query routing work.

    Returns ``(tile [Q, S] f32, err [Q, S] f32, clipped [Q] bool)``.
    ``err`` is a *certified* per-pair bound on ``|quantized − true|``
    (valid whenever the query did not clip; ``clipped`` flags the rows
    where it is not).  The bound exploits that both rounding residual
    magnitudes are exactly known — ``e^q = |q − q̂|`` computed here per
    query, ``resid = |c − ĉ|`` cached at index time by
    :meth:`ShardTopology.centroid_quant` — only their per-pair signs vary,
    so the combined element error is at most ``u_i := e^q_i + resid_i``
    (≈ s/2 on average instead of the worst-case ``s``, which roughly
    halves the bound and with it the fallback rate):

      * L2 — ``d − d̂ = Σ e_i·(2â_i + e_i)`` with ``â = q̂ − ĉ``, so by
        Cauchy–Schwarz ``|d − d̂| ≤ 2·‖u‖·‖â‖ + ‖u‖²`` where ``‖â‖²`` is
        the quantized tile value itself and
        ``‖u‖² = ‖e^q‖² + 2·e^q·residᵀ + ‖resid‖²`` is one small matmul —
        no ``[Q, S, D]`` intermediate, so the bound costs O(Q·S) on top
        of the tile instead of re-streaming a 3-D product (the earlier
        elementwise form spent more bytes than the f32 tile it replaced).
      * ip — ``|q·c − q̂·ĉ| = |Σ q̂·e^c + ĉ·e^q + e^q·e^c|
        ≤ |q̂|·resid + |ĉ|·e^q + e^q·resid`` (three small f32 matmuls).

    The split search loop uses the bounds to certify each query's routing
    decision and falls back to the exact f32 tile only for queries whose
    decision boundary the bound straddles — that is what makes quantized
    routing *decision-identical* to f32 (the parity the tests pin) while
    streaming code bytes for the certified majority.
    """
    q = np.asarray(queries, np.float32)
    codes = np.asarray(codes)
    resid = np.asarray(resid, np.float32)
    cq = spec.quantize(q)
    d = ops.pairwise_distance_u8(
        _on(device, cq, np.uint8), _on(device, codes, np.uint8),
        spec.scale, spec.zero_point, metric,
    ).cpu().numpy()
    s = spec.scale
    lo = spec.zero_point
    hi = lo + 255.0 * s
    clipped = ((q < lo) | (q > hi)).any(axis=1)
    q_hat = spec.dequantize(cq)
    eq = np.abs(q - q_hat)  # [Q, D] exact query-side residuals
    if metric == "ip":
        c_hat = spec.dequantize(codes)
        err = (np.abs(q_hat) @ resid.T
               + eq @ np.abs(c_hat).T
               + eq @ resid.T)
    else:
        u2 = ((eq * eq).sum(axis=1)[:, None]
              + 2.0 * (eq @ resid.T)
              + (resid * resid).sum(axis=1)[None, :])  # [Q, S] = ‖u‖²
        err = 2.0 * np.sqrt(u2 * np.maximum(d, 0.0)) + u2
    return d, err.astype(np.float32), clipped


def _ambiguous_routing(
    sd: np.ndarray,  # [Q, S] tile values sorted ascending per query
    se: np.ndarray,  # [Q, S] matching error bounds
    mode: str,
    count: int,
    margin: float,
) -> np.ndarray:
    """[Q] bool: queries whose routing decision is *not* certified by the
    quantized tile's error intervals — i.e. the true distances could order
    differently than the quantized ones across the decision boundary.
    Exact ties always come back ambiguous (their intervals overlap), so the
    f32 fallback also owns f32's index-order tie-break."""
    nq, n_live = sd.shape
    if mode == "fixed":
        kk = min(count, n_live)
        if kk >= n_live:  # probing everything: no boundary to get wrong
            return np.zeros(nq, bool)
        left_max = (sd[:, :kk] + se[:, :kk]).max(axis=1)
        right_min = (sd[:, kk:] - se[:, kk:]).min(axis=1)
        return left_max >= right_min
    # auto: keep shards with d <= t where t = d1 + (margin-1)·|d1|.  The
    # true d1 is the minimum over *all* shards' true distances, so its
    # interval is [min_i(sd_i - se_i), min_i(sd_i + se_i)] — NOT the
    # quantized-rank-0 interval alone (a large-error shard further down
    # the quantized order can own the true minimum); bound t by
    # evaluating at both ends (f is not monotone for margin > 2 when
    # d1 < 0, so take the envelope)
    d1_lo = (sd - se).min(axis=1, keepdims=True)
    d1_hi = (sd + se).min(axis=1, keepdims=True)
    t_ends = np.stack([
        d1_lo + (margin - 1.0) * np.abs(d1_lo),
        d1_hi + (margin - 1.0) * np.abs(d1_hi),
    ])
    t_lo, t_hi = t_ends.min(axis=0), t_ends.max(axis=0)
    # f has a kink at d1 = 0 (f(0) = 0, a minimum when margin > 2), so an
    # interval straddling zero needs the kink in its envelope too
    straddles = (d1_lo < 0) & (d1_hi > 0)
    t_lo = np.where(straddles, np.minimum(t_lo, 0.0), t_lo)
    # a shard is decided iff it is surely inside the threshold or surely
    # outside it; since t >= d1 for any margin >= 1, "surely outside" also
    # rules out being the forced-kept nearest shard.  No position is
    # exempt: even the quantized-nearest slot must certify (it may not be
    # the true nearest).
    surely_kept = sd + se <= t_lo
    surely_dropped = sd - se > t_hi
    return (~(surely_kept | surely_dropped)).any(axis=1)


def pad_pool(
    ids: np.ndarray, d: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a per-shard [Q, k_shard] result pool to exactly ``k`` columns
    (-1 ids / inf distances).  Tiny shards (fewer than k vectors)
    legitimately return fewer columns; uniform width keeps the routed
    scatter-back and the pool concatenation regular."""
    q, kk = ids.shape
    if kk == k:
        return ids, d
    if kk > k:
        return ids[:, :k], d[:, :k]
    pad_i = np.full((q, k - kk), -1, np.int64)
    pad_d = np.full((q, k - kk), np.inf, np.float32)
    return (np.concatenate([ids, pad_i], axis=1),
            np.concatenate([d, pad_d], axis=1))


# default centroid-distance margin for nprobe="auto": a shard is probed when
# its (squared-L2 / negated-dot) centroid distance is within 25% of the
# query's nearest centroid distance
DEFAULT_AUTO_MARGIN = 1.25

NprobeSpec = typing.Union[int, str, tuple, None]


def parse_nprobe(nprobe: NprobeSpec) -> tuple[str, int, float]:
    """Normalize an ``nprobe`` spec to ``(mode, count, margin)``.

    Accepted forms — ``None`` (scatter to every shard), a positive int
    (fixed probe count), ``"auto"`` (adaptive per-query count by
    centroid-distance margin, :data:`DEFAULT_AUTO_MARGIN`), or
    ``("auto", margin)`` with an explicit ``margin >= 1``.  The spec stays a
    plain hashable value on purpose: the serving layer groups per-request
    options by it, and the backend protocol keeps its single ``nprobe``
    keyword.
    """
    if nprobe is None:
        return "scatter", 0, 0.0
    if isinstance(nprobe, str):
        if nprobe != "auto":
            raise ValueError(
                f"nprobe must be an int, 'auto', or ('auto', margin); "
                f"got {nprobe!r}"
            )
        return "auto", 0, DEFAULT_AUTO_MARGIN
    if isinstance(nprobe, tuple):
        if (len(nprobe) != 2 or nprobe[0] != "auto"
                or not isinstance(nprobe[1], (int, float))):
            raise ValueError(
                f"tuple nprobe must be ('auto', margin); got {nprobe!r}"
            )
        margin = float(nprobe[1])
        if margin < 1.0:
            raise ValueError(f"auto-nprobe margin must be >= 1, got {margin}")
        return "auto", 0, margin
    if isinstance(nprobe, bool):  # bool subclasses int; reject it
        raise ValueError(f"nprobe must be a count, got {nprobe!r}")
    n = int(nprobe)
    if n != nprobe:  # 2.7 would silently probe fewer shards than asked
        raise ValueError(f"nprobe must be integral, got {nprobe!r}")
    if n < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    return "fixed", n, 0.0


def _bucket_size(m: int) -> int:
    """Smallest bucketed batch size >= m: multiples of an eighth of the
    enclosing power of two (…, 8, 9, …, 16, 18, 20, …, 32, 36, …), so
    padding wastes at most ~15% compute while the number of distinct jit
    trace shapes stays O(log Q)."""
    if m <= 8:
        return 8
    p = 1 << (m - 1).bit_length()  # next power of two >= m
    step = p // 8
    return ((m + step - 1) // step) * step


def run_split(beam_fn, topo: ShardTopology, queries, k: int, *,
              width: int, n_iters: int | None = None,
              nprobe: NprobeSpec = None, bucket: bool = False,
              dtype: str = "f32", rerank: int = DEFAULT_RERANK,
              device: torch.device):
    """Shared split-topology search loop: centroid-routed scatter + global re-rank.

    With ``nprobe`` set and centroids available, one batched query×centroid
    distance tile routes each query to its ``min(nprobe, n_shards)`` nearest
    shards, and each shard runs a single batched beam search over only the
    queries assigned to it.  ``nprobe=None`` (default) — or a topology
    without centroids — scatters every query to every shard, the
    pre-routing behavior; ``nprobe >= n_shards`` still routes (the tile is
    computed and counted) but covers every shard, so it returns the scatter
    ids exactly.  ``nprobe="auto"`` (or ``("auto", margin)``, see
    :func:`parse_nprobe`) picks the probe count *per query* from the same
    tile: every shard whose centroid distance is within ``margin`` of the
    query's nearest centroid is probed, so easy queries (deep inside one
    cluster) pay for one shard while boundary queries fan out.  Either way each shard search seeds from the local vector
    nearest its centroid (:meth:`ShardTopology.shard_entries`; local row 0
    without centroids), and per-shard beam scores are exact so the re-rank
    reuses them — no extra distance computations.  The routing tile itself
    is genuine per-query distance work and is counted.

    ``bucket=True`` (the jitted backends) pads each shard's routed query
    group up to a bounded set of sizes (8 steps per power-of-two octave,
    ≤~15% padding waste) — by cycling real rows, so the padded lanes
    converge exactly like the lanes they copy — which caps jit retraces at
    O(n_shards · log Q) distinct shapes instead of one per routing
    distribution.  ``beam_fn`` must then honor ``n_real`` so padded lanes
    never reach the stats.

    A staged ``dtype`` (``"bf16"`` / ``"uint8"``) swaps each shard's
    storage for its cached quantized view (per-shard :class:`QuantSpec`),
    traverses on quantized distances, and widens the per-shard pools to
    ``kq = min(rerank·k, width)`` candidates.  The pools merge on the
    quantized scores (per-shard specs introduce only the bounded
    quantization error, and replicated ids dedup to their closest copy as
    before), and then *one* exact-f32 re-rank epilogue per query scores
    the merged top ``kq`` — not ``nprobe·kq`` — candidates.  Re-ranking
    once after the merge instead of once per shard is what keeps the f32
    traffic a small constant per query.  With
    ``dtype="uint8"`` the routing tile is scored on uint8 codes too
    (:meth:`ShardTopology.centroid_quant` — one shared spec so distances
    stay comparable across shards), counted as quantized work; ``"bf16"``
    keeps the f32 tile (the tile is compute-shaped, and bf16's win is
    storage streaming, not the tiny centroid set).
    """
    queries = np.asarray(queries, np.float32)
    nq = len(queries)
    stats = SearchStats()
    mode, count, margin = parse_nprobe(nprobe)
    live = [s for s, ids in enumerate(topo.shard_ids) if len(ids) > 0]
    if not live or nq == 0:
        return np.full((nq, k), -1, np.int64), stats
    n_live = len(live)
    route = mode != "scatter" and topo.centroids is not None
    if route:
        if dtype == "uint8":
            # quantized routing tile + certified-exact fallback: queries
            # whose decision the code-domain error bound cannot certify
            # (or that clip outside the spec's range) rescore their row in
            # f32, so routing decisions are identical to the f32 tile
            codes, spec, resid = topo.centroid_quant()
            qc, qerr, amb = _query_centroid_distances_u8(
                queries, codes[live], spec, resid[live], topo.metric, device
            )
            stats.n_distance_computations += nq * n_live
            stats.n_quantized_distance_computations += nq * n_live
            pre = np.argsort(qc, axis=1, kind="stable")
            amb = amb | _ambiguous_routing(
                np.take_along_axis(qc, pre, axis=1),
                np.take_along_axis(qerr, pre, axis=1),
                mode, count, margin,
            )
            n_amb = int(amb.sum())
            if n_amb:
                cent = np.asarray(topo.centroids, np.float32)[live]
                qc[amb] = _query_centroid_distances(
                    queries[amb], cent, topo.metric, device
                )
                stats.n_distance_computations += n_amb * n_live
        else:
            cent = np.asarray(topo.centroids, np.float32)[live]
            qc = _query_centroid_distances(queries, cent, topo.metric, device)
            stats.n_distance_computations += nq * n_live
        # [Q, n_live] positions into `live`, nearest shard first
        order = np.argsort(qc, axis=1, kind="stable")
        if mode == "fixed":
            probes = order[:, :min(count, n_live)]
        else:
            # adaptive: probe every shard whose centroid distance is within
            # `margin` of the query's nearest (d <= d1 + (margin-1)·|d1|,
            # which is margin·d1 for the non-negative squared-L2 case and
            # degrades gracefully for negated inner products); distances
            # are sorted, so the kept set is a per-query prefix and -1
            # marks each query's unused probe slots
            sd = np.take_along_axis(qc, order, axis=1)
            d1 = sd[:, :1]
            keep = sd <= d1 + (margin - 1.0) * np.abs(d1)
            keep[:, 0] = True  # the nearest shard is always probed
            probes = np.where(keep, order, -1)
            probes = probes[:, : int(keep.sum(axis=1).max())]
    else:
        probes = np.broadcast_to(
            np.arange(n_live), (nq, n_live)
        )
    n_probe = probes.shape[1]
    entries = topo.shard_entries()
    staged = dtype != "f32"
    tomb = topo.tombstones
    kq = k  # per-shard pool width (candidates per probed shard)
    if staged or tomb is not None:
        # staged dtypes widen for the re-rank epilogue; tombstones widen so
        # masking dead candidates still leaves k live ones after the merge
        kq = min(rerank * k, width)
    if staged:
        shard_store = topo.shard_quant(dtype)
    else:
        f32_store = topo.shard_store()  # cached: stable storage identity
    pool_ids = np.full((nq, n_probe, kq), -1, np.int64)
    pool_d = np.full((nq, n_probe, kq), np.inf, np.float32)
    for p, s in enumerate(live):
        qrows, slots = np.nonzero(probes == p)
        m = qrows.size
        if m == 0:
            continue
        use_rows = qrows
        if bucket and m < nq:
            b = min(_bucket_size(m), nq)
            if b > m:
                use_rows = np.resize(qrows, b)  # cycle real rows as padding
        ids = topo.shard_ids[s]
        if staged:
            store, spec = shard_store[s]
            quant_kw = {"quant": spec if spec is not None else dtype}
        else:
            store, quant_kw = f32_store[s], {}
        local, ld, s_stats = beam_fn(
            store, topo.shard_graphs[s],
            int(entries[s]), queries[use_rows], min(kq, len(ids)),
            width=width, n_iters=n_iters, metric=topo.metric,
            n_real=m if use_rows is not qrows else None, device=device,
            **quant_kw,
        )
        stats += s_stats
        local, ld = pad_pool(local[:m], ld[:m], kq)
        gids = np.where(local >= 0, ids[np.maximum(local, 0)], -1)
        pool_ids[qrows, slots] = gids
        pool_d[qrows, slots] = np.where(local >= 0, ld, np.inf)
    flat_ids = pool_ids.reshape(nq, n_probe * kq)
    flat_d = pool_d.reshape(nq, n_probe * kq)
    if tomb is not None:
        dead = (flat_ids >= 0) & tomb[np.maximum(flat_ids, 0)]
        flat_ids = np.where(dead, -1, flat_ids)
        flat_d = np.where(dead, np.inf, flat_d)
    # f32: pool distances are exact, so the merge takes the final top-k
    # directly; staged: keep kq candidates for the exact re-rank epilogue
    merged = rerank_shard_pools(flat_ids, flat_d, kq if staged else k)
    if not staged:
        return merged, stats
    # one exact-f32 epilogue per query over the merged quantized top-kq
    out, _, n_scored = _rerank_exact_timed(
        topo.data, merged, queries, k, topo.metric
    )
    stats.n_distance_computations += n_scored
    stats.n_rerank_distance_computations += n_scored
    return out, stats


def rerank_shard_pools(
    cat_ids: np.ndarray,  # [Q, P] global ids over all probed shards (-1 pad)
    cat_d: np.ndarray,  # [Q, P] exact scores (inf pad)
    k: int,
) -> np.ndarray:
    """Global re-rank for the split topology: dedup by id (replicated
    vectors appear in several shards, keep the closest copy) and take the k
    best per query.  Scores were already computed — and counted — by the
    in-shard searches, so this adds no distance computations.

    Fully vectorized: a (d, id)-within-(id)-groups ``lexsort`` collapses
    duplicates to their closest copy, and a second (id)-within-(d)
    ``lexsort`` yields the k best per query with the same (distance, id)
    tie-break as the old per-query dict loop.
    """
    nq = len(cat_ids)
    out = np.full((nq, k), -1, np.int64)
    cat_ids = np.asarray(cat_ids, np.int64)
    cat_d = np.asarray(cat_d, np.float32)
    pad = np.iinfo(np.int64).max  # sorts after every real id
    invalid = cat_ids < 0
    ids_key = np.where(invalid, pad, cat_ids)
    d_key = np.where(invalid, np.inf, cat_d)
    # group duplicate ids; within a group the closest copy comes first
    order = np.lexsort((d_key, ids_key), axis=1)
    sid = np.take_along_axis(ids_key, order, axis=1)
    sd = np.take_along_axis(d_key, order, axis=1)
    dup = np.zeros_like(sid, bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    sid = np.where(dup, pad, sid)
    sd = np.where(dup, np.inf, sd)
    # k best per query by (distance, id); padding sorts last
    top = np.lexsort((sid, sd), axis=1)[:, :k]
    top_ids = np.take_along_axis(sid, top, axis=1)
    out[:, : top.shape[1]] = np.where(top_ids == pad, -1, top_ids)
    return out


def topology_from_arrays(
    data: np.ndarray,
    *,
    graph: np.ndarray | None = None,
    medoid: int | None = None,
    shard_ids: list | None = None,
    shard_graphs: list | None = None,
    centroids: np.ndarray | None = None,
    tombstones: np.ndarray | None = None,
    metric: str = "l2",
) -> Topology:
    """A topology from another package's index state held as plain arrays:
    ``graph`` + ``medoid`` for a merged index, or ``shard_ids`` +
    ``shard_graphs`` (+ ``centroids``) for a split one; ``tombstones`` [N]
    bool marks deleted ids.  The port's counterpart of a weight converter:
    the same built graph can be searched by both packages."""
    from repro_torch.core.merge import GlobalIndex

    data = np.asarray(data)
    if tombstones is not None:
        tombstones = np.asarray(tombstones, bool)
        if tombstones.shape != (len(data),):
            raise ValueError("tombstones must be [N] bool")
    if graph is not None:
        if shard_ids is not None or shard_graphs is not None:
            raise ValueError("pass either a merged graph or shards, not both")
        index = GlobalIndex.from_arrays(graph, 0 if medoid is None else medoid,
                                        len(data))
        return MergedTopology(data=data, index=index, metric=metric,
                              tombstones=tombstones)
    if shard_ids is None or shard_graphs is None \
            or len(shard_ids) != len(shard_graphs):
        raise ValueError("a split topology needs aligned shard_ids and "
                         "shard_graphs")
    ids = [np.asarray(i, np.int64) for i in shard_ids]
    graphs = [np.ascontiguousarray(g, np.int32) for g in shard_graphs]
    for i, g in zip(ids, graphs):
        if g.shape[0] != len(i) or (len(i) and (i.min() < 0
                                                or i.max() >= len(data))):
            raise ValueError("shard ids and graphs do not match the data")
    return ShardTopology(
        data=data, shard_ids=ids, shard_graphs=graphs, metric=metric,
        centroids=None if centroids is None
        else np.asarray(centroids, np.float32),
        tombstones=tombstones,
    )
