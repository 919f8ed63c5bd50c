"""`LiveIndex` — the online mutation layer over the shard engine
(counterpart of ``repro/live/index.py``).

The paper's divide-and-merge pipeline (§IV) is build-once; this module is
the streaming-update path: the corpus changes while serving keeps
answering.  Three mutations, all reusing the offline machinery:

* :meth:`LiveIndex.insert_batch` — routes new points to shards via the
  partitioner's centroids, then runs **batched Vamana insertion rounds**
  per target shard: the engine's batched beam
  (:func:`repro_torch.search.beam_pool`, K3 on the card with the default
  ``fused`` backend) collects each new point's visited pool,
  :func:`~repro_torch.core.vamana.robust_prune_batch` sets its neighbor
  list, and :func:`~repro_torch.core.vamana._apply_reverse_edges` links
  it back — the offline build's round body, applied to a live graph.  A
  call uploads the shard's store and widened graph once, runs every round
  on those device tensors, and reads the graph and the distance counter
  back once at its end.
* :meth:`LiveIndex.delete_batch` — tombstones ids.  Dead points keep
  their rows and edges (the graph stays navigable through them) but the
  search drivers mask them out of the merged pools and the final top-k
  (``ShardTopology.tombstones``), so a deleted id is *never returned*
  from the moment the next snapshot swaps in.
* :meth:`LiveIndex.consolidate` — the background pass that makes deletes
  physical (FreshDiskANN-style): rows whose neighbor lists decayed past
  ``consolidate_threshold`` re-prune over ``live neighbors ∪ live 2-hop
  through dead neighbors`` on the device, then dead rows are removed with
  a local-id remap on the host and the tombstone mask drops back out of
  the hot path.  Before each re-prune the valid candidates of a row move
  to its front in their original order and the chunk is cut to its
  widest valid row: RobustPrune's stable sort by (distance, position),
  its kill rule and its counter (valid lanes only) give the same kept ids
  as on the reference's padded rows, at a fraction of the width.

A shard that outgrows ``split_max`` residents is split in two with the
partitioner's 2-means (:func:`repro_torch.core.partition
.split_shard_rows`) and both halves are rebuilt offline
(:func:`~repro_torch.core.vamana.build_shard_index_vamana`).

**State of record on the host.**  ``_data``, ``_ids``, ``_stores``,
``_graphs``, ``_centroids``, ``_tombstones`` and ``_entries`` stay numpy
arrays, as in the reference; only the rounds, the splits' builds and the
consolidation re-prune run on ``device`` (the card unless ``"cpu"`` is
given).  Insert routing, centroids, entries and quantized views are
computed on the host exactly as the reference computes them.

**Generations (copy-on-write).**  Mutations never modify an array a
previous :meth:`snapshot` handed out: per-shard stores/graphs/id-lists
are *replaced* for mutated shards and shared for untouched ones, and the
global data/tombstone arrays grow by copy.  A snapshot is therefore an
immutable generation a server can keep answering on while the next one
is built, and swapping is one atomic attribute store
(:meth:`repro_torch.serving.server.AnnServer.swap_topology`).  Sharing
untouched shards' arrays is also what keeps device caches warm: the
``fused`` backend keys its host→device cache on object identity, so after
a mutation only the mutated shards re-upload — snapshots pre-populate
``ShardTopology``'s ``shard_store()`` / ``shard_quant()`` /
``shard_entries()`` caches from the live state for exactly that reason.

**Durability.**  :meth:`LiveIndex.save` writes an atomic checksummed
snapshot (per-shard segments + manifest + ``CURRENT`` pointer flip, see
:mod:`repro_torch.durability.snapshot`, the reference's format) and
rotates in a fresh write-ahead log; from the first ``save`` on, every
mutation appends a CRC32-framed WAL record **before** touching in-memory
state.  :meth:`LiveIndex.load` restores the committed snapshot and
deterministically replays the WAL tail past the manifest's high-water
mark, so a kill at any byte boundary recovers to an index that serves
*identical* ids.  Either package loads and replays the other's snapshot
and log when both run the same backend (the replay pins compare it).

**Concurrency.**  Mutations (and ``save``) serialize behind one
re-entrant writer lock; :meth:`snapshot` takes the same lock, so a
snapshot cut concurrently with a mutator is always a consistent
generation, and readers never need a lock at all.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading

import numpy as np
import torch

from repro_torch.configs.base import IndexConfig
from repro_torch.core.partition import split_shard_rows
from repro_torch.core.vamana import (PRUNE_CHUNK_BYTES, _apply_reverse_edges,
                                     _rows_per_chunk,
                                     build_shard_index_vamana,
                                     robust_prune_batch)
from repro_torch.device import resolve_device
from repro_torch.durability import (SimulatedCrash, SnapshotCorruptionError,
                                    WalCorruptionError, WriteAheadLog,
                                    load_manifest, save_snapshot)
from repro_torch.durability.crash import NULL_INJECTOR
from repro_torch.durability.snapshot import gc_snapshot_dir, load_segment
from repro_torch.search import ShardTopology
from repro_torch.search.types import QuantSpec, _to_bf16
from repro_torch.telemetry import current_registry, current_tracer

DEFAULT_SPLIT_FACTOR = 2.0
DEFAULT_INSERT_BATCH = 256


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """Knobs for :class:`LiveIndex` (the graph knobs — degree R, build
    width L — come from the :class:`~repro_torch.configs.base.IndexConfig`
    the offline build used, so live and offline graphs share semantics).

    ``alpha`` — RobustPrune's α for insert rounds and consolidation
    re-prunes (the offline build's second-pass value).
    ``backend`` — engine backend for the insert beam searches and the
    splits' builds.  The port defaults to ``"fused"`` (K3 on the card),
    where the reference defaults to ``"numpy"``, under which no kernel
    would run; ``ServingConfig`` made the same change.
    ``consolidate_threshold`` — a live row re-prunes during
    :meth:`LiveIndex.consolidate` when more than this fraction of its
    neighbors are tombstoned; below it the dead edges are simply dropped.
    ``split_max`` — resident count past which a shard splits in two;
    ``None`` derives ``split_factor ×`` the initial mean shard size at
    construction.
    ``batch_size`` — insert-round grain (the offline build's round
    batch).
    """

    alpha: float = 1.2
    backend: str = "fused"
    consolidate_threshold: float = 0.25
    split_max: int | None = None
    split_factor: float = DEFAULT_SPLIT_FACTOR
    batch_size: int = DEFAULT_INSERT_BATCH


class LiveIndex:
    """Mutable shard index: batched inserts, tombstone deletes, background
    consolidation, kmeans shard splits — served through immutable
    copy-on-write :meth:`snapshot` generations.

    Construct from a served topology (:meth:`from_topology`) or straight
    from an offline build (:meth:`from_build`).  ``device`` is where the
    mutations' kernels run: the card unless ``"cpu"`` is given.  All
    mutation methods are synchronous and single-writer by design.
    """

    def __init__(self, topology: ShardTopology, cfg: IndexConfig,
                 live: LiveConfig | None = None, *, device=None):
        if topology.tombstones is not None:
            raise ValueError(
                "construct LiveIndex from a clean topology; tombstones are "
                "owned by the live layer"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.live = live or LiveConfig()
        self.metric = topology.metric
        self._data = np.asarray(topology.data, np.float32)
        self._ids = [np.asarray(i, np.int64) for i in topology.shard_ids]
        self._graphs = [np.asarray(g, np.int32) for g in topology.shard_graphs]
        self._stores = [
            np.asarray(self._data[i], np.float32) for i in self._ids
        ]
        if topology.centroids is not None:
            self._centroids = np.asarray(topology.centroids, np.float32)
        else:  # routing needs centroids; derive them from the residents
            self._centroids = np.stack([
                s.mean(axis=0) if len(s) else np.zeros(
                    self._data.shape[1], np.float32)
                for s in self._stores
            ]).astype(np.float32)
        self._tombstones = np.zeros(len(self._data), bool)
        self._dead_in_shard = np.zeros(len(self._ids), np.int64)
        self._entries = np.zeros(len(self._ids), np.int64)
        for s in range(len(self._ids)):
            self._recompute_entry(s)
        # per-dtype per-shard quantized views; a mutated shard's slot is
        # reset to None and lazily rebuilt at the next snapshot
        self._quant_views: dict[str, list] = {}
        sizes = [len(i) for i in self._ids if len(i)]
        self._split_max = self.live.split_max or max(
            64, int(self.live.split_factor * (
                sum(sizes) / len(sizes) if sizes else 1))
        )
        self.generation = 0
        self.n_distance_computations = 0
        self._init_mutable_state()

    def _init_mutable_state(self) -> None:
        # writer lock: insert/delete/consolidate/save/snapshot serialize
        # here; readers (searches over snapshots) never take it
        self._mutlock = threading.RLock()
        # durable-logging state: attached by the first save()/load();
        # wal_seq counts logged mutations (the manifest's high-water mark
        # plus the replayed/appended tail)
        self._wal: WriteAheadLog | None = None
        self._replaying = False
        self._fsync_interval = 1
        self.wal_seq = 0

    # ---- constructors ---------------------------------------------------

    @classmethod
    def from_topology(cls, topology: ShardTopology, cfg: IndexConfig,
                      live: LiveConfig | None = None, *,
                      device=None) -> "LiveIndex":
        return cls(topology, cfg, live, device=device)

    @classmethod
    def from_build(cls, result, data: np.ndarray, cfg: IndexConfig,
                   live: LiveConfig | None = None, *,
                   device=None) -> "LiveIndex":
        """From a :class:`~repro_torch.core.builder.BuildResult` — serves
        the pre-merge routed shard view (the partition's centroids come
        along for insert routing)."""
        return cls(result.shard_topology(data), cfg, live, device=device)

    # ---- introspection --------------------------------------------------

    @property
    def n_vectors(self) -> int:
        """Total vectors ever inserted (tombstoned ones included)."""
        return len(self._data)

    @property
    def n_live(self) -> int:
        return int(len(self._data) - self._tombstones.sum())

    @property
    def n_shards(self) -> int:
        return len(self._ids)

    @property
    def resident_dead(self) -> int:
        """Tombstoned ids still occupying shard rows (0 after a full
        :meth:`consolidate` — the snapshot drops its tombstone mask and
        the search fast paths come back)."""
        return int(self._dead_in_shard.sum())

    # ---- snapshotting ---------------------------------------------------

    def snapshot(self) -> ShardTopology:
        """An immutable serving generation.

        Untouched shards share their arrays with previous snapshots —
        and the topology's derived caches (``shard_store`` /
        ``shard_quant`` / ``shard_entries``) are pre-populated from the
        live state — so identity-keyed device caches stay warm for
        everything a mutation didn't touch.  The tombstone mask rides
        along only while deleted ids are still resident.  Takes the
        writer lock, so the cut is always a whole generation.
        """
        with self._mutlock:
            topo = ShardTopology(
                data=self._data,
                shard_ids=list(self._ids),
                shard_graphs=list(self._graphs),
                metric=self.metric,
                centroids=self._centroids,
                tombstones=self._tombstones if self.resident_dead else None,
            )
            topo._store_cache = list(self._stores)
            topo._entries = self._entries.copy()
            for dtype in self._quant_views:
                topo._quant_cache[dtype] = self._quant_list(dtype)
            return topo

    def prepare(self, dtype: str) -> None:
        """Register a staged distance dtype (``"bf16"`` / ``"uint8"``):
        every snapshot from here on carries pre-built per-shard quantized
        views, rebuilt only for mutated shards."""
        self._quant_list(dtype)

    def _quant_list(self, dtype: str) -> list:
        views = self._quant_views.setdefault(dtype, [None] * len(self._ids))
        for s, v in enumerate(views):
            if v is None:
                rows = self._stores[s]
                if dtype == "uint8":
                    spec = QuantSpec.from_data(rows)
                    views[s] = (spec.quantize(rows), spec)
                elif dtype == "bf16":
                    views[s] = (_to_bf16(rows), None)
                else:
                    raise ValueError(f"no quantized view for dtype {dtype!r}")
        return list(views)

    # ---- mutation: inserts ----------------------------------------------

    def insert_batch(self, vectors: np.ndarray) -> np.ndarray:
        """Insert a batch of new vectors; returns their global ids.

        Each point routes to its nearest-centroid shard, then every
        target shard runs batched Vamana rounds over its new points (see
        :meth:`_insert_rounds`).  Mutated shards' arrays are replaced
        (copy-on-write); any shard that outgrows ``split_max`` is split in
        two afterwards.
        """
        X = np.atleast_2d(np.asarray(vectors, np.float32))
        m = len(X)
        if m == 0:
            return np.empty(0, np.int64)
        if X.shape[1] != self._data.shape[1]:
            raise ValueError(
                f"insert dim {X.shape[1]} != index dim {self._data.shape[1]}"
            )
        with self._mutlock:
            return self._insert_batch_locked(X, m)

    def _insert_batch_locked(self, X: np.ndarray, m: int) -> np.ndarray:
        tr = current_tracer()
        reg = current_registry()
        self._log_mutation("insert", {"vectors": X})
        gids = len(self._data) + np.arange(m, dtype=np.int64)
        with tr.span("live.insert", track="live", n=m):
            if self.metric == "ip":
                scores = -(X @ self._centroids.T)
            else:
                scores = (
                    (X * X).sum(1)[:, None]
                    - 2.0 * (X @ self._centroids.T)
                    + (self._centroids * self._centroids).sum(1)[None, :]
                )
            assign = np.argmin(scores, axis=1)
            self._data = np.concatenate([self._data, X])
            self._tombstones = np.concatenate(
                [self._tombstones, np.zeros(m, bool)]
            )
            touched = []
            for s in np.unique(assign):
                rows = assign == s
                self._insert_into_shard(int(s), X[rows], gids[rows])
                touched.append(int(s))
            for s in touched:
                if len(self._ids[s]) > self._split_max:
                    self._split_shard(s)
        self.generation += 1
        reg.counter("live_inserts_total",
                    "vectors inserted through the live layer").inc(m)
        reg.gauge("live_generation",
                  "mutation generation of the live index"
                  ).set(self.generation)
        return gids

    def _insert_into_shard(self, s: int, X: np.ndarray,
                           gids: np.ndarray) -> None:
        n0 = len(self._stores[s])
        store = np.concatenate([self._stores[s], X]) if n0 else X.copy()
        if n0 == 0:
            # empty shard: nothing to link against — offline-build the
            # newcomers (the n<=1 degenerate guard handles tiny batches)
            idx = build_shard_index_vamana(
                store, self.cfg, alpha=self.live.alpha,
                backend=self.live.backend, seed=self.cfg.seed,
                device=self.device,
            )
            graph, counted = idx.graph, idx.n_distance_computations
        else:
            graph, counted = self._insert_rounds(s, store, n0)
        self.n_distance_computations += counted
        self._ids[s] = np.concatenate([self._ids[s], gids])
        self._stores[s] = store
        self._graphs[s] = np.asarray(graph, np.int32)
        self._touch_shard(s)

    def _insert_rounds(self, s: int, store: np.ndarray,
                       n0: int) -> tuple[np.ndarray, int]:
        """Rows ``n0:`` of ``store`` join shard ``s``'s graph in rounds of
        ``batch_size``: each round beam-searches the live graph for the
        round's points (seeded at the shard entry), prunes their pools and
        applies the reverse edges, all on ``device`` tensors uploaded once
        (the graph tensor is the build's live state: no backend caches
        it).  Returns the host graph ``[n, max(R, R_old)]`` and the
        distance count, both read back once."""
        from repro_torch.search import beam_pool  # deferred, as in vamana

        dev = self.device
        n = len(store)
        R = min(self.cfg.degree, max(1, n - 1))
        R_old = self._graphs[s].shape[1]
        host = np.full((n, max(R, R_old)), -1, np.int32)
        host[:n0, :R_old] = self._graphs[s]  # COW: old rows copied
        x = torch.from_numpy(store).to(dev)
        graph = torch.from_numpy(host).to(dev)
        counter = [torch.zeros((), dtype=torch.long, device=dev)]
        pool = max(self.cfg.build_degree, R + 1)
        entry = int(self._entries[s])
        alpha = self.live.alpha
        nb = self.live.batch_size
        for b0 in range(n0, n, nb):
            batch = torch.arange(b0, min(b0 + nb, n), device=dev)
            pool_ids, pool_d, p_stats = beam_pool(
                x, graph, entry, x[batch], pool, backend=self.live.backend,
                metric=self.metric, n_iters=pool, device=dev,
            )
            counter[0] = counter[0] + p_stats.n_distance_computations
            pruned = robust_prune_batch(batch, pool_ids, pool_d, x, alpha,
                                        R, counter)
            graph[batch] = -1
            graph[batch, : pruned.shape[1]] = pruned.to(graph.dtype)
            _apply_reverse_edges(batch, pruned, graph, x, alpha, R, counter)
        return graph.cpu().numpy(), int(counter[0])

    # ---- mutation: deletes ----------------------------------------------

    def delete_batch(self, ids: np.ndarray) -> int:
        """Tombstone ids; returns how many were newly deleted.

        O(1) per id on the serving path: nothing in any shard moves —
        the next snapshot carries the (copied) tombstone mask and the
        search drivers mask dead candidates out of pools and the final
        top-k.  Edges through dead points keep working until
        :meth:`consolidate` removes them.
        """
        ids = np.unique(np.asarray(ids, np.int64))
        with self._mutlock:
            if ids.size and (ids[0] < 0 or ids[-1] >= len(self._data)):
                raise ValueError("delete id out of range")
            fresh = ids[~self._tombstones[ids]] if ids.size else ids
            if fresh.size == 0:
                return 0
            return self._delete_batch_locked(fresh)

    def _delete_batch_locked(self, fresh: np.ndarray) -> int:
        tr = current_tracer()
        reg = current_registry()
        self._log_mutation("delete", {"ids": fresh})
        with tr.span("live.delete", track="live", n=int(fresh.size)):
            tomb = self._tombstones.copy()  # COW: snapshots keep the old mask
            tomb[fresh] = True
            self._tombstones = tomb
            mask = np.zeros(len(self._data), bool)
            mask[fresh] = True
            for s, sids in enumerate(self._ids):
                if len(sids):
                    self._dead_in_shard[s] += int(mask[sids].sum())
        self.generation += 1
        reg.counter("live_deletes_total",
                    "ids tombstoned through the live layer"
                    ).inc(int(fresh.size))
        reg.gauge("live_tombstones_resident",
                  "tombstoned ids still resident in shard rows"
                  ).set(self.resident_dead)
        reg.gauge("live_generation",
                  "mutation generation of the live index"
                  ).set(self.generation)
        return int(fresh.size)

    # ---- mutation: consolidation ----------------------------------------

    def consolidate(self, threshold: float | None = None) -> dict:
        """Make tombstones physical (the background pass).

        Per shard with resident dead ids: live rows whose dead-neighbor
        fraction exceeds ``threshold`` re-prune over ``live neighbors ∪
        live 2-hop through dead neighbors`` (RobustPrune self-occludes
        duplicates, so the union needs no dedup); every other live row
        just drops its dead edges.  Then dead rows are physically removed
        with a local-id remap, rows re-compacted, and the shard's entry
        recomputed.

        Returns ``{"rows_repruned": ..., "removed": ..., "shards": ...}``.
        """
        thr = self.live.consolidate_threshold if threshold is None \
            else threshold
        with self._mutlock:
            return self._consolidate_locked(float(thr))

    def _consolidate_locked(self, thr: float) -> dict:
        tr = current_tracer()
        reg = current_registry()
        self._log_mutation(
            "consolidate", {"threshold": np.array([thr], np.float64)})
        repruned = removed = shards = 0
        counter = [0]
        with tr.span("live.consolidate", track="live",
                     resident=self.resident_dead):
            for s in range(len(self._ids)):
                if self._dead_in_shard[s] == 0:
                    continue
                r, d = self._consolidate_shard(s, thr, counter)
                repruned += r
                removed += d
                shards += 1
        self.n_distance_computations += counter[0]
        self.generation += 1
        reg.counter("live_consolidations_total",
                    "consolidation passes completed").inc()
        reg.counter("live_rows_repruned_total",
                    "rows re-pruned by consolidation").inc(repruned)
        reg.gauge("live_tombstones_resident",
                  "tombstoned ids still resident in shard rows"
                  ).set(self.resident_dead)
        reg.gauge("live_generation",
                  "mutation generation of the live index"
                  ).set(self.generation)
        return {"rows_repruned": repruned, "removed": removed,
                "shards": shards}

    def _consolidate_shard(self, s: int, thr: float,
                           counter: list) -> tuple[int, int]:
        ids = self._ids[s]
        store = self._stores[s]
        graph = np.asarray(self._graphs[s], np.int64)  # copy (COW) + widen
        n, R = graph.shape
        dead = self._tombstones[ids]  # local mask
        nbr_valid = graph >= 0
        nbr_dead = nbr_valid & dead[np.maximum(graph, 0)]
        frac = nbr_dead.sum(1) / np.maximum(nbr_valid.sum(1), 1)
        fix = np.nonzero(~dead & (frac > thr))[0]
        if fix.size:
            pruned = self._reprune(store, graph, dead, nbr_dead, fix,
                                   counter)
            graph[fix] = -1
            graph[fix, : pruned.shape[1]] = pruned
        # physical removal: drop dead rows, remap local ids, strip any
        # remaining dead edges (rows under the threshold), re-compact
        keep = ~dead
        remap = np.full(n, -1, np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        g = graph[keep]
        g = np.where(g >= 0, remap[np.maximum(g, 0)], -1)
        order = np.argsort(g < 0, axis=1, kind="stable")
        g = np.take_along_axis(g, order, axis=1)
        self._ids[s] = ids[keep]
        self._stores[s] = np.ascontiguousarray(store[keep])
        self._graphs[s] = g.astype(np.int32)
        n_removed = int(dead.sum())
        self._dead_in_shard[s] = 0
        self._touch_shard(s)
        return int(fix.size), n_removed

    def _reprune(self, store: np.ndarray, graph: np.ndarray,
                 dead: np.ndarray, nbr_dead: np.ndarray, fix: np.ndarray,
                 counter: list) -> np.ndarray:
        """Consolidation's re-prune of rows ``fix`` on ``device``: ``[f, R]``
        kept local ids.  In chunks of rows sized by their padded candidate
        bytes: gather each row's candidates (``live neighbors ∪ live
        2-hop through dead neighbors``, ``R + R²`` lanes, -1 padded),
        count them, and compact the valid ones to the front of the row in
        their order (:func:`_compact`).  Then, widest rows first, prune
        slices of rows that fit the prune's byte budget, each cut to its
        own widest row: rows are independent, so their order changes no
        result, and a slice of narrow rows holds more of them."""
        dev = self.device
        R = graph.shape[1]
        x = torch.from_numpy(store).to(dev)
        g = torch.from_numpy(graph).to(dev)
        dead_t = torch.from_numpy(dead).to(dev)
        nd_t = torch.from_numpy(nbr_dead).to(dev)
        fix_t = torch.from_numpy(fix).to(dev)
        out = torch.empty((len(fix), R), dtype=torch.long, device=dev)
        count = [torch.zeros((), dtype=torch.long, device=dev)]
        step = max(1, PRUNE_CHUNK_BYTES // (32 * (R + R * R)))
        for lo in range(0, len(fix), step):
            rows = fix_t[lo:lo + step]
            g1 = g[rows]
            nd = nd_t[rows]
            c1 = torch.where((g1 >= 0) & ~nd, g1, -1)
            two = g[g1.clamp_min(0)]  # [b, R, R]
            ok2 = nd[:, :, None] & (two >= 0) & ~dead_t[two.clamp_min(0)]
            cand = torch.cat(
                [c1, torch.where(ok2, two, -1).reshape(len(rows), R * R)],
                dim=1)
            widths = (cand >= 0).sum(dim=1)
            count[0] = count[0] + widths.sum()  # scoring the candidates
            order = torch.argsort(widths, descending=True, stable=True)
            cand, rows = _compact(cand[order]), rows[order]
            widths = widths[order].tolist()
            a = 0
            while a < len(rows):
                w = max(1, widths[a])
                b = a + _rows_per_chunk(w, x.shape[1])
                c = cand[a:b, :w]
                cvecs = x[c.clamp_min(0)]
                diff = cvecs - x[rows[a:b]][:, None, :]
                cand_d = torch.where(c >= 0, (diff * diff).sum(dim=2),
                                     torch.inf)
                out[lo + order[a:b]] = robust_prune_batch(
                    rows[a:b], c, cand_d, x, self.live.alpha, R, count,
                    vecs=cvecs)
                a = b
        counter[0] += int(count[0])
        return out.cpu().numpy()

    # ---- mutation: shard split ------------------------------------------

    def _split_shard(self, s: int) -> None:
        tr = current_tracer()
        reg = current_registry()
        rows = self._stores[s]
        with tr.span("live.split", track="live", shard=s, n=len(rows)):
            assign, cents = split_shard_rows(rows, seed=self.cfg.seed,
                                             device=self.device)
            if (assign == 0).all() or (assign == 1).all():
                return  # degenerate 2-means (identical rows): keep as one
            halves = []
            for h in (0, 1):
                mask = assign == h
                idx = build_shard_index_vamana(
                    rows[mask], self.cfg, alpha=self.live.alpha,
                    backend=self.live.backend, seed=self.cfg.seed,
                    device=self.device,
                )
                self.n_distance_computations += idx.n_distance_computations
                halves.append((
                    self._ids[s][mask],
                    np.ascontiguousarray(rows[mask]),
                    np.asarray(idx.graph, np.int32),
                ))
            # shard s becomes half 0; half 1 appends as a new shard
            (self._ids[s], self._stores[s], self._graphs[s]) = halves[0]
            self._ids.append(halves[1][0])
            self._stores.append(halves[1][1])
            self._graphs.append(halves[1][2])
            cent = self._centroids.copy()  # COW: snapshots keep theirs
            cent[s] = cents[0]
            self._centroids = np.concatenate([cent, cents[1][None, :]])
            self._entries = np.append(self._entries, 0)
            dead0 = int(self._tombstones[halves[0][0]].sum())
            dead1 = int(self._tombstones[halves[1][0]].sum())
            self._dead_in_shard[s] = dead0
            self._dead_in_shard = np.append(self._dead_in_shard, dead1)
            for views in self._quant_views.values():
                views.append(None)
            self._touch_shard(s)
            self._touch_shard(len(self._ids) - 1)
        reg.counter("live_splits_total",
                    "shards split by the live layer").inc()

    # ---- durability: WAL + atomic snapshots ------------------------------

    def _replay_pins(self) -> dict:
        """The config values WAL replay depends on — pinned into the
        manifest and verified on load, because replaying under different
        knobs would deterministically diverge.  The same keys as the
        reference's, and no device: a snapshot loads in either package."""
        return {
            "degree": int(self.cfg.degree),
            "build_degree": int(self.cfg.build_degree),
            "seed": int(self.cfg.seed),
            "alpha": float(self.live.alpha),
            "backend": str(self.live.backend),
            "batch_size": int(self.live.batch_size),
            "consolidate_threshold": float(
                self.live.consolidate_threshold),
        }

    def _log_mutation(self, op: str, arrays: dict) -> None:
        """Append the mutation to the WAL **before** any in-memory state
        changes.  No-op until a :meth:`save`/:meth:`load` attaches a
        log; during replay the sequence counter advances without
        re-appending."""
        if self._replaying:
            self.wal_seq += 1
            return
        if self._wal is None:
            return
        self._wal.append(self.wal_seq + 1, op, arrays)
        self.wal_seq += 1

    def save(self, root, *, fsync_interval: int | None = None,
             injector=None) -> dict:
        """Commit an atomic checksummed snapshot to ``root`` and rotate
        in a fresh WAL.

        The first ``save`` is also what arms durable logging: from its
        return on, every mutation is WAL-framed before it applies.
        Commit protocol (see :mod:`repro_torch.durability.snapshot`):
        per-shard ``ids``/``graph`` segments plus one global segment
        (stores are *not* written — shard rows equal ``data[ids]`` by
        construction, so load reconstructs them), then the manifest, then
        the ``CURRENT`` pointer flip — the single commit point.  Returns
        the committed manifest."""
        root = pathlib.Path(root)
        inj = injector if injector is not None else NULL_INJECTOR
        tr = current_tracer()
        reg = current_registry()
        with self._mutlock:
            if fsync_interval is not None:
                self._fsync_interval = int(fsync_interval)
            with tr.span("durability.snapshot_save", track="durability",
                         n_vectors=self.n_vectors, n_shards=self.n_shards,
                         wal_seq=self.wal_seq):
                segments: dict[str, dict] = {
                    f"shard{s:04d}": {"ids": self._ids[s],
                                      "graph": self._graphs[s]}
                    for s in range(len(self._ids))
                }
                segments["global"] = {
                    "data": self._data,
                    "tombstones": self._tombstones,
                    "centroids": self._centroids,
                    "dead_in_shard": self._dead_in_shard,
                    "entries": self._entries,
                }
                meta = {
                    "metric": self.metric,
                    "n_shards": self.n_shards,
                    "n_vectors": self.n_vectors,
                    "dim": int(self._data.shape[1]),
                    "split_max": int(self._split_max),
                    "generation": int(self.generation),
                    "wal_seq": int(self.wal_seq),
                    "config": self._replay_pins(),
                }
                manifest = save_snapshot(root, segments, meta, injector=inj)
                # the committed snapshot covers everything up to wal_seq
                # — rotate in the fresh (empty) log the manifest names;
                # if the rotate never happens, load treats the missing
                # file as an empty log, which is exactly right
                old_wal = self._wal
                inj.reached("wal.rotate")
                self._wal = WriteAheadLog(
                    root / manifest["wal_file"],
                    fsync_interval=self._fsync_interval, injector=inj)
                if old_wal is not None:
                    old_wal.close()
                gc_snapshot_dir(root, manifest)
                reg.counter("snapshot_saves_total",
                            "atomic LiveIndex snapshots committed").inc()
        return manifest

    @classmethod
    def load(cls, root, cfg: IndexConfig, live: LiveConfig | None = None,
             *, fsync_interval: int = 1, injector=None,
             device=None) -> "LiveIndex":
        """Recover: restore the committed snapshot, replay the WAL tail.

        Resolves ``CURRENT`` → manifest (CRC-verified), restores every
        segment (CRC + size verified), then opens the manifest's WAL —
        truncating a torn final record — and replays every record past
        the manifest's high-water mark on ``device``.  Replay calls the
        same mutation methods the original process ran; they are
        deterministic given identical state + config pins, so the
        recovered index is bit-identical to the pre-crash one up to the
        last durable record.  The recovered index keeps logging to the
        same WAL."""
        root = pathlib.Path(root)
        inj = injector if injector is not None else NULL_INJECTOR
        tr = current_tracer()
        reg = current_registry()
        with tr.span("durability.recover", track="durability"):
            manifest = load_manifest(root)
            li = cls._from_snapshot(root, manifest, cfg, live, device)
            li._fsync_interval = int(fsync_interval)
            wal = WriteAheadLog(root / manifest["wal_file"],
                                fsync_interval=int(fsync_interval),
                                injector=inj)
            mark = int(manifest["wal_seq"])
            replayed = 0
            with tr.span("durability.replay", track="durability",
                         n_records=len(wal.records), mark=mark):
                li._replaying = True
                try:
                    for rec in wal.records:
                        if rec.seq <= mark:
                            continue  # already inside the snapshot
                        if rec.seq != li.wal_seq + 1:
                            raise WalCorruptionError(
                                wal.path, rec.offset,
                                f"replay gap: state covers seq "
                                f"{li.wal_seq}, next record is {rec.seq}")
                        li._apply_record(rec)
                        replayed += 1
                        inj.reached("replay.record")
                except SimulatedCrash:
                    # recovery is crash-safe: nothing on disk mutated
                    # (beyond the idempotent torn-tail truncate), so a
                    # re-load simply replays again from the snapshot
                    wal.close()
                    raise
                finally:
                    li._replaying = False
            li._wal = wal
            reg.counter(
                "recovery_total",
                "LiveIndex recoveries (snapshot restore + WAL replay)",
            ).inc()
            reg.counter(
                "recovery_replayed_records_total",
                "WAL tail records replayed during recovery",
            ).inc(replayed)
        return li

    @classmethod
    def _from_snapshot(cls, root: pathlib.Path, manifest: dict,
                       cfg: IndexConfig, live: LiveConfig | None,
                       device=None) -> "LiveIndex":
        live = live or LiveConfig()
        li = object.__new__(cls)
        li.device = resolve_device(device)
        li.cfg = cfg
        li.live = live
        pins = li._replay_pins()
        saved = manifest.get("config", {})
        diffs = {k: (saved.get(k), v) for k, v in pins.items()
                 if saved.get(k) != v}
        if diffs:
            raise ValueError(
                "config disagrees with the snapshot manifest — WAL "
                f"replay would diverge ({{name: (saved, given)}}): {diffs}"
            )
        sid = int(manifest["snapshot_id"])
        gname = f"seg-{sid:06d}-global.npz"
        g = load_segment(root, manifest, gname)
        li.metric = str(manifest["metric"])
        li._data = np.asarray(g["data"], np.float32)
        want = (int(manifest["n_vectors"]), int(manifest["dim"]))
        if li._data.shape != want:
            raise SnapshotCorruptionError(
                root / gname,
                f"data shape {li._data.shape} disagrees with manifest "
                f"{want}")
        li._tombstones = np.asarray(g["tombstones"], bool)
        li._centroids = np.asarray(g["centroids"], np.float32)
        li._dead_in_shard = np.asarray(g["dead_in_shard"], np.int64)
        li._entries = np.asarray(g["entries"], np.int64)
        li._ids, li._graphs, li._stores = [], [], []
        for s in range(int(manifest["n_shards"])):
            name = f"seg-{sid:06d}-shard{s:04d}.npz"
            seg = load_segment(root, manifest, name)
            ids = np.asarray(seg["ids"], np.int64)
            if ids.size and (ids.min() < 0 or ids.max() >= len(li._data)):
                raise SnapshotCorruptionError(
                    root / name,
                    f"shard {s} ids outside [0, {len(li._data)})")
            li._ids.append(ids)
            li._graphs.append(np.asarray(seg["graph"], np.int32))
            # stores are not persisted: shard rows equal data[ids] by
            # construction, so reconstruct (halves the snapshot)
            li._stores.append(np.ascontiguousarray(li._data[ids]))
        li._quant_views = {}
        li._split_max = int(manifest["split_max"])
        li.generation = int(manifest["generation"])
        li.n_distance_computations = 0
        li._init_mutable_state()
        li.wal_seq = int(manifest["wal_seq"])
        return li

    def _apply_record(self, rec) -> None:
        if rec.op == "insert":
            self.insert_batch(rec.arrays["vectors"])
        elif rec.op == "delete":
            self.delete_batch(rec.arrays["ids"])
        elif rec.op == "consolidate":
            self.consolidate(float(rec.arrays["threshold"][0]))
        else:  # unreachable: the WAL decoder already rejected the opcode
            raise ValueError(f"unknown WAL op {rec.op!r}")

    def sync(self) -> None:
        """Force the group-commit barrier: fsync any WAL records still
        inside the ``fsync_interval`` window."""
        with self._mutlock:
            if self._wal is not None:
                self._wal.sync()

    def close(self) -> None:
        """fsync + close + detach the attached WAL (safe without one).

        The index keeps working after ``close()``, but mutations are no
        longer logged — in-memory only, exactly like an index that was
        never ``save()``d.  ``save()`` re-arms durability."""
        with self._mutlock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    # ---- internals ------------------------------------------------------

    def _touch_shard(self, s: int) -> None:
        """A shard's storage changed: refresh its routing centroid and
        entry point and drop its cached quantized views (identity-keyed
        device caches invalidate themselves — the storage object is
        new)."""
        rows = self._stores[s]
        if len(rows):
            cent = self._centroids.copy()  # COW
            cent[s] = rows.mean(axis=0)
            self._centroids = cent
        self._recompute_entry(s)
        for views in self._quant_views.values():
            views[s] = None

    def _recompute_entry(self, s: int) -> None:
        rows = self._stores[s]
        if len(rows) == 0:
            self._entries[s] = 0
            return
        c = self._centroids[s]
        if self.metric == "ip":
            scores = -(rows @ c)
        else:
            diff = rows - c[None, :]
            scores = np.einsum("nd,nd->n", diff, diff)
        # prefer a live seed: a dead entry still traverses, but a live
        # one keeps the first hop useful
        dead = self._tombstones[self._ids[s]]
        if not dead.all():
            scores = np.where(dead, np.inf, scores)
        self._entries[s] = int(np.argmin(scores))


def _compact(cand: torch.Tensor) -> torch.Tensor:
    """Each row's valid candidates (``>= 0``) moved to its front in their
    order, the rest -1, cut to the widest row's valid count (at least
    one lane).  RobustPrune sorts stably by (distance, position) and
    never counts or keeps an invalid lane, so it keeps the same ids from
    the compacted rows as from the padded ones."""
    valid = cand >= 0
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    width = max(1, int(valid.sum(dim=1).max())) if len(cand) else 1
    return cand.gather(1, order[:, :width])
