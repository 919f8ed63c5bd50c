"""The ``fused`` search backend (counterpart of
``repro/search/pallas_backend.py``): a thin host shell around
:func:`repro_torch.kernels.beam.fused_beam`, which runs the whole traversal
(and, for staged dtypes on merged topologies, the exact re-rank too) as one
dispatch per batch — K3 on the card, its plain version on the CPU.

What lives here rather than in the kernel module:

  * **Device residency.**  Storage, graphs and the kernel's per-row
    constants are moved to the device once per ``(storage, graph, stage,
    device)`` and cached in a bounded LRU keyed on object identity; each
    entry holds a strong reference to its host arrays, so an ``id`` cannot
    be recycled while it is cached.  The topologies cache their storage
    views, so steady-state serving presents the same host objects call
    after call.
  * **The beam_fn protocol** (:func:`fused_beam_search`) for the shared
    ``run_merged`` / ``run_split`` search loops and :func:`repro_torch.search
    .beam_pool`: numpy in and out, ``n_real`` stats slicing, ``quant``
    staging.  A graph given as a tensor (a Vamana build's live state) is
    read, with its store, as it is at each call and never cached.
  * **The fused merged staged path** (``fused_beam_search.fused_merged``):
    ``run_merged`` hands the whole staged search back here, so traversal
    and the exact-f32 re-rank run in one dispatch.  It never sees
    tombstones: ``run_merged`` keeps those on its host epilogue.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.kernels import beam as _beam
from repro_torch.search.types import (DEFAULT_RERANK, MergedTopology,
                                      NprobeSpec, QuantSpec, SearchStats,
                                      ShardTopology, is_live, run_merged,
                                      run_split)

# a serving deployment's working set (a few topologies × a few dtype
# stages), small enough that abandoned topologies don't pin device memory
_CACHE_CAP = 16


@dataclasses.dataclass
class _Prepared:
    """Device tensors for one (storage, graph) pair; ``host_*`` keep the
    keys' ``id()`` valid and make the identity check exact."""

    host_x: object
    host_graph: object
    x: torch.Tensor
    graph: torch.Tensor
    aux: tuple | None  # beam_aux(x) on the card; the plain path needs none


_PREP_CACHE: "OrderedDict[tuple, _Prepared]" = OrderedDict()
_PREP_LOCK = threading.Lock()


def _stage(quant) -> str:
    return ("u8" if isinstance(quant, QuantSpec)
            else "bf16" if quant == "bf16" else "f32")


def _prepared(data, graph, quant, device: torch.device) -> _Prepared:
    """Device tensors for ``(data, graph)`` under a staging mode, LRU-cached
    on object identity; a build's live state (a graph tensor,
    :func:`is_live`) is taken as it is at this call and cached nothing for,
    since the build mutates it between calls and the identity cache would
    hand back a stale copy."""
    stage = _stage(quant)
    live = is_live(graph)
    key = (id(data), id(graph), stage, str(device))
    if not live:
        with _PREP_LOCK:
            hit = _PREP_CACHE.get(key)
            if (hit is not None and hit.host_x is data
                    and hit.host_graph is graph):
                _PREP_CACHE.move_to_end(key)
                return hit
    if isinstance(data, torch.Tensor):
        x = data.to(torch.bfloat16 if stage == "bf16" else
                    torch.uint8 if stage == "u8" else torch.float32)
    elif stage == "bf16":
        x = torch.as_tensor(data).to(torch.bfloat16)
    elif stage == "u8":
        x = torch.from_numpy(np.ascontiguousarray(data, np.uint8))
    else:
        x = torch.from_numpy(np.ascontiguousarray(data, np.float32))
    x = x.to(device).contiguous()
    g = graph if isinstance(graph, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(graph, np.int32))
    entry = _Prepared(
        host_x=data, host_graph=graph, x=x,
        graph=g.to(device=device, dtype=torch.int32).contiguous(),
        aux=_beam.beam_aux(x) if x.is_cuda else None,
    )
    if not live:
        with _PREP_LOCK:
            _PREP_CACHE[key] = entry
            while len(_PREP_CACHE) > _CACHE_CAP:
                _PREP_CACHE.popitem(last=False)
    return entry


def _prep_queries(queries, quant, device):
    """(queries on the device in the stage's dtype, scale, zp); numpy or a
    tensor in."""
    if isinstance(quant, QuantSpec):
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().float().cpu().numpy()
        q = torch.from_numpy(quant.quantize(queries)).to(device)
        return q, float(np.float32(quant.scale)), float(
            np.float32(quant.zero_point))
    q = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(queries, np.float32))
    q = q.to(device=device, dtype=torch.float32).contiguous()
    if quant == "bf16":
        q = q.to(torch.bfloat16)
    return q, 0.0, 0.0


def _prep_entries(entries, width: int, device) -> torch.Tensor:
    e = np.atleast_1d(np.asarray(entries, np.int64))[:width]
    return torch.from_numpy(e.astype(np.int32)).to(device)


def _sum(t: torch.Tensor, n_real: int | None = None) -> int:
    return int(t[:n_real].sum())


def fused_beam_search(
    data, graph, entries, queries, k: int, *, width: int = 64,
    n_iters: int | None = None, expand: int = _beam.DEFAULT_EXPAND,
    metric: str = "l2", n_real: int | None = None, quant=None,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """The beam_fn protocol over the fused engine: stats summed over the
    first ``n_real`` queries (all when None).  numpy in, numpy out; a
    build's live state in (:func:`is_live`), tensors out on ``device``."""
    n_iters = _beam.default_n_iters(width) if n_iters is None else n_iters
    prep = _prepared(data, graph, quant, device)
    q, scale, zp = _prep_queries(queries, quant, device)
    ids, ds, n_dist, hops, _ = _beam.fused_beam(
        prep.x, prep.graph, _prep_entries(entries, width, device), q, k,
        width=width, n_iters=n_iters, expand=expand, metric=metric,
        scale=scale, zp=zp, aux=prep.aux,
    )
    nd = _sum(n_dist, n_real)
    stats = SearchStats(
        n_distance_computations=nd,
        n_hops=_sum(hops, n_real),
        n_quantized_distance_computations=nd if quant is not None else 0,
    )
    if is_live(graph):
        return ids.long(), ds, stats
    return (ids.cpu().numpy().astype(np.int64), ds.cpu().numpy(), stats)


def _fused_merged_staged(topo: MergedTopology, entries, queries, k: int,
                         kq: int, *, width: int, n_iters: int | None,
                         dtype: str, device: torch.device
                         ) -> tuple[np.ndarray, SearchStats]:
    """Staged merged search with the re-rank fused into the traversal
    dispatch; the same ids and stats as run_merged's beam +
    :func:`repro_torch.kernels.ops.rerank_exact` composition."""
    n_iters = _beam.default_n_iters(width) if n_iters is None else n_iters
    store, spec = topo.quant_view(dtype)
    quant = spec if spec is not None else dtype
    prep = _prepared(store, topo.index.graph, quant, device)
    exact = _prepared(topo.data, topo.index.graph, None, device)
    q, scale, zp = _prep_queries(queries, quant, device)
    qf = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    ids, _, n_dist, hops, n_rr = _beam.fused_beam(
        prep.x, prep.graph, _prep_entries(entries, width, device), q, kq,
        width=width, n_iters=n_iters, metric=topo.metric, scale=scale, zp=zp,
        x_exact=exact.x, q_exact=qf, rerank_k=k, aux=prep.aux,
    )
    nd, nrr = _sum(n_dist), _sum(n_rr)
    stats = SearchStats(
        n_distance_computations=nd + nrr,
        n_hops=_sum(hops),
        n_quantized_distance_computations=nd,
        n_rerank_distance_computations=nrr,
    )
    return ids.cpu().numpy().astype(np.int64), stats


# run_merged hands staged merged searches back through this hook
fused_beam_search.fused_merged = _fused_merged_staged

# raw batched-beam hook for build-time searches (`beam_pool`)
beam_fn = fused_beam_search


def search_merged(topo: MergedTopology, queries: np.ndarray, k: int, *,
                  width: int = 64, n_entries: int = 16,
                  n_iters: int | None = None, dtype: str = "f32",
                  rerank: int = DEFAULT_RERANK, device: torch.device):
    return run_merged(fused_beam_search, topo, queries, k, width=width,
                      n_entries=n_entries, n_iters=n_iters, dtype=dtype,
                      rerank=rerank, device=device)


def search_split(topo: ShardTopology, queries: np.ndarray, k: int, *,
                 width: int = 64, n_entries: int = 16,
                 n_iters: int | None = None, nprobe: NprobeSpec = None,
                 dtype: str = "f32", rerank: int = DEFAULT_RERANK,
                 device: torch.device):
    del n_entries  # shards seed from their centroid entry
    return run_split(fused_beam_search, topo, queries, k, width=width,
                     n_iters=n_iters, nprobe=nprobe, bucket=True,
                     dtype=dtype, rerank=rerank, device=device)
