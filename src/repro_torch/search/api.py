"""Backend registry + the public query entry point, ``search`` (counterpart
of ``repro/search/api.py``).

The registry holds ``fused`` (the counterpart of the reference's
``pallas``: the hand-written beam kernel on the card, and the default),
``torch`` (the counterpart of ``jax``: the batched beam as torch ops on
the CPU or the card) and ``numpy`` (the exact per-query reference beam on
the host).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.search.types import (DEFAULT_RERANK, MergedTopology,
                                      NprobeSpec, SearchStats, ShardTopology,
                                      as_topology, is_live, parse_dtype,
                                      parse_nprobe)
from repro_torch.telemetry import current_tracer
from repro_torch.telemetry.trace import NULL_SPAN


@runtime_checkable
class SearchBackend(Protocol):
    """A search engine implementation: both methods return
    ``(ids [Q, k] int64, SearchStats)`` with -1 in unused slots."""

    def search_merged(
        self, topo: MergedTopology, queries: np.ndarray, k: int, *,
        width: int, n_entries: int, dtype: str, rerank: int,
        device: torch.device,
    ) -> tuple[np.ndarray, SearchStats]: ...

    def search_split(
        self, topo: ShardTopology, queries: np.ndarray, k: int, *,
        width: int, n_entries: int, nprobe: NprobeSpec, dtype: str,
        rerank: int, device: torch.device,
    ) -> tuple[np.ndarray, SearchStats]: ...


# name -> backend object, or a module path resolved on first use
_REGISTRY: dict[str, SearchBackend | str] = {
    "numpy": "repro_torch.search.numpy_backend",
    "torch": "repro_torch.search.torch_backend",
    "fused": "repro_torch.search.fused_backend",
}


def register_backend(name: str, backend: SearchBackend) -> None:
    """Register (or replace) a backend under ``name``."""
    if not isinstance(backend, SearchBackend):
        raise TypeError("backend must expose search_merged and search_split")
    _REGISTRY[name] = backend


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(name: str) -> SearchBackend:
    try:
        entry = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown search backend {name!r}; available: "
            f"{available_backends()}"
        ) from None
    if isinstance(entry, str):
        entry = importlib.import_module(entry)
        _REGISTRY[name] = entry
    return entry


def beam_pool(data, graph, entries, queries, pool: int, *,
              backend: str = "fused", n_iters: int | None = None,
              metric: str = "l2", n_real: int | None = None, device=None):
    """Build-time search primitive: the engine's raw batched beam, returning
    the whole candidate pool per query — ``(ids [Q, pool] int64 with -1
    padding, dists [Q, pool] f32, SearchStats)`` — with ``k == width ==
    pool``.  ``n_real`` limits the stats and the returned rows to the first
    ``n_real`` queries.

    A host graph gives numpy out.  A ``graph`` given as a tensor (a
    build's, which it mutates between calls) gives tensors out on
    ``device``: every backend reads it and ``data`` as they are at this
    call and keeps no copy of them (:func:`is_live`)."""
    impl = get_backend(backend)
    beam = getattr(impl, "beam_fn", None)
    if beam is None:
        raise ValueError(
            f"backend {backend!r} does not expose a raw beam (beam_fn)"
        )
    pool = int(pool)
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    if not isinstance(queries, torch.Tensor):
        queries = np.asarray(queries, np.float32)
    ids, dists, stats = beam(
        data, graph, entries, queries, pool, width=pool, n_iters=n_iters,
        metric=metric, n_real=n_real, device=resolve_device(device),
    )
    if n_real is not None:
        ids, dists = ids[:n_real], dists[:n_real]
    stats.n_queries = len(queries) if n_real is None else n_real
    if is_live(graph):
        return ids, dists, stats
    return np.asarray(ids, np.int64), np.asarray(dists, np.float32), stats


def search(
    index_or_shards,
    queries: np.ndarray,
    k: int,
    *,
    backend: str = "fused",
    width: int = 64,
    n_entries: int = 16,
    nprobe: NprobeSpec = None,
    dtype: str = "f32",
    rerank: int = DEFAULT_RERANK,
    data: np.ndarray | None = None,
    metric: str | None = None,
    device=None,
) -> tuple[np.ndarray, SearchStats]:
    """Serve a query batch on any topology with any registered backend.

    The arguments are those of ``repro.search.search``: a merged or split
    topology (or a bare ``GlobalIndex`` / ``(shard_ids, shard_graphs)``
    pair with ``data``), ``nprobe`` routing for split topologies (None, a
    count, ``"auto"`` or ``("auto", margin)``), and the staged ``dtype``
    (``"f32"``, ``"bf16"``, ``"uint8"``) with its exact-f32 re-rank of
    ``rerank·k`` candidates.  ``device`` is where the kernels run: the card
    unless ``"cpu"`` is given.

    Returns ``(ids [Q, k] int64, SearchStats)`` stamped with ``n_queries``.

    Under an enabled tracer the call is one ``search.engine`` span whose
    children are its host and device phases in order: ``search.prep``,
    ``search.upload`` (the device copy of the storage, a cache lookup, and
    the queries), ``search.launch``, ``search.wait``, ``search.finish``.  A
    merged call has two ``search.prep`` (the checks here, then the entry
    points) and one of each other; a staged one adds a ``search.prep`` for
    its quantized view.  A split search adds its setup's ``search.prep``,
    ``search.route``, and a ``search.prep`` (the shard's rows),
    ``search.upload`` and ``search.launch`` a probed shard.
    Untraced, the tracer is read for its ``enabled`` flag alone.
    """
    tr = current_tracer()
    on = tr.enabled
    with (tr.span("search.engine", backend=backend, k=k, dtype=dtype)
          if on else NULL_SPAN) as engine:
        with tr.span("search.prep") if on else NULL_SPAN:
            if width < k:
                raise ValueError(
                    f"width ({width}) must be >= k ({k}): the candidate "
                    "list bounds how many results a beam search can return"
                )
            parse_nprobe(nprobe)
            parse_dtype(dtype)
            if (isinstance(rerank, bool) or int(rerank) != rerank
                    or rerank < 1):
                raise ValueError(
                    f"rerank must be a positive int (re-rank rerank·k "
                    f"candidates), got {rerank!r}"
                )
            rerank = int(rerank)
            dev = resolve_device(device)
            topo = as_topology(index_or_shards, data, metric=metric or "l2")
            if metric is not None and topo.metric != metric:
                topo = dataclasses.replace(topo, metric=metric)
            impl = get_backend(backend)
            queries = np.asarray(queries, np.float32)
        if on:
            engine.set(n_queries=len(queries))
        if isinstance(topo, MergedTopology):
            ids, stats = impl.search_merged(
                topo, queries, k, width=width, n_entries=n_entries,
                dtype=dtype, rerank=rerank, device=dev,
            )
        else:
            ids, stats = impl.search_split(
                topo, queries, k, width=width, n_entries=n_entries,
                nprobe=nprobe, dtype=dtype, rerank=rerank, device=dev,
            )
        stats.n_queries = len(queries)
    return ids, stats
