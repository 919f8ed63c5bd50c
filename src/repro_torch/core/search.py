"""DEPRECATED — ``repro_torch.core.search`` moved to :mod:`repro_torch.search`
(counterpart of ``repro/core/search.py``).

This shim keeps the old entry points importable one release longer:

  * ``beam_search``   → :func:`repro_torch.search.beam_search`
  * ``search_index``  → ``repro_torch.search.search(..., backend="numpy")``
  * ``split_search``  → ``repro_torch.search.search(..., backend="numpy")``
  * ``batch_search``  → the ``torch`` backend's batched beam
  * ``SearchStats``   → :class:`repro_torch.search.SearchStats`

New code should call :func:`repro_torch.search.search` with an explicit
backend.  ``device`` is where the routing tiles (and ``batch_search``'s
beam) run: the card unless ``"cpu"`` is given.  Imports are deferred into
the wrappers so that ``repro_torch.core`` and ``repro_torch.search`` can
import in either order.
"""

from __future__ import annotations

import warnings

import numpy as np

from repro_torch.search.types import SearchStats  # noqa: F401  (re-export)


def _warn(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.core.search.{old} is deprecated; use {new}",
        DeprecationWarning,
        stacklevel=3,
    )


def beam_search(data, graph, entry, query, k, *, width: int = 64,
                max_hops: int = 10_000):
    _warn("beam_search", "repro_torch.search.beam_search")
    from repro_torch.search import beam_search as impl

    return impl(data, graph, entry, query, k, width=width, max_hops=max_hops)


def search_index(data, index, queries, k, *, width: int = 64,
                 n_entries: int = 16, device=None):
    _warn("search_index", 'repro_torch.search.search(..., backend="numpy")')
    from repro_torch.search import search

    return search(index, queries, k, data=data, backend="numpy",
                  width=width, n_entries=n_entries, device=device)


def split_search(data, shard_ids, shard_graphs, queries, k, *,
                 width: int = 64, device=None):
    _warn("split_search", 'repro_torch.search.search(..., backend="numpy")')
    from repro_torch.search import search

    return search((shard_ids, shard_graphs), queries, k, data=data,
                  backend="numpy", width=width, device=device)


def batch_search(data, index, queries, k, *, width: int = 64,
                 n_iters: int | None = None, device=None):
    """Old medoid-seeded fixed-iteration batch search; now the ``torch``
    backend (multi-entry seeding, early exit).  Returns ids only, like the
    original."""
    _warn("batch_search", 'repro_torch.search.search(..., backend="torch")')
    from repro_torch.device import resolve_device
    from repro_torch.search.torch_backend import batch_beam_search

    entries = index.entry_points(16)
    ids, _, _ = batch_beam_search(
        np.asarray(data), index.graph, entries, queries, k,
        width=width, n_iters=n_iters, device=resolve_device(device),
    )
    return ids
