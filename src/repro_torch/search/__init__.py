"""``repro_torch.search`` — the query engine of the port (counterpart of
``repro.search``): :func:`search` over merged or centroid-routed split
topologies on the ``fused`` backend, and the build-time :func:`beam_pool`."""

from repro_torch.search.api import (SearchBackend, available_backends,
                                    beam_pool, get_backend,
                                    register_backend, search)
from repro_torch.search.types import (DEFAULT_AUTO_MARGIN, DEFAULT_RERANK,
                                      SEARCH_DTYPES, MergedTopology,
                                      NprobeSpec, QuantSpec, SearchStats,
                                      ShardTopology, as_topology, parse_dtype,
                                      parse_nprobe, topology_from_arrays)

__all__ = [
    "DEFAULT_AUTO_MARGIN", "DEFAULT_RERANK", "MergedTopology", "NprobeSpec",
    "QuantSpec", "SEARCH_DTYPES", "SearchBackend", "SearchStats",
    "ShardTopology", "as_topology", "available_backends", "beam_pool",
    "get_backend", "parse_dtype", "parse_nprobe", "register_backend",
    "search", "topology_from_arrays",
]
