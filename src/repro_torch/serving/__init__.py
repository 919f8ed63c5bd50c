"""``repro_torch.serving`` — the asyncio micro-batching **ANN query** server
(counterpart of ``repro.serving``).

Naming, because the port has two serving layers:

  * ``repro_torch.serving`` (this package) — ANN *query* serving:
    accumulates single-query ``submit()`` calls into engine-sized batches
    and drains them through :func:`repro_torch.search.search` (any
    topology, any backend, routed ``nprobe`` included).
  * ``repro_torch.serve`` — the **LM decode** serving engine (prefill +
    decode slot batching).  Nothing ANN-related is exported from there.

Public surface::

    async with AnnServer(topology,
                         config=ServingConfig(max_wait_ms=2.0)) as srv:
        result = await srv.submit(query)     # QueryResult(ids, latency_s)
        print(srv.stats.snapshot())          # p50/p95/p99, occupancy, QPS

``AnnServer`` runs its engine on the card; ``AnnServer(...,
device="cpu")`` runs the kernels' plain versions on the CPU.

Pieces (importable for reuse/testing): :class:`MicroBatcher` +
:class:`RequestQueue` (flush-on-``max_batch``/``max_wait_ms`` semantics,
bounded admission), :class:`ServerStats` (latency percentiles, batch
occupancy histogram, distance-computations/query), and the
:class:`SLOPolicy` protocol (:class:`FixedWindow`, :class:`AdaptiveWindow`)
that retunes the batching window from observed queue depth.
"""

from repro_torch.serving.policy import (AdaptiveWindow,  # noqa: F401
                                        FixedWindow, SLOPolicy)
from repro_torch.serving.queue import (MicroBatcher,  # noqa: F401
                                       PendingRequest, RequestQueue,
                                       ServerOverloadedError)
from repro_torch.serving.server import (USE_DEFAULT,  # noqa: F401
                                        AnnServer, QueryResult,
                                        ServingConfig)
from repro_torch.serving.stats import ServerStats  # noqa: F401

__all__ = [
    "AnnServer",
    "ServingConfig",
    "QueryResult",
    "ServerStats",
    "MicroBatcher",
    "RequestQueue",
    "PendingRequest",
    "ServerOverloadedError",
    "SLOPolicy",
    "FixedWindow",
    "AdaptiveWindow",
    "USE_DEFAULT",
]
