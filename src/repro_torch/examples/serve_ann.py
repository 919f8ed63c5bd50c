"""Serve single-query ANN traffic through the micro-batching front-end.

The reference's ``examples/serve_ann.py`` on ``repro_torch``: build a
ScaleGANN index, stand up :class:`repro_torch.serving.AnnServer`, fire an
open-loop Poisson stream of single-query ``submit()`` calls at it, and
print the telemetry — the difference between this and calling
``repro_torch.search.search`` per query is the entire point of the server
(a batched engine only earns its QPS at dense batches).  The reference's
``jax`` backend is ``torch`` here.

    PYTHONPATH=src python -m repro_torch.examples.serve_ann               # the card
    PYTHONPATH=src python -m repro_torch.examples.serve_ann --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np

from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.data.synthetic import make_clustered, recall_at
from repro_torch.device import resolve_device
from repro_torch.serving import AnnServer, ServerStats, ServingConfig


async def poisson_clients(srv: AnnServer, queries: np.ndarray,
                          n_requests: int, rate_qps: float):
    """Open-loop arrivals: submit on schedule, whether or not the server
    is keeping up (that's what makes the p95 honest)."""
    rng = np.random.default_rng(0)
    t_next = time.monotonic()
    futs = []
    for j in range(n_requests):
        t_next += rng.exponential(1.0 / rate_qps)
        delay = t_next - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        futs.append(srv.submit_nowait(queries[j % len(queries)],
                                      t_submit=t_next))
    return await asyncio.gather(*futs)


async def serve(dev) -> None:
    ds = make_clustered(5000, 64, n_queries=256, spread=1.0, seed=0,
                        device=dev)
    cfg = IndexConfig(n_clusters=8, degree=16, build_degree=32,
                      epsilon=1.2, block_size=1024)
    res = build_scalegann(ds.data, cfg, n_workers=4, device=dev)

    # a 3 ms batching window: enough to fill engine-sized batches at this
    # rate, small next to a p95 a user would notice (500/s keeps this
    # index comfortably below saturation; push the rate up to watch the
    # queue take over batch formation)
    sc = ServingConfig(backend="torch", k=10, width=96, max_batch=64,
                       max_wait_ms=3.0, adaptive_window=True)
    async with AnnServer(res.index, data=ds.data, config=sc,
                         device=dev) as srv:
        # warm the engine's batch-shape buckets, then measure steady state
        await poisson_clients(srv, ds.queries, n_requests=300,
                              rate_qps=500.0)
        srv.stats = ServerStats()
        outs = await poisson_clients(srv, ds.queries, n_requests=1000,
                                     rate_qps=500.0)

    ids = np.stack([o.ids for o in outs[:len(ds.queries)]])
    snap = srv.stats.snapshot()
    print(f"recall@10      {recall_at(ids, ds.gt, 10):.3f}")
    print(f"achieved QPS   {snap['qps']:.0f}")
    print(f"latency ms     p50={snap['latency_ms']['p50']:.1f} "
          f"p95={snap['latency_ms']['p95']:.1f} "
          f"p99={snap['latency_ms']['p99']:.1f}")
    print(f"batch occupancy mean={snap['batch_occupancy']['mean']:.1f} "
          f"max={snap['batch_occupancy']['max']}")
    print(f"distance comps/query {snap['distance_computations_per_query']:.0f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cpu: their plain versions)")
    args = ap.parse_args(argv)
    asyncio.run(serve(resolve_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
