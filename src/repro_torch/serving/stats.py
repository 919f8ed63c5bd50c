"""Serving telemetry (counterpart of ``repro/serving/stats.py``): latency
percentiles (end-to-end *and* decomposed), batch occupancy, QPS, backed by
the metrics registry.

The serving layer's whole reason to exist is a throughput/latency trade —
micro-batching fills the engine's batch lanes at the cost of a bounded
queueing delay — so the server measures both sides of that trade for
every request: wall-clock end-to-end latency (submit → result, queueing
included), its **queue-wait vs engine-service split** (where the bounded
delay actually went), and the batch occupancy the engine saw.
Engine-side work (distance computations, hops) is folded in from the
per-call :class:`~repro_torch.search.SearchStats` the worker gets back
from ``repro_torch.search.search``; its fields are Python ints on every
backend (the ``fused`` backend reads its device counters back with
``int``), so the registry's counters never hold a tensor.

:class:`ServerStats` *feeds* a
:class:`~repro_torch.telemetry.MetricsRegistry`: every count/latency lives
in a named metric, ``snapshot()`` is a read of the registry, and
``to_prometheus()`` exposes the same numbers in text exposition format for
scraping — byte-equal to the reference's for the same operations.  The
attribute surface (``n_completed``, ``latency_ms()``, ...) is kept as
properties over the registry.
"""

from __future__ import annotations

from collections import Counter as TallyCounter

from repro_torch.search.types import SearchStats
from repro_torch.telemetry.metrics import MetricsRegistry

#: power-of-two-ish bounds for the occupancy histogram exposition
_OCC_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class ServerStats:
    """Aggregate telemetry for one :class:`~repro_torch.serving.AnnServer`.

    Latencies are kept in bounded reservoirs (uniform reservoir sampling
    past ``latency_cap`` samples, seeded — deterministic under a fixed
    submit order) so a long-running server's percentiles stay O(1)
    memory.  Distance-computation accounting is exact when the worker
    pads nothing; with shape-bucket padding it is scaled by the
    real/padded lane ratio (padding lanes recompute real rows, so the
    scaled value is the honest per-request cost).

    ``registry`` defaults to a fresh :class:`MetricsRegistry` per stats
    object (a bench that resets ``srv.stats`` gets a clean window); pass
    a shared one to aggregate several servers into one exposition.
    """

    def __init__(self, latency_cap: int = 100_000,
                 registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        reg = self.registry
        req = "serving_requests_total"
        req_help = "requests by terminal outcome"
        self._c_completed = reg.counter(req, req_help, outcome="completed")
        self._c_rejected = reg.counter(req, req_help, outcome="rejected")
        self._c_shed = reg.counter(req, req_help, outcome="shed")
        self._c_failed = reg.counter(req, req_help, outcome="failed")
        self._c_batches = reg.counter(
            "serving_engine_batches_total", "engine calls made"
        )
        lanes = "serving_engine_lanes_total"
        lanes_help = "engine batch lanes by kind (real vs bucket padding)"
        self._c_real_lanes = reg.counter(lanes, lanes_help, kind="real")
        self._c_padded_lanes = reg.counter(lanes, lanes_help, kind="padded")
        dc = "serving_distance_computations_total"
        dc_help = ("padding-scaled distance computations by stage "
                   "(total = every scored pair, any precision)")
        self._c_dist = reg.counter(dc, dc_help, stage="total")
        self._c_hops = reg.counter(
            "serving_hops_total", "padding-scaled beam expansions"
        )
        self._c_quant = reg.counter(dc, dc_help, stage="quantized")
        self._c_rerank = reg.counter(dc, dc_help, stage="rerank")
        self._c_engine_s = reg.counter(
            "serving_engine_time_seconds_total",
            "engine service wall time, summed over batches",
        )
        cap = int(latency_cap)
        self._h_latency = reg.histogram(
            "serving_request_latency_seconds",
            "end-to-end latency: submit to future resolution",
            reservoir=cap,
        )
        self._h_queue_wait = reg.histogram(
            "serving_queue_wait_seconds",
            "submit to batch flush (admission + batching delay)",
            reservoir=cap,
        )
        self._h_engine = reg.histogram(
            "serving_engine_service_seconds",
            "engine call wall time charged to each request it served",
            reservoir=cap,
        )
        self._h_occupancy = reg.histogram(
            "serving_batch_occupancy",
            "real (non-padding) requests per engine call",
            buckets=_OCC_BUCKETS, reservoir=cap,
        )
        self.search = SearchStats()  # raw engine counters (padded lanes in)
        self._occ = TallyCounter()  # exact occupancy histogram (snapshot)
        self._t_first: float | None = None  # earliest submit seen
        self._t_last: float | None = None  # latest completion seen

    # ---- the historical attribute surface (reads of the registry) -------

    @property
    def n_completed(self) -> int:
        return int(self._c_completed.value)

    @property
    def n_rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def n_shed(self) -> int:
        return int(self._c_shed.value)

    @property
    def n_failed(self) -> int:
        return int(self._c_failed.value)

    @property
    def n_batches(self) -> int:
        return int(self._c_batches.value)

    @property
    def n_served_lanes(self) -> int:
        return int(self._c_real_lanes.value)

    @property
    def n_padded_lanes(self) -> int:
        return int(self._c_padded_lanes.value)

    @property
    def dist_comps(self) -> float:
        return self._c_dist.value

    @property
    def hops(self) -> float:
        return self._c_hops.value

    @property
    def quant_comps(self) -> float:
        return self._c_quant.value

    @property
    def rerank_comps(self) -> float:
        return self._c_rerank.value

    @property
    def batch_time_s(self) -> float:
        return self._c_engine_s.value

    # ---- recording (called by the server/queue, clock units = seconds) ----

    def record_rejected(self) -> None:
        self._c_rejected.inc()

    def record_shed(self) -> None:
        self._c_shed.inc()

    def record_failed(self, n: int = 1) -> None:
        self._c_failed.inc(n)

    def record_completion(self, t_submit: float, t_done: float, *,
                          queue_wait_s: float | None = None,
                          engine_s: float | None = None) -> None:
        """One resolved request.  ``queue_wait_s`` (submit → batch flush)
        and ``engine_s`` (the serving engine call's wall time) decompose
        the end-to-end latency; the worker passes both, older callers
        that only know the endpoints still record the total."""
        self._c_completed.inc()
        self._t_first = (t_submit if self._t_first is None
                         else min(self._t_first, t_submit))
        self._t_last = (t_done if self._t_last is None
                        else max(self._t_last, t_done))
        self._h_latency.observe(max(t_done - t_submit, 0.0))
        if queue_wait_s is not None:
            self._h_queue_wait.observe(max(queue_wait_s, 0.0))
        if engine_s is not None:
            self._h_engine.observe(max(engine_s, 0.0))

    def observe_batch(self, n_real: int, n_padded: int, stats: SearchStats,
                      elapsed_s: float) -> None:
        """One engine call: ``n_real`` requests served in a lane count of
        ``n_padded`` (== ``n_real`` when the worker didn't bucket-pad)."""
        self._c_batches.inc()
        self._occ[int(n_real)] += 1
        self._h_occupancy.observe(n_real)
        self._c_real_lanes.inc(n_real)
        self._c_padded_lanes.inc(max(n_padded - n_real, 0))
        self.search += stats
        scale = n_real / max(n_padded, 1)
        self._c_dist.inc(stats.n_distance_computations * scale)
        self._c_hops.inc(stats.n_hops * scale)
        self._c_quant.inc(stats.n_quantized_distance_computations * scale)
        self._c_rerank.inc(stats.n_rerank_distance_computations * scale)
        self._c_engine_s.inc(elapsed_s)

    # ---- reading --------------------------------------------------------

    def latency_ms(self) -> dict:
        return self._h_latency.summary(scale=1e3)

    def queue_wait_ms(self) -> dict:
        """Submit → batch-flush wait percentiles (the batching delay the
        SLO window is spending)."""
        return self._h_queue_wait.summary(scale=1e3)

    def engine_service_ms(self) -> dict:
        """Engine-call wall time charged to each served request."""
        return self._h_engine.summary(scale=1e3)

    def occupancy(self) -> dict:
        total = sum(self._occ.values())
        if not total:
            return {"mean": 0.0, "max": 0, "histogram": {}}
        return {
            "mean": sum(s * c for s, c in self._occ.items()) / total,
            "max": max(self._occ),
            "histogram": {str(s): self._occ[s] for s in sorted(self._occ)},
        }

    def qps(self) -> float:
        if (self._t_first is None or self._t_last is None
                or self._t_last <= self._t_first):
            return 0.0
        return self.n_completed / (self._t_last - self._t_first)

    def to_prometheus(self) -> str:
        """The registry's Prometheus text exposition (scrape-ready)."""
        return self.registry.to_prometheus()

    def snapshot(self) -> dict:
        """One JSON-ready block: the telemetry a dashboard wants per
        measurement window."""
        # per-query engine work is normalized by lanes actually *served*
        # (not completions: a cancelled request's lane still did the work,
        # and charging it to the survivors would inflate their cost)
        served = max(self.n_served_lanes, 1)
        lanes = self.search.n_queries
        return {
            "n_completed": self.n_completed,
            "n_rejected": self.n_rejected,
            "n_shed": self.n_shed,
            "n_failed": self.n_failed,
            "n_batches": self.n_batches,
            "qps": self.qps(),
            "latency_ms": self.latency_ms(),
            "queue_wait_ms": self.queue_wait_ms(),
            "engine_service_ms": self.engine_service_ms(),
            "batch_occupancy": self.occupancy(),
            "padding_fraction": (self.n_padded_lanes / lanes) if lanes else 0.0,
            "distance_computations_per_query": self.dist_comps / served,
            "hops_per_query": self.hops / served,
            "quantized_distance_computations_per_query":
                self.quant_comps / served,
            "rerank_distance_computations_per_query":
                self.rerank_comps / served,
            "engine_time_ms_per_batch":
                (self.batch_time_s / self.n_batches * 1e3)
                if self.n_batches else 0.0,
        }
