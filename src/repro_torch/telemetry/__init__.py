"""Telemetry of the port (counterpart of ``repro.telemetry``): structured
spans, a metrics registry, kernel-build events and trace validation — one
subsystem observing build, search and serving.

* :mod:`repro_torch.telemetry.trace` — hierarchical span tracer with
  Chrome/Perfetto trace-event export, thread-safe, fake-clock
  deterministic, and the stage accumulator the search drivers report the
  re-rank epilogue to.
* :mod:`repro_torch.telemetry.metrics` — counters / gauges / reservoir
  histograms with Prometheus text exposition and a JSON snapshot;
  ``ServerStats`` and ``BuildResult.feed_metrics`` feed it.
* :mod:`repro_torch.telemetry.jit` — the kernel-build listener
  (``kernel_builds_total``, ``kernel_build_seconds``) and the engine-call
  :class:`SignatureGuard`.
* :mod:`repro_torch.telemetry.validate` — trace schema + semantic checks.

Telemetry defaults to the no-op recorder (:data:`NULL_TRACER`): hot
paths gate on ``tracer.enabled`` and pay one branch when disabled.
Install a tracer process-wide with :func:`use_tracer`, or hand one to the
component that owns the run (``AnnServer(tracer=...)``).
"""

from repro_torch.telemetry.jit import SignatureGuard, install_compile_listener
from repro_torch.telemetry.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           current_registry, parse_prometheus,
                                           set_registry, use_registry)
from repro_torch.telemetry.trace import (NULL_TRACER, ManualClock,
                                         NullTracer, Span, Tracer,
                                         collect_stages, current_tracer,
                                         record_stage, set_tracer,
                                         stage_active, use_tracer)
from repro_torch.telemetry.validate import (check_durability_trace,
                                            check_fleet_trace,
                                            check_serving_trace,
                                            validate_chrome_trace)

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "ManualClock",
    "MetricsRegistry", "NULL_TRACER", "NullTracer", "SignatureGuard",
    "Span", "Tracer", "check_durability_trace", "check_fleet_trace",
    "check_serving_trace",
    "collect_stages", "current_registry", "current_tracer",
    "install_compile_listener", "parse_prometheus", "record_stage",
    "set_registry", "set_tracer", "stage_active", "use_registry",
    "use_tracer", "validate_chrome_trace",
]
