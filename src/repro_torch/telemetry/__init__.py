"""Telemetry of the port: the span tracer and the stage accumulator that
search and build report to (see :mod:`repro_torch.telemetry.trace`)."""

from repro_torch.telemetry.trace import (NULL_TRACER, NullTracer, Span,
                                         Tracer, collect_stages,
                                         current_tracer, record_stage,
                                         set_tracer, stage_active, use_tracer)

__all__ = [
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "collect_stages", "current_tracer", "record_stage", "set_tracer",
    "stage_active", "use_tracer",
]
