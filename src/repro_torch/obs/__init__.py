"""Telemetry plane: span tracing, metrics registry, distributed request
traces (DESIGN.md §15). The JAX package's `obs`, plus span ids and
parents and the program-span level of `trace.py`: it imports neither
torch nor jax, so the two packages record the same reference-named
spans and series under the same names."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      MetricsServer, StatsLineLogger, get_registry,
                      register_bank, register_commlog, register_replenisher,
                      register_service)
from .trace import (TRACE_ID_BYTES, Tracer, configure, current_trace,
                    get_tracer, instant, merge_traces, new_trace_id,
                    set_current_trace, span, trace_id_from_bytes,
                    trace_id_to_bytes)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsServer",
    "StatsLineLogger", "get_registry", "register_bank", "register_commlog",
    "register_replenisher", "register_service",
    "TRACE_ID_BYTES", "Tracer", "configure", "current_trace", "get_tracer",
    "instant", "merge_traces", "new_trace_id", "set_current_trace", "span",
    "trace_id_from_bytes", "trace_id_to_bytes",
]
