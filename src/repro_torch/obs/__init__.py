"""Observability substrate: metrics registry + request tracing.

Stdlib-only and dependency-free by design — ``repro_torch.obs`` is imported by
every layer (core engine, buffer pool, HNSW, maintenance, server,
client, tools) and must never import back into them.  Everything here is
process-wide: one default :class:`MetricsRegistry`, one trace ring, one
slow-op threshold.

Instrumentation is **on by default**.  ``set_enabled(False)`` collapses
every counter increment to one attribute load + one branch and every
``trace()`` block to a bare ``perf_counter`` pair (timing stays correct
— ``SaveReport.seconds`` is derived from spans — but nothing is
recorded).  ``benchmarks/serving_bench.py`` measures both modes and
``benchmarks/perf_gate.py`` enforces obs-on >= 0.95x obs-off QPS.
"""

from repro_torch.obs.accounting import (
    ModelSpace,
    SpaceAccountant,
    TensorSpace,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    parse_prometheus_text,
    set_enabled,
)
from repro_torch.obs.trace import (
    Span,
    current_span,
    get_slow_op_threshold,
    parse_traceparent,
    recent_traces,
    set_slow_op_threshold,
    trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ModelSpace",
    "Span",
    "SpaceAccountant",
    "TensorSpace",
    "current_span",
    "default_registry",
    "get_slow_op_threshold",
    "parse_prometheus_text",
    "parse_traceparent",
    "recent_traces",
    "set_enabled",
    "set_slow_op_threshold",
    "trace",
]
