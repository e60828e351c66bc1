"""Span tracing, latency histograms and per-phase cost attribution for the
port (its own copies of ``repro.obs.trace``, ``hist`` and ``export``,
DESIGN.md §13).  All host-side stdlib: recording never touches torch and
never changes answers or clean versions."""

from repro_torch.obs.export import (
    chrome_trace,
    coverage,
    events_from_chrome,
    format_rollup,
    load_trace,
    rollup,
    top_spans,
    write_trace,
)
from repro_torch.obs.hist import LatencyHistogram
from repro_torch.obs.trace import NULL_TRACER, NullTracer, SpanEvent, Tracer

__all__ = [
    "LatencyHistogram",
    "NULL_TRACER",
    "NullTracer",
    "SpanEvent",
    "Tracer",
    "chrome_trace",
    "coverage",
    "events_from_chrome",
    "format_rollup",
    "load_trace",
    "rollup",
    "top_spans",
    "write_trace",
]
