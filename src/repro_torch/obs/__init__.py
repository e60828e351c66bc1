"""Span tracing for the port (its own copy of ``repro.obs.trace``)."""

from repro_torch.obs.trace import NULL_TRACER, NullTracer, SpanEvent, Tracer

__all__ = ["NULL_TRACER", "NullTracer", "SpanEvent", "Tracer"]
