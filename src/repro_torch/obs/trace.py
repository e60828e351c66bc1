"""Span tracing (the port's own copy of ``repro.obs.trace``, DESIGN.md §13).

One ``Tracer`` is threaded through every layer that does attributable
work — the executor's clean phases, the server's per-ticket serving
stages, the background cleaner's increments, the sharded detection's
shuffle/scan — and collects ``SpanEvent`` records into a thread-safe
bounded ring buffer.  Everything here is host-side stdlib: recording a
span never touches torch, never syncs a device value, and never changes
what the instrumented code computes (the bit-neutrality contract,
asserted by tests/test_obs.py).

Clock and thread contract:

* timestamps are ``time.perf_counter()`` — one monotone clock shared by
  every thread, so spans from the serving thread, the background cleaner
  and the shuffle path order correctly against each other;
* a span belongs to the thread that closed it, and spans on one thread
  are well-nested (context managers) — which is what lets
  ``obs.export.rollup`` compute exclusive self-times by stack
  subtraction.  Events recorded with an explicit ``thread`` (the
  server's queue-wait spans, which overlap many serving spans) live on
  their own synthetic track precisely to keep the real threads' nesting
  intact.

Disabled mode is a strict no-op: ``NULL_TRACER.span(...)`` returns one
shared, immutable context manager and records nothing — no allocation
beyond the kwargs dict at the call site, no lock, no branch in
``__enter__``/``__exit__``.  Layers default their ``tracer`` seam to
``NULL_TRACER``, so an untraced serving loop pays only that call
overhead (gated at <= 3% of a cache-hit serve in tests/test_obs.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional


class SpanEvent(NamedTuple):
    """One closed span: ``t0``/``dur`` on the monotone clock
    (``time.perf_counter``), ``thread`` the recording thread's name (or
    the explicit track for externally-timed events), ``attrs`` host-
    scalar annotations (mode, detect_pairs, strip ranges, ...)."""

    name: str
    t0: float
    dur: float
    thread: str
    attrs: Dict[str, object]


class _NullSpan:
    """The shared disabled-mode context manager: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        """Ignore late attribute annotations (disabled mode)."""


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager for one live span; records into its tracer on exit
    (the span's thread is whichever thread exits it)."""

    __slots__ = ("_tracer", "name", "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Annotate the span after entry (e.g. a detect path only known
        once dispatch resolved)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.record(
            self.name, self.t0, time.perf_counter() - self.t0, **self.attrs
        )
        return False


class Tracer:
    """Thread-safe bounded span recorder.

    ``capacity`` bounds the ring buffer: the newest ``capacity`` events
    are kept, older ones are dropped oldest-first (``dropped`` counts
    them), so a long-lived traced server has bounded memory.  All
    mutation happens under one lock; ``span``/``record``/``instant`` are
    safe from any thread.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self.created = time.perf_counter()
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[SpanEvent] = []
        self._head = 0  # ring start once the buffer saturates

    def __bool__(self) -> bool:
        """Truthiness == enabled, so hot paths can gate optional work
        (building an attrs dict) with ``if tracer:``."""
        return self.enabled

    def span(self, name: str, **attrs):
        """Open a span context manager; the event is recorded when the
        ``with`` block exits.  Returns the shared no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def record(self, name: str, t0: float, dur: float,
               thread: Optional[str] = None, **attrs) -> None:
        """Record one externally-timed span (``t0`` must come from
        ``time.perf_counter``).  ``thread`` overrides the track — pass a
        synthetic name for events that overlap a real thread's nesting
        (the server's queue-wait spans)."""
        if not self.enabled:
            return
        event = SpanEvent(
            name, t0, dur,
            thread if thread is not None else threading.current_thread().name,
            attrs,
        )
        with self._lock:
            if len(self._events) < self.capacity:
                self._events.append(event)
            else:
                self._events[self._head] = event
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration marker (a yield, an overflow retry)."""
        self.record(name, time.perf_counter(), 0.0, **attrs)

    def events(self) -> List[SpanEvent]:
        """Snapshot of buffered events in recording order (thread-safe)."""
        with self._lock:
            return self._events[self._head:] + self._events[:self._head]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        """Drop all buffered events (the ``dropped`` counter survives as
        a lifetime total)."""
        with self._lock:
            self._events = []
            self._head = 0


class NullTracer(Tracer):
    """The always-disabled tracer every instrumentation seam defaults to.

    A real (if degenerate) ``Tracer``, so ``isinstance`` checks and the
    full API hold; ``span`` short-circuits to the shared no-op via the
    base class's ``enabled`` gate and ``record`` drops everything."""

    def __init__(self):
        super().__init__(capacity=1, enabled=False)


NULL_TRACER = NullTracer()
