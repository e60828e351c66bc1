"""Per-user serving sessions (DESIGN.md §9): identity, lineage, limits.

A ``Session`` is the unit of admission control and provenance.  Lineage
records, per answered query, the fingerprint, the clean-state version the
answer was computed at, the rule scopes the answer depended on, and
whether it came from the cache — enough to re-derive *which*
probabilistic instance a user's past answer reflects (the
gradually-cleaned database changes under them by design, §6), and enough
for the background cleaner's priority model to estimate per-scope touch
probabilities from what sessions actually query (DESIGN.md §10).

Limits are enforced at submit time: ``max_inflight`` bounds a session's
concurrently queued tickets (back-pressure per user), ``max_queries``
bounds its lifetime total (quota), and ``class_limits`` bounds the
inflight tickets of individual SLO classes (DESIGN.md §14 — e.g. cap a
user's concurrent ``batch`` tickets without touching their interactive
headroom).  Violations raise ``SessionLimitError`` — the server surfaces
them to the caller without touching the shared executor.

``weight`` is the session's weighted-fair-queueing share (DESIGN.md
§14): the server multiplies it by the ticket's SLO-class weight to get
the effective WFQ weight, so a paying-tier session can be given a larger
slice of the serving order without starving anyone (the qos module's
starvation bound is in terms of these weights).

Thread-safety: every mutating method and every reader of compound state
takes the session's own ``_lock`` (client threads call ``admit``; the
serving thread calls ``complete``/``fail``; the background cleaner calls
``rule_touches``).  Counter fields are only ever written under that lock.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Tuple


class SessionLimitError(RuntimeError):
    """A submit exceeded the session's inflight or lifetime quota."""


@dataclasses.dataclass(frozen=True)
class LineageEntry:
    """Provenance of one answered query (immutable; safe to share across
    threads once appended to a session's lineage under its lock)."""

    fingerprint: str
    clean_version: int
    result_size: int
    cached: bool
    # the (table, rule) scopes the answer depended on (``rule_deps``) —
    # the background priority model's touch-probability signal
    rules: Tuple[Tuple[str, str], ...] = ()


_SIDS = itertools.count()


class Session:
    """One user's admission state and answer provenance (module docstring
    has the locking contract; ``submitted``/``answered``/``failed`` are
    monotone counters, ``inflight`` is the only one that also decreases)."""

    def __init__(
        self,
        sid: Optional[str] = None,
        max_inflight: int = 64,
        max_queries: Optional[int] = None,
        max_lineage: int = 256,
        weight: float = 1.0,
        class_limits: Optional[Dict[str, int]] = None,
    ):
        if weight <= 0.0:
            raise ValueError(f"session weight must be > 0, got {weight}")
        self.sid = sid if sid is not None else f"s{next(_SIDS)}"
        self.max_inflight = max_inflight
        self.max_queries = max_queries
        self.max_lineage = max_lineage
        # WFQ share (DESIGN.md §14): effective ticket weight is this times
        # the SLO-class weight
        self.weight = float(weight)
        # per-SLO-class inflight caps (DESIGN.md §14); classes absent from
        # the mapping are bounded only by ``max_inflight``
        self.class_limits = dict(class_limits or {})
        self.submitted = 0
        self.inflight = 0
        self.answered = 0
        self.failed = 0
        self.inflight_by_class: Dict[str, int] = {}
        self.lineage: List[LineageEntry] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ admission
    def admit(self, slo: str = "interactive") -> None:
        """Claim one submission slot for an SLO class or raise
        ``SessionLimitError`` (lifetime quota, total inflight, or the
        class's own inflight cap)."""
        with self._lock:
            if self.max_queries is not None and self.submitted >= self.max_queries:
                raise SessionLimitError(
                    f"session {self.sid}: lifetime quota {self.max_queries} reached"
                )
            if self.inflight >= self.max_inflight:
                raise SessionLimitError(
                    f"session {self.sid}: {self.inflight} tickets already in flight"
                )
            limit = self.class_limits.get(slo)
            in_class = self.inflight_by_class.get(slo, 0)
            if limit is not None and in_class >= limit:
                raise SessionLimitError(
                    f"session {self.sid}: {in_class} {slo!r} tickets already "
                    f"in flight (class limit {limit})"
                )
            self.submitted += 1
            self.inflight += 1
            self.inflight_by_class[slo] = in_class + 1

    def _release(self, slo: str) -> None:
        """Give back one inflight slot (callers hold ``_lock``)."""
        self.inflight -= 1
        in_class = self.inflight_by_class.get(slo, 0)
        if in_class > 0:
            self.inflight_by_class[slo] = in_class - 1

    def complete(self, entry: LineageEntry, slo: str = "interactive") -> None:
        """Record one answered query (serving thread; ``slo`` must match
        the class the ticket was admitted under)."""
        with self._lock:
            self._release(slo)
            self.answered += 1
            self.lineage.append(entry)
            del self.lineage[: -self.max_lineage]

    def fail(self, slo: str = "interactive") -> None:
        """Release the inflight slot of a submission that errored or was
        cancelled (``slo`` must match the admitted class)."""
        with self._lock:
            self._release(slo)
            self.failed += 1

    # ------------------------------------------------------------- reporting
    def rule_touches(self) -> Dict[Tuple[str, str], int]:
        """How often each (table, rule) scope appeared in this session's
        retained lineage — the background priority model's touch signal
        (recency-weighted for free by the ``max_lineage`` cap)."""
        with self._lock:
            touches: Dict[Tuple[str, str], int] = {}
            for entry in self.lineage:
                for dep in entry.rules:
                    touches[dep] = touches.get(dep, 0) + 1
            return touches

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable state summary (consistent: taken under the
        session lock)."""
        with self._lock:
            return {
                "sid": self.sid,
                "weight": self.weight,
                "submitted": self.submitted,
                "inflight": self.inflight,
                "inflight_by_class": dict(self.inflight_by_class),
                "answered": self.answered,
                "failed": self.failed,
                "cached_answers": sum(e.cached for e in self.lineage),
                "last_clean_version": (
                    self.lineage[-1].clean_version if self.lineage else None
                ),
            }
