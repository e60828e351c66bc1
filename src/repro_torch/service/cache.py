"""Clean-state-aware result cache (DESIGN.md §9, refined in §10).

Entries key on ``(query fingerprint, version)``, where the version the
server passes is the *scope-version vector* over the query's dependency
set (``scheduler.rule_deps``): one monotone counter per (table, rule)
whose cleaning commits can change the answer — since DESIGN.md §11 these
counters live in the executor's work ledger, whose per-strip commits
(foreground steps, background strip increments) each bump exactly the
committing rule's entry, so ledger-vector invalidation stays exact at
rule granularity even when cleaning advances one strip at a time.  The
executor bumps a rule's scope version on every candidate-overlay merge
and checked-bit commit for that rule, and its cleaning steps *skip* — no
state change, no bump — whenever a query's scope is already checked.  Re-executing a query
while its dependency vector is unchanged is therefore a pure function of
the probabilistic instance and returns bit-identical answers (the
soundness contract, asserted in tests/test_service.py), so a hit never
serves a stale answer — and a background cleaner's commits on OTHER rules
never invalidate it (exact-at-rule-granularity invalidation, asserted in
tests/test_service_background.py).

The cache itself is version-agnostic: it compares versions by equality
only, so plain ``clean_version`` ints (the PR-3 keying) and dependency
vectors both work.  Entries store the *post*-execution vector — the state
the answer was computed at (``execute`` may itself advance versions while
cleaning for the query; the answer reflects the advanced state).

Thread-safety: NOT internally locked.  The server performs every
lookup/insert while holding the executor's lock (``Daisy.lock``), which
also serializes it against the background cleaner's commits — that lock
is this structure's synchronization.

Cached ``DaisyResult``s are shared by reference across sessions; they are
treated as immutable (device arrays + a report nobody mutates).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional


class ResultCache:
    """LRU over (fingerprint -> (version, result)); see the module
    docstring for the versioning and locking contract."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: OrderedDict[str, tuple[int, object]] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.stale = 0  # fingerprint present but clean_version moved on
        self.evictions = 0

    def get(self, fingerprint: str, clean_version) -> Optional[object]:
        """Return the cached result iff its stored version equals
        ``clean_version`` (int or dependency vector); drop stale entries."""
        entry = self._entries.get(fingerprint)
        if entry is None:
            self.misses += 1
            return None
        version, result = entry
        if version != clean_version:
            # the instance advanced: the stored answer may no longer equal a
            # fresh execution — drop it (re-insertion re-validates).  pop()
            # rather than del: a second step thread may have dropped it first
            # (stats can under/over-count under that misuse, lookups cannot
            # throw).
            self.stale += 1
            self.misses += 1
            self._entries.pop(fingerprint, None)
            return None
        self.hits += 1
        self._entries.move_to_end(fingerprint)
        return result

    def put(self, fingerprint: str, clean_version, result: object) -> None:
        """Insert/refresh an entry at its post-execution version."""
        self._entries[fingerprint] = (clean_version, result)
        self._entries.move_to_end(fingerprint)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def peek(self, fingerprint: str) -> Optional[tuple]:
        """The stored ``(version, result)`` for a fingerprint WHATEVER its
        age — the overload shed path's last-known-answer read (DESIGN.md
        §14).  Unlike ``get`` it mutates nothing: no hit/miss counters, no
        LRU promotion, and crucially no stale-drop, so an entry stays
        available for tagged stale serving until capacity evicts it or a
        regular lookup at a moved version drops it.  The caller tags the
        answer with ``qos.vector_staleness(version, current)`` and must
        refuse to shed when that distance is incomputable."""
        return self._entries.get(fingerprint)

    def version_of(self, fingerprint: str):
        """The stored version of an entry (None when absent) — test hook."""
        entry = self._entries.get(fingerprint)
        return None if entry is None else entry[0]

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        """Counter snapshot (plain ints; same locking contract as above)."""
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "stale": self.stale,
            "evictions": self.evictions,
        }
