"""Traffic shaping for the query service (DESIGN.md §14): weighted fair
queueing, SLO classes, and stale-serve load shedding.

The paper's core claim is that cleaning adapts to the workload, not the
other way round — which only holds up if the *service* keeps its latency
promises while cleaning competes with queries.  A plain scheduler is
FIFO-by-cluster with no admission control: one heavy session or an
overload burst starves everyone else, and the background cleaner has no
notion of how urgent the queued traffic is.  This module adds the three
shaping mechanisms, composed with (not replacing) the existing cluster
batching:

* **Weighted fair queueing** (``FairQueue``).  Start-time fair queueing
  (the SFQ variant of WFQ): each ticket gets a virtual *start tag*
  ``S = max(V, F_last(session))`` and *finish tag* ``F = S + 1/w`` at
  submit, where ``V`` is the queue's virtual time (advanced to the start
  tag of every ticket picked) and ``w`` the ticket's effective weight
  (session weight x SLO-class weight).  The server admits each step's
  batch in ascending ``(start tag, seq)`` order; ``batch_tickets`` then
  regroups the admitted batch by cluster, so same-cluster amortization
  survives the reordering but can no longer starve an orphan cluster —
  a singleton-cluster ticket is served in the very step its tag comes
  up.  **Starvation bound** (property-tested in tests/test_qos.py): for
  a ticket that is its session's ``q``-th pending ticket at arrival
  (counting itself), at most ``q * ceil(W / w) + N`` other tickets are
  served before it, where ``W`` is the total weight of the sessions
  that ever submitted and ``N`` their number.  Proof sketch: consecutive
  tickets of one session have start tags at least ``1/w_j`` apart and
  pending tags never sit below ``V``, so session ``j`` can own at most
  ``(S_t - V) * w_j + 1`` tags at or below ``S_t``, and the ticket's own
  chain bounds ``S_t - V <= q / w_i``; summing over sessions gives the
  bound.  Batch admission multiplies the positional bound by at most
  ``max_batch`` (within a step the cluster regrouping may reorder).

* **SLO classes** (``SLOClass``).  Tickets carry a class —
  ``interactive`` / ``batch`` / ``background`` — that sets their WFQ
  weight share, their shed eligibility, and a latency target the
  background cleaner's budget adapts to: a recent interactive arrival
  shrinks ``increment_rows``/``max_strips`` (via the per-increment
  preemption points) until one increment fits inside the tightest active target
  (``latency_allowance``/``cleaner_budget`` — a small control loop over
  the cleaner's observed increment duration).

* **Stale-serve load shedding**.  Past ``overload_depth`` pending
  tickets, a sheddable ticket is answered AT SUBMIT from the
  version-vector cache's last-known entry for its fingerprint, tagged
  with an explicit ``staleness`` — the L1 distance between the entry's
  stored dependency vector and the current one
  (``vector_staleness``) — instead of queueing.  Never silently: a shed
  answer always carries the tag (0 means the entry is in fact current),
  an un-shed answer never carries one, and a fingerprint with no cached
  entry cannot be shed and queues normally.  This is the
  graceful-degradation ordering of SNIPPETS.md §1 — relax the
  least-valuable guarantee first: result freshness degrades (visibly,
  bounded by the tag) before interactive latency does, while the batch
  class absorbs the backlog by queueing.

Thread-safety: ``SLOClass``/``QoSPolicy`` are frozen and shared freely.
``FairQueue`` is NOT internally locked — the server mutates it only
under its own queue lock, exactly like the deque it replaces.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class: queueing weight, latency target, shed policy.

    ``weight`` multiplies the session weight into the ticket's WFQ share.
    ``target_s`` is the class's latency objective — ``None`` means "no
    promise" (the cleaner ignores the class when sizing its budget, and
    deadline accounting only applies to tickets that opt in).
    ``sheddable`` marks classes that prefer a tagged slightly-stale
    answer over queueing when the service is past capacity."""

    name: str
    weight: float
    target_s: Optional[float] = None
    sheddable: bool = False

    def __post_init__(self):
        if self.weight <= 0.0:
            raise ValueError(f"SLO class {self.name!r}: weight must be > 0")


#: The default class ladder: interactive traffic holds the latency
#: promise (and may degrade freshness under overload to keep it), batch
#: absorbs backlog, background yields to everyone.
DEFAULT_SLO_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("interactive", weight=8.0, target_s=0.1, sheddable=True),
    SLOClass("batch", weight=2.0, target_s=2.0, sheddable=False),
    SLOClass("background", weight=1.0, target_s=None, sheddable=False),
)


def vector_staleness(stored, current) -> Optional[int]:
    """L1 distance between a cache entry's stored version (vector or a
    plain int) and the current one — the shed tag's value.

    Versions are monotone, so a well-formed pair satisfies
    ``current >= stored`` componentwise and the distance is the number of
    cleaning commits the entry is behind.  Returns ``None`` when the two
    are incomparable (different shapes, non-monotone, or mixed types) —
    the caller must then refuse to shed rather than mis-tag."""
    if isinstance(stored, int) and isinstance(current, int):
        return current - stored if current >= stored else None
    try:
        stored_t, current_t = tuple(stored), tuple(current)
    except TypeError:
        return None
    if len(stored_t) != len(current_t):
        return None
    total = 0
    for s, c in zip(stored_t, current_t):
        if not isinstance(s, int) or not isinstance(c, int) or c < s:
            return None
        total += c - s
    return total


@dataclasses.dataclass(frozen=True)
class QoSPolicy:
    """The traffic-shaping knobs, bundled (frozen: shared by the server,
    the background cleaner, and the CLI without locking).

    ``overload_depth`` is the admission-control threshold: a sheddable
    ticket submitted while more than this many tickets are pending is
    answered stale-from-cache instead of queued (0 disables shedding —
    WFQ and SLO accounting still apply).  ``quiet_s`` is how long after a
    class's last arrival its latency target keeps constraining the
    background cleaner's budget."""

    classes: Tuple[SLOClass, ...] = DEFAULT_SLO_CLASSES
    overload_depth: int = 0
    quiet_s: float = 0.25
    min_increment_rows: int = 32

    def __post_init__(self):
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")

    # --------------------------------------------------------------- classes
    def slo(self, name: str) -> SLOClass:
        """Look up a class by name; unknown names are submit-time errors
        (a typo must not silently become a default weight)."""
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(
            f"unknown SLO class {name!r} (have {[c.name for c in self.classes]})"
        )

    def weight(self, session, slo: str) -> float:
        """A ticket's effective WFQ weight: session weight x class weight
        (sessionless tickets count as weight-1 sessions)."""
        base = session.weight if session is not None else 1.0
        return base * self.slo(slo).weight

    # -------------------------------------------------------------- shedding
    def should_shed(self, slo: str, depth: int) -> bool:
        """Admission decision: shed iff shedding is enabled, the class
        prefers stale answers to queueing, and the pending depth is past
        the overload threshold."""
        return (
            self.overload_depth > 0
            and depth > self.overload_depth
            and self.slo(slo).sheddable
        )

    # ------------------------------------------------- background-cleaner SLA
    def latency_allowance(
        self, now: float, last_arrival: Mapping[str, float]
    ) -> Optional[float]:
        """The tightest latency target among classes that arrived within
        the last ``quiet_s`` — how long the background cleaner may hold
        the executor lock without risking a just-arrived ticket's SLO.
        ``None`` when no target-bearing class is active (cleaner runs at
        its full configured budget)."""
        targets = [
            c.target_s
            for c in self.classes
            if c.target_s is not None
            and now - last_arrival.get(c.name, -math.inf) <= self.quiet_s
        ]
        return min(targets) if targets else None

    def cleaner_budget(
        self,
        allowance: Optional[float],
        est_increment_s: Optional[float],
        base_rows: int,
        base_strips: int,
    ) -> Tuple[int, int]:
        """Shrink the cleaner's per-increment budget so one lock hold fits
        the active latency allowance (DESIGN.md §14).

        ``est_increment_s`` is the cleaner's running estimate of its own
        increment duration at its *current* budget; scaling the budget by
        ``allowance / estimate`` forms a control loop that converges on
        increments of about the allowance: too-slow increments shrink the
        budget, comfortably-fast ones let it climb back toward the base.
        With no estimate yet the first constrained increment runs at the
        minimum (a strip / a quarter of the rows) rather than gambling a
        just-arrived interactive ticket's target on an unknown cost."""
        if allowance is None:
            return base_rows, base_strips
        floor_rows = min(base_rows, max(base_rows // 4, self.min_increment_rows))
        if est_increment_s is None or est_increment_s <= 0.0:
            return floor_rows, 1
        ratio = allowance / est_increment_s
        rows = min(base_rows, max(int(base_rows * ratio), floor_rows))
        strips = min(base_strips, max(int(base_strips * ratio), 1))
        return rows, strips


class FairQueue:
    """The server's pending queue: arrival-ordered storage with either
    FIFO (``policy=None`` — bit-compatible with a plain deque) or
    virtual-time fair pick order (module docstring).  NOT internally
    locked: the owner serializes every call (the server uses its queue
    lock, exactly as it did for the deque this replaces).

    Ingest tickets are BARRIERS in either mode (DESIGN.md §12): fair
    picking only ever reorders tickets within one arrival segment — the
    run of queries between two ingests — so a query never crosses an
    append it arrived before or after.  Virtual time advances to the
    start tag of every picked ticket; within a segment the pick is the
    global minimum, which keeps the pending-tags-never-below-V invariant
    the starvation bound rests on.

    Cancelled tickets (``Ticket.cancel``) are discarded lazily at pick
    time and returned separately from the batch, so the server can count
    them without ever serving them."""

    def __init__(self, policy: Optional[QoSPolicy] = None):
        self.policy = policy
        self._pending: Deque = deque()
        self._vtime = 0.0
        self._finish: Dict[str, float] = {}
        self._depth_by_class: Dict[str, int] = {}

    def __len__(self) -> int:
        """Pending tickets, including not-yet-discarded cancelled ones
        (an overcount the next pick corrects — depth is an admission
        heuristic, not an invariant)."""
        return len(self._pending)

    def depth_by_class(self) -> Dict[str, int]:
        """Pending count per SLO class (same lazy-cancel caveat as
        ``__len__``)."""
        return dict(self._depth_by_class)

    # ------------------------------------------------------------------ push
    def push(self, ticket) -> None:
        """Append one ticket; in fair mode, stamp its virtual start/finish
        tags from its session chain (``ticket.weight`` must be set)."""
        if self.policy is not None and ticket.kind != "ingest":
            key = ticket.session.sid if ticket.session is not None else (
                f"__anon_{ticket.slo}"
            )
            weight = max(float(ticket.weight), 1e-9)
            start = max(self._vtime, self._finish.get(key, 0.0))
            ticket.start_tag = start
            ticket.finish_tag = start + 1.0 / weight
            self._finish[key] = ticket.finish_tag
        self._pending.append(ticket)
        cls = ticket.slo if ticket.kind != "ingest" else "ingest"
        self._depth_by_class[cls] = self._depth_by_class.get(cls, 0) + 1

    # ------------------------------------------------------------------ pick
    def _pick_index(self) -> int:
        """Index of the next ticket to pop: head in FIFO mode; in fair
        mode the minimum ``(start_tag, seq)`` within the head arrival
        segment (an ingest at the head IS the segment)."""
        if self.policy is None or self._pending[0].kind == "ingest":
            return 0
        best, best_key = 0, None
        for i, t in enumerate(self._pending):
            if t.kind == "ingest":
                break  # barrier: never reorder across it
            key = (t.start_tag, t.seq)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def pop_batch(self, k: int) -> Tuple[List, List]:
        """Pop up to ``k`` live tickets in pick order; returns
        ``(batch, cancelled)`` where ``cancelled`` are the discarded
        tickets found on the way (their session slots were already
        released by ``Ticket.cancel``)."""
        batch: List = []
        cancelled: List = []
        while len(batch) < k and self._pending:
            i = self._pick_index()
            ticket = self._pending[i]
            del self._pending[i]
            cls = ticket.slo if ticket.kind != "ingest" else "ingest"
            self._depth_by_class[cls] = self._depth_by_class.get(cls, 1) - 1
            if self.policy is not None and ticket.kind != "ingest":
                self._vtime = max(self._vtime, ticket.start_tag)
            if ticket.is_cancelled():
                cancelled.append(ticket)
                continue
            batch.append(ticket)
        return batch, cancelled


__all__ = [
    "DEFAULT_SLO_CLASSES",
    "FairQueue",
    "QoSPolicy",
    "SLOClass",
    "vector_staleness",
]
