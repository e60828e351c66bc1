"""Admission + rule/cluster batching for the query server (DESIGN.md §9).

A ``Ticket`` is one session's query in flight.  ``batch_tickets`` groups
the tickets admitted into one server step by *cluster key*: the rules the
query overlaps ((X u Y) n (P u W) != {}, §4.1) plus the σ of its equality
predicates on rule attributes — the selection that relaxation expands to a
correlated cluster.  Tickets sharing a cluster run back-to-back, so one
``clean_sigma`` pass pays for the whole batch: the first execution
detects/repairs the cluster and marks it checked; every later ticket in
the group either hits the clean-state-aware cache (identical fingerprint
at an unchanged version) or executes with its cleaning steps skipped
(checked-bit bookkeeping, §4.3).  Groups keep first-arrival order and
tickets keep arrival order within a group, so scheduling only ever pulls
same-cluster work together; the equivalence tests assert the batched
answers stay bit-identical to a serial fresh-instance run.

``rule_deps`` is the cache side of the same overlap computation: the
(table, rule) scopes whose cleaning commits can change a query's answer —
what the server versions cache entries against so a background cleaner's
commits invalidate exactly the overlapping fingerprints (DESIGN.md §10).
Every table read adds its ``(table, __rows__)`` pseudo-scope, bumped only
by ``Daisy.ingest`` — an append invalidates this table's entries exactly
once, even for queries overlapping no rule (DESIGN.md §12).

Ingest tickets (``kind == "ingest"``) are batch BARRIERS: a batch is cut
into segments at each ingest ticket, clustering only within a segment, so
reordering by cluster never moves a query across an append it arrived
before (or after) — arrival order against ingests is preserved.

Pick order is the OTHER half of scheduling and lives in ``qos.FairQueue``
(DESIGN.md §14): the server admits each step's batch FIFO or in weighted
fair order, and only then does ``batch_tickets`` regroup the admitted
batch by cluster — so fairness decides *who* gets in, clustering decides
*how cheaply* they are served together.

Thread-safety: everything here is pure functions over immutable inputs
plus the ``Ticket`` record; a ticket is written by the serving thread and
waited on via its ``event`` by the submitting thread — fields other than
``event`` are read by the submitter only after ``event`` is set.  The
one exception is the pending/serving/cancelled state machine, which both
threads race on and which is guarded by the ticket's own ``_state_lock``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.constraints import overlaps_query, rule_attrs
from repro_torch.core.ledger import TABLE_ROWS_RULE
from repro_torch.core.operators import Query, _fp_value
from repro_torch.service.session import Session


@dataclasses.dataclass
class Ticket:
    """One submitted request: filled in by the serving thread, waited on by
    the submitting session's thread (``wait`` blocks on ``event``; every
    other field is safe to read only after ``event`` is set).

    ``kind`` is ``"query"`` (the default; ``query`` is set) or ``"ingest"``
    (a streaming append, DESIGN.md §12: ``ingest`` holds ``(table, rows)``
    and ``result`` becomes the ``IngestReport``).  Ingest tickets ride the
    same submit queue so appends serialize with queries in arrival order.

    Traffic shaping (DESIGN.md §14): ``slo`` names the ticket's service
    class, ``weight`` its effective WFQ share, and ``start_tag`` /
    ``finish_tag`` its virtual-time stamps (set by ``qos.FairQueue.push``
    in fair mode).  ``deadline`` is an *absolute* ``perf_counter`` time
    for deadline-miss accounting (``None`` = no deadline).  A shed ticket
    (``shed``) was answered at submit from the version-vector cache;
    ``staleness`` then carries the explicit vector distance between the
    answer's stored dependency vector and the current one — an un-shed
    answer never carries a tag (``None``).

    Lifecycle: ``pending -> serving -> done``, or ``pending -> cancelled``
    via ``cancel()`` (a timed-out ``wait`` cancels; the server discards
    cancelled tickets at pick/serve time without doing any cleaning
    work).  The tiny state machine is the only ticket state two threads
    race on, and it is guarded by its own lock."""

    seq: int
    session: Optional[Session]
    query: Optional[Query]
    fingerprint: str
    # the (table, rule) scopes this query's answer depends on — computed at
    # submit, versioned by the cache (DESIGN.md §10)
    deps: Tuple[Tuple[str, str], ...] = ()
    kind: str = "query"
    ingest: Optional[Tuple[str, Dict[str, object]]] = None  # (table, rows)
    # perf_counter stamp set at submit: the serving thread derives queue-wait
    # spans and end-to-end latency histograms from it (DESIGN.md §13)
    submitted: float = 0.0
    # traffic shaping (DESIGN.md §14)
    slo: str = "interactive"
    weight: float = 1.0
    deadline: Optional[float] = None  # absolute perf_counter deadline
    start_tag: float = 0.0  # virtual start time (fair mode)
    finish_tag: float = 0.0  # virtual finish time (fair mode)
    shed: bool = False  # answered stale-from-cache at submit
    staleness: Optional[int] = None  # version-vector distance of a shed answer
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[object] = None  # DaisyResult / IngestReport once served
    cached: bool = False
    clean_version: Optional[int] = None
    error: Optional[BaseException] = None
    _state: str = dataclasses.field(default="pending", init=False)
    _state_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False, compare=False
    )

    # ------------------------------------------------------------- lifecycle
    def begin_serve(self) -> bool:
        """Claim the ticket for serving (serving thread).  False iff the
        ticket was cancelled first — the caller must then skip it without
        touching the executor (cancellation honored at serve time)."""
        with self._state_lock:
            if self._state != "pending":
                return False
            self._state = "serving"
            return True

    def finish_serve(self) -> None:
        """Mark the ticket served (serving thread; after ``event`` work)."""
        with self._state_lock:
            self._state = "done"

    def cancel(self) -> bool:
        """Abandon a still-pending ticket (submitting thread).  Releases
        the session's admission slot immediately and guarantees the server
        will do no detect/repair work for it.  False when serving already
        started or finished — the result then simply goes unread, and the
        slot is released by the normal completion path."""
        with self._state_lock:
            if self._state != "pending":
                return False
            self._state = "cancelled"
        if self.session is not None:
            self.session.fail(self.slo)
        return True

    def is_cancelled(self) -> bool:
        """True once ``cancel`` won the race (either thread may ask)."""
        with self._state_lock:
            return self._state == "cancelled"

    def wait(self, timeout: Optional[float] = None):
        """Block until served; returns the ``DaisyResult`` or raises the
        execution error.  Raises ``TimeoutError`` if the server did not
        answer in time — after CANCELLING the ticket, so an abandoned
        ticket is never executed with nobody reading the result (its
        session slot is released here, not at some later serve)."""
        if not self.event.wait(timeout):
            self.cancel()
            # cancel() lost only if serving already started; if it also
            # *finished* in the race window the answer is ready after all
            if not self.event.is_set():
                raise TimeoutError(
                    f"ticket {self.seq} not served within {timeout}s; cancelled"
                )
        if self.error is not None:
            raise self.error
        return self.result


def rule_deps(query: Query, rules: Dict[str, Sequence]) -> Tuple[Tuple[str, str], ...]:
    """The (table, rule) scopes whose cleaning can change this query's
    answer: rules on the query's tables whose attributes overlap the
    query's ((X u Y) n (P u W) != {}, §4.1).

    Repairs only ever merge candidates for a rule's own attributes, so a
    commit for a non-overlapping rule cannot move this query's answer —
    the cache keys entries on the version vector over exactly this set
    (DESIGN.md §10).

    Every table read also contributes its ``(table, __rows__)`` pseudo-scope
    (``core.ledger.TABLE_ROWS_RULE``), whose version only ``Daisy.ingest``
    bumps: appended rows can change ANY query's answer over the table —
    including one overlapping no rule — so the cache must go stale exactly
    once per append, and does, while entries over untouched tables survive
    (DESIGN.md §12).
    """
    tables = (query.table,) + tuple(j.right for j in query.joins)
    attrs = query.attrs
    out: List[Tuple[str, str]] = []
    for t in tables:
        for rule in rules.get(t, ()):
            if overlaps_query(rule, attrs):
                out.append((t, rule.name))
        out.append((t, TABLE_ROWS_RULE))
    return tuple(out)


def cluster_key(query: Query, rules: Dict[str, Sequence]) -> Tuple:
    """The (rules, σ) cluster a query's cleaning work belongs to.

    Two queries share a key iff they overlap the same rules on the same
    tables and filter rule attributes with the same equality σ — exactly
    when their relaxations expand to the same correlated cluster and the
    first execution's detect/repair pass covers both.  Queries overlapping
    no rule cluster by fingerprint alone (nothing to share but the cache).
    The ``__rows__`` pseudo-scope is a cache dependency, not a cleaning
    cluster, and is excluded here.
    """
    overlapping = tuple(
        d for d in rule_deps(query, rules) if d[1] != TABLE_ROWS_RULE
    )
    rule_cols: set = set()
    for t, rule_name in overlapping:
        for rule in rules.get(t, ()):
            if rule.name == rule_name:
                rule_cols.update(rule_attrs(rule))
    sigma = tuple(
        sorted(
            (p.col, p.op, _fp_value(p.value))
            for p in query.preds
            if p.col in rule_cols and p.op == "=="
        )
    )
    return (tuple(overlapping), sigma)


def batch_tickets(
    tickets: Sequence[Ticket], rules: Dict[str, Sequence]
) -> List[List[Ticket]]:
    """Group one step's tickets by cluster, first-arrival order throughout.

    Ingest tickets are barriers (module docstring): each one becomes its
    own singleton group, and clustering restarts after it — queries are
    only ever reordered relative to other queries in the same segment,
    never across an append."""
    out: List[List[Ticket]] = []
    groups: "OrderedDict[Tuple, List[Ticket]]" = OrderedDict()
    for ticket in tickets:
        if ticket.kind == "ingest":
            out.extend(groups.values())
            groups = OrderedDict()
            out.append([ticket])
            continue
        key = cluster_key(ticket.query, rules)
        if key == ((), ()):  # no rule overlap: share only via the cache
            key = ("fp", ticket.fingerprint)
        groups.setdefault(key, []).append(ticket)
    out.extend(groups.values())
    return out
