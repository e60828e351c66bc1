"""Concurrent query serving over one shared Daisy instance (DESIGN.md §9,
background cleaning §10).

The step loop is continuous batching in the spirit of
``serve/engine.py``'s slot table: submitted tickets queue in arrival
order; every ``step`` admits up to ``max_batch`` tickets, orders them by
cluster (``scheduler.batch_tickets``), and serves each through the
clean-state-aware cache or the shared executor.  Admission happens every
step — sessions never wait for a "round" to finish.

Threading model: ``submit`` is fully thread-safe (many client threads,
one condition-guarded queue); the step loop is intended to run on ONE
serving thread (``run``), which makes batching deterministic.  Each
ticket is served while holding the executor's lock (``Daisy.lock``), so
the version-vector read, cache lookup, execution, and insert are atomic
with respect to a concurrent ``BackgroundCleaner`` — whose increments
take the same lock, making ticket boundaries the preemption points.  The
executor itself is re-entrant, so even misuse — multiple step threads —
degrades to query-granularity interleaving rather than torn state.

Serving a ticket: consult the cache at the query's *current* dependency
version vector (``scope_versions`` over ``rule_deps`` — so cleaning
commits for non-overlapping rules, foreground or background, never
invalidate it); on a hit the answer is returned without touching the
executor (this is where repeated exploratory workloads win); on a miss
the shared executor runs the query — cleaning the gradually-cleaned
instance as a side effect — and the answer is cached at the
post-execution vector.  Duplicate fingerprints inside one step resolve
the same way: the first execution's vector is current for the second
ticket unless an intervening execution advanced a dependency, in which
case the duplicate re-executes exactly as a serial run would.

The background handoff signal: ``pending_count`` and ``wait_idle`` let a
``BackgroundCleaner`` defer to foreground work — the queue going
non-empty clears the idle event, draining it sets the event again.

Traffic shaping (DESIGN.md §14): constructed with a ``qos.QoSPolicy``,
admission changes in three ways while everything above stays true.
Tickets carry an SLO class and a WFQ weight, and each step's batch is
picked in weighted fair order (``qos.FairQueue``) instead of FIFO —
cluster regrouping still happens, but within the fair batch.  Past the
policy's overload depth, sheddable tickets are answered AT SUBMIT from
the cache's last-known entry with an explicit ``staleness`` tag instead
of queueing (``_try_shed`` — it takes ``daisy.lock``, which is why the
shed gate runs outside the queue lock: ``snapshot`` nests the two locks
the other way).  And cancelled tickets (a timed-out ``wait``) are
discarded at pick/serve time without touching the executor.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.executor import Daisy
from repro_torch.core.operators import Query, query_fingerprint
from repro_torch.service.cache import ResultCache
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.qos import FairQueue, QoSPolicy, vector_staleness
from repro_torch.service.scheduler import Ticket, batch_tickets, rule_deps
from repro_torch.service.session import LineageEntry, Session, SessionLimitError


class QueryServer:
    """The serving facade: sessions submit queries, one serving thread
    steps them through cache + shared executor (module docstring has the
    full threading contract).  ``sessions`` is guarded by ``_lock``; the
    pending deque by ``_work`` (same lock object as ``_lock``); everything
    the executor owns by ``daisy.lock``."""

    def __init__(
        self,
        daisy: Daisy,
        cache: Optional[ResultCache] = None,
        metrics: Optional[ServiceMetrics] = None,
        max_batch: int = 8,
        tracer=None,
        qos: Optional[QoSPolicy] = None,
    ):
        self.daisy = daisy
        self.cache = cache if cache is not None else ResultCache()
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.max_batch = max_batch
        # observability seam (DESIGN.md §13): defaults to the executor's
        # tracer so one ``Daisy(tracer=...)`` wires the whole stack.  Spans:
        # per-ticket queue-wait (on a synthetic "queue" track — it overlaps
        # serving-thread spans), batch formation, cache lookup, execute,
        # commit, ingest barriers, idle waits.  End-to-end ticket latency
        # feeds ``metrics.observe_latency`` per ticket class.
        self.tracer = tracer if tracer is not None else daisy.tracer
        # traffic shaping (DESIGN.md §14): None keeps the plain behavior
        # exactly (FIFO admission, no shedding, no class accounting beyond
        # the latency histograms); a policy turns on weighted fair
        # admission, the overload shed gate, and the cleaner's SLO budget.
        self.qos = qos
        self.sessions: Dict[str, Session] = {}
        self._queue = FairQueue(qos)
        # last submit perf_counter stamp per SLO class — what the
        # background cleaner's latency allowance is computed from (§14)
        self._last_arrival: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # set <=> no ticket queued OR admitted-but-unserved: the background
        # cleaner must stay preempted for a whole in-flight batch, not just
        # until step() pops it off the queue
        self._idle = threading.Event()
        self._idle.set()
        self._inflight_batch = 0
        self._seq = 0
        self._stopping = False

    # ------------------------------------------------------------- sessions
    def open_session(self, sid: Optional[str] = None, **limits) -> Session:
        """Create and register a session (thread-safe)."""
        session = Session(sid, **limits)
        with self._lock:
            self.sessions[session.sid] = session
        return session

    def session_list(self) -> List[Session]:
        """Snapshot of registered sessions (thread-safe; the background
        cleaner aggregates lineage touch counts over it)."""
        with self._lock:
            return list(self.sessions.values())

    # ------------------------------------------------------------ admission
    def submit(
        self,
        session: Session,
        query: Query,
        slo: str = "interactive",
        deadline: Optional[float] = None,
    ) -> Ticket:
        """Queue a query; thread-safe; raises ``SessionLimitError`` on
        quota (total, lifetime, or per-class).

        ``slo`` names the ticket's service class (DESIGN.md §14): with a
        ``qos`` policy it sets the WFQ weight, the shed eligibility, and
        the cleaner-budget pressure; without one it is accounting only.
        ``deadline`` (seconds from now, optional) arms deadline-miss
        accounting for this ticket.

        Admission control: when the policy says the service is past
        ``overload_depth`` and the class is sheddable, the ticket is
        answered HERE — from the cache's last-known entry for its
        fingerprint, with an explicit ``staleness`` tag (the version-
        vector distance to the current state) — and never queued.  A
        fingerprint with no cached entry cannot be shed and queues
        normally; shedding never happens silently or with the policy
        disabled."""
        policy = self.qos
        if policy is not None:
            policy.slo(slo)  # unknown class -> KeyError before any state
        try:
            session.admit(slo)
        except SessionLimitError:
            with self._lock:
                self.metrics.rejected += 1
            raise
        now = time.perf_counter()
        with self._work:
            if self._stopping:
                session.fail(slo)
                raise RuntimeError("server is stopping; submission refused")
            seq = self._seq
            self._seq += 1
            self._last_arrival[slo] = now
            depth = len(self._queue) + self._inflight_batch
        self.metrics.observe_admitted(slo)
        ticket = Ticket(
            seq=seq,
            session=session,
            query=query,
            fingerprint=query_fingerprint(query),
            deps=rule_deps(query, self.daisy.rules),
            submitted=now,
            slo=slo,
            weight=policy.weight(session, slo) if policy is not None else 1.0,
            deadline=(now + deadline) if deadline is not None else None,
        )
        # the shed gate runs OUTSIDE the queue lock: it takes the executor
        # lock (version read + cache peek must be atomic vs the background
        # cleaner), and daisy.lock must never be acquired while holding
        # _work — snapshot() nests them the other way around
        if policy is not None and policy.should_shed(slo, depth):
            if self._try_shed(ticket):
                return ticket
        with self._work:
            if self._stopping:
                session.fail(slo)
                raise RuntimeError("server is stopping; submission refused")
            self._queue.push(ticket)
            self._idle.clear()
            self._work.notify()
        return ticket

    def _try_shed(self, ticket: Ticket) -> bool:
        """Answer an overloaded sheddable ticket from the version-vector
        cache's last-known entry, tagged with its explicit staleness
        (DESIGN.md §14).  False when no entry exists or the stored version
        is incomparable with the current vector — the ticket must then
        queue; a stale answer is never served untagged."""
        daisy = self.daisy
        with daisy.lock:
            entry = self.cache.peek(ticket.fingerprint)
            if entry is None:
                return False
            stored_version, result = entry
            current = daisy.scope_versions(ticket.deps)
            staleness = vector_staleness(stored_version, current)
            if staleness is None:
                return False
            clean_version = daisy.clean_version
        # claim the ticket so a concurrent cancel cannot double-release the
        # session slot (the submitter can't have timed out yet, but the
        # state machine is cheap insurance)
        if not ticket.begin_serve():
            return False
        ticket.shed = True
        ticket.staleness = staleness
        ticket.cached = True
        ticket.result = result
        ticket.clean_version = clean_version
        self.metrics.observe_shed(ticket.slo, staleness)
        ticket.session.complete(
            LineageEntry(
                fingerprint=ticket.fingerprint,
                clean_version=clean_version,
                result_size=result.report.result_size,
                cached=True,
                rules=ticket.deps,
            ),
            slo=ticket.slo,
        )
        ticket.finish_serve()
        ticket.event.set()
        self.tracer.instant(
            "serve.shed", seq=ticket.seq, slo=ticket.slo, staleness=staleness
        )
        self.metrics.observe_latency(
            ticket.slo, time.perf_counter() - ticket.submitted
        )
        return True

    def query(
        self,
        session: Session,
        query: Query,
        timeout: Optional[float] = None,
        slo: str = "interactive",
        deadline: Optional[float] = None,
    ):
        """Submit and block until answered (requires a running serving
        thread; synchronous callers use ``submit`` + ``drain`` instead).
        A timed-out wait CANCELS the ticket (scheduler.Ticket.wait), so an
        abandoned query is never executed for nobody."""
        return self.submit(session, query, slo=slo, deadline=deadline).wait(timeout)

    def ingest(self, table: str, rows, session: Optional[Session] = None) -> Ticket:
        """Queue a streaming append (DESIGN.md §12); thread-safe.

        The returned ticket's ``result`` is the ``IngestReport`` once
        served (``wait()``).  Ingest tickets ride the same queue as
        queries and act as batch barriers (``scheduler.batch_tickets``),
        so every query submitted before the append answers over the old
        rows and every one after it answers over the appended instance —
        arrival order, exactly as a serial client would observe.  No
        session quota applies: appends are producer traffic, not answered
        queries."""
        with self._work:
            if self._stopping:
                raise RuntimeError("server is stopping; submission refused")
            ticket = Ticket(
                seq=self._seq,
                session=session,
                query=None,
                fingerprint=f"ingest:{self._seq}",
                kind="ingest",
                ingest=(table, rows),
                submitted=time.perf_counter(),
            )
            self._seq += 1
            self._queue.push(ticket)
            self._idle.clear()
            self._work.notify()
        return ticket

    # ----------------------------------------------------- background signal
    def pending_count(self) -> int:
        """Number of unserved foreground tickets (queued plus the batch a
        step is currently serving) — the background cleaner checks this
        between increments and yields when > 0.  May transiently count a
        cancelled-but-not-yet-discarded ticket; the next pick corrects it."""
        with self._lock:
            return len(self._queue) + self._inflight_batch

    def qos_state(self) -> Dict[str, object]:
        """Traffic snapshot for the background cleaner's budget decision
        (DESIGN.md §14): pending depth (total and per SLO class) and the
        last arrival stamp per class.  Thread-safe; cheap (host dicts)."""
        with self._lock:
            return {
                "depth": len(self._queue) + self._inflight_batch,
                "depth_by_class": self._queue.depth_by_class(),
                "last_arrival": dict(self._last_arrival),
            }

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the pending queue is empty (the handoff signal a
        background cleaner waits on); returns False on timeout."""
        return self._idle.wait(timeout)

    # ------------------------------------------------------------- step loop
    def step(self) -> int:
        """Admit up to ``max_batch`` pending tickets — FIFO, or in weighted
        fair order under a qos policy (DESIGN.md §14) — and serve them
        grouped by cluster.  Returns the number of tickets served.  Single
        serving thread only (see module docstring)."""
        with self._lock:
            batch, dropped = self._queue.pop_batch(self.max_batch)
            self._inflight_batch = len(batch)
            if not batch:
                self._idle.set()
        for t in dropped:  # cancelled while queued: no work was done
            self.metrics.observe_cancelled(t.slo)
        if not batch:
            return 0
        try:
            executed_this_step: set = set()
            with self.tracer.span("serve.batch", tickets=len(batch)) as sp:
                groups = batch_tickets(batch, self.daisy.rules)
                sp.set(groups=len(groups))
            for group in groups:
                for ticket in group:
                    self._serve(ticket, executed_this_step)
        finally:
            # the cleaner may resume only once the whole batch is answered
            with self._lock:
                self._inflight_batch = 0
                if not len(self._queue):
                    self._idle.set()
        self.metrics.steps += 1
        return len(batch)

    def _serve(self, ticket: Ticket, executed_this_step: set) -> None:
        """Serve one ticket under the executor lock (atomic versus the
        background cleaner: vector read, cache lookup, execute, insert)."""
        daisy = self.daisy
        if ticket.kind == "ingest":
            self._serve_ingest(ticket)
            return
        if not ticket.begin_serve():
            # cancelled after admission, before serving: honored here — no
            # detect/repair work, no executor touch, slot already released
            self.metrics.observe_cancelled(ticket.slo)
            return
        self._record_queue_wait(ticket)
        with daisy.lock:
            d0, r0 = daisy.detect_calls, daisy.repair_calls
            tl0, ts0 = daisy.tiles_launched, daisy.tiles_skipped
            with self.tracer.span("serve.cache_lookup", seq=ticket.seq) as sp:
                vector = daisy.scope_versions(ticket.deps)
                result = self.cache.get(ticket.fingerprint, vector)
                sp.set(hit=result is not None)
            if result is not None:
                ticket.cached = True
                self.metrics.observe_hit(
                    same_step=ticket.fingerprint in executed_this_step
                )
            else:
                try:
                    with self.tracer.span(
                        "serve.execute", seq=ticket.seq, table=ticket.query.table
                    ):
                        result = daisy.execute(ticket.query)
                except Exception as exc:  # surface to the caller, keep serving
                    self.metrics.errors += 1
                    # partial cleaning work before the failure still happened
                    self.metrics.observe_work(
                        daisy.detect_calls - d0, daisy.repair_calls - r0,
                        daisy.tiles_launched - tl0, daisy.tiles_skipped - ts0,
                    )
                    ticket.error = exc
                    ticket.session.fail(ticket.slo)
                    ticket.finish_serve()
                    ticket.event.set()
                    return
            if not ticket.cached:
                # a pure cache hit publishes nothing, so only executed
                # results get a commit span — keeping the disabled-tracer
                # tax on the hit path to two no-op call sites (the <= 3%
                # overhead gate in tests/test_obs.py)
                with self.tracer.span("serve.commit", seq=ticket.seq):
                    self.cache.put(
                        ticket.fingerprint, daisy.scope_versions(ticket.deps),
                        result,
                    )
                    executed_this_step.add(ticket.fingerprint)
                    self.metrics.observe_execution(result.report)
            self.metrics.observe_work(
                daisy.detect_calls - d0, daisy.repair_calls - r0,
                daisy.tiles_launched - tl0, daisy.tiles_skipped - ts0,
            )
            ticket.result = result
            ticket.clean_version = daisy.clean_version
        ticket.session.complete(
            LineageEntry(
                fingerprint=ticket.fingerprint,
                clean_version=ticket.clean_version,
                result_size=result.report.result_size,
                cached=ticket.cached,
                rules=ticket.deps,
            ),
            slo=ticket.slo,
        )
        ticket.finish_serve()
        ticket.event.set()
        now = time.perf_counter()
        if ticket.deadline is not None and now > ticket.deadline:
            self.metrics.observe_deadline_miss(ticket.slo)
        if ticket.submitted:
            self.metrics.observe_latency("query", now - ticket.submitted)
            if self.qos is not None:
                # per-SLO-class percentiles (DESIGN.md §14); keyed by class
                # name so snapshot()["latency"]["interactive"] is the SLO gate
                self.metrics.observe_latency(ticket.slo, now - ticket.submitted)

    def _record_queue_wait(self, ticket: Ticket) -> None:
        """Span from submit to the moment serving starts, on the synthetic
        "queue" track (it overlaps serving-thread spans, so it must not
        break their nesting — obs/trace.py's thread contract)."""
        if ticket.submitted and self.tracer:
            now = time.perf_counter()
            self.tracer.record(
                "serve.queue_wait", ticket.submitted, now - ticket.submitted,
                thread="queue", seq=ticket.seq, kind=ticket.kind,
            )

    def _serve_ingest(self, ticket: Ticket) -> None:
        """Apply one queued append under the executor lock (DESIGN.md §12).
        The ``__rows__`` version bump inside ``Daisy.ingest`` is what
        invalidates this table's cache entries; no explicit cache work is
        needed here."""
        daisy = self.daisy
        table, rows = ticket.ingest
        if not ticket.begin_serve():
            self.metrics.observe_cancelled(ticket.slo)
            return
        self._record_queue_wait(ticket)
        with daisy.lock:
            try:
                with self.tracer.span(
                    "serve.ingest", seq=ticket.seq, table=table
                ) as sp:
                    report = daisy.ingest(table, rows)
                    sp.set(rows=report.rows)
            except Exception as exc:  # surface to the caller, keep serving
                self.metrics.errors += 1
                ticket.error = exc
                ticket.finish_serve()
                ticket.event.set()
                return
            self.metrics.observe_ingest(report)
            ticket.result = report
            ticket.clean_version = daisy.clean_version
        ticket.finish_serve()
        ticket.event.set()
        if ticket.submitted:
            self.metrics.observe_latency(
                "ingest", time.perf_counter() - ticket.submitted
            )

    # ------------------------------------------------------------ lifecycle
    def drain(self) -> int:
        """Serve everything pending synchronously (no serving thread needed).
        Returns the number of tickets served."""
        total = 0
        while True:
            served = self.step()
            if served == 0:
                return total
            total += served

    def run(self, max_steps: int = 1_000_000, idle_wait: float = 0.05) -> None:
        """Serving-thread loop: step while work arrives; exit once ``stop()``
        was called and the queue drained.  ``max_steps`` is a runaway
        backstop and counts only steps that served work — idling forever is
        fine.  Idle wait time feeds the ``idle_fraction`` gauge (the
        background cleaner's budget)."""
        served_steps = 0
        while served_steps < max_steps:
            if self.step():
                served_steps += 1
                continue
            with self._work:
                if self._stopping and not len(self._queue):
                    return
                with self.tracer.span("serve.idle"):
                    t0 = time.perf_counter()
                    self._work.wait(timeout=idle_wait)
                    self.metrics.observe_idle(time.perf_counter() - t0)

    def stop(self) -> None:
        """Refuse new submissions and wake the serving thread to exit after
        the queue drains (thread-safe)."""
        with self._work:
            self._stopping = True
            self._work.notify_all()

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable state: metrics (with foreground/background
        attribution and per-scope ledger progress), cache stats, clean
        version, per-session summaries."""
        with self.daisy.lock:  # coverage counts are mutated under this lock
            self.metrics.observe_ledger(self.daisy.ledger.progress())
        snap = self.metrics.snapshot()
        snap["cache"] = self.cache.stats()
        snap["clean_version"] = self.daisy.clean_version
        with self._lock:  # open_session inserts concurrently
            sessions = list(self.sessions.values())
        snap["sessions"] = [s.snapshot() for s in sessions]
        return snap
