"""Cost-model-driven background cleaning behind the serving loop
(DESIGN.md §10).

The paper's engine cleans on demand, so the *first* query to touch a cold
rule/cluster scope pays the full detect/repair latency.  The
``BackgroundCleaner`` removes that first-touch cost from the interactive
path: between serving steps it full-cleans the cold scopes a
foreground query is most likely to touch next, in small preemptible
increments that commit through the executor's normal versioned path —
so by the time the query arrives, its cleaning steps skip and only the
answer is computed.

* **What is cold.**  ``Daisy.cold_rows``: unchecked rows, restricted for
  FDs to statically-dirty groups (clean groups skip via the Fig. 11 gate
  and cost foreground queries nothing — they are not background work
  either).
* **What runs first.**  ``core.cost.prioritize_scopes`` ranks scopes by
  expected foreground pairs saved (the rule's effective full-detect cost
  — dense, or the observed sharded-shuffle cost from
  ``ShardedDetectInfo`` — scaled by the cold fraction) times the
  touch probability aggregated from session lineage (``rule_touches``).
* **How it yields.**  Before each increment the cleaner checks
  ``server.pending_count()`` and defers (``wait_idle``) while foreground
  tickets queue; each increment holds ``Daisy.lock`` for one
  ``clean_scope_increment`` only — bounded for FDs by ``increment_rows``
  (whole lhs groups) and for DCs by ``increment_strips`` ledger strips
  (DESIGN.md §11; one strip x rest-of-dataset scan, NOT a full pairwise
  pass) — so a foreground ticket waits at most one bounded increment
  (the preemption-latency bound tests, FD and DC).
* **Why answers stay sound.**  Increments run the foreground cleaning
  pipeline itself and bump the same per-scope versions, so the cache
  invalidates exactly the fingerprints whose dependency scopes were
  touched; equal version vectors still imply bit-identical answers
  (DESIGN.md §10 has the full argument).

Thread-safety: one cleaner thread (``start``/``stop``); every mutation of
shared cleaning state happens inside ``Daisy.lock`` via
``clean_scope_increment``; metrics go through the ``observe_background``
path (its own lock); session lineage is read under each session's lock.
``step``/``drain`` may instead be called cooperatively from any single
thread (the benchmarks drive idle windows deterministically that way).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.constraints import FD
from repro_torch.core.cost import ScopePriority, prioritize_scopes, sharded_detect_cost
from repro_torch.core.executor import Daisy, StepReport
from repro_torch.core.ledger import TABLE_ROWS_RULE
from repro_torch.service.metrics import ServiceMetrics


@dataclasses.dataclass(frozen=True)
class IncrementReport:
    """What one background increment did (immutable; returned to the
    calling thread only)."""

    table: str
    rule: str
    step: Optional[StepReport]  # None when the executor skipped
    detect_delta: int
    repair_delta: int
    seconds: float
    scope_completed: bool  # the scope went warm with this increment


class BackgroundCleaner:
    """Preemptible background full-cleaner over one shared ``Daisy``.

    Construct with the server to serve behind (preemption + touch
    probabilities + shared metrics) or standalone (``server=None``:
    uniform touch probabilities, no preemption source — cooperative use).
    All configuration is read-only after construction; see the module
    docstring for the threading contract.
    """

    def __init__(
        self,
        daisy: Daisy,
        server=None,
        metrics: Optional[ServiceMetrics] = None,
        increment_rows: int = 512,
        increment_strips: int = 1,
        idle_wait: float = 0.02,
        tracer=None,
        policy=None,
    ):
        self.daisy = daisy
        self.server = server
        self.metrics = metrics if metrics is not None else (
            server.metrics if server is not None else ServiceMetrics()
        )
        # SLO-aware budget (DESIGN.md §14): defaults to the server's qos
        # policy, so one ``QueryServer(qos=...)`` wires the cleaner too.
        # When set, each increment's row/strip budget shrinks so one
        # executor-lock hold fits the tightest latency target among
        # recently-active classes (``QoSPolicy.cleaner_budget``), sized
        # against ``_inc_ewma`` — a running estimate of this cleaner's own
        # increment duration.
        self.policy = policy if policy is not None else (
            getattr(server, "qos", None) if server is not None else None
        )
        self._inc_ewma: Optional[float] = None
        # observability seam (DESIGN.md §13): defaults to the executor's
        # tracer (the server shares it too), so increments, yields and
        # preemption waits land in the same trace as the serving spans.
        self.tracer = tracer if tracer is not None else daisy.tracer
        self.increment_rows = increment_rows
        # DC increments clean this many ledger strips per lock hold
        # (DESIGN.md §11) — the DC analogue of ``increment_rows``
        self.increment_strips = max(int(increment_strips), 1)
        self.idle_wait = idle_wait
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # cached priority ranking, consumed scope-by-scope across increments
        # (cleaner thread only); refreshed when it empties, so a full
        # re-scan — per-rule cold counts under the executor lock plus the
        # session-lineage aggregation — happens once per warmup pass, not
        # once per increment.  Staleness only mis-orders work: every
        # increment re-checks coldness under the lock before cleaning.
        self._ranked: List[ScopePriority] = []

    # ------------------------------------------------------------ priorities
    def rule_touches(self) -> Dict[Tuple[str, str], int]:
        """Aggregate per-scope touch counts across all sessions' lineage
        (the priority model's demand signal; empty without a server).  The
        per-table ``__rows__`` pseudo-scope (cache invalidation on ingest,
        DESIGN.md §12) is not a cleanable scope and stays out of the
        signal."""
        touches: Dict[Tuple[str, str], int] = {}
        if self.server is None:
            return touches
        for session in self.server.session_list():
            for dep, count in session.rule_touches().items():
                if dep[1] == TABLE_ROWS_RULE:
                    continue
                touches[dep] = touches.get(dep, 0) + count
        return touches

    def cold_scopes(self) -> List[ScopePriority]:
        """Cold (table, rule) scopes ranked by expected foreground work
        saved (``core.cost.prioritize_scopes``); empty when warm."""
        daisy = self.daisy
        touches = self.rule_touches()
        keys = [(t, r.name) for t, rs in daisy.rules.items() for r in rs]
        total_touches = sum(touches.values())
        scopes: List[ScopePriority] = []
        for table, rule_name in keys:
            with daisy.lock:
                cold = daisy.cold_count(table, rule_name)
                cm = daisy.cost.get((table, rule_name))
                info = daisy.sharded_info.get((table, rule_name))
                n = int(cm.n) if cm is not None else int(
                    daisy.db[table].num_rows()
                )
                scope_ledger = daisy.ledger.scope(table, rule_name)
                fresh_cold = (
                    scope_ledger.fresh_cold_count if scope_ledger else 0
                )
                pending = daisy.ledger.has_pending(table, rule_name)
            if cm is not None:
                full_cost = cm.df_effective
            elif info is not None:
                full_cost = sharded_detect_cost(info, n_rows=n)
            else:
                rule = daisy._rule_named(table, rule_name)
                full_cost = float(n) if isinstance(rule, FD) else float(n) * n / max(
                    daisy.config.dc_partitions, 1
                )
            # Laplace-smoothed touch probability: every scope keeps a
            # nonzero chance, observed demand dominates as lineage grows
            touch_p = (touches.get((table, rule_name), 0) + 1.0) / (
                total_touches + len(keys)
            )
            scopes.append(
                ScopePriority(
                    table=table,
                    rule=rule_name,
                    cold_rows=cold,
                    expected_pairs=full_cost * cold / max(n, 1),
                    touch_probability=touch_p,
                    # freshly appended rows are the state most likely to
                    # surprise the next foreground query (DESIGN.md §12)
                    fresh_boost=2.0 if (fresh_cold > 0 or pending) else 1.0,
                    pending=pending,
                )
            )
        return prioritize_scopes(scopes)

    # ------------------------------------------------------------ increments
    def budget(self) -> Tuple[int, int]:
        """The (max_rows, max_strips) for the NEXT increment: the
        configured base, shrunk by the qos policy so one executor-lock
        hold fits the tightest latency target among recently-active SLO
        classes (DESIGN.md §14).  An interactive arrival within the
        policy's quiet window therefore makes the cleaner take smaller,
        more preemptible bites — the per-increment preemption points do the
        rest.
        Without a policy or a server this is just the configured base."""
        rows, strips = self.increment_rows, self.increment_strips
        if self.policy is None or self.server is None:
            return rows, strips
        state = self.server.qos_state()
        allowance = self.policy.latency_allowance(
            time.perf_counter(), state["last_arrival"]
        )
        return self.policy.cleaner_budget(
            allowance, self._inc_ewma, rows, strips
        )

    def preempted(self) -> bool:
        """True when foreground tickets are queued — the handoff signal
        checked between increments."""
        return self.server is not None and self.server.pending_count() > 0

    def step(self) -> Optional[IncrementReport]:
        """Run ONE increment on the highest-priority cold scope; returns
        its report, or None when every scope is warm.  Does NOT check
        preemption — callers that should yield use ``drain``/``run``.

        A scope can go warm between the priority scan and the increment
        (a foreground query cleaned it first); such a race is not an
        increment — nothing is recorded and the next-priority scope is
        tried instead.  The ranking is cached across increments and only
        rebuilt once consumed (see ``_ranked``)."""
        daisy = self.daisy
        refreshed = False
        while True:
            if not self._ranked:
                if refreshed:
                    return None  # fresh scan found nothing cold
                self._ranked = self.cold_scopes()
                refreshed = True
                continue
            top = self._ranked[0]
            max_rows, max_strips = self.budget()
            t0 = time.perf_counter()
            with self.tracer.span(
                "bg.increment", table=top.table, rule=top.rule
            ) as sp, daisy.lock:
                d0, r0 = daisy.detect_calls, daisy.repair_calls
                step_rep = daisy.clean_scope_increment(
                    top.table, top.rule,
                    max_rows=max_rows,
                    max_strips=max_strips,
                )
                if step_rep is None:  # raced warm / stale ranking entry
                    sp.set(raced_warm=True)
                    self._ranked.pop(0)
                    continue
                dd = daisy.detect_calls - d0
                rd = daisy.repair_calls - r0
                completed = daisy.cold_count(top.table, top.rule) == 0
                progress = daisy.ledger.progress()
                sp.set(mode=step_rep.mode, completed=completed)
            if completed:
                self._ranked.pop(0)
            seconds = time.perf_counter() - t0
            # duration estimate for the SLO budget control loop (§14):
            # slow increments shrink the next budget, fast ones let it
            # climb back toward the configured base
            self._inc_ewma = seconds if self._inc_ewma is None else (
                0.7 * self._inc_ewma + 0.3 * seconds
            )
            self.metrics.observe_background(dd, rd, seconds, completed)
            self.metrics.observe_latency("bg-increment", seconds)
            self.metrics.observe_ledger(progress)
            return IncrementReport(
                table=top.table,
                rule=top.rule,
                step=step_rep,
                detect_delta=dd,
                repair_delta=rd,
                seconds=seconds,
                scope_completed=completed,
            )

    def drain(self, max_increments: Optional[int] = None) -> int:
        """Run increments until warm, preempted, or ``max_increments``;
        returns the number of increments run.  Cooperative entry point —
        the benchmarks call it in deterministic idle windows."""
        done = 0
        while max_increments is None or done < max_increments:
            if self.preempted():
                self.metrics.observe_bg_yield()
                self.tracer.instant("bg.yield")
                break
            if self.step() is None:
                break
            done += 1
        return done

    # ------------------------------------------------------------- lifecycle
    def run(self) -> None:
        """Cleaner-thread loop: wait for the server to go idle, run one
        increment, repeat; re-checks preemption before every increment.
        When everything is warm the re-scan interval backs off
        exponentially (to 1 s) so a long-lived warm server is not polled
        with per-rule cold counts every ``idle_wait``; any successful
        increment resets the backoff."""
        warm_wait = self.idle_wait
        while not self._stop.is_set():
            if self.server is not None and self.preempted():
                self.metrics.observe_bg_yield()
                self.tracer.instant("bg.yield")
                t0 = time.perf_counter()
                self.server.wait_idle(self.idle_wait)
                # how long foreground pressure kept the cleaner off the
                # lock — the preemption-latency track (DESIGN.md §13)
                self.tracer.record(
                    "bg.preempted", t0, time.perf_counter() - t0
                )
                continue
            if self.step() is None:
                self._stop.wait(warm_wait)
                warm_wait = min(warm_wait * 2.0, 1.0)
            else:
                warm_wait = self.idle_wait

    def start(self) -> "BackgroundCleaner":
        """Spawn the daemon cleaner thread (idempotent); returns self."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run, name="background-cleaner", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Signal the cleaner thread to exit and join it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
