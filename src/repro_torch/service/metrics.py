"""Serving metrics (DESIGN.md §9/§10): throughput, cache effectiveness, and
the cleaning work one shared probabilistic instance amortizes across
sessions — now attributed between the foreground serving path and the
background cleaner.

Thread-safety contract: the foreground observers (``observe_hit``,
``observe_execution``, ``observe_work``) and the step/idle counters are
mutated by the single serving thread only; the background observers
(``observe_background``, ``observe_bg_yield``, ``observe_ledger``) are
mutated by the cleaner thread under ``_bg_lock``, and ``snapshot()``
acquires that same lock to read the ``bg_*`` group and the ledger
progress — the background section of a snapshot is therefore an exact
point-in-time read, never a torn one (an increment's detect/repair/busy
deltas land atomically).  The traffic-shaping observers
(``observe_admitted``, ``observe_shed``, ``observe_cancelled``,
``observe_deadline_miss``, DESIGN.md §14) may be called from MANY client
threads — shed and cancel decisions happen on the submitting side — so
the whole ``qos`` group shares ``_bg_lock`` too: it is the metrics
object's multi-writer lock, not a cleaner-only one.  Foreground counters
are single-writer monotone host ints/floats read without a lock, so
across the groups a snapshot is a consistent approximation under
concurrency and exact once all threads quiesce.  (``queries`` counts
tickets the SERVING thread answered; shed tickets are answered at submit
and counted in ``qos.shed`` — ``snapshot()["answered"]`` is the sum.)  It returns only JSON-serializable scalars plus the last
few serialized ``StepReport`` dicts (``StepReport.asdict``) for
drill-down, and — when latencies were observed — per-ticket-class
p50/p95/p99 under ``"latency"`` (DESIGN.md §13).

The two derived numbers the layer exists for:

* ``detect_repair_per_query`` — *foreground* detect/repair invocations per
  answered query, the paper's incremental-cleaning cost amortized by the
  clean-state-aware cache AND by background warmup
  (benchmarks/serve_bg_warmup.py gates that background cleaning strictly
  lowers it against the same workload without it);
* ``idle_fraction`` — share of serving wall-clock the step loop spent
  waiting for work: the budget the background cleaner runs in.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List

from repro_torch.obs.hist import LatencyHistogram


@dataclasses.dataclass
class ServiceMetrics:
    """Counters for one server (+ optional background cleaner) lifetime.

    Foreground fields are serving-thread-only; fields prefixed ``bg_`` are
    cleaner-thread-only (guarded by ``_bg_lock``); see the module
    docstring for the full contract.  ``detect_calls``/``repair_calls``
    count FOREGROUND work — the executor's own counters hold the total,
    so background work is the difference and is tracked explicitly in the
    ``bg_*`` fields.
    """

    queries: int = 0  # tickets answered (hit or executed)
    steps: int = 0  # step-loop iterations that served >= 1 ticket
    executions: int = 0  # Daisy.execute calls (cache misses)
    cache_hits: int = 0
    batched: int = 0  # hits on a fingerprint executed earlier in the same step
    detect_calls: int = 0  # executor detect invocations while serving (fg)
    repair_calls: int = 0
    # block-sparse launch geometry (DESIGN.md §15): tile pairs the fg DC
    # scans launched vs the checked×checked pairs the ledger worklist let
    # them skip — the kernel-level counterpart of detect_calls
    tiles_launched: int = 0
    tiles_skipped: int = 0
    clean_steps: int = 0  # non-skipped cleaning steps across executions
    skipped_steps: int = 0
    rejected: int = 0  # session-limit denials
    errors: int = 0
    # streaming ingest (DESIGN.md §12): appends served through the ticket
    # queue and the rows they added (serving thread only)
    ingests: int = 0
    ingested_rows: int = 0
    ingest_pending_deltas: int = 0  # rule scopes that queued an ingest-delta
    serving_idle_s: float = 0.0  # step-loop time spent waiting for work
    # traffic shaping (DESIGN.md §14) — multi-writer, guarded by _bg_lock:
    # admission/shed/cancel happen on client threads, deadline accounting
    # on the serving thread
    shed: int = 0  # tickets answered stale-from-cache at submit
    shed_stale: int = 0  # shed answers whose staleness tag was > 0
    shed_staleness_total: int = 0  # sum of staleness tags (avg = /shed)
    cancelled: int = 0  # tickets abandoned before serving started
    deadline_misses: int = 0  # served tickets that blew their deadline
    # per-SLO-class counters: {class: {"admitted"/"shed"/"cancelled"/
    # "deadline_misses": n}}
    by_class: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    # background cleaner attribution (DESIGN.md §10)
    bg_increments: int = 0  # clean_scope_increment calls that did work
    bg_detect_calls: int = 0
    bg_repair_calls: int = 0
    bg_scopes_completed: int = 0  # increments that left their scope warm
    bg_yields: int = 0  # times the cleaner deferred to pending tickets
    bg_busy_s: float = 0.0  # wall-clock spent inside increments
    # latest work-ledger progress snapshot (DESIGN.md §11): per-scope
    # strips done / total + cold rows, updated by whichever side observed
    # it last (cleaner after each increment, server on snapshot)
    ledger_progress: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict
    )
    max_reports: int = 32
    recent_reports: List[Dict[str, object]] = dataclasses.field(default_factory=list)
    started: float = dataclasses.field(default_factory=time.perf_counter)
    # end-to-end latency histograms per ticket class ("query" / "ingest" /
    # "bg-increment"), DESIGN.md §13: log-scale buckets, so percentiles
    # come without retained samples.  Each histogram locks internally;
    # the dict itself is only grown under ``_bg_lock``.
    latency: Dict[str, LatencyHistogram] = dataclasses.field(default_factory=dict)
    _bg_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    # ------------------------------------------------------------ observers
    def observe_hit(self, same_step: bool) -> None:
        """Record one cache hit (serving thread)."""
        self.queries += 1
        self.cache_hits += 1
        if same_step:
            self.batched += 1

    def observe_execution(self, report) -> None:
        """Record one cache-miss execution from its ``ExecReport``
        (serving thread)."""
        self.queries += 1
        self.executions += 1
        for step in report.steps:
            if step.mode == "skipped":
                self.skipped_steps += 1
            else:
                self.clean_steps += 1
        self.recent_reports.append(report.asdict())
        del self.recent_reports[: -self.max_reports]

    def observe_work(
        self, detect_delta: int, repair_delta: int,
        tiles_launched_delta: int = 0, tiles_skipped_delta: int = 0,
    ) -> None:
        """Attribute executor detect/repair deltas (and the DC scans' tile
        launch/skip deltas, DESIGN.md §15) to the foreground serving path
        (serving thread)."""
        self.detect_calls += detect_delta
        self.repair_calls += repair_delta
        self.tiles_launched += tiles_launched_delta
        self.tiles_skipped += tiles_skipped_delta

    def observe_idle(self, seconds: float) -> None:
        """Accumulate step-loop wait time (serving thread)."""
        self.serving_idle_s += seconds

    def observe_ingest(self, report) -> None:
        """Record one served append from its ``IngestReport``
        (serving thread)."""
        self.ingests += 1
        self.ingested_rows += report.rows
        self.ingest_pending_deltas += len(report.pending_rules)

    def observe_background(
        self, detect_delta: int, repair_delta: int, busy_s: float,
        scope_completed: bool,
    ) -> None:
        """Attribute one background increment's work (cleaner thread)."""
        with self._bg_lock:
            self.bg_increments += 1
            self.bg_detect_calls += detect_delta
            self.bg_repair_calls += repair_delta
            self.bg_busy_s += busy_s
            if scope_completed:
                self.bg_scopes_completed += 1

    def _class_counter(self, slo: str, key: str, delta: int = 1) -> None:
        """Bump one per-class counter (callers hold ``_bg_lock``)."""
        cls = self.by_class.setdefault(slo, {})
        cls[key] = cls.get(key, 0) + delta

    def observe_admitted(self, slo: str) -> None:
        """Record one ticket entering the queue for an SLO class (client
        threads; thread-safe)."""
        with self._bg_lock:
            self._class_counter(slo, "admitted")

    def observe_shed(self, slo: str, staleness: int) -> None:
        """Record one overload shed: the ticket was answered at submit
        from the version-vector cache with this explicit staleness tag
        (client threads; thread-safe)."""
        with self._bg_lock:
            self.shed += 1
            self.shed_staleness_total += staleness
            if staleness > 0:
                self.shed_stale += 1
            self._class_counter(slo, "shed")

    def observe_cancelled(self, slo: str) -> None:
        """Record one abandoned ticket discarded before any cleaning work
        (serving thread at pick/serve time; thread-safe anyway)."""
        with self._bg_lock:
            self.cancelled += 1
            self._class_counter(slo, "cancelled")

    def observe_deadline_miss(self, slo: str) -> None:
        """Record one served ticket that finished past its deadline
        (serving thread; thread-safe)."""
        with self._bg_lock:
            self.deadline_misses += 1
            self._class_counter(slo, "deadline_misses")

    def observe_bg_yield(self) -> None:
        """Record the cleaner deferring to foreground work (cleaner thread)."""
        with self._bg_lock:
            self.bg_yields += 1

    def observe_latency(self, kind: str, seconds: float) -> None:
        """Record one end-to-end latency sample for a ticket class
        (``"query"`` / ``"ingest"`` from the serving thread,
        ``"bg-increment"`` from the cleaner thread).  Thread-safe."""
        hist = self.latency.get(kind)
        if hist is None:
            with self._bg_lock:
                hist = self.latency.setdefault(kind, LatencyHistogram())
        hist.observe(seconds)

    def observe_ledger(self, progress: Dict[str, Dict[str, int]]) -> None:
        """Store the latest per-scope ledger progress (strips done / total,
        cold rows — ``WorkLedger.progress()``, DESIGN.md §11).  Called by
        the cleaner after each increment and by the server at snapshot
        time; last writer wins, which is fine for a monotone gauge."""
        with self._bg_lock:
            self.ledger_progress = dict(progress)

    # -------------------------------------------------------------- derived
    @property
    def elapsed(self) -> float:
        """Wall-clock seconds since construction (monotone clock)."""
        return max(time.perf_counter() - self.started, 1e-9)

    @property
    def queries_per_sec(self) -> float:
        """Answered tickets per wall-clock second."""
        return self.queries / self.elapsed

    @property
    def hit_rate(self) -> float:
        """Fraction of answered tickets served from the cache."""
        return self.cache_hits / max(self.queries, 1)

    @property
    def detect_repair_per_query(self) -> float:
        """Foreground cleaning work amortized per answered query."""
        return (self.detect_calls + self.repair_calls) / max(self.queries, 1)

    @property
    def idle_fraction(self) -> float:
        """Share of elapsed wall-clock the step loop spent idle — the
        background cleaner's available budget."""
        return min(self.serving_idle_s / self.elapsed, 1.0)

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable counter snapshot with foreground/background
        attribution nested under ``foreground``/``background`` and
        per-ticket-class latency percentiles under ``latency``.

        The background section (``bg_*`` counters, ledger progress) is
        read under ``_bg_lock`` — the same lock every cleaner-thread
        observer writes under — so it is an exact point-in-time view, not
        a torn read racing a concurrent increment."""
        with self._bg_lock:
            background = {
                "increments": self.bg_increments,
                "detect_calls": self.bg_detect_calls,
                "repair_calls": self.bg_repair_calls,
                "scopes_completed": self.bg_scopes_completed,
                "yields": self.bg_yields,
                "busy_s": round(self.bg_busy_s, 6),
            }
            qos = {
                "shed": self.shed,
                "shed_stale": self.shed_stale,
                "shed_staleness_total": self.shed_staleness_total,
                "cancelled": self.cancelled,
                "deadline_misses": self.deadline_misses,
                "by_class": {k: dict(v) for k, v in self.by_class.items()},
            }
            shed = self.shed
            ledger = {k: dict(v) for k, v in self.ledger_progress.items()}
            latency = dict(self.latency)
        return {
            "queries": self.queries,
            # every admitted-or-shed ticket that got an answer: the serving
            # thread's count plus the submit-time sheds (DESIGN.md §14)
            "answered": self.queries + shed,
            # traffic shaping: sheds, cancels, deadline misses, per-class
            # counts (DESIGN.md §14)
            "qos": qos,
            "steps": self.steps,
            "executions": self.executions,
            "cache_hits": self.cache_hits,
            "batched": self.batched,
            "detect_calls": self.detect_calls,
            "repair_calls": self.repair_calls,
            "tiles_launched": self.tiles_launched,
            "tiles_skipped": self.tiles_skipped,
            "clean_steps": self.clean_steps,
            "skipped_steps": self.skipped_steps,
            "rejected": self.rejected,
            "errors": self.errors,
            "ingests": self.ingests,
            "ingested_rows": self.ingested_rows,
            "ingest_pending_deltas": self.ingest_pending_deltas,
            "elapsed_s": round(self.elapsed, 6),
            "queries_per_sec": round(self.queries_per_sec, 3),
            "hit_rate": round(self.hit_rate, 4),
            "detect_repair_per_query": round(self.detect_repair_per_query, 4),
            "idle_fraction": round(self.idle_fraction, 4),
            "foreground": {
                "detect_calls": self.detect_calls,
                "repair_calls": self.repair_calls,
            },
            "background": background,
            # per-scope warmup progress (strips done / total), so operators
            # and benchmarks report HOW warm each rule is, not only detect
            # counts (DESIGN.md §11)
            "ledger": ledger,
            # p50/p95/p99 per ticket class (query / ingest / bg-increment),
            # DESIGN.md §13
            "latency": {k: h.snapshot() for k, h in latency.items()},
            "recent_reports": list(self.recent_reports),
        }
