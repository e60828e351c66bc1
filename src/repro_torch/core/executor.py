"""Daisy executor in PyTorch: query processing woven with cleaning (§4-§6).

The counterpart of ``repro.core.executor`` for SP, group-by and join
queries.  ``Daisy.execute(query)`` runs the cleaning-aware plan:

1. the planner injects a cleaning step per overlapping rule (planner.py),
   on the base table and on every joined table;
2. an FD step relaxes the answer (``relax_fd``), detects violations over
   the correlated cluster with the sort-based group-by, merges the
   probabilistic repairs and flags the cluster checked;
3. a DC step scans its block worklist with the fused both-role pair scan
   (the CUDA kernel on the card), merges the range fixes and marks the scope;
4. the answer is recomputed with possible-world semantics: a mask for an SP
   query; for a join, the base join of the dirty qualifying parts plus the
   incremental join of the relaxation extras (Fig. 5), the Def. 3 (d)
   re-check of the stitched result, and group-by over its lineage.

Every FD/DC mode of the reference is here — incremental, full (pruned to
the cold part of the scope), strip and skipped — with the same cost
models, statistics and work ledger, so ``StepReport``s and scope versions
match the reference step by step.  So are the reference's other entry
points into the instance:

* ``ingest`` appends rows to a live table (DESIGN.md §12): the relation
  grows bit for bit, the ledger marks the fresh strips, and scopes that
  hold checked rows queue an ingest-delta that the next cleaning step of
  the scope drains (``_process_pending``: an O(checked x fresh) scan — for
  a DC, the pair scan over the checked rows' blocks x the fresh rows'
  col-block range);
* ``clean_scope_increment`` is one bounded background increment
  (DESIGN.md §10/§11): whole lhs groups up to ``max_rows`` for an FD, up
  to ``max_strips`` ledger strips x the whole table for a DC (the pair
  scan over those strips' row blocks);
* ``lock`` serializes them with ``execute`` for the query service.

With ``DaisyConfig(mesh=..., detect_shards=n)`` every FD and DC step whose
rule has an equality key detects over the key-routed shuffle
(DESIGN.md §8, ``repro_torch.dist.detect``): bit-identical results,
``StepReport.detect_path == "sharded"``, the routing kept in
``sharded_info`` and its observed cost fed to the rule's cost model.
Ingest deltas stay dense (a delta is small, and the sharded path has no
partner-side restriction).  The mesh is ``repro_torch.dist.hints.Mesh``
over the engine's own device: logical shards on one device.

All state lives on one device, the ``device`` the engine was built for
(``"cuda"`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import stats as statsmod
from repro_torch.core.constraints import DC, FD
from repro_torch.core.cost import CostModel, sharded_detect_cost
from repro_torch.core.detect import detect_auto, detect_fd
from repro_torch.core.ledger import TABLE_ROWS_RULE, WorkLedger
from repro_torch.core.operators import (
    GroupBySpec,
    JoinState,
    Query,
    _finalize_groupby,
    compact_order,
    dedupe_pairs,
    expected_value,
    filter_mask,
    groupby_agg,
    key_candidates,
    prob_equijoin,
)
from repro_torch.core.planner import (
    CleanStep,
    PlanInfo,
    plan_query,
    probe_step,
    strip_step,
)
from repro_torch.core.relax import relax_fd
from repro_torch.core.relation import Relation, append_rows, resolve_device
from repro_torch.core.repair import Candidates, dc_repair_candidates, fd_repair_candidates
from repro_torch.core.setops import group_distinct_candidates
from repro_torch.core.update import apply_candidates, mark_checked, unchecked
from repro_torch.obs.trace import NULL_TRACER


def _host(mask: torch.Tensor) -> np.ndarray:
    return mask.cpu().numpy()


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def _blocks_attr(blocks) -> Optional[List[int]]:
    """JSON-safe span annotation for a kernel block range ``[lo, hi)``."""
    if blocks is None:
        return None
    lo, hi = blocks
    return [int(lo), int(hi)]


@dataclasses.dataclass
class DaisyConfig:
    k: int = 8
    join_capacity: int = 8192
    join_row_block: int = 2048
    dc_partitions: int = 16
    dc_block: int = 256
    accuracy_threshold: float = 0.5
    expected_queries: int = 50
    use_cost_model: bool = True
    collect_stats: bool = True
    max_relax_iters: Optional[int] = None
    lemma1_fast_path: bool = False
    # sharded detection (DESIGN.md §8): with a mesh (dist.hints.Mesh over
    # the engine's device), equality-keyed rules detect over shuffle_by_key
    # in detect_shards logical shards (None -> the mesh's data extent)
    mesh: Optional[object] = None
    detect_shards: Optional[int] = None
    # work-ledger strip size: rows per partition strip (None -> dc_block),
    # rounded up to a whole number of detect tiles
    strip_rows: Optional[int] = None
    # let the DC detect planner scan exact narrower atom encodings
    kernel_encodings: bool = True


@dataclasses.dataclass
class StepReport:
    rule: str
    table: str
    mode: str  # incremental | full | strip | skipped | ingest-delta
    detect_path: str = "dense"
    answer_size: int = 0
    extra: int = 0
    repaired: int = 0
    detect_pairs: int = 0
    tiles_launched: int = 0
    tiles_skipped: int = 0
    relax_iterations: int = 0
    relax_converged: bool = True
    alg2_accuracy: float = 1.0
    alg2_support: float = 0.0

    def asdict(self) -> Dict[str, object]:
        """Plain-scalar dict (host ints/floats/strs/bools)."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ExecReport:
    steps: List[StepReport] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)
    result_size: int = 0
    recheck_violations: int = 0
    join_overflow: bool = False

    def asdict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DaisyResult:
    mask: Optional[torch.Tensor] = None  # SP result (mask over base table)
    join: Optional[JoinState] = None  # join lineage
    groups: Optional[Dict[str, torch.Tensor]] = None  # group-by output
    report: ExecReport = dataclasses.field(default_factory=ExecReport)


@dataclasses.dataclass
class IngestReport:
    """What one ``Daisy.ingest`` call did (DESIGN.md §12): where the rows
    landed, whether the relation grew, which strips went fresh, and which
    rule scopes queued an ingest-delta for their next cleaning step."""

    table: str
    rows: int  # appended row count
    start: int  # row index of the first appended row
    capacity_before: int
    capacity: int
    grown: bool
    fresh_strips: int  # strips (per rule scope, max over rules) marked fresh
    pending_rules: List[str] = dataclasses.field(default_factory=list)
    versions: Dict[str, int] = dataclasses.field(default_factory=dict)

    def asdict(self) -> Dict[str, object]:
        """Plain-scalar dict for service metrics / json."""
        return dataclasses.asdict(self)


class Daisy:
    """Query-driven cleaning engine on one torch device."""

    def __init__(
        self,
        db: Dict[str, Relation],
        rules: Dict[str, Sequence[FD | DC]],
        config: DaisyConfig | None = None,
        tracer=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        for table, rel in db.items():
            if rel.device.type != self.device.type:
                raise ValueError(
                    f"table {table!r} lives on {rel.device}, Daisy runs on {self.device}"
                )
        self.db = dict(db)
        self.rules = {t: list(rs) for t, rs in rules.items()}
        self.config = config or DaisyConfig()
        if self.config.mesh is not None:
            from repro_torch.dist.hints import holds

            if not holds(self.config.mesh, self.device):
                raise ValueError(
                    f"the detect mesh {self.config.mesh!r} does not hold the "
                    f"engine's device {self.device}"
                )
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.stats: Dict[Tuple[str, str], object] = {}
        self.cost: Dict[Tuple[str, str], CostModel] = {}
        self._clean_version = 0
        # the routing of the last sharded detect per rule (the background
        # cleaner's priority model reads it)
        self.sharded_info: Dict[Tuple[str, str], object] = {}
        self.detect_calls = 0
        self.repair_calls = 0
        self.detect_pairs = 0
        self.tiles_launched = 0
        self.tiles_skipped = 0
        self._lock = threading.RLock()
        self.ledger = WorkLedger(self.config.strip_rows, self.config.dc_block)
        if self.config.collect_stats:
            self._collect_stats()
        for table, rs in self.rules.items():
            for rule in rs:
                self.ledger.register(
                    table, rule.name, self.db[table].capacity,
                    _host(self.cold_rows(table, rule.name)),
                )

    @property
    def clean_version(self) -> int:
        """Monotone clean-state version, bumped on every commit."""
        return self._clean_version

    @property
    def lock(self) -> threading.RLock:
        """The executor's re-entrancy lock.  Callers that must read versioned
        state and act on it atomically with respect to a concurrent cleaner
        (the service's cache-lookup-or-execute, the background cleaner's
        increments) take it; ``execute`` and ``ingest`` re-acquire it."""
        return self._lock

    def scope_version(self, table: str, rule_name: str) -> int:
        """Monotone per-(table, rule) version, backed by the work ledger."""
        return self.ledger.version(table, rule_name)

    def scope_versions(self, deps: Sequence[Tuple[str, str]]) -> Tuple[int, ...]:
        """Version vector over a dependency list of (table, rule) pairs."""
        return self.ledger.versions(deps)

    def _apply(self, rel: Relation, deltas, table: str, rule_name: str) -> Relation:
        """``apply_candidates`` + version bumps."""
        self._clean_version += 1
        self.ledger.bump(table, rule_name)
        return apply_candidates(rel, deltas)

    def _mark(self, rel: Relation, table: str, rule_name: str, scope) -> Relation:
        """``mark_checked`` + version bump + ledger coverage refresh."""
        with self.tracer.span("clean.mark", rule=rule_name, table=table):
            self._clean_version += 1
            rel = mark_checked(rel, rule_name, scope)
            self.ledger.commit(
                table, rule_name, _host(self._cold_mask(rel, table, rule_name))
            )
            cm = self.cost.get((table, rule_name))
            if cm is not None:
                cm.observe_progress(self.ledger.scope(table, rule_name).cold_fraction)
        return rel

    # ------------------------------------------------------------ statistics
    def _collect_stats(self) -> None:
        """Precompute per-(table, rule) statistics (§5.2.3, §7/Fig 11)."""
        for table, rules in self.rules.items():
            rel = self.db[table]
            n = int(rel.num_rows())
            for rule in rules:
                key = (table, rule.name)
                if isinstance(rule, FD):
                    st = statsmod.fd_stats(rel, rule)
                    self.stats[key] = st
                    self.cost[key] = CostModel(
                        n=n, epsilon=st.epsilon, p=st.p_est, df=float(n),
                        expected_queries=self.config.expected_queries,
                    )
                else:
                    st = statsmod.dc_stats(rel, rule, p=self.config.dc_partitions)
                    self.stats[key] = st
                    self.cost[key] = CostModel(
                        n=n, epsilon=int(st.range_vio.sum()), p=2.0,
                        df=n * n / max(self.config.dc_partitions, 1),
                        expected_queries=self.config.expected_queries,
                    )

    def _refresh_stats(self, table: str) -> None:
        """Recompute one table's per-rule statistics after an append and
        fold the new instance size into the existing cost models in place
        (histories and the switched flag survive: an append changes the
        economics of future work, not what already happened)."""
        rel = self.db[table]
        n = int(rel.num_rows())
        for rule in self.rules.get(table, ()):
            key = (table, rule.name)
            cm = self.cost.get(key)
            if isinstance(rule, FD):
                st = statsmod.fd_stats(rel, rule)
                self.stats[key] = st
                if cm is not None:
                    cm.n, cm.df = n, float(n)
                    cm.epsilon, cm.p = st.epsilon, st.p_est
            else:
                st = statsmod.dc_stats(rel, rule, p=self.config.dc_partitions)
                self.stats[key] = st
                if cm is not None:
                    cm.n = n
                    cm.df = n * n / max(self.config.dc_partitions, 1)
                    cm.epsilon = int(st.range_vio.sum())

    # ---------------------------------------------------------------- ingest
    def ingest(self, table: str, rows: Mapping[str, np.ndarray]) -> IngestReport:
        """Append host rows into a live table (DESIGN.md §12).

        Under ``lock``, in order: the rows land in the relation's spare
        capacity (growing to ``next_pow2`` when full; every existing array
        is kept bit for bit); the table's statistics and cost models
        refresh; and each rule scope's ledger extends, the fresh rows'
        strips reading as cold and fresh, no checked state invalidated.
        Scopes that already hold checked rows queue a ``PendingIngest``:
        the next cleaning step of the scope (foreground or background)
        gives those rows the fresh partners' evidence in O(new x all) work
        (``_process_pending``).  Only the table's ``TABLE_ROWS_RULE``
        version bumps here, so every cached answer over this table goes
        stale exactly once."""
        with self._lock, self.tracer.span("daisy.ingest", table=table) as sp:
            report = self._ingest_locked(table, rows)
            sp.set(rows=report.rows, grown=report.grown)
            return report

    def _ingest_locked(self, table: str, rows: Mapping[str, np.ndarray]) -> IngestReport:
        if table not in self.db:
            raise KeyError(f"unknown table {table!r}")
        rel = self.db[table]
        cap_before = rel.capacity
        # per-rule ingest-delta inputs BEFORE the append: which rows are
        # checked, and (FDs) which rows were statically dirty
        had_checked: Dict[str, np.ndarray] = {}
        old_dirty: Dict[str, np.ndarray] = {}
        for rule in self.rules.get(table, ()):
            ch = rel.checked.get(rule.name)
            if ch is None:
                continue
            ch_np = _host(ch)
            if ch_np.any():
                had_checked[rule.name] = ch_np
                if isinstance(rule, FD):
                    st = self.stats.get((table, rule.name))
                    dirty = (
                        st.dirty_row if st is not None
                        else statsmod.fd_stats(rel, rule).dirty_row
                    )
                    old_dirty[rule.name] = np.asarray(dirty, dtype=bool)
        new_rel, start = append_rows(rel, rows)
        n_new = int(new_rel.valid.sum()) - start
        report = IngestReport(
            table=table, rows=n_new, start=start,
            capacity_before=cap_before, capacity=new_rel.capacity,
            grown=new_rel.capacity != cap_before, fresh_strips=0,
        )
        if n_new == 0:
            return report
        self.db[table] = new_rel
        hi = start + n_new
        if self.config.collect_stats:
            self._refresh_stats(table)
        cap = new_rel.capacity
        for rule in self.rules.get(table, ()):
            checked = had_checked.get(rule.name)
            od = old_dirty.get(rule.name)
            if checked is not None and checked.shape[0] < cap:
                checked = np.pad(checked, (0, cap - checked.shape[0]))
            if od is not None and od.shape[0] < cap:
                od = np.pad(od, (0, cap - od.shape[0]))
            cold = _host(self._cold_mask(new_rel, table, rule.name))
            scope = self.ledger.record_ingest(
                table, rule.name, cap, cold, start, hi, checked=checked, old_dirty=od,
            )
            report.fresh_strips = max(report.fresh_strips, len(scope.fresh))
            if scope.pending:
                report.pending_rules.append(rule.name)
            cm = self.cost.get((table, rule.name))
            if cm is not None:
                cm.observe_progress(scope.cold_fraction)
        self.ledger.bump(table, TABLE_ROWS_RULE)
        report.versions = {
            rule.name: self.ledger.version(table, rule.name)
            for rule in self.rules.get(table, ())
        }
        report.versions[TABLE_ROWS_RULE] = self.ledger.version(table, TABLE_ROWS_RULE)
        return report

    def _want_full(self) -> Dict[Tuple[str, str], bool]:
        if not self.config.use_cost_model:
            return {}
        return {key: cm.should_switch_to_full() for key, cm in self.cost.items()}

    # ----------------------------------------------- ledger and increments
    def _detect_mesh(self, step: CleanStep):
        """The mesh to detect on for this step: the configured mesh when the
        planner marked the rule shardable, else None (dense scan)."""
        return self.config.mesh if step.shardable else None

    def _rule_named(self, table: str, rule_name: str):
        for rule in self.rules.get(table, ()):
            if rule.name == rule_name:
                return rule
        raise KeyError(f"no rule {rule_name!r} on table {table!r}")

    def _cold_mask(self, rel: Relation, table: str, rule_name: str) -> torch.Tensor:
        """Cold rows for a rule: unchecked rows, intersected for FDs with the
        statically-known dirty groups."""
        rule = self._rule_named(table, rule_name)
        cold = unchecked(rel, rule_name)
        st = self.stats.get((table, rule_name))
        if isinstance(rule, FD) and st is not None:
            cold = cold & torch.from_numpy(st.dirty_row).to(cold.device)
        return cold

    def cold_rows(self, table: str, rule_name: str) -> torch.Tensor:
        """Rows a first-touch foreground query would still pay detect work
        for.  Read under ``lock`` if a cleaner may be committing."""
        return self._cold_mask(self.db[table], table, rule_name)

    def cold_count(self, table: str, rule_name: str) -> int:
        """Host count of ``cold_rows``, read from the ledger (no device
        sync).  A scope the ledger has never sized (a rule appended to a
        live Daisy) is registered from the real cold mask on first read."""
        scope = self.ledger.scope(table, rule_name)
        cap = self.db[table].capacity
        if scope is None or scope.capacity < cap:
            scope = self.ledger.register(
                table, rule_name, cap, _host(self.cold_rows(table, rule_name)),
            )
        return scope.cold_count

    def _fd_increment_seed(
        self,
        rel: Relation,
        fd: FD,
        cold: torch.Tensor,
        max_rows: Optional[int],
        prefer: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """Whole-lhs-group seed mask for one FD increment: the first
        (ascending group id) cold groups whose valid rows total at least
        ``max_rows`` (always >= 1 group; every cold group for None).  Groups
        are taken whole: candidates are per-group evidence.  ``prefer``
        front-loads groups meeting that host mask (the freshly ingested
        strips).  Host numpy, as the reference."""
        valid = _host(rel.valid)
        cold_np = _host(cold)
        gid = np.zeros(valid.shape[0], dtype=np.int64)
        for attr in fd.lhs:
            _, inv = np.unique(_host(rel.columns[attr]), return_inverse=True)
            gid = gid * (int(inv.max()) + 1) + inv
        # densify the combined key so per-group sizes are one bincount pass
        _, gid = np.unique(gid, return_inverse=True)
        cold_groups = np.unique(gid[cold_np])
        if prefer is not None:
            pref = np.unique(gid[prefer & cold_np])
            rest = cold_groups[~np.isin(cold_groups, pref)]
            cold_groups = np.concatenate([pref, rest])
        if max_rows is not None:
            sizes = np.bincount(gid[valid], minlength=int(gid.max()) + 1)
            cum = np.cumsum(sizes[cold_groups])
            cut = int(np.searchsorted(cum, max_rows)) + 1
            cold_groups = cold_groups[:cut]
        return torch.from_numpy(valid & np.isin(gid, cold_groups)).to(rel.device)

    def clean_scope_increment(
        self,
        table: str,
        rule_name: str,
        max_rows: Optional[int] = None,
        max_strips: Optional[int] = None,
    ) -> Optional[StepReport]:
        """One preemptible background-cleaning increment for a rule scope
        (DESIGN.md §10/§11); its ``StepReport``, or ``None`` when the scope
        is already warm.

        Runs under ``lock`` and commits through the foreground path, so it
        bumps the ledger versions exactly as a query would.  An FD cleans up
        to ``max_rows`` cold rows, seeded on whole lhs groups and run through
        the incremental pipeline (relax, detect, repair, mark); a DC cleans
        up to ``max_strips`` ledger strips (``None``: every cold strip, the
        remaining full clean) x the whole table through the pair scan's row
        worklist.  Queued ingest-deltas drain first; a scope with nothing
        cold but a delta reports the delta.  Cost-model histories are not
        touched (``record_cost=False``)."""
        with self._lock:
            rule = self._rule_named(table, rule_name)
            report = ExecReport()
            pending_rep = self._process_pending(table, rule, report)
            rel = self.db[table]
            cold = self.cold_rows(table, rule_name)
            if not bool(cold.any()):
                return pending_rep
            if isinstance(rule, FD):
                scope_l = self.ledger.scope(table, rule_name)
                prefer = None
                if scope_l is not None and scope_l.fresh:
                    prefer = scope_l.strip_mask(sorted(scope_l.fresh))
                seed = self._fd_increment_seed(rel, rule, cold, max_rows, prefer=prefer)
                self._clean_fd(
                    probe_step(table, rule), report,
                    answer_override=seed, record_cost=False,
                )
            else:
                # register-and-refresh from the cold mask just computed, so a
                # rule appended to a live Daisy hands over its real strips
                scope = self.ledger.register(table, rule_name, rel.capacity, _host(cold))
                strips = scope.cold_strips(fresh_first=True)
                if max_strips is not None:
                    strips = strips[: max(int(max_strips), 1)]
                self._clean_dc(strip_step(table, rule, strips), report, record_cost=False)
            return report.steps[-1] if report.steps else None

    # -------------------------------------------------------- ingest deltas
    def _process_pending(
        self, table: str, rule, report: Optional[ExecReport] = None
    ) -> Optional[StepReport]:
        """Drain a scope's queued ingest-deltas (DESIGN.md §12): for every
        append since the scope's last cleaning step, give the rows that were
        checked at append time the evidence the fresh rows owe them, an
        O(checked x fresh) scan.  Runs at the top of every cleaning path,
        before any skip gate.  No rows are marked: the fresh rows stay cold
        until their own first clean."""
        pendings = self.ledger.take_pending(table, rule.name)
        if not pendings:
            return None
        rep = StepReport(rule.name, table, "ingest-delta")
        with self.tracer.span(
            "clean.ingest_delta", rule=rule.name, table=table, deltas=len(pendings),
        ) as sp:
            if isinstance(rule, FD):
                self._ingest_delta_fd(table, rule, pendings, rep)
            else:
                self._ingest_delta_dc(table, rule, pendings, rep)
            sp.set(pairs=rep.detect_pairs)
        if report is not None:
            report.steps.append(rep)
        return rep

    def _pending_masks(self, ent, cap: int):
        """Host (checked at append time, fresh rows) masks of one pending
        ingest at the relation's current capacity."""
        pos = np.arange(cap)
        checked = np.zeros(cap, dtype=bool)
        c = np.asarray(ent.checked, dtype=bool)
        checked[: min(c.shape[0], cap)] = c[:cap]
        return checked, (pos >= ent.lo) & (pos < ent.hi)

    def _ingest_delta_fd(self, table: str, fd: FD, pendings, rep: StepReport) -> None:
        """FD ingest-delta: re-derive candidate evidence for checked rows
        whose lhs group gained fresh members, append by append against the
        instance each one saw (rows below its ``hi``).  Over the relaxation
        closure of the fresh rows' groups, checked rows that were dirty at
        append time get the fresh-weighted counts (fresh members weigh 1,
        old ones 0: by Lemma 4 the sum equals one merge over the whole
        group); checked rows that were clean then and are violated now get
        the full group counts, their first evidence merge."""
        k = self.config.k
        for ent in pendings:
            rel = self.db[table]
            dev = rel.device
            cap = rel.capacity
            checked_np, fresh_np = self._pending_masks(ent, cap)
            dirty = np.zeros(cap, dtype=bool)
            if ent.old_dirty is not None:
                d = np.asarray(ent.old_dirty, dtype=bool)
                dirty[: min(d.shape[0], cap)] = d[:cap]
            fresh = torch.from_numpy(fresh_np).to(dev)
            below = torch.from_numpy(np.arange(cap) < ent.hi).to(dev)
            rel_hi = dataclasses.replace(rel, valid=rel.valid & below)
            seed = fresh & rel_hi.valid
            if not bool(seed.any()):
                continue
            self.detect_calls += 1
            res = relax_fd(
                rel_hi, seed, fd, max_iters=self.config.max_relax_iters, use_rhs=True,
            )
            scope = (seed | res.extra) & rel_hi.valid
            scope_n = _count(scope)
            rep.answer_size += _count(seed)
            rep.extra += _count(res.extra)
            rep.detect_pairs += scope_n  # group-by is O(scope)
            self.detect_pairs += scope_n
            lhs_cols = [rel.columns[a] for a in fd.lhs]
            rhs_col = rel.columns[fd.rhs]
            wt = fresh.to(torch.float32)
            full_v, full_n, violated, _ = group_distinct_candidates(
                lhs_cols, rhs_col, scope, k
            )
            fresh_v, fresh_n, _, _ = group_distinct_candidates(
                lhs_cols, rhs_col, scope, k, weight=wt
            )
            lhs_single = len(fd.lhs) == 1
            if lhs_single:
                lfull_v, lfull_n, _, _ = group_distinct_candidates(
                    [rhs_col], lhs_cols[0], scope, k
                )
                lfresh_v, lfresh_n, _, _ = group_distinct_candidates(
                    [rhs_col], lhs_cols[0], scope, k, weight=wt
                )
            checked = torch.from_numpy(checked_np).to(dev)
            dirty_t = torch.from_numpy(dirty).to(dev)
            t_fresh = checked & violated & dirty_t & scope
            t_full = checked & violated & ~dirty_t & scope
            kinds = torch.zeros(full_v.shape, dtype=torch.int8, device=dev)
            deltas = []
            for rows_mask, rv, rn, lv, ln in (
                (t_fresh, fresh_v, fresh_n,
                 *((lfresh_v, lfresh_n) if lhs_single else (None, None))),
                (t_full, full_v, full_n,
                 *((lfull_v, lfull_n) if lhs_single else (None, None))),
            ):
                if not bool(rows_mask.any()):
                    continue
                deltas.append((fd.rhs, Candidates(rv, rn, kinds, rows_mask)))
                if lv is not None:
                    deltas.append((fd.lhs[0], Candidates(lv, ln, kinds, rows_mask)))
            if deltas:
                self.repair_calls += 1
                rep.repaired += _count(t_fresh | t_full)
                self.db[table] = self._apply(rel, deltas, table, fd.name)

    def _ingest_delta_dc(self, table: str, dc: DC, pendings, rep: StepReport) -> None:
        """DC ingest-delta: one [checked x fresh] matrix strip per append,
        the pair scan over the checked rows' blocks x the fresh rows'
        col-block range ``[lo // block, ceil(hi / block))``.  The first col
        block holds old rows too when the append starts mid-block; the col
        scope (the fresh rows) masks them out.  The fresh rows stay cold:
        their own [fresh x all] evidence comes with their first clean."""
        block = self.config.dc_block
        cm = self.cost.get((table, dc.name))
        for ent in pendings:
            rel = self.db[table]
            dev = rel.device
            checked_np, fresh_np = self._pending_masks(ent, rel.capacity)
            fresh = torch.from_numpy(fresh_np).to(dev)
            row_scope = torch.from_numpy(checked_np).to(dev) & rel.valid
            if not bool(row_scope.any()):
                continue
            row_block_ids = self._active_blocks(row_scope)
            col_blocks = (ent.lo // block, -(-ent.hi // block))
            rep.answer_size += _count(fresh & rel.valid)
            # dense scan only: the sharded path has no partner-side
            # restriction, and a delta is small by construction
            rel, det = self._dc_detect_repair(
                rel, dc, row_scope, fresh, None, cm, rep,
                col_blocks=col_blocks, row_block_ids=row_block_ids,
            )
            rep.repaired += _count(((det.t1_count > 0) | (det.t2_count > 0)) & row_scope)
            self.db[table] = rel

    # ------------------------------------------------------------- FD steps
    def _clean_fd(
        self,
        step: CleanStep,
        report: ExecReport,
        answer_override: Optional[torch.Tensor] = None,
        record_cost: bool = True,
    ) -> None:
        """One FD cleaning step (see the reference's ``Daisy._clean_fd``).
        ``answer_override`` stands in for the predicate filter (a background
        increment's cold groups); ``record_cost=False`` keeps background
        work out of the cost-model history."""
        table, fd = step.table, step.rule
        self._process_pending(table, fd, report)
        rel = self.db[table]
        cm = self.cost.get((table, fd.name)) if record_cost else None
        st = self.stats.get((table, fd.name))
        rep = StepReport(fd.name, table, step.mode)

        mark_scope = None
        if step.mode == "full":
            # detect only lhs groups still holding cold rows, taken whole;
            # the mark still covers the whole relation
            cold = self._cold_mask(rel, table, fd.name)
            if bool(cold.any()):
                scope = self._fd_increment_seed(rel, fd, cold, None)
            else:
                scope = rel.valid
            mark_scope = rel.valid
            rep.answer_size = _count(scope)
        else:
            answer = (
                answer_override if answer_override is not None
                else filter_mask(rel, step.preds)
            )
            rep.answer_size = _count(answer)
            # Fig. 11 skip: answer touches no dirty group and nothing unchecked
            if st is not None:
                dirty = torch.from_numpy(st.dirty_row).to(answer.device)
                if not bool((answer & dirty & unchecked(rel, fd.name)).any()):
                    rep.mode = "skipped"
                    report.steps.append(rep)
                    if cm:
                        cm.record(rep.answer_size, 0, 0.0, 0)
                    return
            with self.tracer.span("clean.relax", rule=fd.name, table=table) as sp:
                res = relax_fd(
                    rel, answer, fd,
                    max_iters=self.config.max_relax_iters, use_rhs=step.use_rhs,
                )
                scope = answer | res.extra
                rep.extra = _count(res.extra)
                rep.relax_iterations = res.iterations
                rep.relax_converged = res.converged
                sp.set(extra=rep.extra, iterations=rep.relax_iterations)

        repair_scope = scope & unchecked(rel, fd.name)
        if not bool(repair_scope.any()):
            rep.mode = "skipped"
            report.steps.append(rep)
            if cm:
                cm.record(rep.answer_size, rep.extra, 0.0, 0)
            return
        mesh = self._detect_mesh(step)
        self.detect_calls += 1
        rep.detect_pairs = _count(scope)  # group-by is O(scope)
        self.detect_pairs += rep.detect_pairs
        with self.tracer.span(
            "clean.detect", rule=fd.name, table=table, mode=rep.mode,
            pairs=rep.detect_pairs,
        ) as sp:
            det, sinfo = detect_auto(
                rel, fd, scope, k=self.config.k,
                mesh=mesh, n_shards=self.config.detect_shards,
                strip_rows=self.ledger.strip_rows, tracer=self.tracer,
            )
            if sinfo is not None:
                rep.detect_path = "sharded"
                self._observe_sharded(table, fd.name, sinfo, cm)
            sp.set(path=rep.detect_path)
        self.repair_calls += 1
        with self.tracer.span("clean.repair", rule=fd.name, table=table) as sp:
            deltas = fd_repair_candidates(rel, fd, det, repair_scope)
            rep.repaired = _count(det.violated & repair_scope)
            rel = self._apply(rel, deltas, table, fd.name)
            sp.set(repaired=rep.repaired)
        rel = self._mark(
            rel, table, fd.name, scope if mark_scope is None else mark_scope
        )
        self.db[table] = rel
        if cm:
            cm.record(rep.answer_size, rep.extra, float(rep.detect_pairs), rep.repaired)
            if step.mode == "full":
                cm.mark_switched()
        report.steps.append(rep)

    def _observe_sharded(self, table: str, rule_name: str, info, cm) -> None:
        """Record a sharded routing's ``ShardedDetectInfo`` and feed its
        observed cost to the rule's cost model, so the full/partial decision
        and the background priority model (DESIGN.md §10) price the path
        the executor takes."""
        self.sharded_info[(table, rule_name)] = info
        if cm is not None:
            cm.observe_detect_cost(sharded_detect_cost(info, n_rows=cm.n))

    # ------------------------------------------------------------- DC steps
    def _dc_detect_repair(self, rel, dc, row_scope, col_scope, mesh, cm, rep,
                          col_blocks=None, row_block_ids=None, col_block_ids=None):
        """One detect + repair-candidate pass of the DC increment engine:
        the pair scan over ``row_scope x col_scope`` on the block worklist
        (``row_block_ids`` / ``col_block_ids``, or the col-block range
        ``col_blocks`` of an ingest delta) or, with a ``mesh``, over the
        key-routed shards; the role fixes merged for the ``row_scope``
        rows; accounts the scanned comparison space and the launch
        geometry.  Returns ``(rel, detect_result)``."""
        table = rep.table
        self.detect_calls += 1
        rows = _count(row_scope & rel.valid)
        cols = _count(col_scope & rel.valid)
        rep.detect_pairs += rows * cols
        self.detect_pairs += rows * cols
        with self.tracer.span(
            "clean.detect", rule=dc.name, table=table, mode=rep.mode,
            pairs=rows * cols, row_blocks=None, col_blocks=_blocks_attr(col_blocks),
            row_block_ids=None if row_block_ids is None else len(row_block_ids),
            col_block_ids=None if col_block_ids is None else len(col_block_ids),
        ) as sp:
            det, sinfo = detect_auto(
                rel, dc, row_scope, col_scope, block=self.config.dc_block,
                mesh=mesh, n_shards=self.config.detect_shards,
                col_blocks=col_blocks,
                row_block_ids=row_block_ids, col_block_ids=col_block_ids,
                strip_rows=self.ledger.strip_rows, tracer=self.tracer,
                encode=self.config.kernel_encodings,
            )
            if sinfo is not None:
                rep.detect_path = "sharded"
                self._observe_sharded(table, dc.name, sinfo, cm)
            launched = int(det.tiles_launched)
            skipped = max(int(det.tiles_total) - launched, 0)
            rep.tiles_launched += launched
            rep.tiles_skipped += skipped
            self.tiles_launched += launched
            self.tiles_skipped += skipped
            scope = self.ledger.scope(table, dc.name)
            if scope is not None:
                scope.note_tiles(launched, skipped)
            if cm is not None and rep.mode == "full" and det.tiles_total:
                cm.observe_tile_sparsity(launched / det.tiles_total)
            sp.set(path=rep.detect_path, tiles_launched=launched, tiles_skipped=skipped)
        self.repair_calls += 1
        with self.tracer.span("clean.repair", rule=dc.name, table=table):
            deltas = dc_repair_candidates(rel, dc, det, row_scope, k=self.config.k)
            rel = self._apply(rel, deltas, table, dc.name)
        return rel, det

    def _active_blocks(self, mask) -> Optional[np.ndarray]:
        """Exact kernel-grid block ids holding the mask's nonzero rows (None
        for an empty mask)."""
        idx = np.flatnonzero(_host(mask))
        if idx.size == 0:
            return None
        return np.unique(idx // self.config.dc_block).astype(np.int32)

    def _clean_dc(
        self, step: CleanStep, report: ExecReport, record_cost: bool = True
    ) -> None:
        """One DC cleaning step through the strip-grained increment engine
        (DESIGN.md §11).  Modes, as the reference's:

        * ``auto`` — Algorithm 2 resolves full vs incremental, its support
          input the ledger's strip coverage;
        * ``incremental`` — the answer's matrix strip [answer x rest] plus
          the partner strip [rest x answer] (§4.2);
        * ``full`` — the remaining cold strips x the whole table;
        * ``strip`` — an explicit cold-strip subset (``step.strips``), the
          background cleaner's bounded increment; a sweep that covers every
          cold strip is the remaining full clean and reports ``full``.

        ``record_cost=False`` keeps background work out of the cost-model
        history (a scope-completing sweep still marks the rule switched)."""
        table, dc = step.table, step.rule
        self._process_pending(table, dc, report)
        rel = self.db[table]
        key = (table, dc.name)
        cm = self.cost.get(key)
        st: statsmod.DCStats = self.stats.get(key)
        scope_ledger = self.ledger.register(table, dc.name, rel.capacity)
        rep = StepReport(dc.name, table, step.mode)

        answer = filter_mask(rel, step.preds) if step.preds else rel.valid
        mode = step.mode
        if mode == "auto" and st is not None:
            answer_size = _count(answer)
            pivot_vals = _host(rel.columns[st.pivot])[_host(answer)]
            dec = statsmod.algorithm2_decide(
                st, pivot_vals, answer_size, scope_ledger.support,
                self.config.accuracy_threshold,
            )
            rep.alg2_accuracy = dec.accuracy
            rep.alg2_support = dec.support
            mode = "full" if dec.full_clean else "incremental"
        elif mode == "auto":
            mode = "incremental"

        live = unchecked(rel, dc.name)
        cold_ids = scope_ledger.cold_strips()
        cold_frac = scope_ledger.cold_fraction
        row_block_ids = None
        if mode == "incremental":
            row_scope = answer & live
        else:
            sel = cold_ids
            if step.strips is not None:
                # drop strips that raced warm since the step was planned
                sel = np.intersect1d(np.asarray(step.strips, dtype=np.int64), cold_ids)
            if mode == "strip" and len(sel) < len(cold_ids):
                rep.mode = "strip"
            else:
                mode = "full"  # covers every cold strip == remaining full clean
            if len(sel):
                row_scope = (
                    torch.from_numpy(scope_ledger.strip_mask(sel)).to(live.device) & live
                )
                # the exact cold-strip block ids: warm strips never launch
                row_block_ids = scope_ledger.strip_block_ids(sel, self.config.dc_block)
            else:
                row_scope = torch.zeros_like(rel.valid)
        rep.mode = mode if mode != "strip" else rep.mode
        rep.answer_size = _count(row_scope if mode == "strip" else answer)

        # idempotence gate: everything this step would scope is checked
        if not bool(row_scope.any()):
            rep.mode = "skipped"
            report.steps.append(rep)
            if cm and record_cost:
                cm.record(rep.answer_size, 0, 0.0, 0)
            return

        mesh = self._detect_mesh(step)
        col_scope = rel.valid
        if mode == "incremental":
            row_block_ids = self._active_blocks(row_scope)
        rel, det = self._dc_detect_repair(
            rel, dc, row_scope, col_scope, mesh, cm, rep, row_block_ids=row_block_ids,
        )
        repaired = (det.t1_count > 0) | (det.t2_count > 0)
        rep.repaired = _count(repaired & row_scope)

        if mode == "incremental":
            # partners of the answer get their role fixes too: the matrix
            # strip [rest x answer], restricted to the answer's active blocks
            partner_scope = rel.valid & ~answer
            rel, det2 = self._dc_detect_repair(
                rel, dc, partner_scope, answer, mesh, cm, rep,
                row_block_ids=self._active_blocks(partner_scope),
                col_block_ids=self._active_blocks(answer),
            )
            rep.extra = _count(
                ((det2.t1_count > 0) | (det2.t2_count > 0)) & partner_scope
            )

        rel = self._mark(rel, table, dc.name, row_scope)
        self.db[table] = rel
        if cm and record_cost:
            n = cm.n
            d_i = (
                float(rep.answer_size) * n / max(self.config.dc_partitions, 1)
                if mode == "incremental"
                else cm.df_effective * cold_frac
            )
            cm.record(rep.answer_size, rep.extra, d_i, rep.repaired)
        if cm and rep.mode == "full":
            cm.mark_switched()
        report.steps.append(rep)

    # ------------------------------------------------------------ execution
    def _run_steps(self, plan: PlanInfo, report: ExecReport) -> None:
        for step in plan.steps:
            if isinstance(step.rule, FD):
                self._clean_fd(step, report)
            else:
                self._clean_dc(step, report)

    def execute(self, query: Query) -> DaisyResult:
        """Clean what the query touches, then answer it."""
        with self._lock, self.tracer.span(
            "daisy.execute", table=query.table, joins=len(query.joins)
        ) as sp:
            plan = plan_query(
                query, self.rules, self._want_full(),
                lemma1_fast_path=self.config.lemma1_fast_path,
                ledger=self.ledger,
            )
            report = ExecReport(notes=list(plan.notes))
            if not query.joins:
                result = self._execute_sp(query, plan, report)
            else:
                result = self._execute_join(query, plan, report)
            sp.set(steps=len(report.steps), result_size=report.result_size)
            return result

    # ----------------------------------------------------------- SP queries
    def _execute_sp(self, query: Query, plan: PlanInfo, report: ExecReport) -> DaisyResult:
        self._run_steps(plan, report)
        rel = self.db[query.table]
        mask = filter_mask(rel, query.preds)
        report.result_size = _count(mask)
        result = DaisyResult(mask=mask, report=report)
        if query.groupby is not None:
            result.groups = groupby_agg(rel, mask, query.groupby)
        return result

    # --------------------------------------------------------- join queries
    def _join_masks(self, query: Query) -> Dict[str, torch.Tensor]:
        masks = {query.table: filter_mask(self.db[query.table], query.preds)}
        for j in query.joins:
            masks[j.right] = filter_mask(self.db[j.right], j.right_preds)
        return masks

    def _execute_join(self, query: Query, plan: PlanInfo, report: ExecReport) -> DaisyResult:
        pre_masks = self._join_masks(query)  # the dirty base join inputs
        self._run_steps(plan, report)  # clean each side's qualifying part
        post_masks = self._join_masks(query)
        state: Optional[JoinState] = None
        for j in query.joins:
            state = self._join_once(query, state, j, pre_masks, post_masks, report)
        report.result_size = _count(state.valid)
        report.recheck_violations = self._recheck(state)
        result = DaisyResult(join=state, report=report)
        if query.groupby is not None:
            result.groups = self._groupby_join(state, query.groupby)
        return result

    def _key_source(self, state: Optional[JoinState], base: str, col: str) -> str:
        """Which table provides ``col`` for the current join state."""
        tables = [base] if state is None else list(state.tables)
        for t in tables:
            if col in self.db[t].columns:
                return t
        raise KeyError(f"join key {col!r} not found among {tables}")

    def _join_once(self, query, state, j, pre_masks, post_masks, report) -> JoinState:
        cfg = self.config
        left_table = self._key_source(state, query.table, j.left_on)
        rel_l = self.db[left_table]
        rel_r = self.db[j.right]
        kv_l, al_l = key_candidates(rel_l, j.left_on)
        kv_r, al_r = key_candidates(rel_r, j.right_on)

        def join(l_vals, l_alive, mask_l, mask_r):
            return prob_equijoin(l_vals, l_alive, mask_l, kv_r, al_r, mask_r,
                                 cfg.join_capacity, cfg.join_row_block)

        if state is None:
            pre_l, post_l = pre_masks[query.table], post_masks[query.table]
            pre_r, post_r = pre_masks[j.right], post_masks[j.right]
            # base join on the dirty qualifying parts, then the incremental
            # join of the relaxation extras (Fig. 5): extras_l x post_r and
            # pre_l x extras_r
            parts = [
                join(kv_l, al_l, pre_l, pre_r),
                join(kv_l, al_l, post_l & ~pre_l, post_r),
                join(kv_l, al_l, pre_l, post_r & ~pre_r),
            ]
            li, ri, v = (torch.cat([p[i] for p in parts]) for i in range(3))
            v = dedupe_pairs(li, ri, v)
            order = compact_order(v, cfg.join_capacity)
            li, ri, v = li[order], ri[order], v[order]
            overflow = parts[0][3] | parts[1][3] | parts[2][3]
            report.join_overflow = bool(overflow)
            return JoinState(
                tables=(left_table, j.right),
                rows={left_table: li, j.right: ri},
                valid=v,
                overflow=overflow,
            )

        # chained join: gather the current result's key candidates (the
        # reference's gather clamps the out-of-range ids of free slots)
        rows_l = state.rows[left_table].long().clamp(max=rel_l.capacity - 1)
        kv_res = kv_l[rows_l]
        al_res = al_l[rows_l] & state.valid[:, None]
        post_r = post_masks.get(j.right, rel_r.valid)
        li, ri, v, ovf = join(kv_res, al_res, state.valid, post_r)
        v = dedupe_pairs(li, ri, v)
        new_rows = {
            t: torch.where(v, r[li.long().clamp(max=r.shape[0] - 1)], r.shape[0])
            for t, r in state.rows.items()
        }
        new_rows[j.right] = torch.where(v, ri, rel_r.capacity)
        report.join_overflow = report.join_overflow or bool(ovf)
        return JoinState(
            tables=state.tables + (j.right,),
            rows=new_rows,
            valid=v,
            overflow=state.overflow | ovf,
        )

    def _recheck(self, state: JoinState) -> int:
        """Def. 3 (d): re-check the stitched join result for violations.
        Lemma 5 predicts zero NEW violations among unchecked rows."""
        total = 0
        for table in state.tables:
            rel = self.db[table]
            rows = state.rows[table][state.valid].long()
            used = torch.zeros_like(rel.valid)
            used[rows[rows < rel.capacity]] = True
            for rule in self.rules.get(table, ()):
                if isinstance(rule, FD):
                    self.detect_calls += 1
                    det = detect_fd(rel, rule, used & rel.valid, k=self.config.k)
                    total += _count(det.violated & unchecked(rel, rule.name))
        return total

    def _groupby_join(self, state: JoinState, spec: GroupBySpec):
        """Group-by over join lineage: gather key/value columns, aggregate
        with expected-value semantics."""
        table = spec.table or self._key_source(state, state.tables[0], spec.keys[0])
        rel = self.db[table]
        safe = state.rows[table].long().clamp(max=rel.capacity - 1)
        keys = [rel.columns[a][safe] for a in spec.keys]
        w = state.valid.to(torch.float32)
        if spec.value:
            vt = spec.table or self._key_source(state, state.tables[0], spec.value)
            vrel = self.db[vt]
            vrows = state.rows[vt].long().clamp(max=vrel.capacity - 1)
            v = expected_value(vrel, spec.value)[vrows]
        else:
            v = torch.zeros_like(w)
        return _finalize_groupby(spec, keys, state.valid, w, v)
