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

Every FD/DC mode that the reference's ``execute`` reaches is here —
incremental, full (pruned to the cold part of the scope) and skipped —
with the same cost models, statistics and work ledger, so ``StepReport``s
and scope versions match the reference query by query.  The strip mode,
which only the reference's background increments plan, waits with them.
Streaming ingest, background increments and sharded detection wait for
later slices: a config with a ``mesh`` raises ``NotImplementedError``.

All state lives on one device, the ``device`` the engine was built for
(``"cuda"`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import stats as statsmod
from repro_torch.core.constraints import DC, FD
from repro_torch.core.cost import CostModel
from repro_torch.core.detect import detect_auto, detect_fd
from repro_torch.core.ledger import WorkLedger
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
from repro_torch.core.planner import CleanStep, PlanInfo, plan_query
from repro_torch.core.relax import relax_fd
from repro_torch.core.relation import Relation, resolve_device
from repro_torch.core.repair import dc_repair_candidates, fd_repair_candidates
from repro_torch.core.update import apply_candidates, mark_checked, unchecked
from repro_torch.obs.trace import NULL_TRACER


def _host(mask: torch.Tensor) -> np.ndarray:
    return mask.cpu().numpy()


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


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
    # sharded detection; not ported yet, so a mesh raises
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
    mode: str  # incremental | full | skipped
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
            raise NotImplementedError("sharded detection is not ported yet")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.stats: Dict[Tuple[str, str], object] = {}
        self.cost: Dict[Tuple[str, str], CostModel] = {}
        self._clean_version = 0
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

    def _want_full(self) -> Dict[Tuple[str, str], bool]:
        if not self.config.use_cost_model:
            return {}
        return {key: cm.should_switch_to_full() for key, cm in self.cost.items()}

    # -------------------------------------------------------------- ledger
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
        """Rows a first-touch foreground query would still pay detect work for."""
        return self._cold_mask(self.db[table], table, rule_name)

    def _cold_groups(self, rel: Relation, fd: FD, cold: torch.Tensor) -> torch.Tensor:
        """Valid rows of every lhs group that holds a cold row, groups taken
        whole (candidates are per-group evidence).  Host numpy, as the
        reference's ``_fd_increment_seed`` with no row budget."""
        valid = _host(rel.valid)
        gid = np.zeros(valid.shape[0], dtype=np.int64)
        for attr in fd.lhs:
            _, inv = np.unique(_host(rel.columns[attr]), return_inverse=True)
            gid = gid * (int(inv.max()) + 1) + inv
        _, gid = np.unique(gid, return_inverse=True)
        cold_groups = np.unique(gid[_host(cold)])
        return torch.from_numpy(valid & np.isin(gid, cold_groups)).to(rel.device)

    # ------------------------------------------------------------- FD steps
    def _clean_fd(self, step: CleanStep, report: ExecReport) -> None:
        """One FD cleaning step (see the reference's ``Daisy._clean_fd``)."""
        table, fd = step.table, step.rule
        rel = self.db[table]
        cm = self.cost.get((table, fd.name))
        st = self.stats.get((table, fd.name))
        rep = StepReport(fd.name, table, step.mode)

        mark_scope = None
        if step.mode == "full":
            # detect only lhs groups still holding cold rows, taken whole;
            # the mark still covers the whole relation
            cold = self._cold_mask(rel, table, fd.name)
            if bool(cold.any()):
                scope = self._cold_groups(rel, fd, cold)
            else:
                scope = rel.valid
            mark_scope = rel.valid
            rep.answer_size = _count(scope)
        else:
            answer = filter_mask(rel, step.preds)
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
        self.detect_calls += 1
        rep.detect_pairs = _count(scope)  # group-by is O(scope)
        self.detect_pairs += rep.detect_pairs
        with self.tracer.span(
            "clean.detect", rule=fd.name, table=table, mode=rep.mode,
            pairs=rep.detect_pairs,
        ) as sp:
            det, _ = detect_auto(rel, fd, scope, k=self.config.k)
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

    # ------------------------------------------------------------- DC steps
    def _dc_detect_repair(self, rel, dc, row_scope, col_scope, cm, rep,
                          row_block_ids=None, col_block_ids=None):
        """One detect + repair-candidate pass of the DC increment engine over
        the block worklist; accounts the scanned comparison space and the
        launch geometry.  Returns ``(rel, detect_result)``."""
        table = rep.table
        self.detect_calls += 1
        rows = _count(row_scope & rel.valid)
        cols = _count(col_scope & rel.valid)
        rep.detect_pairs += rows * cols
        self.detect_pairs += rows * cols
        with self.tracer.span(
            "clean.detect", rule=dc.name, table=table, mode=rep.mode,
            pairs=rows * cols, row_blocks=None, col_blocks=None,
            row_block_ids=None if row_block_ids is None else len(row_block_ids),
            col_block_ids=None if col_block_ids is None else len(col_block_ids),
        ) as sp:
            det, _ = detect_auto(
                rel, dc, row_scope, col_scope, block=self.config.dc_block,
                row_block_ids=row_block_ids, col_block_ids=col_block_ids,
                encode=self.config.kernel_encodings,
            )
            launched = int(det.tiles_launched)
            skipped = max(int(det.tiles_total) - launched, 0)
            rep.tiles_launched += launched
            rep.tiles_skipped += skipped
            self.tiles_launched += launched
            self.tiles_skipped += skipped
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

    def _clean_dc(self, step: CleanStep, report: ExecReport) -> None:
        """One DC cleaning step through the strip-grained increment engine
        (modes auto / incremental / full, as the reference)."""
        table, dc = step.table, step.rule
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
        cold_frac = scope_ledger.cold_fraction
        row_block_ids = None
        if mode == "incremental":
            row_scope = answer & live
        else:
            # the remaining full clean: every cold strip of the scope
            sel = scope_ledger.cold_strips()
            if step.strips is not None:
                sel = np.intersect1d(np.asarray(step.strips, dtype=np.int64), sel)
            if len(sel):
                row_scope = (
                    torch.from_numpy(scope_ledger.strip_mask(sel)).to(live.device) & live
                )
                row_block_ids = scope_ledger.strip_block_ids(sel, self.config.dc_block)
            else:
                row_scope = torch.zeros_like(rel.valid)
        rep.mode = mode
        rep.answer_size = _count(answer)

        # idempotence gate: everything this step would scope is checked
        if not bool(row_scope.any()):
            rep.mode = "skipped"
            report.steps.append(rep)
            if cm:
                cm.record(rep.answer_size, 0, 0.0, 0)
            return

        col_scope = rel.valid
        if mode == "incremental":
            row_block_ids = self._active_blocks(row_scope)
        rel, det = self._dc_detect_repair(
            rel, dc, row_scope, col_scope, cm, rep, row_block_ids=row_block_ids,
        )
        repaired = (det.t1_count > 0) | (det.t2_count > 0)
        rep.repaired = _count(repaired & row_scope)

        if mode == "incremental":
            # partners of the answer get their role fixes too: the matrix
            # strip [rest x answer], restricted to the answer's active blocks
            partner_scope = rel.valid & ~answer
            rel, det2 = self._dc_detect_repair(
                rel, dc, partner_scope, answer, cm, rep,
                row_block_ids=self._active_blocks(partner_scope),
                col_block_ids=self._active_blocks(answer),
            )
            rep.extra = _count(
                ((det2.t1_count > 0) | (det2.t2_count > 0)) & partner_scope
            )

        rel = self._mark(rel, table, dc.name, row_scope)
        self.db[table] = rel
        if cm:
            n = cm.n
            d_i = (
                float(rep.answer_size) * n / max(self.config.dc_partitions, 1)
                if mode == "incremental"
                else cm.df * cold_frac
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
