"""Cleaning-aware logical planning (paper §5.1).

The planner detects which rules overlap the query's attributes
((X u Y) n (P u W) != {}), injects a cleaning step per overlapping rule, and
chooses placement + mode:

* **group-by with no select/join** -> cleaning pushed below the aggregation
  as a FULL clean (the group-by touches the whole dataset, so incremental
  relaxation has nothing to prune — §4 "we push down cleaning to avoid the
  grouping recomputation");
* **select** -> clean AFTER the filter via query-result relaxation, unless
  the per-rule online cost model (Inequality (1)) says the remaining-dirty
  full clean is now cheaper (the Fig. 9/14 switch);
* **join** -> clean each side's qualifying part before the join
  (push-down, §5.1), then incremental-join the extra tuples (Fig. 5) and
  re-check the stitched result (Def. 3 (d));
* **FD filtered on the rhs only** -> the Lemma-1 fast path: relaxation skips
  the rhs expansion (one effective closure round).
* **DC** -> mode 'auto': the full/partial decision is Algorithm 2's accuracy
  estimate, which needs the answer and is therefore taken at execution time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.constraints import DC, FD, equality_key_attrs, overlaps_query
from repro_torch.core.operators import JoinClause, Pred, Query


@dataclasses.dataclass(frozen=True)
class CleanStep:
    table: str
    rule: FD | DC
    placement: str  # 'pre' (below the filter / full) or 'post' (on the result)
    mode: str  # 'incremental' | 'full' | 'auto' (DC: Algorithm 2 at exec time)
    use_rhs: bool = True  # Algorithm 1 rhs expansion (False = Lemma-1 path)
    preds: Tuple[Pred, ...] = ()  # the filter this step cleans against
    # the rule has an equality routing key, so detection MAY take the
    # sharded path when the executor runs on a mesh (DESIGN.md §8); the
    # executor combines this with its mesh config at execution time.
    shardable: bool = False
    # partition-strip grain (DESIGN.md §11): when set, the step scans ONLY
    # these ledger strips (DC row-block strips of the comparison matrix) —
    # the background cleaner's bounded increments and the planner's
    # ledger-pruned full cleans both express their scope this way.  None
    # means the step is not strip-scoped (FD steps, answer-scoped DC steps).
    strips: Tuple[int, ...] | None = None


@dataclasses.dataclass
class PlanInfo:
    steps: List[CleanStep]
    join_order: List[JoinClause]
    notes: List[str]


def _fd_use_rhs(fd: FD, preds: Sequence[Pred], lemma1_fast_path: bool) -> bool:
    """Lemma 1: a filter purely on the rhs converges in one lhs round, so the
    rhs expansion adds no *qualifying* tuples and may be skipped.

    NOTE: the paper's own candidate tables (2b, 4d) nevertheless use lhs
    candidates drawn from rhs-sharing tuples OUTSIDE that one-round closure
    (its Example-2 narrative contradicts its Table 2b values).  We therefore
    default to the full closure — candidate sets exactly match the paper's
    tables — and expose the Lemma-1 shortcut as an opt-in fast path
    (``DaisyConfig.lemma1_fast_path``) for workloads that only need
    qualification recovery, not full candidate domains."""
    if not lemma1_fast_path:
        return True
    pred_attrs = {p.col for p in preds} & set(fd.attrs)
    return not (pred_attrs and pred_attrs <= {fd.rhs})


def probe_step(table: str, rule) -> CleanStep:
    """An incremental step with no predicate filter: the executor substitutes
    an explicit answer mask (``answer_override``).  Background FD increments
    use it so a cold-group sweep runs the same relax -> detect -> repair ->
    mark pipeline a foreground query selecting those groups would
    (DESIGN.md §10), keeping the shardable mark consistent with the planner's.
    """
    return CleanStep(
        table, rule, "post", "incremental", True, (), bool(equality_key_attrs(rule))
    )


def strip_step(table: str, rule, strips) -> CleanStep:
    """A DC step scoped to a set of ledger strips (DESIGN.md §11): the
    executor scans ``strips`` x rest-of-dataset and marks exactly the cold
    rows it covered.  This is the background cleaner's bounded-latency DC
    increment — and, with ALL cold strips passed, the ledger-pruned form of
    the full clean (foreground full cleans route through it too, so both
    paths are one increment engine)."""
    return CleanStep(
        table, rule, "pre", "strip", True, (),
        bool(equality_key_attrs(rule)), tuple(int(s) for s in strips),
    )


def plan_query(
    query: Query,
    rules: Dict[str, Sequence[FD | DC]],
    want_full: Dict[Tuple[str, str], bool],
    lemma1_fast_path: bool = False,
    ledger=None,
) -> PlanInfo:
    """Build the cleaning plan.  ``want_full[(table, rule)]`` carries the
    cost model's current verdict (executor refreshes it before each query).

    With a ``WorkLedger`` passed, cost-model DC full cleans plan at strip
    grain: the step carries the scope's cold strips, so the executor scans
    only the part of the comparison matrix no earlier pass (foreground or
    background) already covered — partial-work reuse, DESIGN.md §11."""
    steps: List[CleanStep] = []
    notes: List[str] = []

    def add_steps(table: str, preds: Tuple[Pred, ...], attrs: Sequence[str]):
        for rule in rules.get(table, ()):  # planner preserves rule order
            if not overlaps_query(rule, attrs):
                continue
            if ledger is not None and ledger.has_pending(table, rule.name):
                # the executor drains queued ingest-deltas at the top of
                # every cleaning step (DESIGN.md §12); surface it in the plan
                notes.append(
                    f"{rule.name}@{table}: ingest-delta pending "
                    "(drained before this step)"
                )
            full = want_full.get((table, rule.name), False)
            shardable = bool(equality_key_attrs(rule))
            if isinstance(rule, FD):
                if not preds and query.groupby is not None:
                    steps.append(
                        CleanStep(table, rule, "pre", "full", True, (), shardable)
                    )
                    notes.append(f"{rule.name}@{table}: pushdown full (bare group-by)")
                elif full:
                    steps.append(
                        CleanStep(table, rule, "pre", "full", True, preds, shardable)
                    )
                    notes.append(f"{rule.name}@{table}: cost-model switch -> full")
                else:
                    use_rhs = _fd_use_rhs(rule, preds, lemma1_fast_path)
                    steps.append(
                        CleanStep(
                            table, rule, "post", "incremental", use_rhs, preds,
                            shardable,
                        )
                    )
                    if not use_rhs:
                        notes.append(f"{rule.name}@{table}: Lemma-1 rhs-filter path")
            else:
                mode = "full" if full else "auto"
                strips = None
                if full and ledger is not None:
                    scope = ledger.scope(table, rule.name)
                    if scope is not None and scope.strips_done > 0:
                        strips = tuple(int(s) for s in scope.cold_strips())
                        notes.append(
                            f"{rule.name}@{table}: full clean pruned to "
                            f"{len(strips)}/{scope.n_strips} cold strips"
                        )
                steps.append(
                    CleanStep(
                        table, rule, "post", mode, True, preds, shardable, strips
                    )
                )
                if not shardable:
                    notes.append(
                        f"{rule.name}@{table}: no equality atom — dense detect only"
                    )

    base_attrs = list(query.attrs)
    add_steps(query.table, tuple(query.preds), base_attrs)
    for j in query.joins:
        add_steps(j.right, tuple(j.right_preds), base_attrs)
    return PlanInfo(steps, list(query.joins), notes)
