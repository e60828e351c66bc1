"""The cost model (paper §5.2): incremental vs full cleaning, online.

The port's own copy of ``repro.core.cost`` (pure Python).  A
mesh-configured ``Daisy`` feeds each sharded detect's routing through
``observe_detect_cost``; without a mesh ``df_observed`` stays None.

Implements the two cost expressions and the online Inequality-(1) check that
drives the strategy switch seen in Figs. 9 and 14 ("Daisy initially applies
data cleaning incrementally, and then, by evaluating the total cost after
each query, switches strategy and applies the cleaning task over the rest of
the dataset").

Two extensions beyond the paper's formulas live here as well (DESIGN.md §10):

* **Sharded detection pricing.**  When the executor detects over the
  key-routed shuffle (DESIGN.md §8) it feeds the observed
  ``ShardedDetectInfo`` — per-shard row counts and the retry history —
  back through ``observe_detect_cost``, so the full/partial decision
  prices the *sharded* comparison space (``Σ rows_s²`` plus the shuffle
  passes) instead of the dense ``n²/partitions`` estimate.
* **Background scope priorities.**  ``ScopePriority`` /
  ``prioritize_scopes`` rank the cold (unchecked-and-dirty) rule scopes a
  background cleaner should full-clean first: expected detect pair-count
  a first-touch foreground query would pay, times the touch probability
  observed in session lineage.

Per-query incremental cost (formula (1)):

    (n - sum_{j<i} q_j)                relaxation over the unknown tuples
  +  d_i                               error detection over q_i + e_i
  +  eps_i (q_i + e_i)                 data repairing over the enhanced result
  +  (n - sum eps_j) + p sum eps_j     probabilistic dataset update
  +  eps_i p

Offline cost (per §5.2.1, plus executing the q queries over clean data):

    q n + df + eps n + n + eps p

All quantities are row counts — the model compares relative work, as in the
paper (both sides run on the same executor so constants cancel).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional


def sharded_detect_cost(info, n_rows: Optional[int] = None) -> float:
    """Price a full-scope sharded detect from an observed routing.

    ``info`` is duck-typed as the reference's ``ShardedDetectInfo``
    (``n_shards``, ``per_shard_rows``, ``routed_rows``, ``retries``,
    ``sharded_pairs``).  The estimate is the uniform per-shard pair count at ``n_rows``
    scaled by the observed skew (actual routed pairs over the uniform pair
    count of the observed routing), plus one shuffle pass over the rows per
    attempt the retry history says the routing needed.
    """
    n = int(n_rows if n_rows is not None else info.routed_rows)
    shards = max(int(info.n_shards), 1)
    per = -(-n // shards)
    uniform = float(shards * per * per)
    if info.routed_rows:
        obs_per = -(-int(info.routed_rows) // shards)
        obs_uniform = float(shards * obs_per * obs_per) or 1.0
        skew = max(float(info.sharded_pairs) / obs_uniform, 1.0)
    else:
        skew = 1.0
    return uniform * skew + (int(info.retries) + 1) * n


@dataclasses.dataclass(frozen=True)
class ScopePriority:
    """One cold (table, rule) scope ranked for background cleaning
    (DESIGN.md §10).

    ``expected_pairs`` is the detect comparison-space a first-touch
    foreground query would pay on this scope right now — the rule's
    effective full-detect cost (dense, or sharded once the executor has
    observed a routing) scaled by the cold fraction.  ``touch_probability``
    is the Laplace-smoothed share of recently answered queries whose
    dependency set included this scope (from session lineage), i.e. how
    likely the next query is to pay that first touch.
    """

    table: str
    rule: str
    cold_rows: int  # unchecked rows a foreground detect would still scan
    expected_pairs: float
    touch_probability: float
    # streaming ingest (DESIGN.md §12): >1 when the scope holds FRESH cold
    # strips or queued ingest-deltas — appended rows are the coldest state a
    # foreground query can hit, so they outrank equally-priced steady scopes
    fresh_boost: float = 1.0
    pending: bool = False  # queued ingest-deltas awaiting _process_pending

    @property
    def priority(self) -> float:
        """Expected foreground work saved by cleaning this scope now."""
        return self.expected_pairs * self.touch_probability * self.fresh_boost


def prioritize_scopes(scopes: Iterable[ScopePriority]) -> List[ScopePriority]:
    """Sort cold scopes by descending expected saved work; drop warm ones.
    A scope with zero cold rows but queued ingest-deltas is still work
    (DESIGN.md §12) and is kept.

    Ties break on (table, rule) so the background cleaner's pick is
    deterministic under equal priorities (the seeded interleaving tests
    rely on that).
    """
    return sorted(
        (s for s in scopes if s.cold_rows > 0 or s.pending),
        key=lambda s: (-s.priority, s.table, s.rule),
    )


@dataclasses.dataclass
class QueryCost:
    q_i: int  # result size
    e_i: int  # extra (relaxed) tuples
    d_i: float  # detection cost actually incurred
    eps_i: int  # errors repaired this query


@dataclasses.dataclass
class CostModel:
    """Online cost model for one (relation, rule) pair."""

    n: int  # dataset size
    epsilon: int  # estimated total errors (from stats)
    p: float  # estimated candidate-set size per error (from stats)
    df: float  # full-clean detection cost estimate (n for FDs, n^2/parts for DCs)
    expected_queries: int = 50  # workload length estimate (paper: known q)
    history: List[QueryCost] = dataclasses.field(default_factory=list)
    switched: bool = False
    # observed full-detect cost on the sharded path (DESIGN.md §8/§10):
    # None until the executor has seen a ShardedDetectInfo for this rule
    df_observed: Optional[float] = None
    # ledger strip coverage (DESIGN.md §11): fraction of the scope's strips
    # still cold, fed by the executor at every commit.  None until observed;
    # with it, the remaining-full-clean price shrinks as strips complete —
    # foreground OR background — so the Inequality-(1) flip can fire
    # mid-scope instead of waiting on query-coverage estimates.
    cold_fraction: Optional[float] = None
    # measured tile-level launch sparsity of the last full-mode DC scan
    # (tiles launched / dense tiles, DESIGN.md §15): the kernel-truth
    # counterpart of ``cold_fraction`` — identical for block-aligned strips,
    # but measured from the worklist the scan actually launched
    tile_ratio: Optional[float] = None

    # -------------------------------------------------------------- records
    def record(self, q_i: int, e_i: int, d_i: float, eps_i: int) -> None:
        self.history.append(QueryCost(q_i, e_i, d_i, eps_i))

    def observe_progress(self, cold_fraction: float) -> None:
        """Record the ledger's current cold-strip fraction for this scope
        (the executor calls this from every ``_mark`` commit)."""
        self.cold_fraction = min(max(float(cold_fraction), 0.0), 1.0)

    def observe_tile_sparsity(self, ratio: float) -> None:
        """Record a full-mode scan's measured launch ratio — tiles launched
        over the dense tile count (DESIGN.md §15)."""
        self.tile_ratio = min(max(float(ratio), 0.0), 1.0)

    def observe_detect_cost(self, cost: float) -> None:
        """Record an observed full-detect cost (e.g. ``sharded_detect_cost``
        of a routing the executor actually ran), so the full/partial decision
        prices the execution path detection will really take."""
        self.df_observed = cost if self.df_observed is None else min(
            self.df_observed, cost
        )

    @property
    def df_effective(self) -> float:
        """Full-detect cost the decision should use: the static estimate,
        improved by the cheapest observed (sharded) detect if any."""
        return self.df if self.df_observed is None else min(self.df, self.df_observed)

    @property
    def seen_rows(self) -> int:
        return sum(h.q_i for h in self.history)

    @property
    def repaired_errors(self) -> int:
        return sum(h.eps_i for h in self.history)

    # ---------------------------------------------------------------- costs
    def _update_cost(self, prior_eps: int, eps_i: int) -> float:
        """Probabilistic-update (outer-join) cost.  Implementation refinement
        over the raw formula (documented in DESIGN.md §2): Daisy isolates the
        delta first, so an EMPTY delta skips the outer-join entirely — the
        n-scan is only paid when eps_i > 0."""
        if eps_i <= 0:
            return 0.0
        return (self.n - prior_eps) + self.p * prior_eps + eps_i * self.p

    def incremental_query_cost(self, q_i: int, e_i: int, d_i: float, eps_i: int) -> float:
        prior_q = self.seen_rows
        prior_eps = self.repaired_errors
        relax = max(self.n - prior_q, 0)
        repair = eps_i * (q_i + e_i)
        return relax + d_i + repair + self._update_cost(prior_eps, eps_i)

    def incremental_cost_so_far(self) -> float:
        total = 0.0
        prior_q = 0
        prior_eps = 0
        for h in self.history:
            relax = max(self.n - prior_q, 0)
            repair = h.eps_i * (h.q_i + h.e_i)
            total += relax + h.d_i + repair + self._update_cost(prior_eps, h.eps_i)
            prior_q += h.q_i
            prior_eps += h.eps_i
        return total

    def projected_incremental_remaining(self) -> float:
        """Extrapolate the remaining workload.  Future relax scans shrink
        with coverage (the formula's ``n - sum q_j``), and future updates are
        only paid while errors remain, so the projection uses the CURRENT
        state, not the historical average: each remaining query costs the
        cost the next query would, with the error stream assumed to continue
        at the observed dirty-query rate until ``epsilon`` is exhausted."""
        done = len(self.history)
        remaining = max(self.expected_queries - done, 0)
        if done == 0 or remaining == 0:
            return 0.0
        avg_q = self.seen_rows / done
        avg_e = sum(h.e_i for h in self.history) / done
        avg_d = sum(h.d_i for h in self.history) / done
        dirty_queries = sum(1 for h in self.history if h.eps_i > 0)
        avg_eps = self.repaired_errors / max(dirty_queries, 1)
        dirty_rate = dirty_queries / done
        eps_left = max(self.epsilon - self.repaired_errors, 0)
        total = 0.0
        seen = float(self.seen_rows)
        prior_eps = float(self.repaired_errors)
        for _ in range(remaining):
            eps_i = avg_eps if (dirty_rate > 0 and eps_left > 0) else 0.0
            eps_i = min(eps_i, eps_left)
            relax = max(self.n - seen, 0.0)
            repair = eps_i * (avg_q + avg_e)
            update = (
                (self.n - prior_eps) + self.p * prior_eps + eps_i * self.p
                if eps_i > 0
                else 0.0
            )
            total += relax + avg_d + repair + update
            seen += avg_q
            prior_eps += eps_i
            eps_left -= eps_i
        return total

    def offline_cost(self) -> float:
        q = self.expected_queries
        return (
            q * self.n
            + self.df_effective
            + self.epsilon * self.n
            + self.n
            + self.epsilon * self.p
        )

    def remaining_full_clean_cost(self) -> float:
        """Cleaning the REST of the dataset now (what the switch buys):
        detection over the still-cold part + repair of remaining errors +
        update.  The cold part is the ledger's strip-coverage fraction when
        observed (DESIGN.md §11) — query-coverage row sums double-count
        revisited rows, the ledger does not — else the row-sum estimate."""
        unseen = max(self.n - self.seen_rows, 0)
        eps_left = max(self.epsilon - self.repaired_errors, 0)
        frac = unseen / max(self.n, 1)
        if self.cold_fraction is not None:
            frac = min(frac, self.cold_fraction)
        detect_frac = frac
        if self.tile_ratio is not None:
            # the detect term prices kernel launches, and the worklist scan
            # measures exactly what fraction of the dense grid it launches
            # (DESIGN.md §15); repair/update stay row-fraction priced
            detect_frac = min(detect_frac, self.tile_ratio)
        return (
            detect_frac * self.df_effective
            + eps_left * frac * self.p
            + frac * self.n
        )

    # -------------------------------------------------------------- decision
    def should_switch_to_full(self) -> bool:
        """Inequality (1) evaluated online: switch when the projected
        incremental remainder exceeds full-cleaning the remaining dirty part
        (plus running the remaining queries over clean data)."""
        if self.switched:
            return False
        done = len(self.history)
        remaining_q = max(self.expected_queries - done, 0)
        if done == 0 or remaining_q == 0:
            return False
        incremental = self.projected_incremental_remaining()
        full = self.remaining_full_clean_cost() + remaining_q * self.n
        return incremental > full

    def mark_switched(self) -> None:
        self.switched = True
