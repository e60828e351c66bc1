"""The per-(table, rule, partition-strip) work ledger (DESIGN.md §11).

The paper's DC detection partitions the cartesian comparison matrix and
prunes partitions by boundary ranges (§4.2); the ``dc_pairs`` kernel runs
that plan over a worklist of block tiles (DESIGN.md §15).  The ledger
tracks cleaning progress with one structure per (table, rule) scope:

* the row space splits into **Okcan–Riedewald block-row strips** of
  ``strip_rows`` rows, aligned to the kernel tile grid (``strip_rows`` is
  a multiple of the detect block, so a strip is a whole number of grid
  rows and a strip-scoped scan is a grid-row range, not a masked full
  sweep);
* every detect/repair commit reports the rows still cold (unchecked and,
  for FDs, statically dirty); the ledger folds them into per-strip cold
  counts, from which strip coverage and the Algorithm-2 support
  fraction are host-cheap reads;
* the scope **version** lives here too: equal ledger vectors over a
  query's dependency scopes imply bit-identical answers, because every
  commit path bumps the ledger exactly when it advances the instance.

Why ledger-equal ⇒ bit-identical (the §11 argument, short form): repairs
merge into the candidate overlay, never into the base columns detection
reads, and the Lemma-4 merge is commutative and associative over
row-disjoint deltas.  A strip therefore contributes the same delta
whenever it is cleaned, and "which strips have contributed" — exactly
what the ledger tracks — determines the overlay state up to merge order,
which the merge erases.

Thread-safety: the ledger is NOT internally locked; every mutation and
read happens under the executor's lock.

Since DESIGN.md §12 each scope also owns its ingest state: which strips
hold FRESH rows (the background cleaner's priority signal) and the
pending ingest-deltas the next cleaning step must process.  The module is
numpy only, the port's own copy of ``repro.core.ledger``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Pseudo-rule naming a table's ROW COUNT as a cache-version coordinate:
# ``Daisy.ingest`` bumps (table, TABLE_ROWS_RULE) so cached answers over a
# grown table go stale even when they overlap no cleaning rule (DESIGN.md
# §12).  Cleaning commits never bump it, so rule-free entries survive all
# background cleaning — invalidation stays exact.
TABLE_ROWS_RULE = "__rows__"


def resolve_strip_rows(strip_rows: Optional[int], block: int) -> int:
    """Align the configured strip size to the detect tile grid: at least
    one block, rounded up to a whole number of blocks (a strip must be a
    contiguous run of kernel grid rows for the strip-scoped scan entry)."""
    base = int(strip_rows) if strip_rows else int(block)
    if base <= 0:
        raise ValueError(f"strip_rows must be positive, got {strip_rows}")
    return -(-base // int(block)) * int(block)


@dataclasses.dataclass
class PendingIngest:
    """One ingest's unprocessed delta against a scope's CHECKED rows
    (DESIGN.md §12).  Fresh rows occupy ``[lo, hi)``; ``checked``
    snapshots which rows were already checked for the rule when the
    append landed (those rows' overlays must absorb the fresh partners'
    evidence without being re-scanned); ``old_dirty`` (FDs only)
    snapshots which rows were statically dirty BEFORE the append — it
    classifies checked rows into "has full old evidence" (merge
    fresh-weighted counts) versus "checked while clean, no evidence"
    (merge full counts).  Entries are processed in append order: each is
    evaluated against rows ``< hi`` only, so a later append's rows never
    leak into an earlier delta."""

    lo: int
    hi: int
    checked: np.ndarray  # (cap,) bool host snapshot at append time
    old_dirty: Optional[np.ndarray] = None  # (cap,) bool, FD scopes only


@dataclasses.dataclass
class StripLedger:
    """Work ledger for ONE (table, rule) scope: per-strip cold-row counts
    plus the scope's monotone version (see the module docstring for the
    locking and soundness contracts).  Since DESIGN.md §12 it also owns
    the scope's ingest state: which strips hold FRESH rows (recent data
    is hot data — the background cleaner's priority signal) and the
    pending ingest-deltas the next cleaning step must process."""

    table: str
    rule: str
    capacity: int
    strip_rows: int
    version: int = 0
    cold_per_strip: np.ndarray = dataclasses.field(default=None)  # (n_strips,) int64
    fresh: set = dataclasses.field(default_factory=set)  # strip ids with fresh rows
    pending: List[PendingIngest] = dataclasses.field(default_factory=list)
    # cumulative DC-scan launch geometry for this scope (DESIGN.md §15):
    # tile pairs actually launched vs skipped by the ledger worklist
    tiles_launched: int = 0
    tiles_skipped: int = 0

    def __post_init__(self):
        if self.cold_per_strip is None:
            self.cold_per_strip = np.zeros(self.n_strips, dtype=np.int64)

    # ------------------------------------------------------------- geometry
    @property
    def n_strips(self) -> int:
        """Number of block-row strips covering the row space."""
        return -(-self.capacity // self.strip_rows)

    def strip_mask(self, strips: Sequence[int]) -> np.ndarray:
        """Row mask (capacity,) selecting the given strips."""
        mask = np.zeros(self.capacity, dtype=bool)
        for s in strips:
            mask[s * self.strip_rows : (s + 1) * self.strip_rows] = True
        return mask

    def strip_blocks(self, strips: Sequence[int], block: int) -> Tuple[int, int]:
        """Covering kernel-grid block-row range [lo, hi) of the given strips
        (the ``row_blocks`` argument of the strip-scoped detect entry).
        ``strip_rows`` is block-aligned, so strip bounds are block bounds.

        One contiguous range, not per-strip runs: warm strips inside the
        range cost only grid iterations — their row blocks are fully
        scoped out, so the kernel's scope-masked bound pruning gives them
        identity bounds and ``@pl.when`` skips the tile body entirely
        (DESIGN.md §7)."""
        per = self.strip_rows // block
        lo = min(strips) * per
        hi = (max(strips) + 1) * per
        return lo, min(hi, -(-self.capacity // block))

    def strip_block_ids(self, strips: Sequence[int], block: int) -> np.ndarray:
        """EXACT kernel-grid block-row ids of the given strips — the
        block-sparse worklist entry (DESIGN.md §15).  Unlike
        ``strip_blocks``, warm strips between the selected ones are not
        covered at all: their tile pairs are absent from the launch, not
        merely scope-pruned inside it.  ``strip_rows`` is block-aligned,
        so each strip contributes a whole run of block ids."""
        per = self.strip_rows // block
        nb = -(-self.capacity // block)
        ids = [
            b
            for s in sorted(set(strips))
            for b in range(s * per, min((s + 1) * per, nb))
        ]
        return np.asarray(ids, dtype=np.int32)

    def cold_block_ids(self, block: int) -> np.ndarray:
        """Block-row ids of every strip still holding cold rows — the row
        side of a full-scope ledger-masked scan (checked x checked tile
        pairs never launch, DESIGN.md §15)."""
        return self.strip_block_ids(np.flatnonzero(self.cold_per_strip > 0), block)

    # ------------------------------------------------------------- progress
    @property
    def cold_count(self) -> int:
        """Rows a first-touch foreground detect would still pay for."""
        return int(self.cold_per_strip.sum())

    @property
    def strips_done(self) -> int:
        """Strips with no cold rows left (fully covered for this rule)."""
        return int((self.cold_per_strip == 0).sum())

    @property
    def support(self) -> float:
        """Fraction of strips covered — the Algorithm-2 support input
        (replaces the diagonal-partition bookkeeping, DESIGN.md §11)."""
        return self.strips_done / max(self.n_strips, 1)

    @property
    def cold_fraction(self) -> float:
        """Cold strips over total strips — prices the REMAINING full-clean
        detection (``CostModel.remaining_full_clean_cost``)."""
        return 1.0 - self.support

    def cold_strips(self, fresh_first: bool = False) -> np.ndarray:
        """Ids of strips that still hold cold rows, ascending — or, with
        ``fresh_first``, fresh strips ahead of stale ones (each group
        ascending): the background cleaner's recent-data-is-hot-data
        ordering (DESIGN.md §12)."""
        cold = np.flatnonzero(self.cold_per_strip > 0)
        if not fresh_first or not self.fresh:
            return cold
        is_fresh = np.isin(cold, sorted(self.fresh))
        return np.concatenate([cold[is_fresh], cold[~is_fresh]])

    @property
    def fresh_cold_count(self) -> int:
        """Cold rows sitting in fresh strips (the ingest-priority signal)."""
        if not self.fresh:
            return 0
        ids = [s for s in self.fresh if s < self.n_strips]
        return int(self.cold_per_strip[ids].sum()) if ids else 0

    def note_fresh(self, lo: int, hi: int) -> None:
        """Mark the strips overlapping row range [lo, hi) as fresh."""
        if hi > lo:
            self.fresh.update(range(lo // self.strip_rows,
                                    -(-hi // self.strip_rows)))

    def prune_fresh(self) -> None:
        """Drop fresh flags on strips that no longer hold cold rows —
        called after commits so the priority signal decays as the fresh
        data gets cleaned."""
        self.fresh = {s for s in self.fresh
                      if s < self.n_strips and self.cold_per_strip[s] > 0}

    def note_tiles(self, launched: int, skipped: int) -> None:
        """Accumulate one DC scan's launch geometry (DESIGN.md §15):
        ``launched`` tile pairs ran, ``skipped`` were pruned from the
        launch by the ledger worklist.  Called under the executor lock."""
        self.tiles_launched += int(launched)
        self.tiles_skipped += int(skipped)

    # -------------------------------------------------------------- commits
    def bump(self) -> None:
        """Advance the scope version (every instance-advancing commit)."""
        self.version += 1

    def observe_cold(self, cold: np.ndarray) -> None:
        """Fold a fresh cold-row mask into per-strip counts.  ``cold`` is
        the (capacity,) host bool mask of rows a foreground detect would
        still scan; called under the executor lock at every commit."""
        cold = np.asarray(cold, dtype=bool)
        pad = self.n_strips * self.strip_rows - cold.shape[0]
        if pad:
            cold = np.pad(cold, (0, pad))
        self.cold_per_strip = cold.reshape(self.n_strips, self.strip_rows).sum(
            axis=1, dtype=np.int64
        )


class WorkLedger:
    """All scopes' strip ledgers behind one lookup — the single progress
    structure foreground cleaning, background cleaning and the service
    cache key on (DESIGN.md §11).  Unknown scopes read as version 0 and
    empty progress, mirroring the old version-dict semantics."""

    def __init__(self, strip_rows: int, block: int):
        self.strip_rows = resolve_strip_rows(strip_rows, block)
        self.block = int(block)
        self._scopes: Dict[Tuple[str, str], StripLedger] = {}

    # ------------------------------------------------------------- registry
    def register(self, table: str, rule: str, capacity: int,
                 cold: Optional[np.ndarray] = None) -> StripLedger:
        """Create (or return) the scope's strip ledger; ``cold`` seeds the
        initial per-strip cold counts.  A scope first seen through a bare
        version bump (capacity 0 — e.g. a rule appended to a live Daisy)
        grows to the real capacity on its first sized registration; the
        version is preserved, the strip grid re-derives."""
        key = (table, rule)
        scope = self._scopes.get(key)
        if scope is None:
            scope = StripLedger(table, rule, int(capacity), self.strip_rows)
            self._scopes[key] = scope
        elif int(capacity) > scope.capacity:
            # growth without a cold mask seeds ALL-COLD, never all-warm: an
            # unknown scope must read as work to do (a warm-seeded scope
            # would skip every clean forever and serve dirty silently); the
            # first checked-bit commit replaces the pessimistic counts with
            # the real ones.
            scope.capacity = int(capacity)
            scope.cold_per_strip = np.full(
                scope.n_strips, scope.strip_rows, dtype=np.int64
            )
        if cold is not None:
            scope.observe_cold(cold)
        return scope

    def scope(self, table: str, rule: str) -> Optional[StripLedger]:
        """The scope's ledger, or None when never registered."""
        return self._scopes.get((table, rule))

    def scopes(self) -> List[StripLedger]:
        """Every registered scope ledger (stable registration order)."""
        return list(self._scopes.values())

    # ------------------------------------------------------------- versions
    def version(self, table: str, rule: str) -> int:
        """Monotone per-scope version (0 for unknown scopes)."""
        scope = self._scopes.get((table, rule))
        return 0 if scope is None else scope.version

    def versions(self, deps: Sequence[Tuple[str, str]]) -> Tuple[int, ...]:
        """Version vector over a dependency list — the service cache's key
        half (read under the executor lock when a cleaner may commit)."""
        return tuple(self.version(t, r) for t, r in deps)

    def bump(self, table: str, rule: str) -> None:
        """Advance one scope's version (auto-registers unknown scopes so a
        commit can never be dropped from the vector)."""
        self.register(table, rule, 0).bump()

    def commit(self, table: str, rule: str, cold: np.ndarray) -> None:
        """One instance-advancing commit that also refreshed coverage:
        bump the version AND fold the new cold mask (checked-bit commits)."""
        scope = self.register(table, rule, cold.shape[0])
        scope.bump()
        scope.observe_cold(cold)
        scope.prune_fresh()

    def record_ingest(
        self,
        table: str,
        rule: str,
        capacity: int,
        cold: np.ndarray,
        lo: int,
        hi: int,
        checked: Optional[np.ndarray] = None,
        old_dirty: Optional[np.ndarray] = None,
    ) -> StripLedger:
        """Fold one append into a rule scope (DESIGN.md §12): extend the
        strip grid to the (possibly grown) capacity, replace the cold
        counts with the post-append mask, mark the strips holding rows
        [lo, hi) fresh, and — when any row was already checked — queue a
        ``PendingIngest`` delta for the next cleaning step.  Does NOT
        bump the scope version: ingest by itself changes no overlay or
        checked bit; the versions move when the delta is processed."""
        scope = self.register(table, rule, capacity, cold=cold)
        scope.note_fresh(lo, hi)
        if checked is not None and bool(np.asarray(checked).any()):
            scope.pending.append(
                PendingIngest(lo=lo, hi=hi, checked=np.asarray(checked, dtype=bool),
                              old_dirty=old_dirty)
            )
        return scope

    def take_pending(self, table: str, rule: str) -> List[PendingIngest]:
        """Claim (and clear) a scope's queued ingest-deltas, append order.
        The caller owns processing them under the executor lock."""
        scope = self._scopes.get((table, rule))
        if scope is None or not scope.pending:
            return []
        out, scope.pending = scope.pending, []
        return out

    def has_pending(self, table: str, rule: str) -> bool:
        """True when the scope has unprocessed ingest-deltas."""
        scope = self._scopes.get((table, rule))
        return scope is not None and bool(scope.pending)

    # ------------------------------------------------------------- progress
    def cold_count(self, table: str, rule: str) -> int:
        scope = self._scopes.get((table, rule))
        return 0 if scope is None else scope.cold_count

    def support(self, table: str, rule: str) -> float:
        scope = self._scopes.get((table, rule))
        return 1.0 if scope is None else scope.support

    def progress(self) -> Dict[str, Dict[str, int]]:
        """JSON-serializable per-scope progress: strips done / total plus
        remaining cold rows (exported by ``service.metrics`` snapshots).
        Capacity-0 scopes — version-only coordinates like the
        ``TABLE_ROWS_RULE`` pseudo-rule — carry no strip grid and are
        skipped."""
        return {
            f"{s.table}/{s.rule}": {
                "strips_done": s.strips_done,
                "strips_total": s.n_strips,
                "cold_rows": s.cold_count,
                "tiles_launched": s.tiles_launched,
                "tiles_skipped": s.tiles_skipped,
            }
            for s in self._scopes.values()
            if s.capacity > 0
        }
