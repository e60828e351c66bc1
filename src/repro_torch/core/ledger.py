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

The port keeps only what query-driven cleaning uses: the ingest
bookkeeping (fresh strips, pending deltas) and the progress export of the
reference wait for the slices that port ingest and the service.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def resolve_strip_rows(strip_rows: Optional[int], block: int) -> int:
    """Align the configured strip size to the detect tile grid: at least
    one block, rounded up to a whole number of blocks (a strip must be a
    contiguous run of kernel grid rows for the strip-scoped scan entry)."""
    base = int(strip_rows) if strip_rows else int(block)
    if base <= 0:
        raise ValueError(f"strip_rows must be positive, got {strip_rows}")
    return -(-base // int(block)) * int(block)


@dataclasses.dataclass
class StripLedger:
    """Work ledger for ONE (table, rule) scope: per-strip cold-row counts
    plus the scope's monotone version (see the module docstring for the
    locking and soundness contracts)."""

    table: str
    rule: str
    capacity: int
    strip_rows: int
    version: int = 0
    cold_per_strip: np.ndarray = dataclasses.field(default=None)  # (n_strips,) int64

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

    def strip_block_ids(self, strips: Sequence[int], block: int) -> np.ndarray:
        """EXACT kernel-grid block-row ids of the given strips — the
        block-sparse worklist entry (DESIGN.md §15).  Warm strips between
        the selected ones are not covered at all: their tile pairs are
        absent from the launch.  ``strip_rows`` is block-aligned, so each
        strip contributes a whole run of block ids."""
        per = self.strip_rows // block
        nb = -(-self.capacity // block)
        ids = [
            b
            for s in sorted(set(strips))
            for b in range(s * per, min((s + 1) * per, nb))
        ]
        return np.asarray(ids, dtype=np.int32)

    # ------------------------------------------------------------- progress
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

    def cold_strips(self) -> np.ndarray:
        """Ids of strips that still hold cold rows, ascending."""
        return np.flatnonzero(self.cold_per_strip > 0)

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
    """All scopes' strip ledgers behind one lookup (DESIGN.md §11).
    Unknown scopes read as version 0."""

    def __init__(self, strip_rows: int, block: int):
        self.strip_rows = resolve_strip_rows(strip_rows, block)
        self._scopes: Dict[Tuple[str, str], StripLedger] = {}

    # ------------------------------------------------------------- registry
    def register(self, table: str, rule: str, capacity: int,
                 cold: Optional[np.ndarray] = None) -> StripLedger:
        """Create (or return) the scope's strip ledger; ``cold`` seeds the
        per-strip cold counts."""
        key = (table, rule)
        scope = self._scopes.get(key)
        if scope is None:
            scope = StripLedger(table, rule, int(capacity), self.strip_rows)
            self._scopes[key] = scope
        if cold is not None:
            scope.observe_cold(cold)
        return scope

    def scope(self, table: str, rule: str) -> Optional[StripLedger]:
        """The scope's ledger, or None when never registered."""
        return self._scopes.get((table, rule))

    # ------------------------------------------------------------- versions
    def version(self, table: str, rule: str) -> int:
        """Monotone per-scope version (0 for unknown scopes)."""
        scope = self._scopes.get((table, rule))
        return 0 if scope is None else scope.version

    def versions(self, deps: Sequence[Tuple[str, str]]) -> Tuple[int, ...]:
        """Version vector over a dependency list of (table, rule) pairs."""
        return tuple(self.version(t, r) for t, r in deps)

    def bump(self, table: str, rule: str) -> None:
        """Advance one registered scope's version."""
        self._scopes[(table, rule)].bump()

    def commit(self, table: str, rule: str, cold: np.ndarray) -> None:
        """One instance-advancing commit that also refreshed coverage:
        bump the version AND fold the new cold mask (checked-bit commits)."""
        scope = self.register(table, rule, cold.shape[0])
        scope.bump()
        scope.observe_cold(cold)
