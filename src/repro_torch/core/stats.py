"""Statistics for the cost model and the full/partial decision (Algorithm 2).

The port's copy of ``repro.core.stats``: the statistics are host-side numpy,
read from the relation's tensors.

Two statistic families, both precomputed once per (relation, rule) pair as in
the paper (§5.2.3: "we precompute a) the group by based on the lhs and the
rhs of the FD rules, and b) a histogram to estimate the selectivity of the
theta-join"):

* **FD group stats**: per-row dirty-group membership (used at query time to
  skip violation checks for rows in clean groups — the Fig. 11 optimization),
  the error count estimate ``epsilon`` and the candidate-set size estimate
  ``p_est`` of Inequality (1).
* **DC partition stats** (``Estimate_Errors``): the theta-join comparison
  matrix is split into ``p`` value-range partitions; per partition pair the
  boundary-range overlap yields an estimated violation count.  At query time
  the ranges overlapping the query answer give the estimated errors, the
  accuracy estimate and the support (checked-diagonal fraction) — Algorithm 2
  lines 3-10.

NOTE on Algorithm 2 line 8: the pseudocode reads "if accuracy > th then full
cleaning", but the Fig. 12 narrative is the reverse ("Daisy predicts a 23%
accuracy, therefore it decides to clean the whole dataset"; the 99%/80%
accurate runs stay partial).  We follow Fig. 12: LOW predicted accuracy
triggers the full clean.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.constraints import DC, FD
from repro_torch.core.detect import detect_fd
from repro_torch.core.relation import Relation


class FDStats(NamedTuple):
    dirty_row: np.ndarray  # (cap,) bool — row belongs to a violating group
    epsilon: int  # number of erroneous (violating-group) rows
    p_est: float  # avg candidate-set size among dirty groups
    n: int  # dataset rows


def fd_stats(rel: Relation, fd: FD) -> FDStats:
    """Precompute the per-rule group-by statistics (host-side arrays)."""
    det = detect_fd(rel, fd, rel.valid)
    dirty = det.violated.cpu().numpy()
    eps = int(dirty.sum())
    distinct = (det.rhs_count > 0).sum(dim=1).cpu().numpy()
    p_est = float(distinct[dirty].mean()) if eps else 1.0
    return FDStats(dirty, eps, p_est, int(rel.num_rows()))


class DCStats(NamedTuple):
    edges: np.ndarray  # (p+1,) partition boundaries over the pivot attribute
    part_rows: np.ndarray  # (p,) rows per partition
    range_vio: np.ndarray  # (p,) estimated violations involving partition
    pivot: str  # partitioning attribute
    n: int


def dc_stats(rel: Relation, dc: DC, p: int = 16) -> DCStats:
    """``Estimate_Errors`` (Algorithm 2 lines 1-7): partition the pivot
    attribute's value range, estimate per-partition-pair conflicts from
    boundary overlaps of the remaining atoms."""
    pivot = dc.atoms[0].left
    vals = {a: rel.columns[a].cpu().numpy() for a in dc.attrs}
    valid = rel.valid.cpu().numpy()
    pv = vals[pivot][valid]
    n = int(valid.sum())
    # quantile partitions over the pivot (the matrix row/col ranges)
    qs = np.linspace(0, 100, p + 1)
    edges = np.percentile(pv, qs)
    edges[-1] = np.nextafter(edges[-1], np.inf)
    part = np.clip(np.searchsorted(edges, pv, side="right") - 1, 0, p - 1)
    part_rows = np.bincount(part, minlength=p)

    # per-partition bounds of every atom attribute
    bounds = {}
    for a in dc.attrs:
        av = vals[a][valid]
        lo = np.full(p, np.inf)
        hi = np.full(p, -np.inf)
        for i in range(p):
            sel = part == i
            if sel.any():
                lo[i] = av[sel].min()
                hi[i] = av[sel].max()
        bounds[a] = (lo, hi)

    def overlap_frac(lo1, hi1, lo2, hi2):
        lo = max(lo1, lo2)
        hi = min(hi1, hi2)
        if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
            return 0.0
        w1 = max(hi1 - lo1, 1e-12)
        w2 = max(hi2 - lo2, 1e-12)
        return ((hi - lo) / w1) * ((hi - lo) / w2)

    range_vio = np.zeros(p)
    for r1 in range(p):
        for r2 in range(p):
            if part_rows[r1] == 0 or part_rows[r2] == 0:
                continue
            frac = 1.0
            for atom in dc.atoms:
                lo1, hi1 = bounds[atom.left][0][r1], bounds[atom.left][1][r1]
                lo2, hi2 = bounds[atom.right][0][r2], bounds[atom.right][1][r2]
                if atom.op in ("<", "<="):
                    possible = lo1 < hi2
                elif atom.op in (">", ">="):
                    possible = hi1 > lo2
                else:
                    possible = (lo1 <= hi2) and (lo2 <= hi1)
                if not possible:
                    frac = 0.0
                    break
                frac *= max(overlap_frac(lo1, hi1, lo2, hi2), 1e-6)
            # estimated conflicts between the two partitions
            range_vio[r1] += frac * part_rows[r1] * part_rows[r2] * 0.5
    return DCStats(edges, part_rows, range_vio, pivot, n)


class Alg2Decision(NamedTuple):
    accuracy: float
    support: float
    estimated_errors: float
    full_clean: bool


def algorithm2_decide(
    stats: DCStats,
    answer_values: np.ndarray,
    answer_size: int,
    support: float,
    threshold: float,
) -> Alg2Decision:
    """Algorithm 2 lines 3-10: given a query answer over the pivot attribute,
    estimate the accuracy of partial cleaning and decide full vs partial.

    ``support`` is the fraction of the scope's comparison space already
    checked — since the work ledger (DESIGN.md §11), the caller passes its
    strip-coverage fraction directly (strips done / total), replacing the
    old diagonal-partition bookkeeping."""
    if answer_size == 0:
        return Alg2Decision(1.0, 1.0, 0.0, False)
    lo, hi = float(answer_values.min()), float(answer_values.max())
    in_range = (stats.edges[:-1] <= hi) & (stats.edges[1:] >= lo)
    # errors from ranges OUTSIDE the answer's ranges (line 5: i != range)
    errors = float(stats.range_vio[~in_range].sum())
    accuracy = answer_size / (answer_size + errors) if (answer_size + errors) else 1.0
    support = min(max(float(support), 0.0), 1.0)
    return Alg2Decision(accuracy, support, errors, accuracy < threshold)
