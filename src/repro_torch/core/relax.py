"""Query result relaxation (paper §4.1, Algorithm 1) in PyTorch.

The counterpart of ``repro.core.relax``: augment an answer mask with the
correlated tuples of an FD — unvisited rows sharing an lhs key, or an rhs
value, with the reached set — to the transitive-closure fixpoint.  The
reference's ``lax.while_loop`` is a bounded Python loop here, with the same
``default_max_iters`` bound and the same ``iterations``/``converged``
bookkeeping.  Membership is the exact sort-merge semijoin
(``setops.member_in``), as in the reference code.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.constraints import FD
from repro_torch.core.relation import Relation
from repro_torch.core.setops import member_in


class RelaxResult(NamedTuple):
    extra: torch.Tensor  # (cap,) bool — total_extra of Algorithm 1
    iterations: int  # rounds until fixpoint
    converged: bool  # fixpoint reached within max_iters


def default_max_iters(capacity: int) -> int:
    return int(math.ceil(math.log2(max(capacity, 2)))) + 2


def relax_fd(
    rel: Relation,
    answer: torch.Tensor,
    fd: FD,
    max_iters: int | None = None,
    use_rhs: bool = True,
) -> RelaxResult:
    """Algorithm 1: compute the correlated extra tuples for ``answer``.

    ``use_rhs=False`` restricts expansion to lhs-sharing only (the Lemma-1
    path the planner takes for rhs-only filters)."""
    iters = max_iters or default_max_iters(rel.capacity)
    lhs_cols = [rel.columns[a] for a in fd.lhs]
    rhs_col = rel.columns[fd.rhs]
    valid = rel.valid
    answer = answer & valid
    reached, unvisited = answer, valid & ~answer
    it, changed = 0, True
    while changed and it < iters:
        # line 6: unvisited tuples sharing an lhs key with the reached set
        extra_l = member_in(lhs_cols, unvisited, lhs_cols, reached)
        unvisited = unvisited & ~extra_l
        reached = reached | extra_l
        changed = bool(extra_l.any())
        if use_rhs:
            # line 8: unvisited tuples sharing an rhs value with the reached set
            extra_r = member_in([rhs_col], unvisited, [rhs_col], reached)
            unvisited = unvisited & ~extra_r
            reached = reached | extra_r
            changed = changed or bool(extra_r.any())
        it += 1
    return RelaxResult(extra=reached & ~answer, iterations=it, converged=not changed)


def lemma2_prob(n: int, num_violations: int, relaxed_size: int) -> float:
    """Lemma 2: P(>=1 violation inside a relaxed result of size |A_R|),
    hypergeometric, computed in log-space."""
    n = int(n)
    v = int(num_violations)
    a = int(relaxed_size)
    if v <= 0 or a <= 0:
        return 0.0
    if a > n - v:
        return 1.0
    log_p0 = (
        math.lgamma(n - v + 1)
        - math.lgamma(n - v - a + 1)
        + math.lgamma(n - a + 1)
        - math.lgamma(n + 1)
    )
    return 1.0 - math.exp(log_p0)


def lemma3_upper_bound(
    dataset_freq: Sequence[torch.Tensor], result_freq: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Lemma 3: R = sum_i (sum_j D_ij - sum_j Dq_ij), a float32 total."""
    total = torch.tensor(0.0, dtype=torch.float32)
    for d, q in zip(dataset_freq, result_freq):
        total = total + d.sum().to(torch.float32).cpu() - q.sum().to(torch.float32).cpu()
    return total
