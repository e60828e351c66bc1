"""Probabilistic repair (paper §4.1-§4.3) in PyTorch.

The counterpart of ``repro.core.repair``: detection results become
per-attribute candidate overlay deltas.  FD violations get the group's
distinct rhs (and, for a one-attribute lhs, lhs) values with their
frequencies; DC violations get the original value and, per violated
inequality atom, the open range inverting it against all partners, both
weighted by the row's violating-pair count (Example 4's 50/50).  Counts,
not probabilities, are stored so the multi-rule merge is a plain
union-sum (Lemma 4).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.constraints import DC, FD, flip_op
from repro_torch.core.detect import DCDetectResult, FDDetectResult
from repro_torch.core.relation import CAND_GT, CAND_LT, CAND_VALUE, Relation


class Candidates(NamedTuple):
    """Per-row candidate overlay delta for one attribute."""

    values: torch.Tensor  # (cap, K)
    counts: torch.Tensor  # (cap, K) float32; 0 == empty slot
    kinds: torch.Tensor  # (cap, K) int8
    rows: torch.Tensor  # (cap,) bool — rows the delta applies to


def fd_repair_candidates(
    rel: Relation, fd: FD, det: FDDetectResult, scope: torch.Tensor
) -> Tuple[Tuple[str, Candidates], ...]:
    """Candidate deltas per attribute for FD violations inside ``scope``."""
    rows = det.violated & scope & rel.valid
    out = []
    kinds = torch.zeros(det.rhs_cand.shape, dtype=torch.int8, device=rows.device)
    out.append((fd.rhs, Candidates(det.rhs_cand, det.rhs_count, kinds, rows)))
    if det.lhs_cand is not None and len(fd.lhs) == 1:
        lkinds = torch.zeros(det.lhs_cand.shape, dtype=torch.int8, device=rows.device)
        out.append(
            (fd.lhs[0], Candidates(det.lhs_cand, det.lhs_count, lkinds, rows))
        )
    return tuple(out)


# fix kind that inverts a violated atom ``row.x op partner.y`` for ALL partners
_FIX_KIND = {"<": CAND_GT, "<=": CAND_GT, ">": CAND_LT, ">=": CAND_LT}


def _role_candidates(
    rel: Relation,
    attrs: Sequence[str],
    ops: Sequence[str],
    count: torch.Tensor,
    stats: Sequence[torch.Tensor],
    scope: torch.Tensor,
    k: int,
):
    """Original-value + range-fix candidate pair per violated inequality
    atom, both slots weighted by the row's violating-pair count."""
    rows = (count > 0) & scope & rel.valid
    weight = count.to(torch.float32)
    out = []
    for attr, op, stat in zip(attrs, ops, stats):
        if op not in _FIX_KIND:
            continue  # equality atom: no range fix
        col = rel.columns[attr]
        cap = col.shape[0]
        values = torch.zeros((cap, k), dtype=col.dtype, device=col.device)
        counts = torch.zeros((cap, k), dtype=torch.float32, device=col.device)
        kinds = torch.zeros((cap, k), dtype=torch.int8, device=col.device)
        values[:, 0] = col  # original value
        values[:, 1] = stat.to(col.dtype)  # range bound
        counts[:, 0] = weight
        counts[:, 1] = weight
        kinds[:, 1] = _FIX_KIND[op]
        out.append((attr, Candidates(values, counts, kinds, rows)))
    return out


def dc_repair_candidates(
    rel: Relation, dc: DC, det: DCDetectResult, scope: torch.Tensor,
    k: int | None = None,
) -> Tuple[Tuple[str, Candidates], ...]:
    """Candidate deltas for DC violations: both tuple roles (Example 4)."""
    k = k or max(rel.k, 2)
    # role t1: atoms as written — fix on the LEFT attribute of each atom
    t1 = _role_candidates(
        rel, [a.left for a in dc.atoms], [a.op for a in dc.atoms],
        det.t1_count, det.t1_stat, scope, k,
    )
    # role t2: flipped atoms — fix on the RIGHT attribute
    t2 = _role_candidates(
        rel, [a.right for a in dc.atoms], [flip_op(a.op) for a in dc.atoms],
        det.t2_count, det.t2_stat, scope, k,
    )
    return tuple(t1 + t2)


def repaired_value(rel: Relation, attr: str) -> torch.Tensor:
    """Most-probable concrete candidate per cell (ties -> first slot); cells
    without an overlay keep their primary value."""
    if attr not in rel.cand:
        return rel.columns[attr]
    counts = rel.ccount[attr]
    kinds = rel.ckind[attr]
    eff = torch.where(kinds == CAND_VALUE, counts, -1.0)
    best = _first_argmax(eff)
    rows = torch.arange(counts.shape[0], device=counts.device)
    has = (counts > 0).any(dim=1)
    return torch.where(has, rel.cand[attr][rows, best], rel.columns[attr])


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax taking the FIRST maximal slot, as ``jnp.argmax``."""
    k = x.shape[1]
    is_max = x == x.amax(dim=1, keepdim=True)
    slots = torch.arange(k, device=x.device).expand_as(x)
    return torch.where(is_max, slots, k).amin(dim=1)
