"""Probabilistic dataset update (paper §4, §6) in PyTorch.

The counterpart of ``repro.core.update``: candidate deltas merge into the
relation's overlay by the Lemma-4 union — counts summed for identical
(value, kind) pairs, same-kind range candidates coalesced to the tighter
bound — and overflow beyond the K slots keeps the K heaviest (a stable
sort of -counts, so ties keep the lower slot first).  Functional like the
reference: a merge returns a new ``Relation`` and leaves its input alone.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core.relation import Relation
from repro_torch.core.repair import Candidates
from repro_torch.kernels.dc_pairs import extremum


def _dedupe_sum(values, counts, kinds):
    """Per-row: merge duplicate slots, zeroing the absorbed one.  Identical
    (value, kind) slots sum counts; same-kind RANGE slots sum counts and
    keep the tighter bound (max for GT, min for LT).  Empty slots never
    match.  Returns the merged ``(values, counts)``."""
    k2 = values.shape[1]
    out_values = values.clone()
    out_counts = counts.clone()
    for i in range(k2):
        for j in range(i + 1, k2):
            vi, vj = out_values[:, i], out_values[:, j]
            ci, cj = out_counts[:, i], out_counts[:, j]
            alive = (ci > 0) & (cj > 0)
            same_kind = kinds[:, i] == kinds[:, j]
            is_range = kinds[:, i] != 0  # CAND_LT / CAND_GT
            same = alive & same_kind & (is_range | (vi == vj))
            tighter = torch.where(
                kinds[:, i] == 2,  # CAND_GT: (bound, +inf) keeps the max bound
                extremum(vi, vj, "max"),
                extremum(vi, vj, "min"),
            )
            out_values[:, i] = torch.where(same & is_range, tighter, vi)
            out_counts[:, i] = torch.where(same, ci + cj, ci)
            out_counts[:, j] = torch.where(same, 0.0, cj)
    return out_values, out_counts


def merge_candidates(a_values, a_counts, a_kinds, b_values, b_counts, b_kinds, k: int):
    """Union-merge two per-row candidate sets, keep the top-k by count."""
    values = torch.cat([a_values, b_values], dim=1)
    counts = torch.cat([a_counts, b_counts], dim=1)
    kinds = torch.cat([a_kinds, b_kinds], dim=1)
    values, counts = _dedupe_sum(values, counts, kinds)
    order = torch.argsort(-counts, dim=1, stable=True)[:, :k]
    return (
        torch.gather(values, 1, order),
        torch.gather(counts, 1, order),
        torch.gather(kinds, 1, order),
    )


def apply_candidates(
    rel: Relation, deltas: Sequence[Tuple[str, Candidates]]
) -> Relation:
    """Merge candidate deltas into the relation's overlay (rows-masked)."""
    cand = dict(rel.cand)
    ccount = dict(rel.ccount)
    ckind = dict(rel.ckind)
    k = rel.k
    for attr, delta in deltas:
        if attr not in cand:
            raise KeyError(
                f"attribute {attr!r} has no overlay; pass it in make_relation(overlay=...)"
            )
        mv, mc, mk = merge_candidates(
            cand[attr], ccount[attr], ckind[attr],
            delta.values, torch.where(delta.rows[:, None], delta.counts, 0.0),
            delta.kinds, k,
        )
        rows = delta.rows[:, None]
        cand[attr] = torch.where(rows, mv, cand[attr])
        ccount[attr] = torch.where(rows, mc, ccount[attr])
        ckind[attr] = torch.where(rows, mk, ckind[attr])
    return dataclasses.replace(rel, cand=cand, ccount=ccount, ckind=ckind)


def mark_checked(rel: Relation, rule_name: str, scope: torch.Tensor) -> Relation:
    """Record that ``scope`` rows have been checked for ``rule_name``."""
    checked = dict(rel.checked)
    prev = checked.get(rule_name)
    if prev is None:
        prev = torch.zeros_like(rel.valid)
    checked[rule_name] = prev | (scope & rel.valid)
    return dataclasses.replace(rel, checked=checked)


def unchecked(rel: Relation, rule_name: str) -> torch.Tensor:
    prev = rel.checked.get(rule_name)
    if prev is None:
        return rel.valid
    return rel.valid & ~prev
