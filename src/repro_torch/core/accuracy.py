"""Repair accuracy metrics (paper §7: precision / recall / F1) in PyTorch.

precision = correct updates / total updates
recall    = correct updates / total errors

An "update" is a cell whose most-probable repaired value differs from its
original (dirty) value; it is "correct" when it equals the ground truth.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from repro_torch.core.relation import Relation
from repro_torch.core.repair import repaired_value


class Accuracy(NamedTuple):
    precision: float
    recall: float
    f1: float
    updates: int
    correct: int
    errors: int


def repair_accuracy(
    rel: Relation,
    truth: Dict[str, torch.Tensor],
    attrs: Sequence[str] | None = None,
) -> Accuracy:
    """Compare repaired values against ground-truth columns (tensors on the
    relation's device)."""
    attrs = list(attrs or truth.keys())
    updates = correct = errors = 0
    for attr in attrs:
        t = truth[attr]
        orig = rel.orig.get(attr, rel.columns[attr])
        fixed = repaired_value(rel, attr)
        v = rel.valid
        err = (orig != t) & v
        upd = (fixed != orig) & v
        ok = upd & (fixed == t)
        errors += int(err.sum())
        updates += int(upd.sum())
        correct += int(ok.sum())
    precision = correct / updates if updates else 1.0
    recall = correct / errors if errors else 1.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    return Accuracy(precision, recall, f1, updates, correct, errors)
