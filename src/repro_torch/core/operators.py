"""Query AST + probabilistic execution primitives (paper §4, §5) in PyTorch.

The counterpart of ``repro.core.operators`` for SP and group-by queries:

* **filter**: a tuple qualifies iff >= 1 candidate qualifies
  (``Relation.candidate_matches``);
* **group-by**: expected-value aggregation — each candidate contributes its
  probability mass to its group.

The AST (``Pred``, ``JoinClause``, ``GroupBySpec``, ``Query``) and
``query_fingerprint`` are copied verbatim, so fingerprints agree across the
two packages.  The possible-world join waits for a later slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.relation import CAND_VALUE, Relation
from repro_torch.core.setops import segment_reduce, group_info, unique_counts


# --------------------------------------------------------------------- AST
@dataclasses.dataclass(frozen=True)
class Pred:
    col: str
    op: str
    value: float | int


@dataclasses.dataclass(frozen=True)
class JoinClause:
    right: str  # right table name
    left_on: str
    right_on: str
    right_preds: Tuple[Pred, ...] = ()


@dataclasses.dataclass(frozen=True)
class GroupBySpec:
    keys: Tuple[str, ...]
    agg: str = "count"  # count | sum | avg
    value: Optional[str] = None  # aggregated column (for sum/avg)
    table: Optional[str] = None  # which table the key/value columns live in


@dataclasses.dataclass(frozen=True)
class Query:
    table: str
    preds: Tuple[Pred, ...] = ()
    project: Tuple[str, ...] = ()
    joins: Tuple[JoinClause, ...] = ()
    groupby: Optional[GroupBySpec] = None

    @property
    def attrs(self) -> Tuple[str, ...]:
        out = list(self.project)
        for p in self.preds:
            out.append(p.col)
        for j in self.joins:
            out.append(j.left_on)
            out.append(j.right_on)
            for p in j.right_preds:
                out.append(p.col)
        if self.groupby:
            out.extend(self.groupby.keys)
            if self.groupby.value:
                out.append(self.groupby.value)
        return tuple(dict.fromkeys(out))


# ----------------------------------------------------------- fingerprinting
def _fp_value(v) -> str:
    """Canonical token for a predicate constant: bools/ints by value, floats
    by exact bit pattern (hex), so equal constants always tokenize equally
    while 1 and 1.0000001 never collide."""
    if isinstance(v, (bool, np.bool_)):
        return f"b{int(v)}"
    if isinstance(v, (int, np.integer)):
        return f"i{int(v)}"
    return f"f{float(v).hex()}"


def _fp_preds(preds: Sequence[Pred]) -> List[Tuple[str, str, str]]:
    return sorted((p.col, p.op, _fp_value(p.value)) for p in preds)


def query_fingerprint(query: Query) -> str:
    """Stable fingerprint of a query's logical content (DESIGN.md §9).

    The service cache keys on ``(fingerprint, clean_version)``, so this must
    be deterministic across processes — hashlib over a canonical token
    stream, never ``hash()`` (PYTHONHASHSEED).  Conjunctive predicates are
    order-normalized (AND commutes); join order is preserved because it
    decides capacity truncation and is therefore answer-relevant.
    """
    parts: List[str] = ["T", query.table]
    # projection feeds Query.attrs and hence the planner's rule-overlap
    # decision, so it is state-trajectory-relevant even though it never
    # filters rows; list order is not (attrs dedups into a set check).
    for col in sorted(query.project):
        parts += ["R", col]
    for col, op, val in _fp_preds(query.preds):
        parts += ["P", col, op, val]
    for j in query.joins:
        parts += ["J", j.right, j.left_on, j.right_on]
        for col, op, val in _fp_preds(j.right_preds):
            parts += ["P", col, op, val]
    g = query.groupby
    if g is not None:
        parts += ["G", ",".join(g.keys), g.agg, g.value or "", g.table or ""]
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()[:16]


# ----------------------------------------------------------------- filters
def filter_mask(rel: Relation, preds: Sequence[Pred]) -> torch.Tensor:
    """Possible-world conjunctive filter."""
    mask = rel.valid
    for p in preds:
        mask = mask & rel.candidate_matches(p.col, p.op, p.value)
    return mask


def key_candidates(rel: Relation, attr: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cap, K) candidate values + alive mask for a key.  Rows without an
    overlay expose their primary value as the single candidate; range
    candidates do not participate."""
    col = rel.columns[attr]
    if attr not in rel.cand:
        return col[:, None], rel.valid[:, None]
    cand = rel.cand[attr]
    alive = (rel.ccount[attr] > 0) & (rel.ckind[attr] == CAND_VALUE)
    has = alive.any(dim=1)
    vals = torch.where(
        has[:, None], cand, torch.cat([col[:, None], cand[:, 1:]], dim=1)
    )
    first = torch.zeros_like(alive)
    first[:, 0] = True
    alive = torch.where(has[:, None], alive, first)
    return vals, alive & rel.valid[:, None]


# ---------------------------------------------------------------- group-by
def expected_value(rel: Relation, attr: str) -> torch.Tensor:
    """Per-row expected value of a (possibly probabilistic) numeric column."""
    col = rel.columns[attr].to(torch.float32)
    if attr not in rel.cand:
        return col
    probs = rel.probs(attr)
    vals = torch.where(
        rel.ckind[attr] == CAND_VALUE,
        rel.cand[attr].to(torch.float32),
        col[:, None],
    )
    has = (rel.ccount[attr] > 0).any(dim=1)
    exp = (probs * vals).sum(dim=1)
    return torch.where(has, exp, col)


def groupby_agg(
    rel: Relation,
    mask: torch.Tensor,
    spec: GroupBySpec,
    weights: torch.Tensor | None = None,
) -> Dict[str, torch.Tensor]:
    """Expected-value group-by over (possibly probabilistic) keys: dense
    key columns, per-group weighted count and aggregate, ``num_groups``."""
    base_w = (
        mask.to(torch.float32) if weights is None else torch.where(mask, weights, 0.0)
    )
    vcol = expected_value(rel, spec.value) if spec.value else torch.zeros_like(base_w)

    if len(spec.keys) == 1 and spec.keys[0] in rel.cand:
        attr = spec.keys[0]
        kv, _alive = key_candidates(rel, attr)
        probs = rel.probs(attr)
        has = (rel.ccount[attr] > 0).any(dim=1)
        first = torch.zeros_like(probs)
        first[:, 0] = 1.0
        w = torch.where(has[:, None], probs, first) * base_w[:, None]
        flat_keys = [kv.reshape(-1)]
        flat_w = w.reshape(-1)
        flat_v = torch.repeat_interleave(vcol, kv.shape[1])
        flat_mask = flat_w > 0
    else:
        flat_keys = [rel.columns[a] for a in spec.keys]
        flat_w = base_w
        flat_v = vcol
        flat_mask = mask
    return _finalize_groupby(spec, flat_keys, flat_mask, flat_w, flat_v)


def _finalize_groupby(spec, flat_keys, flat_mask, flat_w, flat_v):
    """Segment-sum per distinct key; unique ``i`` aligns with segment ``i``
    (both dense in sorted key order)."""
    n = flat_keys[0].shape[0]
    gid, _ = group_info(flat_keys, flat_mask)
    wsum = segment_reduce(torch.where(flat_mask, flat_w, 0.0), gid, n, "sum")
    vsum = segment_reduce(torch.where(flat_mask, flat_w * flat_v, 0.0), gid, n, "sum")
    uvals, _, nuniq = unique_counts(flat_keys, flat_mask)
    result = {f"key_{a}": uvals[i] for i, a in enumerate(spec.keys)}
    result["count"] = wsum
    if spec.agg == "sum":
        result["agg"] = vsum
    elif spec.agg == "avg":
        result["agg"] = torch.where(wsum > 0, vsum / torch.clamp(wsum, min=1e-30), 0.0)
    else:
        result["agg"] = wsum
    result["num_groups"] = nuniq
    return result
