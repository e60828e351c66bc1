"""Query AST + probabilistic execution primitives (paper §4, §5) in PyTorch.

The counterpart of ``repro.core.operators``:

* **filter**: a tuple qualifies iff >= 1 candidate qualifies
  (``Relation.candidate_matches``);
* **join**: a pair qualifies iff the candidate value sets of the join keys
  overlap; lineage is the originating row ids of each pair, kept in a
  ``JoinState`` of fixed capacity with an overflow flag;
* **group-by**: expected-value aggregation — each candidate contributes its
  probability mass to its group.

The AST (``Pred``, ``JoinClause``, ``GroupBySpec``, ``Query``) and
``query_fingerprint`` are copied verbatim, so fingerprints agree across the
two packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.relation import CAND_VALUE, Relation
from repro_torch.core.setops import group_info, lex_order, segment_reduce, unique_counts


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


# ----------------------------------------------------------------- results
@dataclasses.dataclass
class JoinState:
    """Lineage of a (possibly multi-way) join: per-table originating row ids
    for each result pair (the paper's probabilistic-join lineage)."""

    tables: Tuple[str, ...]
    rows: Dict[str, torch.Tensor]  # table -> (cap_out,) int32 row ids
    valid: torch.Tensor  # (cap_out,) bool
    overflow: torch.Tensor  # () bool


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


# -------------------------------------------------------------------- joins
def _overlap_pairs(l_vals, l_alive, mask_l, r_vals, r_alive, mask_r):
    """Every (li, ri) with ``mask_l[li]``, ``mask_r[ri]`` and overlapping
    candidate sets (the possible-world join), as flat ids ``li * n_r + ri``
    sorted row-major (int64, deduplicated).  A sort-merge on the candidate
    values finds them without the dense (n_l, n_r) overlap matrix."""
    dev = l_vals.device
    dtype = torch.promote_types(l_vals.dtype, r_vals.dtype)
    n_r = r_vals.shape[0]
    r_ok = r_alive & mask_r[:, None]
    l_ok = l_alive & mask_l[:, None]
    rv, lv = r_vals.to(dtype), l_vals.to(dtype)
    if dtype.is_floating_point:  # NaN equals nothing
        r_ok, l_ok = r_ok & ~rv.isnan(), l_ok & ~lv.isnan()
    r_row = torch.nonzero(r_ok)[:, 0]
    r_sorted, r_perm = torch.sort(rv[r_ok], stable=True)
    r_row = r_row[r_perm]
    l_idx = torch.nonzero(l_ok)[:, 0]
    l_key = lv[l_ok]
    lo = torch.searchsorted(r_sorted, l_key, right=False)
    hi = torch.searchsorted(r_sorted, l_key, right=True)
    n_match = hi - lo
    total = int(n_match.sum())
    if total == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    owner = torch.repeat_interleave(torch.arange(l_key.shape[0], device=dev), n_match)
    start = torch.cumsum(n_match, 0) - n_match
    pos = lo[owner] + torch.arange(total, device=dev) - start[owner]
    keys = l_idx[owner] * n_r + r_row[pos]
    return torch.unique(keys)


def prob_equijoin(
    l_vals: torch.Tensor,
    l_alive: torch.Tensor,
    mask_l: torch.Tensor,
    r_vals: torch.Tensor,
    r_alive: torch.Tensor,
    mask_r: torch.Tensor,
    cap_out: int,
    row_block: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Possible-world equi-join.  Returns (li, ri, valid, overflow) with
    static output capacity ``cap_out``, exactly as the reference: the left
    rows go in blocks of ``row_block``; each block keeps its first
    ``cap_out`` pairs in row-major order, the blocks' pairs are concatenated
    and cut to ``cap_out``, and the free slots hold ``(n_l, n_r, False)``.
    ``overflow`` says that a block or the total held more than ``cap_out``.
    Only the kept pairs are gathered; the free slots are padded once."""
    n_l, n_r = l_vals.shape[0], r_vals.shape[0]
    dev = l_vals.device
    keys = _overlap_pairs(l_vals, l_alive, mask_l, r_vals, r_alive, mask_r)
    li = keys // n_r
    blk = li // row_block
    # rank of each pair inside its row block (keys are sorted, so blocks are runs)
    first = torch.searchsorted(blk, blk, right=False)
    rank = torch.arange(keys.shape[0], device=dev) - first
    keep = rank < cap_out
    block_over = bool((~keep).any())
    keys = keys[keep]
    overflow = block_over or keys.shape[0] > cap_out
    keys = keys[:cap_out]
    m = keys.shape[0]
    out_li = torch.full((cap_out,), n_l, dtype=torch.int32, device=dev)
    out_ri = torch.full((cap_out,), n_r, dtype=torch.int32, device=dev)
    valid = torch.zeros((cap_out,), dtype=torch.bool, device=dev)
    out_li[:m] = (keys // n_r).to(torch.int32)
    out_ri[:m] = (keys % n_r).to(torch.int32)
    valid[:m] = True
    return out_li, out_ri, valid, torch.tensor(overflow, device=dev)


def dedupe_pairs(li: torch.Tensor, ri: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mark duplicate (li, ri) pairs invalid (keep first occurrence)."""
    n = li.shape[0]
    big = torch.iinfo(torch.int32).max
    k1 = torch.where(valid, li, big)
    k2 = torch.where(valid, ri, big)
    perm = lex_order([k1, k2])
    sk1, sk2 = k1[perm], k2[perm]
    dup = torch.zeros((n,), dtype=torch.bool, device=li.device)
    if n > 1:
        dup[1:] = (sk1[1:] == sk1[:-1]) & (sk2[1:] == sk2[:-1])
    keep = torch.zeros((n,), dtype=torch.bool, device=li.device)
    keep[perm] = ~dup
    return valid & keep


def compact_order(valid: torch.Tensor, cap: int) -> torch.Tensor:
    """The first ``cap`` positions of the stable sort that puts valid slots
    first (the reference's ``argsort(~valid, stable=True)[:cap]``; torch
    sorts no bool, so the key is uint8)."""
    return torch.sort((~valid).to(torch.uint8), stable=True).indices[:cap]


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
