"""Sort-based exact set/group primitives (PyTorch).

The counterpart of ``repro.core.setops``.  The reference sorts several
key columns at once with one stable ``lax.sort``; here the lexicographic
order is a chain of stable single-key ``torch.sort`` calls, last key
first, which yields the same permutation.  Both treat -0.0 and +0.0 as
equal keys and sort NaN last, so the carried payloads land identically.

All functions treat ``mask==False`` rows as absent: their keys are
replaced by a sentinel that sorts last, and outputs for them are
zero/false.  Scatters never see duplicate destinations (each one writes
run starts or a permutation), so every output is deterministic on any
device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core.relation import masked_keys


def lex_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64) of ``keys``."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for key in reversed(keys):
        idx = torch.sort(key[perm], stable=True).indices
        perm = perm[idx]
    return perm


def _runs(sorted_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """(n,) bool: position starts a new distinct key run."""
    n = sorted_keys[0].shape[0]
    new = torch.zeros((n,), dtype=torch.bool, device=sorted_keys[0].device)
    if n == 0:
        return new
    new[0] = True
    if n > 1:
        diff = torch.zeros((n - 1,), dtype=torch.bool, device=new.device)
        for k in sorted_keys:
            diff = diff | (k[1:] != k[:-1])
        new[1:] = diff
    return new


def _run_ids(new_run: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(new_run.to(torch.int32), 0, dtype=torch.int32) - 1


def segment_reduce(values: torch.Tensor, ids: torch.Tensor, n: int, reduce: str):
    """``jax.ops.segment_{sum,min,max}`` over ``n`` segments: empty segments
    take 0 for sums and the dtype's identity for min/max, as in JAX."""
    if reduce == "sum":
        out = torch.zeros((n,), dtype=values.dtype, device=values.device)
        return out.index_add_(0, ids.long(), values)
    info = torch.iinfo(values.dtype)
    fill = info.max if reduce == "amin" else info.min
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, ids.long(), values, reduce=reduce)


def member_in(
    query_cols: Sequence[torch.Tensor],
    query_mask: torch.Tensor,
    set_cols: Sequence[torch.Tensor],
    set_mask: torch.Tensor,
) -> torch.Tensor:
    """Exact multi-column semijoin membership: ``(n_q,) bool`` — whether
    each masked-in query row's key tuple appears among the masked-in set
    rows' key tuples."""
    n_q = query_cols[0].shape[0]
    n_s = set_cols[0].shape[0]
    dev = query_mask.device
    keys = [
        torch.cat([masked_keys(s, set_mask), masked_keys(q, query_mask)])
        for q, s in zip(query_cols, set_cols)
    ]
    # set rows sort before query rows inside an equal-key run (stable)
    perm = lex_order(keys)
    skeys = [k[perm] for k in keys]
    is_set = perm < n_s
    run_id = _run_ids(_runs(skeys))
    has_set = segment_reduce(is_set.to(torch.int32), run_id, n_s + n_q, "amax")
    in_set = (has_set[run_id] > 0) & ~is_set
    out = torch.zeros((n_q,), dtype=torch.bool, device=dev)
    out[perm[~is_set] - n_s] = in_set[~is_set]
    return out & query_mask


def group_info(
    key_cols: Sequence[torch.Tensor], mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group rows by key tuple.  Returns ``(group_id, group_size)`` per row
    (int32); ids are dense in sorted-key order and masked rows share the
    last group, sized over masked-in rows only."""
    n = key_cols[0].shape[0]
    keys = [masked_keys(c, mask) for c in key_cols]
    perm = lex_order(keys)
    run_id = _run_ids(_runs([k[perm] for k in keys]))
    gid = torch.zeros((n,), dtype=torch.int32, device=mask.device)
    gid[perm] = run_id
    mask_i = mask.to(torch.int32)
    gsize = segment_reduce(mask_i[perm], run_id, n, "sum")
    return gid, gsize[gid.long()] * mask_i


def group_distinct_candidates(
    key_cols: Sequence[torch.Tensor],
    value_col: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    weight: torch.Tensor | None = None,
):
    """Per-row distinct values of ``value_col`` within the row's key group
    (the FD repair workhorse).  Returns ``(cand (n,k), count (n,k) float32,
    violated (n,) bool, overflow () bool)`` exactly as the reference."""
    n = key_cols[0].shape[0]
    dev = mask.device
    keys = [masked_keys(c, mask) for c in key_cols] + [masked_keys(value_col, mask)]
    w = (
        mask.to(torch.float32)
        if weight is None
        else torch.where(mask, weight, 0.0)
    )
    perm = lex_order(keys)
    skeys = [key[perm] for key in keys]
    sw = w[perm]
    sval = skeys[-1]
    new_group = _runs(skeys[:-1])
    new_pair = _runs(skeys)
    group_id = _run_ids(new_group)
    pair_id = _run_ids(new_pair)
    pair_count = segment_reduce(sw, pair_id, n, "sum")
    first_pair = segment_reduce(pair_id, group_id, n, "amin")
    slot = pair_id - first_pair[group_id.long()]
    # per-group candidate table, written at pair starts only
    gcand = torch.zeros((n, k), dtype=value_col.dtype, device=dev)
    gcount = torch.zeros((n, k), dtype=torch.float32, device=dev)
    put = new_pair & (slot < k)
    rows, cols = group_id[put].long(), slot[put].long()
    gcand[rows, cols] = sval[put]
    gcount[rows, cols] = pair_count[pair_id[put].long()]
    distinct = segment_reduce(
        torch.where(new_pair, slot + 1, 0).to(torch.int32), group_id, n, "amax"
    )
    overflow = (distinct > k).any()
    row_group = torch.zeros((n,), dtype=torch.int64, device=dev)
    row_group[perm] = group_id.long()
    cand = gcand[row_group]
    count = gcount[row_group]
    violated = (distinct[row_group] >= 2) & mask
    cand = torch.where(mask[:, None], cand, torch.zeros_like(cand))
    count = torch.where(mask[:, None], count, 0.0)
    return cand, count, violated, overflow


def unique_counts(
    cols: Sequence[torch.Tensor], mask: torch.Tensor
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Distinct key tuples (compacted to the front) with their int32
    frequencies; returns ``(values, counts, num_distinct)``."""
    n = cols[0].shape[0]
    keys = [masked_keys(c, mask) for c in cols]
    perm = lex_order(keys)
    skeys = [k[perm] for k in keys]
    new_run = _runs(skeys)
    run_id = _run_ids(new_run)
    # mask==False rows share the sentinel run; count masked-in rows only
    counts = segment_reduce(mask[perm].to(torch.int32), run_id, n, "sum")
    put = new_run & (counts[run_id.long()] > 0)
    dest = run_id[put].long()
    out_vals = []
    for c, sk in zip(cols, skeys):
        v = torch.zeros((n,), dtype=c.dtype, device=c.device)
        v[dest] = sk[put]
        out_vals.append(v)
    out_counts = torch.zeros((n,), dtype=torch.int32, device=mask.device)
    out_counts[dest] = counts[run_id.long()][put]
    num_distinct = (out_counts > 0).sum(dtype=torch.int32)
    return out_vals, out_counts, num_distinct
