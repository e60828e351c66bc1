"""Sharded violation detection over the key-routed shuffle (DESIGN.md §8),
in PyTorch.

The counterpart of ``repro.dist.detect``.  The paper's general-DC
detection is a partitioned theta-join over the comparison space (§4.2).
Here the partitioning is the equality-atom key: a violating pair (t1, t2)
satisfies every atom, so for any equality atom ``t1.a == t2.a`` both rows
agree on ``a``, and hash-routing every row by its combined equality-key
value (``shuffle_by_key``) puts all of a row's potential partners on its
own shard.  The per-shard scans then lose no pair.  The same argument
shards FD detection by the lhs (groups live whole on one shard), and,
through a second routing keyed on the rhs, the swapped P(lhs | rhs)
grouping too.

Correctness invariants (held bit for bit against the reference and the
dense scans by ``tests/test_torch_dist.py``):

* every row appears at most once in the routed layout, so the scans'
  diagonal exclusion still means "never pair a row with itself";
* counts are sums and stats are min/max over a row's partner set, all of
  which lives on the row's shard, so per-shard results equal the dense
  scan's row for row;
* rows outside both scopes are not routed; they get count 0 and the
  reduce identity, as the dense scan gives them.

Skewed keys overflow the shuffle's per-shard capacity; ``_route`` retries
with a doubled capacity factor until the overflow flag clears (a factor of
``n_shards`` cannot overflow, so the loop ends).

``n_shards`` is a logical shard count on one device: the reference's
``vmap`` branch.  Every shard's DC scan runs in ONE launch of the pair-scan
kernel (``kernels.dc_pairs.dc_pair_scan_sharded``), and every shard's FD
group-by in one sort with the shard id as the leading key.  The
reference's ``shard_map`` branch (shards spread over the devices of a
mesh with a data extent above 1) is not ported: ``dist.hints.Mesh``
refuses such a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.constraints import DC, FD, equality_key_attrs, flip_op
from repro_torch.core.detect import _T1_REDUCE, DCDetectResult, FDDetectResult
from repro_torch.core.relation import Relation, masked_keys
from repro_torch.core.setops import group_distinct_candidates
from repro_torch.dist.hints import dp_axes
from repro_torch.dist.shuffle import CAPACITY_FACTOR, shuffle_by_key
from repro_torch.kernels import dc_pairs
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class ShardedDetectInfo:
    """What the routing did: read by the executor's cost model, the
    background cleaner's priority model and the overflow-retry tests."""

    n_shards: int
    capacity_factor: float  # the factor that finally fit
    retries: int  # shuffles beyond the first
    routed_rows: int  # valid rows after routing
    per_shard_rows: List[int]  # routed row count per shard
    dense_pairs: int  # cap^2: the dense scan's comparison space
    sharded_pairs: int  # sum_s rows_s^2: what the shards scanned
    # distinct source ledger strips (DESIGN.md §11) each shard's routed rows
    # came from, when the caller passed its strip size; None otherwise
    per_shard_strips: Optional[List[int]] = None
    # launch geometry of the per-shard scans (DESIGN.md §15): each shard
    # scans the occupied block range of its routed slot prefix.  DC path
    # only (0 for FDs).
    tiles_launched: int = 0
    tiles_total: int = 0


def default_n_shards(mesh) -> int:
    """Logical shard count for a mesh: the data-parallel extent (1 when the
    mesh has no data axes to spread over)."""
    axes = dp_axes(mesh)
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


# ----------------------------------------------------------------- routing
def _transport(col: torch.Tensor) -> torch.Tensor:
    """View a column as int32 for payload transport (bit-exact round trip)."""
    if col.dtype == torch.int32:
        return col
    return col.to(torch.float32).view(torch.int32)


def _untransport(col: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int32:
        return col
    return col.contiguous().view(torch.float32).to(dtype)


def _combine_keys(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Hash-combine key columns into one int32 routing key.

    Equal value tuples give equal keys (a collision merely co-locates
    unrelated keys, which costs capacity, never correctness), so every
    column that is not int32 is viewed as float32 with -0.0 folded onto
    +0.0 before the bit view.  ``h * 1_000_003 ^ c`` wraps in int32."""
    h = None
    for c in cols:
        if c.dtype != torch.int32:
            c = c.to(torch.float32)
            c = torch.where(c == 0.0, torch.zeros_like(c), c)
            ci = c.view(torch.int32)
        else:
            ci = c
        if h is None:
            h = ci
        else:
            prod = torch.bitwise_and(h.to(torch.int64) * 1_000_003, 0xFFFFFFFF)
            h = ((prod ^ 0x80000000) - 0x80000000).to(torch.int32) ^ ci
    return h


def _route(
    key: torch.Tensor,  # (cap,) int32
    payload_cols: Sequence[torch.Tensor],  # (cap,) each, int32-transported
    valid: torch.Tensor,  # (cap,) bool
    mesh,
    n_shards: int,
    capacity_factor: float,
    tracer=None,
):
    """Shuffle rows by key with overflow-retry.  Returns ``(result, factor,
    retries)``; ``result`` has leading dims ``(n_shards, cap_routed)``.
    ``tracer`` spans the routing (``dist.shuffle``) and marks each overflow
    retry with an instant (DESIGN.md §13)."""
    tracer = tracer if tracer is not None else NULL_TRACER
    cap = key.shape[0]
    n_local = -(-cap // n_shards)
    padded = n_shards * n_local
    # a factor >= 1 keeps the routed slot space at least ``padded`` wide
    capacity_factor = max(capacity_factor, 1.0)

    def shard_view(x):
        pad = [0, 0] * (x.dim() - 1) + [0, padded - cap]
        x = torch.nn.functional.pad(x, pad) if padded != cap else x
        return x.reshape((n_shards, n_local) + tuple(x.shape[1:]))

    keys2 = shard_view(key)
    payload2 = shard_view(torch.stack(list(payload_cols), dim=-1))
    valid2 = shard_view(valid)

    factor, retries = capacity_factor, 0
    with tracer.span("dist.shuffle", n_shards=n_shards, rows=int(cap)) as sp:
        while True:
            res = shuffle_by_key(keys2, payload2, valid2, mesh, capacity_factor=factor)
            if not bool(res.overflow) or factor >= n_shards:
                sp.set(retries=retries, capacity_factor=float(factor))
                return res, factor, retries
            factor = min(factor * 2.0, float(n_shards))
            retries += 1
            tracer.instant("dist.shuffle_overflow_retry", capacity_factor=float(factor))


def _unroute(routed: torch.Tensor, src: torch.Tensor, valid: torch.Tensor,
             cap: int, init) -> torch.Tensor:
    """Scatter per-slot results back to the original row order.  ``init``
    fills rows that were never routed (the dense scan's value for them)."""
    flat = routed.reshape((-1,) + tuple(routed.shape[2:]))
    keep = valid.reshape(-1)
    out = torch.full((cap,) + tuple(flat.shape[1:]), init, dtype=flat.dtype,
                     device=flat.device)
    out[src.reshape(-1)[keep].long()] = flat[keep]
    return out


def _info(res, n_shards, factor, retries, cap,
          strip_rows: Optional[int] = None) -> ShardedDetectInfo:
    valid = res.valid.cpu().numpy()
    per_shard = valid.sum(axis=1).astype(np.int64)
    per_shard_strips = None
    if strip_rows:
        # distinct source strips per shard: the routed slots' original row
        # indices, bucketed by the caller's ledger strip grid
        src = res.src.cpu().numpy()
        per_shard_strips = [
            len(np.unique(src[s][valid[s]] // int(strip_rows)))
            for s in range(src.shape[0])
        ]
    return ShardedDetectInfo(
        n_shards=n_shards,
        capacity_factor=factor,
        retries=retries,
        routed_rows=int(per_shard.sum()),
        per_shard_rows=[int(c) for c in per_shard],
        dense_pairs=int(cap) ** 2,
        sharded_pairs=int((per_shard ** 2).sum()),
        per_shard_strips=per_shard_strips,
    )


# ---------------------------------------------------------------- DC path
def detect_dc_sharded_info(
    rel: Relation,
    dc: DC,
    row_scope: torch.Tensor,
    col_scope: torch.Tensor,
    mesh,
    n_shards: Optional[int] = None,
    block: int = 256,
    capacity_factor: float = CAPACITY_FACTOR,
    strip_rows: Optional[int] = None,
    tracer=None,
) -> Tuple[DCDetectResult, ShardedDetectInfo]:
    """Sharded ``detect_dc``: bit-identical to the dense scan for DCs with at
    least one same-attribute equality atom.  Also returns the routing info
    (``strip_rows`` adds the per-shard source-strip report, DESIGN.md §11).
    ``tracer`` spans the shuffle and the shards' scan."""
    tracer = tracer if tracer is not None else NULL_TRACER
    key_attrs = equality_key_attrs(dc)
    if not key_attrs:
        raise ValueError(
            f"DC {dc.name!r} has no same-attribute equality atom — "
            "sharded detection cannot route it; use the dense detect_dc"
        )
    n_shards = n_shards or default_n_shards(mesh)
    if n_shards < 2:
        raise ValueError("n_shards must be >= 2 (use detect_dc on one shard)")

    cap = rel.capacity
    row_scope = row_scope & rel.valid
    col_scope = col_scope & rel.valid
    participate = row_scope | col_scope

    # payload: every atom column (deduped) + the two scope masks
    attrs: List[str] = []
    for a in dc.atoms:
        for name in (a.left, a.right):
            if name not in attrs:
                attrs.append(name)
    dtypes = {name: rel.columns[name].dtype for name in attrs}
    payload_cols = [_transport(rel.columns[name]) for name in attrs]
    payload_cols.append(row_scope.to(torch.int32))
    payload_cols.append(col_scope.to(torch.int32))

    key = _combine_keys([rel.columns[a] for a in key_attrs])
    res, factor, retries = _route(
        key, payload_cols, participate, mesh, n_shards, capacity_factor, tracer=tracer,
    )

    cols = {
        name: _untransport(res.payload[..., i], dtypes[name])
        for i, name in enumerate(attrs)
    }
    rs = (res.payload[..., -2] > 0) & res.valid
    cs = (res.payload[..., -1] > 0) & res.valid

    ops = [a.op for a in dc.atoms]
    flipped = [flip_op(op) for op in ops]
    t1_red = [_T1_REDUCE[op] for op in ops]
    t2_red = [_T1_REDUCE[op] for op in flipped]
    l_names = [a.left for a in dc.atoms]
    r_names = [a.right for a in dc.atoms]
    l_cols = [cols[n] for n in l_names]
    r_cols = [cols[n] for n in r_names]

    # Occupied block range of the routed slot prefix (DESIGN.md §15): the
    # shuffle compacts each shard's rows to slots [0, count_s), so every
    # shard scans blocks [0, hi) with hi sized by the fullest shard.
    cap_routed = int(res.valid.shape[-1])
    nb_local = max(-(-cap_routed // block), 1)
    info = _info(res, n_shards, factor, retries, cap, strip_rows=strip_rows)
    occupancy = max(info.per_shard_rows)
    hi = min(nb_local, max(-(-occupancy // block), 1))
    tiles_launched = n_shards * hi * hi
    tiles_total = n_shards * nb_local * nb_local

    with tracer.span(
        "dist.shard_scan", n_shards=n_shards, tiles_launched=tiles_launched,
        tiles_skipped=tiles_total - tiles_launched,
    ):
        t1c, t1s, t2c, t2s = dc_pairs.dc_pair_scan_sharded(
            l_cols, r_cols, ops, flipped, rs, cs, t1_red, t2_red, block, hi,
        )

    def identity(name, red):
        return dc_pairs.identity(dtypes[name], red)

    t1_count = _unroute(t1c, res.src, res.valid, cap, 0)
    t2_count = _unroute(t2c, res.src, res.valid, cap, 0)
    t1_stat = tuple(
        _unroute(s, res.src, res.valid, cap, identity(n, red))
        for s, n, red in zip(t1s, r_names, t1_red)
    )
    t2_stat = tuple(
        _unroute(s, res.src, res.valid, cap, identity(n, red))
        for s, n, red in zip(t2s, l_names, t2_red)
    )
    distinct = dc_pairs.distinct_columns(l_cols, r_cols)[0]
    per_tile = kops._tile_bytes(distinct, l_cols, r_cols, block)
    det = DCDetectResult(
        t1_count, t2_count, t1_stat, t2_stat,
        tiles_launched=tiles_launched, tiles_total=tiles_total,
        bytes_moved=tiles_launched * per_tile,
    )
    info.tiles_launched = tiles_launched
    info.tiles_total = tiles_total
    return det, info


def detect_dc_sharded(
    rel: Relation,
    dc: DC,
    row_scope: torch.Tensor,
    col_scope: torch.Tensor,
    mesh,
    n_shards: Optional[int] = None,
    block: int = 256,
    capacity_factor: float = CAPACITY_FACTOR,
) -> DCDetectResult:
    det, _ = detect_dc_sharded_info(
        rel, dc, row_scope, col_scope, mesh,
        n_shards=n_shards, block=block, capacity_factor=capacity_factor,
    )
    return det


# ---------------------------------------------------------------- FD path
def _group_per_shard(key_cols, value_col, valid, k):
    """``group_distinct_candidates`` of each shard (row ``s`` of every
    ``(n_shards, cap)`` input), in one pass: the shard id leads the group
    key.  The masking is applied here, shard by shard as the per-shard
    call applies it (out-of-scope slots keep their shard id, so they group
    only within their own shard), and the call sees every slot as in."""
    n_shards, cap = valid.shape
    total = n_shards * cap
    shard = torch.arange(n_shards, dtype=torch.int32, device=valid.device)
    shard = shard[:, None].expand(n_shards, cap).reshape(total)
    m = valid.reshape(total)
    keys = [shard] + [masked_keys(c.reshape(total), m) for c in key_cols]
    values = masked_keys(value_col.reshape(total), m)
    everything = torch.ones_like(m)
    cand, count, violated, overflow = group_distinct_candidates(
        keys, values, everything, k, weight=m.to(torch.float32),
    )
    cand = torch.where(m[:, None], cand, torch.zeros_like(cand))
    count = torch.where(m[:, None], count, 0.0)
    violated = violated & m
    return (
        cand.reshape(n_shards, cap, k), count.reshape(n_shards, cap, k),
        violated.reshape(n_shards, cap), overflow,
    )


def _grouped_candidates_sharded(
    key_cols: Sequence[torch.Tensor],
    value_col: torch.Tensor,
    scope: torch.Tensor,
    k: int,
    mesh,
    n_shards: int,
    capacity_factor: float,
    strip_rows: Optional[int] = None,
    tracer=None,
):
    """Sharded ``group_distinct_candidates``: route rows by the group key so
    each group lives whole on one shard, group per shard, un-route."""
    tracer = tracer if tracer is not None else NULL_TRACER
    cap = value_col.shape[0]
    dtypes = [c.dtype for c in key_cols] + [value_col.dtype]
    payload = [_transport(c) for c in key_cols] + [_transport(value_col)]
    res, factor, retries = _route(
        _combine_keys(key_cols), payload, scope, mesh, n_shards, capacity_factor,
        tracer=tracer,
    )
    n_keys = len(key_cols)
    keys_r = [_untransport(res.payload[..., i], dtypes[i]) for i in range(n_keys)]
    value_r = _untransport(res.payload[..., n_keys], dtypes[n_keys])
    with tracer.span("dist.shard_scan", n_shards=n_shards):
        cand, count, violated, overflow = _group_per_shard(keys_r, value_r, res.valid, k)
    return (
        _unroute(cand, res.src, res.valid, cap, 0),
        _unroute(count, res.src, res.valid, cap, 0.0),
        _unroute(violated, res.src, res.valid, cap, False),
        overflow,
        _info(res, n_shards, factor, retries, cap, strip_rows=strip_rows),
    )


def detect_fd_sharded_info(
    rel: Relation,
    fd: FD,
    scope: torch.Tensor,
    mesh,
    k: Optional[int] = None,
    n_shards: Optional[int] = None,
    capacity_factor: float = CAPACITY_FACTOR,
    strip_rows: Optional[int] = None,
    tracer=None,
) -> Tuple[FDDetectResult, ShardedDetectInfo]:
    """Sharded ``detect_fd``: lhs groups route whole onto one shard; the
    swapped P(lhs | rhs) grouping (one-attribute lhs) takes a second
    routing keyed on the rhs.  Bit-identical to the dense path.
    ``strip_rows`` adds the per-shard strip-coverage report (§11)."""
    k = k or max(rel.k, 2)
    n_shards = n_shards or default_n_shards(mesh)
    if n_shards < 2:
        raise ValueError("n_shards must be >= 2 (use detect_fd on one shard)")
    scope = scope & rel.valid
    lhs_cols = [rel.columns[a] for a in fd.lhs]
    rhs_col = rel.columns[fd.rhs]

    rhs_cand, rhs_count, violated, overflow, info = _grouped_candidates_sharded(
        lhs_cols, rhs_col, scope, k, mesh, n_shards, capacity_factor,
        strip_rows=strip_rows, tracer=tracer,
    )
    lhs_cand = lhs_count = None
    if len(fd.lhs) == 1:
        lhs_cand, lhs_count, _, ovf2, _ = _grouped_candidates_sharded(
            [rhs_col], lhs_cols[0], scope, k, mesh, n_shards, capacity_factor,
            tracer=tracer,
        )
        overflow = overflow | ovf2
    det = FDDetectResult(violated, rhs_cand, rhs_count, lhs_cand, lhs_count, overflow)
    return det, info


def detect_fd_sharded(
    rel: Relation,
    fd: FD,
    scope: torch.Tensor,
    mesh,
    k: Optional[int] = None,
    n_shards: Optional[int] = None,
    capacity_factor: float = CAPACITY_FACTOR,
) -> FDDetectResult:
    det, _ = detect_fd_sharded_info(
        rel, fd, scope, mesh, k=k, n_shards=n_shards, capacity_factor=capacity_factor,
    )
    return det


# ------------------------------------------------------------- reporting
def pair_count_report(n_rows: int, n_shards: int,
                      capacity_factor: float = CAPACITY_FACTOR) -> dict:
    """Capacity-planning arithmetic (DESIGN.md §8): dense against sharded
    comparison-space size under uniform keys.  The sharded scan touches
    ``n_shards * (n_rows / n_shards)^2`` pairs, an ``n_shards``-x saving,
    at the cost of one shuffle of the routed payload."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    per_shard = -(-n_rows // n_shards)
    dense = int(n_rows) ** 2
    sharded = n_shards * per_shard**2
    return {
        "n_rows": int(n_rows),
        "n_shards": int(n_shards),
        "dense_pairs": dense,
        "sharded_pairs_uniform": sharded,
        "pair_savings_x": (dense / sharded) if sharded else 1.0,
        "per_shard_capacity_rows": int(per_shard * capacity_factor),
    }
