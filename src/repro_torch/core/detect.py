"""Violation detection (paper §4.1 FDs, §4.2 general DCs) in PyTorch.

The counterpart of ``repro.core.detect``.  FD detection is the sort-based
group-by: a group violates iff it holds >= 2 distinct rhs values, and the
same pass yields the candidate (value, frequency) tables.  DC detection is
the partitioned theta-join, one fused both-role scan
(``kernels.ops.dc_pair_scan``) — the CUDA kernel on the card.

Every entry of the reference is here: whole-grid scans, strip and
worklist scans (the background cleaner's strip increments), col-range
scans (streaming ingest's deltas, DESIGN.md §12), and the sharded path
(``detect_auto`` with a ``mesh``, DESIGN.md §8), which routes rows by the
rule's equality key (``repro_torch.dist.detect``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.constraints import DC, FD, flip_op
from repro_torch.core.relation import Relation
from repro_torch.core.setops import group_distinct_candidates
from repro_torch.kernels import ops as kops


class FDDetectResult(NamedTuple):
    violated: torch.Tensor  # (cap,) bool — row belongs to a violating group
    rhs_cand: torch.Tensor  # (cap, K) candidate rhs values (group-distinct)
    rhs_count: torch.Tensor  # (cap, K) frequency of each candidate
    lhs_cand: torch.Tensor | None  # (cap, K) candidate lhs values (1-attr lhs)
    lhs_count: torch.Tensor | None
    overflow: torch.Tensor  # () bool — >K distinct candidates somewhere


def detect_fd(
    rel: Relation, fd: FD, scope: torch.Tensor, k: int | None = None
) -> FDDetectResult:
    """Detect FD violations among rows in ``scope`` and compute candidates
    (rhs by lhs group; lhs by rhs group when the lhs is one attribute)."""
    k = k or max(rel.k, 2)
    scope = scope & rel.valid
    lhs_cols = [rel.columns[a] for a in fd.lhs]
    rhs_col = rel.columns[fd.rhs]
    rhs_cand, rhs_count, violated, overflow = group_distinct_candidates(
        lhs_cols, rhs_col, scope, k
    )
    lhs_cand = lhs_count = None
    if len(fd.lhs) == 1:
        lhs_cand, lhs_count, _, ovf2 = group_distinct_candidates(
            [rhs_col], lhs_cols[0], scope, k
        )
        overflow = overflow | ovf2
    return FDDetectResult(violated, rhs_cand, rhs_count, lhs_cand, lhs_count, overflow)


class DCDetectResult(NamedTuple):
    """Per-row DC violation statistics for both tuple roles, plus the launch
    geometry of the scan that produced them."""

    t1_count: torch.Tensor  # (cap,) int32
    t2_count: torch.Tensor  # (cap,) int32
    t1_stat: Tuple[torch.Tensor, ...]  # n_atoms x (cap,)
    t2_stat: Tuple[torch.Tensor, ...]  # n_atoms x (cap,)
    tiles_launched: int = 0
    tiles_total: int = 0
    bytes_moved: int = 0


# For a violating atom ``t1.l op t2.r`` the t1-side fix bound is the max
# (op in {<,<=}) or min (op in {>,>=}) of the partners' r.
_T1_REDUCE = {"<": "max", "<=": "max", ">": "min", ">=": "min", "==": "min", "!=": "min"}


def detect_dc(
    rel: Relation,
    dc: DC,
    row_scope: torch.Tensor,
    col_scope: torch.Tensor,
    block: int = 256,
    row_blocks: Tuple[int, int] | None = None,
    col_blocks: Tuple[int, int] | None = None,
    row_block_ids=None,
    col_block_ids=None,
    encode: bool = True,
) -> DCDetectResult:
    """Detect DC violations between ``row_scope`` rows (role t1) and
    ``col_scope`` rows (role t2), both directions, in one fused scan over
    the block worklist.  ``encode=True`` lets the planner scan narrower
    exact encodings; stats are decoded back, so results are identical."""
    row_scope = row_scope & rel.valid
    col_scope = col_scope & rel.valid
    ops = [a.op for a in dc.atoms]
    reduces = [_T1_REDUCE[op] for op in ops]
    flipped = [flip_op(op) for op in ops]
    t2_reduces = [_T1_REDUCE[op] for op in flipped]

    attrs = {a.left for a in dc.atoms} | {a.right for a in dc.atoms}
    plan = (
        kops.plan_dc_encodings(
            {name: rel.columns[name] for name in attrs},
            [(a.left, a.right, a.op) for a in dc.atoms],
        )
        if encode
        else None
    )
    if plan is not None:
        # one encoded tensor per attribute, so same-attribute atoms share it
        cols = {name: kops.encode_column(rel.columns[name], plan[name]) for name in attrs}
    else:
        cols = {name: rel.columns[name] for name in attrs}
    l_cols = [cols[a.left] for a in dc.atoms]
    r_cols = [cols[a.right] for a in dc.atoms]

    res = kops.dc_pair_scan(
        l_cols, r_cols, ops, flipped, row_scope, col_scope,
        reduces, t2_reduces, block=block,
        row_blocks=row_blocks, col_blocks=col_blocks,
        row_block_ids=row_block_ids, col_block_ids=col_block_ids,
    )
    t1_stat, t2_stat = res.t1_stat, res.t2_stat
    if plan is not None:
        t1_stat = tuple(
            kops.decode_stat(
                s, res.t1_count, plan[a.right], rel.columns[a.right].dtype, red
            )
            for s, a, red in zip(t1_stat, dc.atoms, reduces)
        )
        t2_stat = tuple(
            kops.decode_stat(
                s, res.t2_count, plan[a.left], rel.columns[a.left].dtype, red
            )
            for s, a, red in zip(t2_stat, dc.atoms, t2_reduces)
        )
    return DCDetectResult(
        res.t1_count, res.t2_count, tuple(t1_stat), tuple(t2_stat),
        tiles_launched=res.tiles.launched, tiles_total=res.tiles.total,
        bytes_moved=res.tiles.bytes_moved,
    )


def dc_violation_count(result: DCDetectResult) -> torch.Tensor:
    """Total number of violating ordered pairs (each counted once), int32."""
    return result.t1_count.sum(dtype=torch.int32)


# ------------------------------------------------------------------ dispatch
# The seam between the dense scans above and the sharded path in
# repro_torch.dist.detect (DESIGN.md §8).  The dist imports are lazy: the
# sharded module imports this one.


def will_shard(rule, mesh, n_shards: int | None = None) -> bool:
    """True when ``detect_auto`` takes the sharded path for ``rule`` on
    ``mesh``: the single source of truth for that decision."""
    from repro_torch.core.constraints import equality_key_attrs

    if mesh is None or not equality_key_attrs(rule):
        return False
    if n_shards is not None:
        return n_shards >= 2
    from repro_torch.dist.detect import default_n_shards

    return default_n_shards(mesh) >= 2


class DetectResult(NamedTuple):
    """What a detection dispatch returns: the rule-shaped detection
    (``FDDetectResult`` or ``DCDetectResult``) and the ``ShardedDetectInfo``
    of the routing when the sharded path ran (``None`` on the dense path),
    which the executor feeds to the cost model (DESIGN.md §10)."""

    detection: object  # FDDetectResult | DCDetectResult
    info: object | None  # dist.detect.ShardedDetectInfo | None


def detect_auto(
    rel: Relation,
    rule,
    row_scope: torch.Tensor,
    col_scope: torch.Tensor | None = None,
    *,
    k: int | None = None,
    block: int = 256,
    mesh=None,
    n_shards: int | None = None,
    row_blocks: Tuple[int, int] | None = None,
    col_blocks: Tuple[int, int] | None = None,
    row_block_ids=None,
    col_block_ids=None,
    encode: bool = True,
    strip_rows: int | None = None,
    tracer=None,
) -> DetectResult:
    """The detection entry point: dispatch ``rule`` (FD or DC) to the dense
    or the sharded scan and return a ``DetectResult``.

    With a ``mesh`` and a rule that has an equality key (``will_shard``),
    rows route through ``dist.shuffle.shuffle_by_key`` and scan per logical
    shard, bit-identical to the dense result, with the routing's
    ``ShardedDetectInfo`` attached.  The sharded path ignores
    ``row_blocks`` / ``col_blocks`` / ``*_block_ids`` (strip locality does
    not survive the shuffle; its scopes already shrink to the strip's rows
    and its shards scan only their occupied blocks) and ``encode``;
    ``strip_rows`` feeds its per-shard strip report (DESIGN.md §11) and
    ``tracer`` its ``dist.*`` spans (DESIGN.md §13).

    FD rules use ``row_scope`` as the group-by scope and ``k`` for the
    candidate width; ``col_scope`` (required), ``block`` and the worklist
    arguments are DC-only."""
    if isinstance(rule, FD):
        if will_shard(rule, mesh, n_shards):
            from repro_torch.dist.detect import detect_fd_sharded_info

            det, info = detect_fd_sharded_info(
                rel, rule, row_scope, mesh, k=k, n_shards=n_shards,
                strip_rows=strip_rows, tracer=tracer,
            )
            return DetectResult(det, info)
        return DetectResult(detect_fd(rel, rule, row_scope, k=k), None)
    if isinstance(rule, DC):
        if col_scope is None:
            raise ValueError("detect_auto on a DC requires col_scope")
        if will_shard(rule, mesh, n_shards):
            from repro_torch.dist.detect import detect_dc_sharded_info

            det, info = detect_dc_sharded_info(
                rel, rule, row_scope, col_scope, mesh, n_shards=n_shards,
                block=block, strip_rows=strip_rows, tracer=tracer,
            )
            return DetectResult(det, info)
        return DetectResult(
            detect_dc(
                rel, rule, row_scope, col_scope, block=block,
                row_blocks=row_blocks, col_blocks=col_blocks,
                row_block_ids=row_block_ids, col_block_ids=col_block_ids,
                encode=encode,
            ),
            None,
        )
    raise TypeError(f"detect_auto: unsupported rule type {type(rule).__name__}")



# Deprecated thin aliases (the reference's pre-§12 API): prefer ``detect_auto``.


def detect_dc_auto_info(
    rel: Relation,
    dc: DC,
    row_scope: torch.Tensor,
    col_scope: torch.Tensor,
    block: int = 256,
    mesh=None,
    n_shards: int | None = None,
    row_blocks: Tuple[int, int] | None = None,
    strip_rows: int | None = None,
):
    """Deprecated: ``detect_auto(rel, dc, ...)`` as a ``(detection, info)``
    pair."""
    return tuple(
        detect_auto(
            rel, dc, row_scope, col_scope, block=block, mesh=mesh,
            n_shards=n_shards, row_blocks=row_blocks, strip_rows=strip_rows,
        )
    )


def detect_dc_auto(
    rel: Relation,
    dc: DC,
    row_scope: torch.Tensor,
    col_scope: torch.Tensor,
    block: int = 256,
    mesh=None,
    n_shards: int | None = None,
) -> DCDetectResult:
    """Deprecated: ``detect_auto(rel, dc, ...).detection``."""
    return detect_auto(
        rel, dc, row_scope, col_scope, block=block, mesh=mesh, n_shards=n_shards
    ).detection


def detect_fd_auto_info(
    rel: Relation,
    fd: FD,
    scope: torch.Tensor,
    k: int | None = None,
    mesh=None,
    n_shards: int | None = None,
    strip_rows: int | None = None,
):
    """Deprecated: ``detect_auto(rel, fd, ...)`` as a ``(detection, info)``
    pair."""
    return tuple(
        detect_auto(rel, fd, scope, k=k, mesh=mesh, n_shards=n_shards,
                    strip_rows=strip_rows)
    )


def detect_fd_auto(
    rel: Relation,
    fd: FD,
    scope: torch.Tensor,
    k: int | None = None,
    mesh=None,
    n_shards: int | None = None,
) -> FDDetectResult:
    """Deprecated: ``detect_auto(rel, fd, ...).detection``."""
    return detect_auto(rel, fd, scope, k=k, mesh=mesh, n_shards=n_shards).detection
