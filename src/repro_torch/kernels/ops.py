"""Dispatch wrappers for the port's kernels, and the DC atom encodings.

The counterpart of ``repro.kernels.ops``: the single-role ``dc_role_scan``
and the fused ``dc_pair_scan`` (the same signatures, ``TileStats`` launch
telemetry and exactness-proved atom encodings), ``semijoin`` and
``flash_attention``.  Where the reference picks its Pallas kernel or its
jnp oracle by backend, the port picks by the device the tensors live on
(``kernels.dc_pairs``, ``kernels.semijoin``, ``kernels.flash_attention``):
the CUDA kernel on the card, the plain PyTorch version on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import dc_pairs
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import semijoin as _semijoin
from repro_torch.kernels.dc_pairs import distinct_columns, resolve_block_ids


def dc_role_scan(
    l_cols: Sequence[torch.Tensor],
    r_cols: Sequence[torch.Tensor],
    ops: Sequence[str],
    row_scope: torch.Tensor,
    col_scope: torch.Tensor,
    reduces: Sequence[str],
    block: int = 256,
    row_blocks: Tuple[int, int] | None = None,
    col_blocks: Tuple[int, int] | None = None,
    row_block_ids=None,
    col_block_ids=None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One-role DC scan: for every row i in ``row_scope``, the count of
    partners j in ``col_scope`` (j != i) for which every atom
    ``l_cols[a][i] op_a r_cols[a][j]`` holds, and per atom the min or max
    (``reduces[a]``) of ``r_cols[a][j]`` over them.  ``row_blocks=(lo, hi)``
    scans only that strip of row blocks (DESIGN.md §11), ``col_blocks`` the
    partner strip (DESIGN.md §12), and ``row_block_ids`` /
    ``col_block_ids`` an arbitrary block worklist (DESIGN.md §15); rows
    outside get count 0 and the reduce identity.  A strip or id outside the
    grid raises ``ValueError``."""
    n = l_cols[0].shape[0]
    nb = -(-n // block)
    rid = resolve_block_ids(nb, row_blocks, row_block_ids)
    cid = resolve_block_ids(nb, col_blocks, col_block_ids)
    return dc_pairs.dc_role_scan(
        list(l_cols), list(r_cols), list(ops), row_scope, col_scope, list(reduces),
        block, rid, cid,
    )


class TileStats(NamedTuple):
    """Launch geometry + modeled bytes of one DC scan: ``bytes_moved`` is a
    deterministic model computed from the launch geometry and the operand
    dtypes (the reference's model), not a hardware counter."""

    launched: int  # tile pairs in the worklist
    total: int  # tile pairs a dense scan would launch (nb x nb)
    bytes_moved: int  # modeled bytes moved by the launched tiles


def _tile_bytes(
    distinct: Sequence[torch.Tensor],
    l_cols: Sequence[torch.Tensor],
    r_cols: Sequence[torch.Tensor],
    block: int,
) -> int:
    """Modeled per-tile traffic of the fused scan: one row and one col tile
    per DISTINCT atom column, both scopes, scalar bounds, and both roles'
    outputs (the reference's ``ops._tile_bytes``)."""
    col_bytes = sum(block * c.element_size() for c in distinct)
    scope_bytes = 2 * block * 4
    bound_bytes = 4 * sum(c.element_size() for c in distinct)
    out_bytes = (
        2 * block * 4
        + sum(block * c.element_size() for c in r_cols)
        + sum(block * c.element_size() for c in l_cols)
    )
    return 2 * col_bytes + scope_bytes + bound_bytes + out_bytes


class DCPairScanResult(NamedTuple):
    t1_count: torch.Tensor
    t1_stat: Tuple[torch.Tensor, ...]
    t2_count: torch.Tensor
    t2_stat: Tuple[torch.Tensor, ...]
    tiles: TileStats


def dc_pair_scan(
    l_cols: Sequence[torch.Tensor],
    r_cols: Sequence[torch.Tensor],
    ops: Sequence[str],
    flipped: Sequence[str],
    row_scope: torch.Tensor,
    col_scope: torch.Tensor,
    t1_reduces: Sequence[str],
    t2_reduces: Sequence[str],
    block: int = 256,
    row_blocks: Tuple[int, int] | None = None,
    col_blocks: Tuple[int, int] | None = None,
    row_block_ids=None,
    col_block_ids=None,
) -> DCPairScanResult:
    """Fused BOTH-role DC scan over one block worklist: role t1 (atoms as
    written) and role t2 (``flipped`` atoms, column sides swapped).  An
    empty worklist returns identities and launches nothing."""
    n = l_cols[0].shape[0]
    nb = -(-n // block)
    rid = resolve_block_ids(nb, row_blocks, row_block_ids)
    cid = resolve_block_ids(nb, col_blocks, col_block_ids)
    launched = int(rid.size) * int(cid.size)
    distinct, _, _ = distinct_columns(l_cols, r_cols)
    tiles = TileStats(
        launched=launched,
        total=nb * nb,
        bytes_moved=launched * _tile_bytes(distinct, l_cols, r_cols, block),
    )
    t1c, t1s, t2c, t2s = dc_pairs.dc_pair_scan(
        list(l_cols), list(r_cols), list(ops), list(flipped), row_scope,
        col_scope, list(t1_reduces), list(t2_reduces), block, rid, cid,
    )
    return DCPairScanResult(t1c, tuple(t1s), t2c, tuple(t2s), tiles)


# ------------------------------------------------------- compressed encodings
# A column may be scanned in a narrower dtype only when every predicate
# outcome is PROVABLY identical to the int32/float32 original:
#
# * ``code`` — order-preserving dense ranks, for attributes whose every
#              touching atom is a same-attribute ==/!= atom;
# * ``int8`` — identity cast for integer-valued columns within int8 range;
# * ``bf16`` — float columns that round-trip f32 -> bf16 -> f32 exactly;
# * ``orig`` — the always-sound fallback.
#
# Both sides of every atom must land on the SAME kind; the planner demotes
# to a fixpoint.  Planning is host-side numpy, as in the reference.


class ColumnEncoding(NamedTuple):
    kind: str  # "orig" | "int8" | "bf16" | "code"
    table: Optional[np.ndarray]  # code: sorted distinct values (decode table)
    code_dtype: object = None  # code: np.int8/np.int16/np.int32


_ENC_RANK = {"orig": 0, "bf16": 1, "int8": 2, "code": 3}
_NP_TO_TORCH = {np.int8: torch.int8, np.int16: torch.int16, np.int32: torch.int32}


def _bf16_round_trip(arr: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) -> f32, as ``jnp.bfloat16``."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _eligible_kinds(arr: np.ndarray) -> set:
    """Encoding kinds this column alone can prove exact (``code`` depends
    on the atoms and is decided by the planner)."""
    kinds = {"orig"}
    if arr.size == 0:
        return kinds
    if np.issubdtype(arr.dtype, np.integer):
        if arr.min() >= -128 and arr.max() <= 127:
            kinds.add("int8")
        return kinds
    if np.isnan(arr).any():
        return kinds
    if np.all(arr == np.floor(arr)) and arr.min() >= -128 and arr.max() <= 127:
        kinds.add("int8")
    if np.array_equal(_bf16_round_trip(arr).astype(arr.dtype), arr):
        kinds.add("bf16")
    return kinds


def plan_dc_encodings(
    cols: Dict[str, torch.Tensor],
    atoms: Sequence[Tuple[str, str, str]],
) -> Optional[Dict[str, ColumnEncoding]]:
    """Choose one exact encoding per attribute for a DC's atom columns
    (``atoms`` is ``[(left_attr, right_attr, op), ...]``); ``None`` when
    nothing compresses."""
    host = {a: c.cpu().numpy() for a, c in cols.items()}
    eligible = {a: _eligible_kinds(arr) for a, arr in host.items()}
    touching: Dict[str, List[Tuple[str, str, str]]] = {a: [] for a in host}
    for lname, rname, op in atoms:
        touching[lname].append((lname, rname, op))
        if rname != lname:
            touching[rname].append((lname, rname, op))
    for a, arr in host.items():
        if not touching[a]:
            continue
        same_eq = all(
            ln == rn == a and op in ("==", "!=") for ln, rn, op in touching[a]
        )
        no_nan = not (
            np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any()
        )
        if same_eq and no_nan and arr.size:
            eligible[a].add("code")
    enc = {
        a: max(kinds, key=_ENC_RANK.__getitem__) for a, kinds in eligible.items()
    }
    changed = True
    while changed:
        changed = False
        for lname, rname, _ in atoms:
            if enc[lname] == enc[rname]:
                continue
            common = eligible[lname] & eligible[rname]
            cap = min(_ENC_RANK[enc[lname]], _ENC_RANK[enc[rname]])
            k = max(
                (c for c in common if _ENC_RANK[c] <= cap),
                key=_ENC_RANK.__getitem__,
            )
            enc[lname] = enc[rname] = k
            changed = True
    if all(k == "orig" for k in enc.values()):
        return None
    out = {}
    for a, kind in enc.items():
        if kind == "code":
            table = np.unique(host[a])
            cdt = (
                np.int8 if table.size <= 127
                else np.int16 if table.size <= 32767
                else np.int32
            )
            out[a] = ColumnEncoding("code", table, cdt)
        else:
            out[a] = ColumnEncoding(kind, None)
    return out


def encode_column(col: torch.Tensor, enc: ColumnEncoding) -> torch.Tensor:
    if enc.kind == "orig":
        return col
    if enc.kind == "int8":
        return col.to(torch.int8)
    if enc.kind == "bf16":
        return col.to(torch.bfloat16)
    if enc.kind == "code":
        table = torch.as_tensor(enc.table, device=col.device)
        codes = torch.searchsorted(table, col)
        return codes.to(_NP_TO_TORCH[enc.code_dtype])
    raise ValueError(enc.kind)


def decode_stat(
    stat: torch.Tensor,
    count: torch.Tensor,
    enc: ColumnEncoding,
    orig_dtype: torch.dtype,
    reduce: str,
) -> torch.Tensor:
    """Map an encoded extremal-partner stat back to the original value
    space; rows with ``count == 0`` get the original dtype's identity."""
    ident = dc_pairs.identity(orig_dtype, reduce)
    if enc.kind == "orig":
        return stat
    if enc.kind == "code":
        table = torch.as_tensor(enc.table, device=stat.device)
        idx = torch.clamp(stat.to(torch.int64), 0, len(enc.table) - 1)
        dec = table[idx]
    else:
        dec = stat.to(orig_dtype)
    return torch.where(count > 0, dec, torch.tensor(ident, dtype=dec.dtype, device=dec.device))


# ----------------------------------------------------------------- semijoin
# the dispatch lives beside the kernel and its plain version
semijoin = _semijoin.semijoin


# ---------------------------------------------------------- flash attention
# the dispatch lives beside the kernel and its plain versions
flash_attention = _flash.flash_attention
