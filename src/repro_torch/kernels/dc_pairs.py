"""Blocked theta-join scans for DC violation detection: the CUDA kernel, its
wrappers, and their plain PyTorch versions.

The paper's DC detection partitions the comparison matrix and prunes
partitions whose boundary ranges cannot produce a violation (§4.2).  The
fused both-role scan runs over a worklist of (row-block, col-block) tile
pairs: role t1 evaluates the atoms as written, role t2 the flipped atoms
with the column sides swapped.  For every row it returns the count of
in-scope partners ``j != i`` (by global row id) for which all atoms hold,
and per atom the min or max partner value, or the reduce identity of the
column's own dtype when the count is 0.  The role scan is role t1 alone,
for arbitrary left and right columns.

Three pieces live here, beside each other:

* ``dc_pair_scan`` and ``dc_role_scan`` — the wrappers.  On CPU tensors
  they run the plain versions; on CUDA tensors they launch
  ``csrc/dc_pairs.cu`` (which replaces the TPU kernels
  ``repro/kernels/dc_pairs.py::dc_pair_scan_pallas`` and
  ``dc_role_scan_pallas``; the role scan is the same kernel with role t2
  compiled out) and count the launch in ``LAUNCHES``.  There is no fallback
  from the card to the plain version; ``plain_version()`` forces it
  explicitly for comparisons.
* ``dc_pair_scan_plain`` and ``dc_role_scan_plain`` — the blocked loop of
  the reference oracle (``repro.kernels.ref.dc_role_scan``, twice for the
  pair scan), with XLA's min/max semantics: NaN propagates and -0.0 orders
  below +0.0.
* host helpers shared by both: ``resolve_block_ids``, ``distinct_columns``,
  ``_block_bounds`` and ``_tile_possible`` (the per-tile pruning predicate
  the kernel evaluates on the card).

The kernel library is built with ``nvcc`` at first use into
``repro_torch/_build/`` (git-ignored, ``kernels.build``) and loaded with
``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

MAX_ATOMS = 8
MAX_DISTINCT = 16
_OP_CODE = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_RED_CODE = {"min": 0, "max": 1}
_DTYPE_CODE = {
    torch.int32: 0, torch.float32: 1, torch.int8: 2, torch.int16: 3,
    torch.bfloat16: 4,
}

# launches of the CUDA kernel, counted by the wrapper at each launch
LAUNCHES = {"dc_pair_scan": 0, "dc_role_scan": 0}

_state = threading.local()


def reset_launch_counts() -> None:
    """Zero every kernel launch counter."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_version():
    """Within this context the wrapper runs the plain PyTorch version on
    CUDA tensors too (for holding the kernel against it on the card)."""
    prev = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


# ----------------------------------------------------------------- helpers
def resolve_block_ids(
    nb: int,
    blocks: Optional[Tuple[int, int]] = None,
    block_ids=None,
) -> np.ndarray:
    """Normalize a grid restriction into the sorted, deduped int32 worklist
    side: explicit ``block_ids`` win, else the ``(lo, hi)`` range, else the
    full grid."""
    if block_ids is not None:
        ids = np.unique(np.asarray(block_ids, dtype=np.int32).ravel())
        if ids.size and (ids[0] < 0 or ids[-1] >= nb):
            raise ValueError(f"block ids {ids!r} outside grid [0, {nb})")
        return ids
    if blocks is None:
        return np.arange(nb, dtype=np.int32)
    lo, hi = blocks
    if not (0 <= lo < hi <= nb):
        raise ValueError(f"blocks {blocks!r} outside grid [0, {nb})")
    return np.arange(lo, hi, dtype=np.int32)


def distinct_columns(
    l_cols: Sequence[torch.Tensor], r_cols: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], Tuple[int, ...], Tuple[int, ...]]:
    """Dedup the atom columns by object identity (same-attribute atoms share
    one tensor); returns the distinct list and per-atom indices into it."""
    distinct: List[torch.Tensor] = []
    index: dict = {}

    def at(col):
        key = id(col)
        if key not in index:
            index[key] = len(distinct)
            distinct.append(col)
        return index[key]

    l_idx = tuple(at(c) for c in l_cols)
    r_idx = tuple(at(c) for c in r_cols)
    return distinct, l_idx, r_idx


def identity(dtype: torch.dtype, reduce: str):
    """Reduce identity in the dtype's OWN range (an int8-encoded atom carries
    int8 identities)."""
    if reduce not in ("min", "max"):
        raise ValueError(reduce)
    if dtype.is_floating_point:
        return float("inf") if reduce == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "min" else info.min


def _wide(x: torch.Tensor) -> torch.Tensor:
    """The exact widened comparison type: int32 for integers, float32 for
    floats."""
    return x.to(torch.float32 if x.dtype.is_floating_point else torch.int32)


def _block_bounds(vals, scope, reduce: str, nb: int, block: int) -> torch.Tensor:
    """Scope-masked per-block min or max of a padded column, widened; NaN in
    scope propagates into the bound (``_tile_possible`` then keeps the
    tile).  Out-of-scope blocks get the widened identity."""
    w = _wide(vals)
    masked = torch.where(scope, w, identity(w.dtype, reduce))
    resh = masked.reshape(nb, block)
    return resh.amin(dim=1) if reduce == "min" else resh.amax(dim=1)


def _tile_possible(op, lmin, lmax, rmin, rmax):
    """Can ``l op r`` hold for ANY l in [lmin, lmax], r in [rmin, rmax]?
    Broadcasting over bound tensors.  A NaN bound proves nothing, so the
    tile stays possible."""
    if op == "<":
        ok = lmin < rmax
    elif op == "<=":
        ok = lmin <= rmax
    elif op == ">":
        ok = lmax > rmin
    elif op == ">=":
        ok = lmax >= rmin
    elif op == "==":
        ok = (lmin <= rmax) & (rmin <= lmax)
    elif op == "!=":  # only impossible when both ranges are one singleton
        ok = ~((lmin == lmax) & (rmin == rmax) & (lmin == rmin))
    else:
        raise ValueError(op)
    if lmin.dtype.is_floating_point or rmin.dtype.is_floating_point:
        nan = lmin.isnan() | lmax.isnan() | rmin.isnan() | rmax.isnan()
        ok = ok | nan
    return ok


def _compare_operands(a: torch.Tensor, b: torch.Tensor):
    """Mixed int/float atoms compare in float32, as the reference promotes."""
    if a.dtype.is_floating_point != b.dtype.is_floating_point:
        return a.to(torch.float32), b.to(torch.float32)
    return a, b


def _apply_op(a, op, b):
    a, b = _compare_operands(a, b)
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise ValueError(op)


# ------------------------------------------------------------ plain version
def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key ordering float32 values like XLA's min/max: -0.0 < +0.0
    (NaN is handled apart).  The map is its own inverse."""
    b = x.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def extremum(acc: torch.Tensor, new: torch.Tensor, reduce: str) -> torch.Tensor:
    """Elementwise min/max with XLA semantics (``jnp.minimum``/``maximum``):
    NaN propagates and -0.0 orders below +0.0."""
    if not acc.dtype.is_floating_point:
        return torch.minimum(acc, new) if reduce == "min" else torch.maximum(acc, new)
    a, b = acc.to(torch.float32), new.to(torch.float32)
    ka, kb = _order_key(a), _order_key(b)
    k = torch.minimum(ka, kb) if reduce == "min" else torch.maximum(ka, kb)
    out = torch.where(a.isnan() | b.isnan(), float("nan"), _from_key(k))
    return out.to(acc.dtype)


def _tile_reduce(viol, r_t, ident, reduce: str) -> torch.Tensor:
    """Row-wise min/max of ``r_t`` over the violating partners of a tile,
    with XLA semantics (``jnp.min`` of ``where(viol, r, ident)``)."""
    if not r_t.dtype.is_floating_point:
        vals = torch.where(viol, r_t[None, :], ident)
        return vals.amin(dim=1) if reduce == "min" else vals.amax(dim=1)
    r32 = r_t.to(torch.float32)
    ident_key = _order_key(torch.tensor([ident], dtype=torch.float32)).item()
    keys = torch.where(viol, _order_key(r32)[None, :], ident_key)
    k = keys.amin(dim=1) if reduce == "min" else keys.amax(dim=1)
    has_nan = (viol & r32.isnan()[None, :]).any(dim=1)
    out = torch.where(has_nan, float("nan"), _from_key(k))
    return out.to(r_t.dtype)


def dc_role_scan_plain(l_cols, r_cols, ops, row_scope, col_scope, reduces,
                       block, rid, cid):
    """One role of the reference oracle's blocked loop over col blocks
    (``repro.kernels.ref.dc_role_scan``).  Returns ``(count, stats)``."""
    n = l_cols[0].shape[0]
    dev = row_scope.device
    nb = -(-n // block)
    npad = nb * block
    pad = npad - n
    idents = [identity(r.dtype, red) for r, red in zip(r_cols, reduces)]
    if rid.size == 0 or cid.size == 0:
        return _empty_role(n, r_cols, reduces, dev)

    def padded(x):
        return torch.nn.functional.pad(x, (0, pad)) if pad else x

    cs = padded(col_scope)
    r_pad = [padded(r) for r in r_cols]
    ridx = (
        torch.as_tensor(rid, device=dev).long()[:, None] * block
        + torch.arange(block, device=dev)[None, :]
    ).reshape(-1)
    rs = padded(row_scope)[ridx]
    l_g = [padded(c)[ridx] for c in l_cols]
    m = ridx.shape[0]
    count = torch.zeros((m,), dtype=torch.int32, device=dev)
    stats = [
        torch.full((m,), idents[a], dtype=r_cols[a].dtype, device=dev)
        for a in range(len(ops))
    ]
    ar = torch.arange(block, device=dev)
    for c in cid.tolist():
        sl = c * block
        col_ids = sl + ar
        viol = rs[:, None] & cs[sl:sl + block][None, :] & (ridx[:, None] != col_ids[None, :])
        for lcol, op, r in zip(l_g, ops, r_pad):
            viol = viol & _apply_op(lcol[:, None], op, r[sl:sl + block][None, :])
        count += viol.sum(dim=1, dtype=torch.int32)
        for a, red in enumerate(reduces):
            tile = _tile_reduce(viol, r_pad[a][sl:sl + block], idents[a], red)
            stats[a] = extremum(stats[a], tile, red)
    if rid.size == nb:  # dense row coverage: outputs already in order
        return count[:n], [s[:n] for s in stats]
    count_f, stats_f = _empty_role(npad, r_cols, reduces, dev)
    count_f[ridx] = count
    for s_f, s in zip(stats_f, stats):
        s_f[ridx] = s
    return count_f[:n], [s[:n] for s in stats_f]


def _empty_role(n, r_cols, reduces, dev):
    """Count 0 and the reduce identity everywhere — what a scan gives rows
    outside its worklist or scope."""
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    stats = [
        torch.full((n,), identity(c.dtype, red), dtype=c.dtype, device=dev)
        for c, red in zip(r_cols, reduces)
    ]
    return count, stats


def dc_pair_scan_plain(l_cols, r_cols, ops, flipped, row_scope, col_scope,
                       t1_reduces, t2_reduces, block, rid, cid):
    """The plain PyTorch version of the fused scan: the two role scans of the
    reference oracle (``repro.kernels.ref.dc_pair_scan``).  Returns
    ``(t1_count, t1_stats, t2_count, t2_stats)``."""
    t1c, t1s = dc_role_scan_plain(
        l_cols, r_cols, ops, row_scope, col_scope, t1_reduces, block, rid, cid
    )
    t2c, t2s = dc_role_scan_plain(
        r_cols, l_cols, flipped, row_scope, col_scope, t2_reduces, block, rid, cid
    )
    return t1c, t1s, t2c, t2s


# ------------------------------------------------------------- CUDA kernel
class _DcArgs(ctypes.Structure):
    """Mirror of ``struct DcArgs`` in ``csrc/dc_pairs.cu``."""

    _fields_ = [
        ("cols", ctypes.c_void_p * MAX_DISTINCT),
        ("stat1", ctypes.c_void_p * MAX_ATOMS),
        ("stat2", ctypes.c_void_p * MAX_ATOMS),
        ("bounds", ctypes.c_void_p),
        ("row_scope", ctypes.c_void_p),
        ("col_scope", ctypes.c_void_p),
        ("rid", ctypes.c_void_p),
        ("cid", ctypes.c_void_p),
        ("count1", ctypes.c_void_p),
        ("count2", ctypes.c_void_p),
        ("col_dtype", ctypes.c_int32 * MAX_DISTINCT),
        ("op1", ctypes.c_int32 * MAX_ATOMS),
        ("op2", ctypes.c_int32 * MAX_ATOMS),
        ("red1", ctypes.c_int32 * MAX_ATOMS),
        ("red2", ctypes.c_int32 * MAX_ATOMS),
        ("l_idx", ctypes.c_int32 * MAX_ATOMS),
        ("r_idx", ctypes.c_int32 * MAX_ATOMS),
        ("nrows", ctypes.c_int32),
        ("ncols", ctypes.c_int32),
        ("nb", ctypes.c_int32),
        ("block", ctypes.c_int32),
        ("n_distinct", ctypes.c_int32),
        ("n_atoms", ctypes.c_int32),
    ]


_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.build_library("dc_pairs")))
            for fn in (lib.dc_pair_scan_launch, lib.dc_role_scan_launch):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.dc_args_size.restype = ctypes.c_int
            for fn in (lib.dc_max_atoms, lib.dc_max_distinct):
                fn.restype = ctypes.c_int
            if (
                lib.dc_args_size() != ctypes.sizeof(_DcArgs)
                or lib.dc_max_atoms() != MAX_ATOMS
                or lib.dc_max_distinct() != MAX_DISTINCT
            ):
                raise RuntimeError("csrc/dc_pairs.cu and its ctypes mirror disagree")
            _lib = lib
        return _lib


def block_bounds(distinct, row_scope, col_scope, nb, block) -> torch.Tensor:
    """(4, n_distinct, nb) widened per-block bounds — row min, row max under
    the row scope, col min, col max under the col scope — as raw 32-bit
    words (float bounds bit-cast), the layout the kernel reads."""
    rows = [[_block_bounds(c, row_scope, red, nb, block) for c in distinct]
            for red in ("min", "max")]
    cols = [[_block_bounds(c, col_scope, red, nb, block) for c in distinct]
            for red in ("min", "max")]
    words = [
        torch.stack([b.view(torch.int32) for b in side])
        for side in rows + cols
    ]
    return torch.stack(words).contiguous()


def _scan_cuda(l_cols, r_cols, ops, flipped, row_scope, col_scope,
               t1_reduces, t2_reduces, block, rid, cid):
    """Launch the kernel over the worklist ``rid x cid``: both roles, or role
    t1 alone when ``flipped`` is None (then the t2 outputs are None)."""
    both = flipped is not None
    name = "dc_pair_scan" if both else "dc_role_scan"
    n = l_cols[0].shape[0]
    dev = row_scope.device
    n_atoms = len(ops)
    nb = -(-n // block)
    npad = nb * block
    distinct, l_idx, r_idx = distinct_columns(l_cols, r_cols)
    if n_atoms > MAX_ATOMS or len(distinct) > MAX_DISTINCT:
        raise ValueError(
            f"{name} kernel takes at most {MAX_ATOMS} atoms over "
            f"{MAX_DISTINCT} distinct columns, got {n_atoms} over {len(distinct)}"
        )
    if not 1 <= block <= 1024:
        raise ValueError(f"block {block} outside the kernel's [1, 1024]")
    for c in distinct:
        if c.device != dev or c.dtype not in _DTYPE_CODE or c.dim() != 1:
            raise ValueError(f"unsupported atom column {c.dtype} on {c.device}")
    pad = npad - n

    def padded(x):
        x = torch.nn.functional.pad(x, (0, pad)) if pad else x
        return x.contiguous()

    cols = [padded(c) for c in distinct]
    rs = padded(row_scope.to(torch.bool))
    cs = padded(col_scope.to(torch.bool))
    bounds = block_bounds(cols, rs, cs, nb, block)
    rid_t = torch.as_tensor(rid, dtype=torch.int32, device=dev)
    cid_t = torch.as_tensor(cid, dtype=torch.int32, device=dev)
    count2 = stat2 = None
    if rid.size == nb:
        count1 = torch.empty((npad,), dtype=torch.int32, device=dev)
        stat1 = [torch.empty((npad,), dtype=c.dtype, device=dev) for c in r_cols]
        if both:
            count2 = torch.empty((npad,), dtype=torch.int32, device=dev)
            stat2 = [torch.empty((npad,), dtype=c.dtype, device=dev) for c in l_cols]
    else:  # rows outside the worklist keep count 0 and the identity
        count1, stat1 = _empty_role(npad, r_cols, t1_reduces, dev)
        if both:
            count2, stat2 = _empty_role(npad, l_cols, t2_reduces, dev)

    args = _DcArgs()
    for i, c in enumerate(cols):
        args.cols[i] = c.data_ptr()
        args.col_dtype[i] = _DTYPE_CODE[c.dtype]
    for i in range(n_atoms):
        args.stat1[i] = stat1[i].data_ptr()
        args.op1[i] = _OP_CODE[ops[i]]
        args.red1[i] = _RED_CODE[t1_reduces[i]]
        args.l_idx[i] = l_idx[i]
        args.r_idx[i] = r_idx[i]
        if both:
            args.stat2[i] = stat2[i].data_ptr()
            args.op2[i] = _OP_CODE[flipped[i]]
            args.red2[i] = _RED_CODE[t2_reduces[i]]
    args.bounds = bounds.data_ptr()
    args.row_scope = rs.data_ptr()
    args.col_scope = cs.data_ptr()
    args.rid = rid_t.data_ptr()
    args.cid = cid_t.data_ptr()
    args.count1 = count1.data_ptr()
    args.count2 = count2.data_ptr() if both else None
    args.nrows, args.ncols, args.nb, args.block = len(rid), len(cid), nb, block
    args.n_distinct, args.n_atoms = len(cols), n_atoms
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    launch = lib.dc_pair_scan_launch if both else lib.dc_role_scan_launch
    err = launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    out1 = (count1[:n], [s[:n] for s in stat1])
    if not both:
        return out1
    return out1 + (count2[:n], [s[:n] for s in stat2])


def _use_plain(row_scope: torch.Tensor, name: str) -> bool:
    """CPU tensors, or the ``plain_version()`` context, take the plain
    version; CUDA tensors the kernel; any other device raises."""
    if row_scope.device.type == "cpu" or getattr(_state, "plain", False):
        return True
    if row_scope.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {row_scope.device}")
    return False


def dc_pair_scan(l_cols, r_cols, ops, flipped, row_scope, col_scope,
                 t1_reduces, t2_reduces, block, rid, cid):
    """Fused both-role scan over the worklist ``rid x cid`` (resolved int32
    block-id arrays).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or the plain version inside ``plain_version()``).
    An empty worklist launches nothing and returns counts 0 and the reduce
    identities."""
    if rid.size == 0 or cid.size == 0:
        n, dev = l_cols[0].shape[0], row_scope.device
        t1c, t1s = _empty_role(n, r_cols, t1_reduces, dev)
        t2c, t2s = _empty_role(n, l_cols, t2_reduces, dev)
        return t1c, t1s, t2c, t2s
    args = (l_cols, r_cols, ops, flipped, row_scope, col_scope,
            t1_reduces, t2_reduces, block, rid, cid)
    if _use_plain(row_scope, "dc_pair_scan"):
        return dc_pair_scan_plain(*args)
    return _scan_cuda(*args)


def dc_role_scan(l_cols, r_cols, ops, row_scope, col_scope, reduces, block, rid, cid):
    """Role-t1 scan over the worklist ``rid x cid``: ``(count, stats)``.
    Dispatch as ``dc_pair_scan``; an empty worklist launches nothing."""
    if rid.size == 0 or cid.size == 0:
        return _empty_role(l_cols[0].shape[0], r_cols, reduces, row_scope.device)
    if _use_plain(row_scope, "dc_role_scan"):
        return dc_role_scan_plain(l_cols, r_cols, ops, row_scope, col_scope, reduces,
                                  block, rid, cid)
    return _scan_cuda(l_cols, r_cols, ops, None, row_scope, col_scope, reduces, None,
                      block, rid, cid)
