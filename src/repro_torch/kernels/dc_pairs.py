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
  the kernel evaluates on the card);
* the kernel's keys, made and decoded by PyTorch passes around the launch:
  ``partner_keys``, ``row_ranges`` (each atom as one range test on int32
  keys), ``decode_stat`` and ``plan_scan`` (which key arrays a launch
  stages, and which kernel instantiation it takes).

The kernel library is built with ``nvcc`` at first use into
``repro_torch/_build/`` (git-ignored, ``kernels.build``) and loaded with
``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

MAX_ATOMS = 8
MAX_DISTINCT = 16
_OP_CODE = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
# the atom column dtypes the kernel takes
_DTYPES = (torch.int32, torch.float32, torch.int8, torch.int16, torch.bfloat16)

# launches of the CUDA kernel, counted by the wrapper at each launch; the
# query service launches from its serving and cleaner threads, so the count
# is taken under a lock
LAUNCHES = {"dc_pair_scan": 0, "dc_role_scan": 0}
_launches_lock = threading.Lock()

_state = threading.local()


def reset_launch_counts() -> None:
    """Zero every kernel launch counter."""
    with _launches_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_version():
    """Within this context the wrapper runs the plain PyTorch version on
    CUDA tensors too (for holding the kernel against it on the card).  The
    switch is the calling thread's: a launch from another thread (a
    background cleaner's) still takes the kernel, so hold the two against
    each other on schedules driven from one thread."""
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


# ------------------------------------------------------- the kernel's keys
# The kernel tests every atom as one range check on int32 keys and reduces
# every stat as a min of int32 keys.  These helpers make the keys from the
# columns before the launch and decode the stat keys to the columns' dtypes
# after it, as PyTorch passes on the tensors' own device; the CPU tests hold
# them against ``_apply_op`` and ``extremum``.
#
# * An atom compares in int32 when both columns are integers, else in
#   float32 (``_compare_operands``).  A partner's compare key is its widened
#   int32, or the order key of its float32 value (``_order_key``: -0.0 one
#   below +0.0).  For a row value x, the partners y with ``x op y`` are one
#   interval of keys, which wraps around for ``!=``; ``row_ranges`` gives its
#   start ``lo`` and ``span`` (its length - 1) so that the test is
#   ``(uint32)(key - lo) <= span``.  -0.0 and +0.0 compare equal: their two
#   keys form one class.  A row for which an atom holds for no partner (NaN
#   under any op but ``!=``, +inf under ``<``, INT32_MAX under ``<`` on ints,
#   ...) is dead: its role writes nothing and keeps count 0.
# * A NaN partner's key is INT32_MIN, outside every interval but ``!=``'s.
# * The stat of an atom reduces the partner's own column: its widened int32,
#   or its float order key.  A max-reduced key is stored bit-inverted, which
#   reverses the order, so the kernel always takes a min and a NaN partner
#   (INT32_MIN) wins either way, as in XLA.  The interval of a max-reduced
#   atom is inverted with its keys.

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1
_U32 = 2**32
_KEY_NEG_INF = -2139095041  # _order_key(-inf)
_KEY_POS_INF = 2139095040  # _order_key(+inf)


def atom_is_float(a_dtype: torch.dtype, b_dtype: torch.dtype) -> bool:
    """An atom over these two column dtypes compares in float32."""
    return a_dtype.is_floating_point or b_dtype.is_floating_point


def partner_keys(col: torch.Tensor, as_float: bool, reduce: str) -> torch.Tensor:
    """The stored int32 key of every value of ``col`` as a partner, for an
    atom that compares in float32 (``as_float``) or int32 and whose stat
    reduces with ``reduce``."""
    if as_float:
        f = col.to(torch.float32)
        k = _order_key(f)
    else:
        k = col.to(torch.int32)
    if reduce == "max":
        k = torch.bitwise_not(k)
    if as_float:
        k = torch.where(f.isnan(), torch.full_like(k, _I32_MIN), k)
    return k.contiguous()


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32."""
    return (torch.remainder(v + 2**31, _U32) - 2**31).to(torch.int32)


def row_ranges(x: torch.Tensor, as_float: bool, op: str, reduce: str):
    """For every row value ``x``, the interval of stored partner keys
    (``partner_keys(.., as_float, reduce)``) that satisfy ``x op y``:
    ``(lo, span, dead)``, ``lo`` and ``span`` int32 (``span`` read as
    uint32), ``dead`` where no partner can satisfy it."""
    if as_float:
        f = x.to(torch.float32)
        k = _order_key(f).to(torch.int64)
        zero = f == 0
        cl_lo, cl_hi = torch.where(zero, -1, k), torch.where(zero, 0, k)
        kmin, kmax = _KEY_NEG_INF, _KEY_POS_INF
    else:
        cl_lo = cl_hi = x.to(torch.int64)
        kmin, kmax = _I32_MIN, _I32_MAX
    if op == "<":
        lo, hi = cl_hi + 1, kmax
    elif op == "<=":
        lo, hi = cl_lo, kmax
    elif op == ">":
        lo, hi = torch.full_like(cl_lo, kmin), cl_lo - 1
    elif op == ">=":
        lo, hi = torch.full_like(cl_lo, kmin), cl_hi
    elif op == "==":
        lo, hi = cl_lo, cl_hi
    elif op == "!=":  # the complement of x's class, wrapping around
        lo, hi = cl_hi + 1, cl_lo - 1 + _U32
    else:
        raise ValueError(op)
    span = hi - lo
    dead = span < 0
    if as_float:
        nan = f.isnan()
        if op == "!=":  # NaN != y holds for every y
            lo = torch.where(nan, 0, lo)
            span = torch.where(nan, _U32 - 1, span)
        else:
            dead = dead | nan
    span = torch.where(dead, 0, span)
    if reduce == "max":  # keys stored as ~k = -1 - k
        lo = -1 - lo - span
    return _wrap32(lo), _wrap32(span), dead


def in_range(keys: torch.Tensor, lo: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """The kernel's atom test ``(uint32)(key - lo) <= (uint32)span``,
    broadcasting."""
    d = torch.remainder(keys.to(torch.int64) - lo.to(torch.int64), _U32)
    return d <= torch.remainder(span.to(torch.int64), _U32)


def decode_stat(key: torch.Tensor, count: torch.Tensor, dtype: torch.dtype,
                reduce: str) -> torch.Tensor:
    """A stat in ``dtype`` from the kernel's min of stored keys: the reduce
    identity where ``count`` is 0, NaN where a NaN partner won."""
    k = key if reduce == "min" else torch.bitwise_not(key)
    if dtype.is_floating_point:
        val = torch.where(key == _I32_MIN, float("nan"), _from_key(k)).to(dtype)
    else:
        val = k.to(dtype)
    return torch.where(count > 0, val, torch.full_like(val, identity(dtype, reduce)))


class ScanPlan(NamedTuple):
    """Which key arrays a launch stages and which each role's atom reads."""

    arrays: Tuple[Tuple[int, bool, str], ...]  # (distinct column, as_float, reduce)
    cmp_arr: Tuple[Tuple[int, ...], ...]  # per role and atom: the compared array
    stat_arr: Tuple[Tuple[int, ...], ...]  # per role and atom: the reduced array
    kernel_atoms: int  # 1-4, or MAX_ATOMS: the generic path


def plan_scan(dtypes: Sequence[torch.dtype], roles) -> ScanPlan:
    """Plan the key arrays of a scan over distinct columns of ``dtypes``;
    ``roles`` holds ``(row_idx, par_idx, ops, reduces)`` per role.  An atom
    whose partner column is an integer but which compares in float32
    reduces another array than it compares (the stat keeps the exact
    integer); such a scan, or one of more than 4 atoms, takes the generic
    kernel."""
    arrays: dict = {}
    cmp_arr, stat_arr = [], []
    split = False
    for row_idx, par_idx, _, reduces in roles:
        cmp, stat = [], []
        for x, p, red in zip(row_idx, par_idx, reduces):
            cmp_spec = (p, atom_is_float(dtypes[x], dtypes[p]), red)
            stat_spec = (p, dtypes[p].is_floating_point, red)
            split = split or cmp_spec != stat_spec
            cmp.append(arrays.setdefault(cmp_spec, len(arrays)))
            stat.append(arrays.setdefault(stat_spec, len(arrays)))
        cmp_arr.append(tuple(cmp))
        stat_arr.append(tuple(stat))
    n_atoms = len(cmp_arr[0])
    kernel_atoms = n_atoms if n_atoms <= 4 and not split else MAX_ATOMS
    return ScanPlan(tuple(arrays), tuple(cmp_arr), tuple(stat_arr), kernel_atoms)


# ------------------------------------------------------------- CUDA kernel
MAX_ARRAYS = 32
_TILE = 256  # partners a shared-memory tile (csrc/dc_pairs.cu DC_TILE)


class _ScanArgs(ctypes.Structure):
    """Mirror of ``struct ScanArgs`` in ``csrc/dc_pairs.cu``."""

    _fields_ = [
        ("keys", ctypes.c_void_p * MAX_ARRAYS),
        ("valid", ctypes.c_void_p),
        ("full", ctypes.c_void_p),
        ("lo", ctypes.c_void_p),
        ("span", ctypes.c_void_p),
        ("alive", ctypes.c_void_p),
        ("bounds", ctypes.c_void_p),
        ("rid", ctypes.c_void_p),
        ("cid", ctypes.c_void_p),
        ("count", ctypes.c_void_p),
        ("stat", ctypes.c_void_p),
        ("cmp_arr", ctypes.c_int32 * (2 * MAX_ATOMS)),
        ("stat_arr", ctypes.c_int32 * (2 * MAX_ATOMS)),
        ("op", ctypes.c_int32 * (2 * MAX_ATOMS)),
        ("row_col", ctypes.c_int32 * (2 * MAX_ATOMS)),
        ("par_col", ctypes.c_int32 * (2 * MAX_ATOMS)),
        ("col_float", ctypes.c_int32 * MAX_DISTINCT),
        ("n_arrays", ctypes.c_int32),
        ("nrows", ctypes.c_int32),
        ("ncols", ctypes.c_int32),
        ("nb", ctypes.c_int32),
        ("block", ctypes.c_int32),
        ("n_distinct", ctypes.c_int32),
        ("n_atoms", ctypes.c_int32),
        ("kernel_atoms", ctypes.c_int32),
        ("chunks", ctypes.c_int32),
        ("pieces", ctypes.c_int32),
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
            for fn in (lib.dc_args_size, lib.dc_max_atoms, lib.dc_max_distinct,
                       lib.dc_max_arrays, lib.dc_tile):
                fn.restype = ctypes.c_int
            if (
                lib.dc_args_size() != ctypes.sizeof(_ScanArgs)
                or lib.dc_max_atoms() != MAX_ATOMS
                or lib.dc_max_distinct() != MAX_DISTINCT
                or lib.dc_max_arrays() != MAX_ARRAYS
                or lib.dc_tile() != _TILE
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


class ScanInputs(NamedTuple):
    """Everything a launch reads and writes, prepared on the columns'
    device: ``count`` zeroed and ``stat`` at INT32_MAX for the kernel to
    merge into."""

    n: int
    nb: int
    block: int
    cols: List[torch.Tensor]  # distinct atom columns, padded to nb * block
    roles: list  # (row_idx, par_idx, ops, reduces) per role
    plan: ScanPlan
    keys: List[torch.Tensor]  # (npad,) int32 per plan array
    valid: torch.Tensor  # (npad,) int32 col scope
    full: torch.Tensor  # (nb, tiles a block) uint8: every partner of the tile in scope
    lo: torch.Tensor  # (roles, kernel_atoms, npad) int32
    span: torch.Tensor  # (roles, kernel_atoms, npad) int32
    alive: torch.Tensor  # (roles, npad) uint8
    bounds: torch.Tensor  # (4, n_distinct, nb) block_bounds
    count: torch.Tensor  # (roles, npad) int32
    stat: torch.Tensor  # (roles, kernel_atoms, npad) int32


def prepare_scan(l_cols, r_cols, ops, flipped, row_scope, col_scope,
                 t1_reduces, t2_reduces, block) -> ScanInputs:
    """The kernel's inputs: both roles, or role t1 alone when ``flipped`` is
    None.  Raises on what the kernel does not take."""
    name = "dc_role_scan" if flipped is None else "dc_pair_scan"
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
        if c.device != dev or c.dtype not in _DTYPES or c.dim() != 1:
            raise ValueError(f"unsupported atom column {c.dtype} on {c.device}")
    pad = npad - n

    def padded(x):
        x = torch.nn.functional.pad(x, (0, pad)) if pad else x
        return x.contiguous()

    cols = [padded(c) for c in distinct]
    rs = padded(row_scope.to(torch.bool))
    cs = padded(col_scope.to(torch.bool))
    roles = [(l_idx, r_idx, ops, t1_reduces)]
    if flipped is not None:
        roles.append((r_idx, l_idx, flipped, t2_reduces))
    plan = plan_scan([c.dtype for c in cols], roles)
    kn, nr = plan.kernel_atoms, len(roles)
    lo = torch.zeros((nr, kn, npad), dtype=torch.int32, device=dev)
    span = torch.full((nr, kn, npad), -1, dtype=torch.int32, device=dev)  # unused atoms hold
    alive = rs.repeat(nr, 1)
    for r, (row_idx, par_idx, role_ops, reduces) in enumerate(roles):
        for a in range(n_atoms):
            x = cols[row_idx[a]]
            fl = atom_is_float(x.dtype, cols[par_idx[a]].dtype)
            lo[r, a], span[r, a], dead = row_ranges(x, fl, role_ops[a], reduces[a])
            alive[r] &= ~dead
    return ScanInputs(
        n=n, nb=nb, block=block, cols=cols, roles=roles, plan=plan,
        keys=[partner_keys(cols[d], fl, red) for d, fl, red in plan.arrays],
        valid=cs.to(torch.int32), full=_full_tiles(cs, nb, block), lo=lo, span=span,
        alive=alive.to(torch.uint8), bounds=block_bounds(cols, rs, cs, nb, block),
        count=torch.zeros((nr, npad), dtype=torch.int32, device=dev),
        stat=torch.full((nr, kn, npad), _I32_MAX, dtype=torch.int32, device=dev),
    )


def _full_tiles(cs: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """Per col block and kernel tile of ``_TILE`` partners, whether every
    partner lies in the col scope (the kernel then skips the scope test)."""
    nsub = -(-block // _TILE)
    per = torch.nn.functional.pad(cs.reshape(nb, block), (0, nsub * _TILE - block), value=True)
    return per.reshape(nb, nsub, _TILE).all(dim=2).to(torch.uint8).contiguous()


def finish_scan(inp: ScanInputs):
    """Decode the merged counts and stat keys: ``(count, stats)`` per role,
    flattened."""
    out = []
    for r, (_, par_idx, _, reduces) in enumerate(inp.roles):
        c = inp.count[r, :inp.n]
        out += [c, [decode_stat(inp.stat[r, a, :inp.n], c, inp.cols[par_idx[a]].dtype, red)
                    for a, red in enumerate(reduces)]]
    return tuple(out)


def _scan_cuda(l_cols, r_cols, ops, flipped, row_scope, col_scope,
               t1_reduces, t2_reduces, block, rid, cid, chunks=None):
    """Launch the kernel over the worklist ``rid x cid``: both roles, or role
    t1 alone when ``flipped`` is None.  ``chunks`` fixes the number of col
    chunks, which changes no bit of the result (default: fill the card)."""
    inp = prepare_scan(l_cols, r_cols, ops, flipped, row_scope, col_scope,
                       t1_reduces, t2_reduces, block)
    both = flipped is not None
    name = "dc_pair_scan" if both else "dc_role_scan"
    dev = row_scope.device
    plan, n_atoms = inp.plan, len(ops)
    rid_t = torch.as_tensor(rid, dtype=torch.int32, device=dev)
    cid_t = torch.as_tensor(cid, dtype=torch.int32, device=dev)
    args = _ScanArgs()
    for i, k in enumerate(inp.keys):
        args.keys[i] = k.data_ptr()
    for i, c in enumerate(inp.cols):
        args.col_float[i] = int(c.dtype.is_floating_point)
    for r, (row_idx, par_idx, role_ops, _) in enumerate(inp.roles):
        for a in range(n_atoms):  # the generic kernel's unused atoms read array 0
            at = r * MAX_ATOMS + a
            args.cmp_arr[at], args.stat_arr[at] = plan.cmp_arr[r][a], plan.stat_arr[r][a]
            args.op[at] = _OP_CODE[role_ops[a]]
            args.row_col[at], args.par_col[at] = row_idx[a], par_idx[a]
    args.valid, args.full = inp.valid.data_ptr(), inp.full.data_ptr()
    args.lo, args.span = inp.lo.data_ptr(), inp.span.data_ptr()
    args.alive, args.bounds = inp.alive.data_ptr(), inp.bounds.data_ptr()
    args.rid, args.cid = rid_t.data_ptr(), cid_t.data_ptr()
    args.count, args.stat = inp.count.data_ptr(), inp.stat.data_ptr()
    args.n_arrays, args.nrows, args.ncols = len(inp.keys), len(rid), len(cid)
    args.nb, args.block, args.n_distinct = inp.nb, block, len(inp.cols)
    args.n_atoms, args.kernel_atoms = n_atoms, plan.kernel_atoms
    args.chunks = int(chunks or 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    launch = lib.dc_pair_scan_launch if both else lib.dc_role_scan_launch
    err = launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _launches_lock:
        LAUNCHES[name] += 1
    return finish_scan(inp)


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
