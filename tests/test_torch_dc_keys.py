"""The DC scan kernel's keys, on the CPU: what ``kernels/dc_pairs.py``
prepares before the launch and decodes after it.

The kernel tests every atom as ``(uint32)(key - lo) <= span`` on int32 keys
and reduces every stat as a min of int32 keys.  These tests hold the keys
against the plain version's own predicates and reductions, bit for bit:

* the range test built from ``partner_keys``, ``row_ranges`` and the dead
  flag gives ``_apply_op``'s truth table, for every op, every dtype pair the
  wrapper takes and a grid of special values (NaN, signed zeros, infinities,
  subnormals, the integer extremes, 2**24 + 1);
* a min of stored stat keys decoded by ``decode_stat`` gives the plain
  version's min or max (``_tile_reduce``, ``extremum``), with the identity
  where no partner holds;
* the whole preparation (``prepare_scan``), an emulation of the kernel's
  loop on those inputs, and ``finish_scan`` give ``dc_pair_scan_plain`` and
  ``dc_role_scan_plain``, for every specialised atom count and the generic
  path.

The file imports no JAX, so it also runs where JAX is not installed."""

import zlib

import numpy as np
import pytest
import torch

from repro_torch.core.constraints import flip_op
from repro_torch.core.detect import _T1_REDUCE
from repro_torch.kernels import dc_pairs
from repro_torch.kernels.dc_scan_check import bits as _bits

torch.set_num_threads(1)

OPS = ["<", "<=", ">", ">=", "==", "!="]
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
SUBNORMAL = np.float32(np.finfo(np.float32).smallest_subnormal)

FLOATS = np.array(
    [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, SUBNORMAL, -SUBNORMAL, 1.0, -1.0, 0.5,
     2.0**24, 2.0**24 + 2, 2.0**31, -(2.0**31), 127.0, -128.0, 32767.0, -32768.0,
     3.0e38, -3.0e38, 1e-30],
    np.float32,
)
INTS = np.array(
    [I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1, 0, -1, 1, 2**24, 2**24 + 1, 2**24 + 2,
     -(2**24 + 1), 127, -128, 126, 32767, -32768, 2**31 - 128, 1000],
    np.int64,
)


def special(dtype: torch.dtype) -> torch.Tensor:
    """The grid of special values, as far as ``dtype`` holds them."""
    if dtype.is_floating_point:
        return torch.from_numpy(FLOATS).to(dtype)
    info = torch.iinfo(dtype)
    vals = INTS[(INTS >= info.min) & (INTS <= info.max)]
    return torch.from_numpy(vals).to(dtype)


DTYPE_PAIRS = [
    (torch.int8, torch.int8), (torch.int16, torch.int16), (torch.int32, torch.int32),
    (torch.int8, torch.int32), (torch.int16, torch.int8), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.int32, torch.float32), (torch.float32, torch.int32), (torch.int8, torch.bfloat16),
    (torch.bfloat16, torch.int16),
]


def _name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pair", DTYPE_PAIRS, ids=lambda p: f"{_name(p[0])}-{_name(p[1])}")
def test_range_test_is_apply_op(pair, op, reduce):
    """Row x (left dtype) against partner y (right dtype): the kernel's range
    test on the prepared keys holds exactly where ``x op y`` does."""
    x, y = special(pair[0]), special(pair[1])
    fl = dc_pairs.atom_is_float(x.dtype, y.dtype)
    keys = dc_pairs.partner_keys(y, fl, reduce)
    lo, span, dead = dc_pairs.row_ranges(x, fl, op, reduce)
    assert keys.dtype == lo.dtype == span.dtype == torch.int32
    got = dc_pairs.in_range(keys[None, :], lo[:, None], span[:, None]) & ~dead[:, None]
    want = dc_pairs._apply_op(x[:, None], op, y[None, :])
    bad = (got != want).nonzero()
    assert bad.numel() == 0, [(x[i].item(), op, y[j].item()) for i, j in bad[:5].tolist()]
    # a dead row holds for no partner of any value of the compare type
    if dead.any():
        wide = special(torch.float32 if fl else torch.int32)
        assert not dc_pairs._apply_op(x[dead][:, None], op, wide[None, :]).any()


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32, torch.bfloat16,
                                   torch.float32], ids=_name)
def test_stat_keys_round_trip(dtype, reduce):
    """The min of the stored stat keys over any subset of partners decodes to
    the plain version's min or max of the values (NaN wins, -0.0 below
    +0.0), and to the dtype's identity over the empty subset."""
    v = special(dtype)
    rng = np.random.default_rng(7)
    hold = torch.from_numpy(rng.random((200, v.numel())) < 0.3)
    hold[0] = False
    hold[1 : 1 + v.numel()] = torch.eye(v.numel(), dtype=torch.bool)
    keys = dc_pairs.partner_keys(v, dtype.is_floating_point, reduce)
    merged = torch.where(hold, keys[None, :], I32_MAX).amin(dim=1)
    count = hold.sum(dim=1, dtype=torch.int32)
    got = dc_pairs.decode_stat(merged, count, dtype, reduce)
    ident = dc_pairs.identity(dtype, reduce)
    want = dc_pairs._tile_reduce(hold, v, ident, reduce)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    # two halves merged by the kernel's min, or decoded apart and merged by
    # the plain version's extremum: the same bits
    halves = [(hold[:, h::2], keys[None, h::2]) for h in (0, 1)]
    mins = [torch.where(m, k, I32_MAX).amin(dim=1) for m, k in halves]
    assert torch.equal(torch.minimum(*mins), merged)
    decoded = [dc_pairs.decode_stat(k, m.sum(dim=1, dtype=torch.int32), dtype, reduce)
               for k, (m, _) in zip(mins, halves)]
    assert torch.equal(_bits(dc_pairs.extremum(*decoded, reduce)), _bits(got))


def test_plan_shares_arrays_and_picks_the_kernel():
    f32, i32 = torch.float32, torch.int32
    # fig12's DC: each role compares and reduces its own two arrays
    plan = dc_pairs.plan_scan([f32, f32], [((0, 1), (0, 1), ["<", ">"], ["max", "min"]),
                                           ((0, 1), (0, 1), [">", "<"], ["min", "max"])])
    assert plan.kernel_atoms == 2 and len(plan.arrays) == 4
    assert plan.cmp_arr == plan.stat_arr == ((0, 1), (2, 3))
    # the same column and reduce in two atoms: one array
    plan = dc_pairs.plan_scan([i32], [((0, 0), (0, 0), ["<", "!="], ["max", "max"])])
    assert plan.arrays == ((0, False, "max"),) and plan.kernel_atoms == 2
    # an int partner in a float atom reduces its exact ints: the generic kernel
    plan = dc_pairs.plan_scan([f32, i32], [((0,), (1,), ["<"], ["max"])])
    assert plan.cmp_arr != plan.stat_arr and plan.kernel_atoms == dc_pairs.MAX_ATOMS
    # more than four atoms: the generic kernel
    plan = dc_pairs.plan_scan([i32] * 5, [(tuple(range(5)), tuple(range(5)), ["<"] * 5,
                                           ["max"] * 5)])
    assert plan.kernel_atoms == dc_pairs.MAX_ATOMS


def emulated_scan(inp, rid, cid):
    """The kernel's loop over the worklist, as dense tensor ops on the
    prepared inputs: a partner holds when it is in scope, is not the row,
    and passes every atom's range test; live rows merge their count and the
    min of their partners' stat keys."""
    block, plan = inp.block, inp.plan
    n_atoms = len(inp.roles[0][2])
    ar = torch.arange(block)
    rows = (torch.as_tensor(rid).long()[:, None] * block + ar).reshape(-1)
    parts = (torch.as_tensor(cid).long()[:, None] * block + ar).reshape(-1)
    for r in range(len(inp.roles)):
        hold = inp.valid[parts].bool()[None, :] & (rows[:, None] != parts[None, :])
        hold &= inp.alive[r, rows].bool()[:, None]
        for a in range(plan.kernel_atoms):
            keys = inp.keys[plan.cmp_arr[r][a] if a < n_atoms else 0][parts]
            hold &= dc_pairs.in_range(keys[None, :], inp.lo[r, a, rows][:, None],
                                      inp.span[r, a, rows][:, None])
        inp.count[r, rows] += hold.sum(dim=1, dtype=torch.int32)
        for a in range(n_atoms):
            keys = inp.keys[plan.stat_arr[r][a]][parts]
            m = torch.where(hold, keys[None, :], I32_MAX).amin(dim=1)
            inp.stat[r, a, rows] = torch.minimum(inp.stat[r, a, rows], m)
    return dc_pairs.finish_scan(inp)


def _col(rng, dtype, n):
    if dtype.is_floating_point:
        vals = rng.choice(np.concatenate([FLOATS, rng.integers(-20, 20, 40).astype(np.float32)]), n)
        return torch.from_numpy(vals.astype(np.float32)).to(dtype)
    info = torch.iinfo(dtype)
    pool = np.concatenate([INTS[(INTS >= info.min) & (INTS <= info.max)],
                           rng.integers(-20, 20, 40)])
    return torch.from_numpy(rng.choice(pool, n)).to(dtype)


# (name, left dtypes, right dtypes, ops, block, worklist restriction)
SCANS = [
    ("1 atom f32", [torch.float32], [torch.float32], ["<"], 16, {}),
    ("2 atoms fig12", [torch.float32, torch.float32], None, ["<", ">"], 32, {}),
    ("3 atoms ints", [torch.int32, torch.int16, torch.int8], [torch.int8, torch.int32, torch.int32],
     ["<=", "!=", ">"], 16, {"rid": [0, 2], "cid": [1, 2, 3]}),
    ("4 atoms bf16", [torch.bfloat16, torch.float32, torch.bfloat16, torch.float32],
     [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16], ["==", "!=", ">=", "<="],
     8, {}),
    ("mixed int32/f32", [torch.int32], [torch.float32], ["<="], 32, {}),
    ("f32/int8 !=", [torch.float32, torch.int8], [torch.int8, torch.float32],
     ["!=", "<"], 1, {}),
    ("8 atoms over 16 columns", [torch.float32, torch.int32, torch.bfloat16, torch.int8] * 2,
     [torch.int16, torch.float32, torch.int32, torch.bfloat16] * 2,
     ["<", "<=", ">", ">=", "!=", "<", "!=", ">="], 16, {"rid": [1], "cid": [0, 1, 3]}),
    ("ragged block 100", [torch.int32], None, ["<"], 100, {}),
]


@pytest.mark.parametrize("both", [True, False], ids=["pair", "role"])
@pytest.mark.parametrize("case", SCANS, ids=[c[0] for c in SCANS])
def test_prepared_scan_matches_plain(case, both):
    """prepare_scan, the emulated kernel loop and finish_scan against the
    plain version, counts and stats bit for bit."""
    name, ldt, rdt, ops, block, restr = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 61 if block <= 32 else 333
    l_cols = [_col(rng, d, n) for d in ldt]
    r_cols = list(l_cols) if rdt is None else [_col(rng, d, n) for d in rdt]
    rs = torch.from_numpy(rng.random(n) < 0.8)
    cs = torch.from_numpy(rng.random(n) < 0.8)
    nb = -(-n // block)
    rid = np.asarray(restr.get("rid", range(nb)), np.int32)
    cid = np.asarray(restr.get("cid", range(nb)), np.int32)
    if both:
        flipped = [flip_op(o) for o in ops]
        red1 = [_T1_REDUCE[o] for o in ops]
        red2 = [_T1_REDUCE[o] for o in flipped]
        want = dc_pairs.dc_pair_scan_plain(l_cols, r_cols, ops, flipped, rs, cs, red1, red2,
                                           block, rid, cid)
    else:  # the role scan takes any reduces: alternate them
        flipped, red1, red2 = None, [("max", "min")[i % 2] for i in range(len(ops))], None
        want = dc_pairs.dc_role_scan_plain(l_cols, r_cols, ops, rs, cs, red1, block, rid, cid)
    inp = dc_pairs.prepare_scan(l_cols, r_cols, ops, flipped, rs, cs, red1, red2, block)
    # the generic kernel: more than 4 atoms, or an integer partner in an
    # atom that compares in float32 (t1's partner is the right side)
    rdt = rdt or ldt
    int_partner = [(l.is_floating_point and not r.is_floating_point)
                   or (both and r.is_floating_point and not l.is_floating_point)
                   for l, r in zip(ldt, rdt)]
    generic = len(ops) > 4 or any(int_partner)
    assert inp.plan.kernel_atoms == (dc_pairs.MAX_ATOMS if generic else len(ops))
    got = emulated_scan(inp, rid, cid)
    assert len(got) == len(want)
    for g, w in zip(got[0::2], want[0::2]):
        assert torch.equal(g, w)
    for gs, ws in zip(got[1::2], want[1::2]):
        for g, w in zip(gs, ws):
            assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))


def test_prepare_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(8, dtype=torch.float32)
    s = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="block"):
        dc_pairs.prepare_scan([x], [x], ["<"], None, s, s, ["max"], None, 2048)
    with pytest.raises(ValueError, match="atoms"):
        dc_pairs.prepare_scan([x] * 9, [x] * 9, ["<"] * 9, None, s, s, ["max"] * 9, None, 8)
    with pytest.raises(ValueError, match="unsupported"):
        dc_pairs.prepare_scan([x.double()], [x.double()], ["<"], None, s, s, ["max"], None, 8)
