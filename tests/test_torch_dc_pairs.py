"""The fused both-role DC pair scan: the port's plain PyTorch version (what
the wrapper runs on CPU tensors) against the reference's jnp oracle, and
once against the reference's Pallas kernel in interpret mode.

Counts and stats are compared exactly, stats by bit pattern, so NaN
propagation under ``!=`` and the sign of a zero extremum are pinned too.
The CUDA kernel itself is held against the plain version by
``tests/test_torch_cuda.py`` (marked ``gpu``) and by ``chip_smoke.py``."""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.constraints import flip_op
from repro.core.detect import _T1_REDUCE
from repro.kernels import ops as jops
from repro_torch.kernels import dc_pairs
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

SETTINGS = dict(max_examples=10, deadline=None)
OPS = ["<", "<=", ">", ">=", "==", "!="]


def host(x):
    x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return x


def same_scan(ref, port):
    """Both roles' counts and stats, exactly (stats by bit pattern)."""
    pairs = [(ref.t1_count, port.t1_count), (ref.t2_count, port.t2_count)]
    pairs += list(zip(ref.t1_stat, port.t1_stat)) + list(zip(ref.t2_stat, port.t2_stat))
    for r, p in pairs:
        r = np.asarray(r.astype(jnp.float32) if r.dtype == jnp.bfloat16 else r)
        p = host(p)
        assert r.dtype == p.dtype, (r.dtype, p.dtype)
        if r.dtype.kind == "f":
            assert np.array_equal(np.isnan(r), np.isnan(p))
            r, p = np.where(np.isnan(r), 0, r), np.where(np.isnan(p), 0, p)
            np.testing.assert_array_equal(np.signbit(r), np.signbit(p))
        np.testing.assert_array_equal(r, p)
    assert ref.tiles == port.tiles


def scan_both(cols_l, cols_r, ops, rs, cs, block, force="ref", **restr):
    """Run the reference (``force``) and the port on the same numpy inputs;
    columns shared between the sides stay shared (one array object)."""
    flipped = [flip_op(o) for o in ops]
    red1 = [_T1_REDUCE[o] for o in ops]
    red2 = [_T1_REDUCE[o] for o in flipped]
    jmap, tmap = {}, {}

    def conv(a):
        if id(a) not in jmap:
            jmap[id(a)] = jnp.asarray(a)
            t = torch.from_numpy(np.ascontiguousarray(a))
            tmap[id(a)] = t
        return jmap[id(a)], tmap[id(a)]

    jl, tl = zip(*[conv(a) for a in cols_l])
    jr, tr = zip(*[conv(a) for a in cols_r])
    ref = jops.dc_pair_scan(
        list(jl), list(jr), ops, flipped, jnp.asarray(rs), jnp.asarray(cs),
        red1, red2, block=block, force=force, **restr,
    )
    port = tops.dc_pair_scan(
        list(tl), list(tr), ops, flipped, torch.from_numpy(rs), torch.from_numpy(cs),
        red1, red2, block=block, **restr,
    )
    return ref, port


N_ROWS, BLOCK = 80, 16


@given(st.integers(0, 2**31 - 1), st.sampled_from(OPS), st.sampled_from(OPS))
@settings(**SETTINGS)
def test_sparse_worklists_match_oracle(seed, op1, op2):
    """TestDCPairsBlockSparse's property: random row and col worklists,
    partial scopes, duplicate values; two atoms over two columns."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, N_ROWS).astype(np.int32)
    b = rng.integers(0, 4, N_ROWS).astype(np.int32)
    rs = rng.random(N_ROWS) < 0.7
    cs = rng.random(N_ROWS) < 0.7
    nb = N_ROWS // BLOCK
    rows = np.flatnonzero(rng.random(nb) < 0.5).astype(np.int32)
    cols = np.flatnonzero(rng.random(nb) < 0.7).astype(np.int32)
    same_scan(*scan_both([a, b], [a, b], [op1, op2], rs, cs, BLOCK,
                         row_block_ids=rows, col_block_ids=cols))


@pytest.mark.parametrize("restr", [
    dict(row_block_ids=np.array([], np.int32)),  # all checked: no launch
    dict(col_block_ids=np.array([], np.int32)),
    dict(row_block_ids=np.arange(5, dtype=np.int32)),  # all cold
    dict(row_blocks=(1, 3)),  # contiguous strip
    dict(col_blocks=(2, 5)),  # partner strip
    {},  # dense
])
def test_worklist_shapes(restr):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 9, N_ROWS).astype(np.int32)
    rs = rng.random(N_ROWS) < 0.8
    cs = rng.random(N_ROWS) < 0.8
    ref, port = scan_both([a], [a], ["<="], rs, cs, BLOCK, **restr)
    same_scan(ref, port)


def test_empty_worklist_identities_and_no_launch():
    a = np.arange(48, dtype=np.int32)
    ones = np.ones(48, bool)
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    ref, port = scan_both([a], [a], ["<"], ones, ones, 16,
                          row_block_ids=np.array([], np.int32))
    same_scan(ref, port)
    assert port.tiles.launched == 0
    assert not port.t1_count.any()
    assert (port.t1_stat[0] == np.iinfo(np.int32).min).all()
    assert (port.t2_stat[0] == np.iinfo(np.int32).max).all()
    assert dc_pairs.LAUNCHES["dc_pair_scan"] == before


@pytest.mark.parametrize("n", [1, 255, 300, 513])
def test_ragged_n_full_block(n):
    """n not a multiple of the 256-row block, the executor's block size."""
    rng = np.random.default_rng(n)
    price = rng.uniform(0, 100, n).astype(np.float32)
    disc = (100 - price + rng.normal(0, 8, n)).astype(np.float32)
    rs = rng.random(n) < 0.9
    ref, port = scan_both([price, disc], [price, disc], ["<", ">"], rs, np.ones(n, bool), 256)
    same_scan(ref, port)


@pytest.mark.parametrize("dtype", ["int8", "int16", "bf16", "int32", "float32"])
def test_every_encoding_dtype(dtype):
    """The operand dtypes the encodings produce carry their own identities
    (int8 127/-128, int16 32767/-32768, bf16 +-inf) through both roles."""
    rng = np.random.default_rng(7)
    n = 70
    if dtype == "bf16":
        vals = (rng.integers(-40, 40, n) / 4).astype(np.float32)
        col = torch.from_numpy(vals).to(torch.bfloat16)
        jcol = jnp.asarray(vals).astype(jnp.bfloat16)
    else:
        np_dt = {"int8": np.int8, "int16": np.int16, "int32": np.int32, "float32": np.float32}[dtype]
        vals = rng.integers(-100, 100, n).astype(np_dt)
        col, jcol = torch.from_numpy(vals), jnp.asarray(vals)
    rs, cs = rng.random(n) < 0.5, rng.random(n) < 0.6
    ops = ["<", "!="]
    flipped = [flip_op(o) for o in ops]
    red1, red2 = [_T1_REDUCE[o] for o in ops], [_T1_REDUCE[o] for o in flipped]
    ref = jops.dc_pair_scan([jcol, jcol], [jcol, jcol], ops, flipped, jnp.asarray(rs),
                            jnp.asarray(cs), red1, red2, block=32, force="ref")
    port = tops.dc_pair_scan([col, col], [col, col], ops, flipped, torch.from_numpy(rs),
                             torch.from_numpy(cs), red1, red2, block=32)
    assert port.t1_stat[0].dtype == col.dtype
    same_scan(ref, port)


def test_nan_and_signed_zero_stats():
    """A NaN partner enters a stat only through ``!=`` and then wins the
    min/max, as ``jnp.min``; among zeros -0.0 is the min, +0.0 the max."""
    special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf], np.float32)
    rng = np.random.default_rng(11)
    n = 64
    x = rng.choice(special, n)
    y = rng.choice(special, n)
    rs, cs = rng.random(n) < 0.9, rng.random(n) < 0.9
    for ops in (["!="], ["!=", "<"], ["<=", ">="], ["==", "!="]):
        cols = [x, y][: len(ops)]
        same_scan(*scan_both(cols, cols, ops, rs, cs, 16))
    zeros = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    ref, port = scan_both([zeros], [zeros], ["<="], np.ones(4, bool), np.ones(4, bool), 4)
    same_scan(ref, port)


def test_interpret_mode_pallas_kernel():
    """One affordable case against the reference's Pallas kernel itself
    (interpret mode): two float atoms, sparse rows, partial scopes."""
    rng = np.random.default_rng(5)
    n = 48
    a = rng.uniform(0, 10, n).astype(np.float32)
    b = rng.uniform(0, 10, n).astype(np.float32)
    rs, cs = rng.random(n) < 0.8, rng.random(n) < 0.8
    same_scan(*scan_both([a, b], [a, b], ["<", ">="], rs, cs, 16, force="interpret",
                         row_block_ids=np.array([0, 2], np.int32)))


def test_tile_possible_is_sound():
    """Every tile the bounds rule out holds no violating pair — also with NaN
    in scope, where a NaN bound keeps the tile."""
    rng = np.random.default_rng(3)
    special = np.array([np.nan, 0.0, -0.0, 1.0, 2.0, 3.0], np.float32)
    block, nb = 8, 6
    n = block * nb
    for trial in range(6):
        v = torch.from_numpy(rng.choice(special, n) if trial % 2 else
                             rng.integers(0, 4, n).astype(np.float32))
        rs = torch.from_numpy(rng.random(n) < 0.8)
        cs = torch.from_numpy(rng.random(n) < 0.8)
        bounds = [dc_pairs._block_bounds(v, s, red, nb, block)
                  for s, red in ((rs, "min"), (rs, "max"), (cs, "min"), (cs, "max"))]
        for op in OPS:
            ok = dc_pairs._tile_possible(op, bounds[0][:, None], bounds[1][:, None],
                                         bounds[2][None, :], bounds[3][None, :])
            for r, c in zip(*np.nonzero(~ok.numpy())):
                t1c, _, _, _ = dc_pairs.dc_pair_scan_plain(
                    [v], [v], [op], [flip_op(op)], rs, cs, ["min"], ["min"],
                    block, np.array([r], np.int32), np.array([c], np.int32))
                assert not t1c.any(), (trial, op, r, c)


def test_bf16_round_trip_eligibility():
    """bf16 eligibility is a round trip; torch rounds f32 -> bf16 like
    ``jnp.bfloat16`` (to nearest, ties to even) on boundary values."""
    one_ulp = np.float32(2.0 ** -7)  # bf16 spacing at 1.0
    vals = np.array([1.0, 1.0 + one_ulp, 1.0 + one_ulp / 2, 1.0 + 3 * one_ulp / 2,
                     np.float32(3.0e38), np.float32(1e-40), -0.0, 65504.0], np.float32)
    for v in vals:
        arr = np.array([v, 2.0], np.float32)
        assert jops._eligible_kinds(arr) == tops._eligible_kinds(arr), v
    rt = jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(np.asarray(rt), tops._bf16_round_trip(vals))


def test_encoding_plans_match():
    rng = np.random.default_rng(9)
    cols = {
        "small": rng.integers(-100, 100, 50).astype(np.int32),
        "big": rng.integers(0, 1000, 50).astype(np.int32),
        "halves": (rng.integers(-64, 64, 50) / 2).astype(np.float32),
        "frac": rng.uniform(0, 1, 50).astype(np.float32),
        "codes": rng.choice(np.array([3.5, -7.25, 100.0], np.float32), 50),
    }
    for atoms in ([("small", "small", "<")], [("small", "big", "<")],
                  [("halves", "halves", ">="), ("frac", "frac", "<")],
                  [("codes", "codes", "=="), ("big", "big", "!=")]):
        names = {a for at in atoms for a in at[:2]}
        ref = jops.plan_dc_encodings({k: jnp.asarray(cols[k]) for k in names}, atoms)
        port = tops.plan_dc_encodings({k: torch.from_numpy(cols[k]) for k in names}, atoms)
        assert (ref is None) == (port is None)
        if ref is None:
            continue
        for k in names:
            assert ref[k].kind == port[k].kind
            assert ref[k].code_dtype == port[k].code_dtype
            if ref[k].table is not None:
                np.testing.assert_array_equal(ref[k].table, port[k].table)
            enc_j = jops.encode_column(jnp.asarray(cols[k]), ref[k])
            enc_t = tops.encode_column(torch.from_numpy(cols[k]), port[k])
            np.testing.assert_array_equal(
                np.asarray(enc_j.astype(jnp.float32) if enc_j.dtype == jnp.bfloat16 else enc_j),
                host(enc_t),
            )
