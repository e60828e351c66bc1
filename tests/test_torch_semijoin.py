"""The semijoin membership test and the single-role DC scan: the port's
plain PyTorch versions (what the wrappers run on CPU tensors) against the
reference's jnp oracles (``ref.semijoin``, ``ref.dc_role_scan``) and against
the reference's Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them.

Tolerance: none.  Every output is compared bit for bit (stats by bit
pattern, so NaN propagation and the sign of a zero extremum are pinned).
The role scan is held against the interpret-mode kernel on NaN-free inputs
only: the TPU kernel's tile pruning skips tiles with a NaN bound, which its
own oracle does not (ROADMAP Queue 3); the port follows the oracle.  The
CUDA kernels themselves (the semijoin's is a hash build and probe, whose
table size ``table_slots`` is tested here) are held against the plain
versions by ``tests/test_torch_cuda.py`` (marked ``gpu``) and by
``chip_smoke.py``."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.dc_pairs import dc_role_scan_pallas
from repro.kernels.semijoin import semijoin_pallas
from repro_torch.kernels import dc_pairs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import semijoin as tsj

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


OPS = ["<", "<=", ">", ">=", "==", "!="]
RED = {"<": "max", "<=": "max", ">": "min", ">=": "min", "==": "min", "!=": "min"}


def _bits(x):
    """Host array for a bit-for-bit comparison (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def same(ref_out, port_out, what=""):
    r, p = _bits(ref_out), _bits(port_out)
    assert r.dtype == p.dtype and r.shape == p.shape, (what, r.dtype, p.dtype)
    if r.dtype.kind == "f":
        assert np.array_equal(np.isnan(r), np.isnan(p)), what
        r, p = np.where(np.isnan(r), 0, r), np.where(np.isnan(p), 0, p)
        np.testing.assert_array_equal(np.signbit(r), np.signbit(p), err_msg=what)
    np.testing.assert_array_equal(r, p, err_msg=what)


# ----------------------------------------------------------------- semijoin
def semijoin_inputs(n, m, seed, hi=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, n).astype(np.int32), rng.random(n) < 0.8,
            rng.integers(0, hi, m).astype(np.int32), rng.random(m) < 0.8)


def semijoin_both(q, qm, k, km, block, kernel=False):
    j = jnp.asarray
    fn = ((lambda *a, block: semijoin_pallas(*a, block=block, interpret=True)) if kernel
          else ref.semijoin)
    want = fn(j(q), j(qm), j(k), j(km), block=block)
    t = torch.from_numpy
    before = tsj.LAUNCHES["semijoin"]
    got = tops.semijoin(t(q), t(qm), t(k), t(km), block=block)
    assert tsj.LAUNCHES["semijoin"] == before  # CPU tensors launch nothing
    same(want, got)
    return got


# the shapes of tests/test_kernels.py::TestSemijoinKernel, one block size each
SEMIJOIN_SHAPES = [(5, 7, 64), (64, 64, 256), (100, 257, 64), (513, 100, 256)]


@pytest.mark.parametrize("n,m,block", SEMIJOIN_SHAPES)
def test_semijoin_matches_oracle_and_pallas(n, m, block):
    q, qm, k, km = semijoin_inputs(n, m, n * m)
    got = semijoin_both(q, qm, k, km, block)
    semijoin_both(q, qm, k, km, block, kernel=True)
    np.testing.assert_array_equal(got.numpy(), np.isin(q, k[km]) & qm)


def test_semijoin_all_false_key_mask():
    q, qm, k, _ = semijoin_inputs(64, 64, 3)
    got = semijoin_both(q, qm, k, np.zeros(64, bool), 256, kernel=True)
    assert not got.any()


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=6, deadline=None)
def test_semijoin_property(seed):
    q, qm, k, km = semijoin_inputs(100, 257, seed, hi=12)
    semijoin_both(q, qm, k, km, 64)


def test_semijoin_float_keys_nan_and_signed_zero():
    """``==`` semantics: NaN matches nothing, -0.0 matches +0.0."""
    special = np.array([np.nan, 0.0, -0.0, 1.0, 2.5], np.float32)
    rng = np.random.default_rng(8)
    q, k = rng.choice(special, 100), rng.choice(special, 257)
    semijoin_both(q, np.ones(100, bool), k, rng.random(257) < 0.7, 64)


def test_semijoin_plain_chunks_queries(monkeypatch):
    """The plain version's query chunking does not change the answer."""
    q, qm, k, km = semijoin_inputs(513, 100, 4)
    whole = tsj.semijoin_plain(*map(torch.from_numpy, (q, qm, k, km)), 256)
    monkeypatch.setattr(tsj, "PLAIN_QUERY_CHUNK", 7)
    chunked = tsj.semijoin_plain(*map(torch.from_numpy, (q, qm, k, km)), 256)
    assert torch.equal(whole, chunked)


def _edge_case(name):
    """Tiny inputs of the kernel's edge cases: int32 extremes as keys,
    duplicates with mixed masks, no keys, no queries."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if name == "int32 extremes":
        k = np.array([lo, hi, -1, 0, 7], np.int32)
        q = np.array([lo, lo + 1, hi, hi - 1, -1, -2, 0, 1, 7, lo], np.int32)
        return q, np.ones(10, bool), k, np.array([1, 1, 1, 1, 0], bool)
    if name == "duplicates, mixed masks":
        # 3 appears in and out, 5 only out, 9 only in
        k = np.array([3, 3, 5, 9, 3, 5, 9, -1], np.int32)
        km = np.array([0, 1, 0, 1, 0, 0, 1, 0], bool)
        q = np.array([3, 5, 9, -1, 4, 3, 9], np.int32)
        return q, np.array([1, 1, 1, 1, 1, 0, 1], bool), k, km
    if name == "m=0":
        return np.array([0, 1, -1], np.int32), np.ones(3, bool), np.zeros(0, np.int32), \
            np.zeros(0, bool)
    return np.zeros(0, np.int32), np.zeros(0, bool), np.array([1, 2], np.int32), np.ones(2, bool)


@pytest.mark.parametrize("name", ["int32 extremes", "duplicates, mixed masks", "m=0", "n=0"])
def test_semijoin_edge_cases_match_oracle(name):
    q, qm, k, km = _edge_case(name)
    if name == "m=0":
        # ref.semijoin traces its key-block loop body even for no block and
        # cannot slice an empty key column (ROADMAP Queue 3): hold the port
        # at m = 0 against the oracle on one masked-out key, the same set
        got = tops.semijoin(*map(torch.from_numpy, (q, qm, k, km)), block=4)
        want = semijoin_both(q, qm, np.zeros(1, np.int32), np.zeros(1, bool), 4)
        assert torch.equal(got, want)
    else:
        got = semijoin_both(q, qm, k, km, 4)
    np.testing.assert_array_equal(got.numpy(), np.isin(q, k[km]) & qm)


@pytest.mark.parametrize("m,slots", [(0, 1024), (1, 1024), (512, 1024), (513, 2048),
                                     (75_000, 262_144), (1 << 20, 1 << 21)])
def test_semijoin_table_slots(m, slots):
    """The kernel's table: a power of two at least 2 m, at least the minimum."""
    got = tsj.table_slots(m)
    assert got == slots
    assert got & (got - 1) == 0 and got >= max(2 * m, tsj.MIN_TABLE_SLOTS)


def test_semijoin_other_devices_raise():
    x = torch.zeros(4, dtype=torch.int32, device="meta")
    m = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tops.semijoin(x, m, x, m)


# ------------------------------------------------------------ dc_role_scan
def _col(vals, dtype):
    if dtype == "bf16":
        return jnp.asarray(vals).astype(jnp.bfloat16), torch.from_numpy(vals).to(torch.bfloat16)
    a = vals.astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


def role_both(l_vals, r_vals, ops, rs, cs, block, dtype="int32", kernel=False,
              reduces=None, **restr):
    """The reference (oracle or interpret-mode kernel) and the port on the
    same numpy inputs; a column passed on both sides stays one object."""
    jmap, tmap = {}, {}

    def conv(v):
        if id(v) not in jmap:
            jmap[id(v)], tmap[id(v)] = _col(v, dtype)
        return jmap[id(v)], tmap[id(v)]

    jl, tl = zip(*[conv(v) for v in l_vals])
    jr, tr = zip(*[conv(v) for v in r_vals])
    reduces = reduces or [RED[o] for o in ops]
    fn = ((lambda *a, **kw: dc_role_scan_pallas(*a, interpret=True, **kw)) if kernel
          else ref.dc_role_scan)
    want_c, want_s = fn(list(jl), list(jr), ops, jnp.asarray(rs), jnp.asarray(cs), reduces,
                        block=block, **restr)
    before = dc_pairs.LAUNCHES["dc_role_scan"]
    got_c, got_s = tops.dc_role_scan(list(tl), list(tr), ops, torch.from_numpy(rs),
                                     torch.from_numpy(cs), reduces, block=block, **restr)
    assert dc_pairs.LAUNCHES["dc_role_scan"] == before
    same(want_c, got_c, "count")
    assert len(want_s) == len(got_s)
    for a, (w, g) in enumerate(zip(want_s, got_s)):
        assert g.dtype == tr[a].dtype
        same(w, g, f"stat {a}")
    return got_c, got_s


N, BLOCK = 80, 16


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "bf16", "float32"])
@pytest.mark.parametrize("n_atoms", [1, 3])
def test_role_scan_dtypes_and_atoms(dtype, n_atoms):
    rng = np.random.default_rng(n_atoms)
    cols = [(rng.integers(-40, 40, N) / (4 if dtype in ("bf16", "float32") else 1))
            .astype(np.float32) for _ in range(n_atoms)]
    ops = ["<", "!=", ">="][:n_atoms]
    rs, cs = rng.random(N) < 0.7, rng.random(N) < 0.8
    role_both(cols, cols[::-1], ops, rs, cs, BLOCK, dtype=dtype)


@given(st.integers(0, 2**31 - 1), st.sampled_from(OPS), st.sampled_from(OPS),
       st.sampled_from(OPS))
@settings(max_examples=10, deadline=None)
def test_role_scan_every_op_on_worklists(seed, op1, op2, op3):
    """Three atoms over three columns, random row and col worklists."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 5, N).astype(np.float32) for _ in range(3)]
    nb = N // BLOCK
    rows = np.flatnonzero(rng.random(nb) < 0.6).astype(np.int32)
    colsb = np.flatnonzero(rng.random(nb) < 0.7).astype(np.int32)
    role_both(cols, [cols[1], cols[2], cols[0]], [op1, op2, op3], rng.random(N) < 0.8,
              rng.random(N) < 0.8, BLOCK, row_block_ids=rows, col_block_ids=colsb)


@pytest.mark.parametrize("restr", [
    dict(row_blocks=(1, 3)),
    dict(col_blocks=(2, 5)),
    dict(row_block_ids=np.array([4, 0, 2, 2], np.int32), col_block_ids=np.array([1, 3], np.int32)),
    dict(row_block_ids=np.array([], np.int32)),
    dict(col_block_ids=np.array([], np.int32)),
])
def test_role_scan_strips_and_worklists(restr):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 9, N).astype(np.float32)
    b = rng.integers(0, 9, N).astype(np.float32)
    count, stats = role_both([a, b], [a, b], ["<=", ">"], rng.random(N) < 0.8,
                             rng.random(N) < 0.8, BLOCK, **restr)
    if "row_block_ids" in restr and not restr["row_block_ids"].size:
        assert not count.any() and (stats[0] == np.iinfo(np.int32).min).all()


@pytest.mark.parametrize("n", [1, 255, 300])
def test_role_scan_ragged_n(n):
    """n not a multiple of the block."""
    rng = np.random.default_rng(n)
    price = rng.uniform(0, 100, n).astype(np.float32)
    disc = (100 - price + rng.normal(0, 8, n)).astype(np.float32)
    role_both([price, disc], [price, disc], ["<", ">"], rng.random(n) < 0.9,
              np.ones(n, bool), 256, dtype="float32")


def test_role_scan_nan_and_signed_zero_stats():
    """A NaN partner enters a stat only through ``!=`` and then wins; among
    zeros -0.0 is the min, +0.0 the max (against the oracle)."""
    special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf], np.float32)
    rng = np.random.default_rng(11)
    x, y = rng.choice(special, 64), rng.choice(special, 64)
    rs, cs = rng.random(64) < 0.9, rng.random(64) < 0.9
    for ops in (["!="], ["!=", "<"], ["<=", ">="], ["==", "!="]):
        cols = [x, y][: len(ops)]
        role_both(cols, cols[::-1], ops, rs, cs, 16, dtype="float32")
    zeros = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    ones = np.ones(4, bool)
    for red in ("min", "max"):
        role_both([zeros], [zeros], ["<="], ones, ones, 4, dtype="float32", reduces=[red])


# interpret-mode Pallas: four shapes, NaN-free
@pytest.mark.parametrize("n,block,dtype,ops,restr", [
    (48, 16, "float32", ["<", ">="], dict(row_block_ids=np.array([0, 2], np.int32))),
    (64, 32, "int32", ["<", ">"], {}),
    (40, 8, "int8", ["<"], dict(row_blocks=(1, 3))),
    (70, 32, "bf16", ["!=", "<="], dict(col_block_ids=np.array([0, 2], np.int32))),
])
def test_role_scan_matches_interpret_mode_pallas(n, block, dtype, ops, restr):
    rng = np.random.default_rng(n)
    cols = [rng.integers(-20, 20, n).astype(np.float32) for _ in ops]
    role_both(cols, cols, ops, rng.random(n) < 0.8, rng.random(n) < 0.8, block,
              dtype=dtype, kernel=True, **restr)


def test_role_scan_out_of_range_strip_raises():
    """``resolve_block_ids``'s ``ValueError`` (tests/test_ledger.py's case)."""
    col = torch.from_numpy(np.random.default_rng(1).integers(0, 5, 16).astype(np.int32))
    scope = torch.ones(16, dtype=torch.bool)
    for restr in (dict(row_blocks=(1, 5)), dict(col_blocks=(0, 3)),
                  dict(row_block_ids=np.array([2], np.int32))):
        with pytest.raises(ValueError):
            tops.dc_role_scan([col], [col], ["<"], scope, scope, ["max"], block=8, **restr)
    with pytest.raises(ValueError):
        jops.dc_role_scan([jnp.asarray(col.numpy())] * 1, [jnp.asarray(col.numpy())], ["<"],
                          jnp.ones(16, bool), jnp.ones(16, bool), ["max"], block=8,
                          force="ref", row_blocks=(1, 5))
