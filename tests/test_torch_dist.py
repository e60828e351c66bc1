"""Sharded detection in the port (DESIGN.md §8) against the JAX reference.

The port's key-routed shuffle (``repro_torch.dist.shuffle``) and sharded
FD/DC detection (``repro_torch.dist.detect``) are held bit for bit against
the reference's (``repro.dist``) on a one-device JAX mesh, where the
reference scans its logical shards under ``vmap``, and against the port's
own dense scans: every output array, the tile telemetry and every
``ShardedDetectInfo`` field.  The cases cover full and asymmetric scopes,
a skewed key that overflows and retries, a -0.0 key, a capacity factor
below 1 that is clamped, int8 and float key columns, a multi-attribute
lhs and the per-shard strip report.  Also here: the dispatch
(``will_shard``, ``detect_auto`` and the deprecated aliases),
``pair_count_report``, the ``dist.*`` spans, the port's ``Mesh``, the
sharded launch's flat layout, and one interpret-mode Pallas pair scan
under ``vmap`` against the port's plain sharded scan.

Each case builds its table once in numpy and gives the same arrays to
both packages; the reference compiles once per case.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import detect as jcore
from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom, flip_op as jflip
from repro.core.relation import make_relation as jmake
from repro.dist import detect as jdist
from repro.dist import shuffle as jshuffle
from repro.kernels import ops as jops
from repro.obs.trace import Tracer as JTracer
from repro_torch.core import detect as tcore
from repro_torch.core.constraints import DC, FD, Atom, flip_op
from repro_torch.dist import detect as tdist
from repro_torch.dist import hints, shuffle as tshuffle
from repro_torch.kernels import dc_pairs
from repro_torch.obs.trace import Tracer
from repro_torch.testing import relation_from_numpy, relation_to_numpy

torch.set_num_threads(1)
SETTINGS = dict(max_examples=8, deadline=None)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end."""
    yield
    jax.clear_caches()
    gc.collect()


def jax_mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


MESH = hints.one_device_mesh("cpu")


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits(got, want, what=""):
    got, want = host(got), host(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        got, want = got.view(np.uint8), want.view(np.uint8)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------------------------ tables
def table(seed, skew=False, n=96, cap=128):
    """Both packages' relation over the same arrays: an int32, a float (with
    +0.0 and -0.0) and an int8 key column, and the DC's price/tax."""
    rng = np.random.default_rng(seed)
    dept = np.zeros(n, np.int32) if skew else rng.integers(-3, 4, n).astype(np.int32)
    data = {
        "dept": dept,
        "fkey": rng.choice(np.array([0.0, -0.0, 1.5, -2.25], np.float32), n),
        "d8": rng.integers(-100, 100, n).astype(np.int32),
        "salary": rng.integers(1, 9, n).astype(np.float32),
        "tax": rng.integers(1, 9, n).astype(np.float32) / 10.0,
    }
    jrel = jmake(data, capacity=cap, overlay=["salary", "tax"], k=4, rules=["phi"])
    # an int8 column: make_relation widens, so the reference's is replaced
    d8 = np.full(cap, -128, np.int8)
    d8[:n] = data["d8"]
    jrel = dataclasses.replace(jrel, columns={**jrel.columns, "d8": jnp.asarray(d8)})
    return jrel, relation_from_numpy(relation_to_numpy(jrel), device="cpu")


def both_dc(name, atoms):
    return (JDC(name, [JAtom(*a) for a in atoms]), DC(name, [Atom(*a) for a in atoms]))


DC_EQ = both_dc("phi", [("dept", "==", "dept"), ("salary", "<", "salary"), ("tax", ">", "tax")])
DC_MULTI = both_dc("phi", [("fkey", "==", "fkey"), ("dept", "==", "dept"),
                           ("salary", "<=", "salary"), ("tax", ">", "tax")])
DC_I8 = both_dc("phi", [("d8", "==", "d8"), ("salary", "<", "salary"), ("tax", ">=", "tax")])
DC_NO_EQ = both_dc("phi", [("salary", "<", "salary"), ("tax", ">", "tax")])

# name -> (dc, table seed, skew, scopes, n_shards, block, capacity factor, strip rows)
DC_CASES = {
    "full scopes, strip report": (DC_EQ, 0, False, "full", 4, 256, 2.0, 16),
    "asymmetric scopes, hi below the shard's blocks": (DC_EQ, 1, False, "asym", 4, 16, 2.0, None),
    "one key: overflow and retries": (DC_EQ, 2, True, "full", 4, 256, 2.0, 32),
    "capacity factor 0.5 clamped": (DC_EQ, 3, False, "full", 4, 256, 0.5, None),
    "float and int32 keys with -0.0": (DC_MULTI, 4, False, "full", 8, 256, 2.0, None),
    "int8 key": (DC_I8, 5, False, "asym", 2, 256, 2.0, 64),
}


def scopes(kind, seed, cap, valid_np):
    if kind == "full":
        return valid_np, valid_np
    rng = np.random.default_rng(seed + 100)
    return rng.random(cap) < 0.3, rng.random(cap) < 0.4


def dc_outputs(det):
    return [det.t1_count, det.t2_count, *det.t1_stat, *det.t2_stat]


def tiles(det):
    return (det.tiles_launched, det.tiles_total, det.bytes_moved)


@pytest.fixture(scope="module", params=list(DC_CASES), ids=list(DC_CASES))
def dc_case(request):
    """One case run through the reference's sharded path, the port's sharded
    path and the port's dense scan."""
    (jdc, tdc), seed, skew, kind, n_shards, block, factor, strip = DC_CASES[request.param]
    jrel, trel = table(seed, skew)
    rs, cs = scopes(kind, seed, trel.capacity, host(trel.valid))
    jtr, ttr = JTracer(), Tracer()
    want, winfo = jdist.detect_dc_sharded_info(
        jrel, jdc, jnp.asarray(rs), jnp.asarray(cs), jax_mesh(), n_shards=n_shards,
        block=block, capacity_factor=factor, strip_rows=strip, tracer=jtr,
    )
    trs, tcs = torch.from_numpy(rs), torch.from_numpy(cs)
    got, info = tdist.detect_dc_sharded_info(
        trel, tdc, trs, tcs, MESH, n_shards=n_shards, block=block,
        capacity_factor=factor, strip_rows=strip, tracer=ttr,
    )
    dense = tcore.detect_dc(trel, tdc, trs, tcs, block=block)
    return dict(name=request.param, want=want, winfo=winfo, got=got, info=info,
                dense=dense, jtr=jtr, ttr=ttr, block=block)


def test_dc_sharded_matches_reference(dc_case):
    c = dc_case
    for i, (g, w) in enumerate(zip(dc_outputs(c["got"]), dc_outputs(c["want"]), strict=True)):
        assert_bits(g, w, f"{c['name']} output {i}")
    assert tiles(c["got"]) == tiles(c["want"])
    assert dataclasses.asdict(c["info"]) == dataclasses.asdict(c["winfo"])


def test_dc_sharded_matches_port_dense(dc_case):
    c = dc_case
    for i, (g, w) in enumerate(zip(dc_outputs(c["got"]), dc_outputs(c["dense"]), strict=True)):
        assert_bits(g, w, f"{c['name']} output {i}")
    assert int(c["got"].t1_count.sum()) > 0  # a case with violations
    info = c["info"]
    assert info.sharded_pairs < info.dense_pairs
    if "retries" in c["name"]:
        assert info.retries >= 1 and info.capacity_factor > 2.0
        assert sorted(info.per_shard_rows)[:-1] == [0] * (info.n_shards - 1)
    if "hi below" in c["name"]:
        assert info.tiles_launched < info.tiles_total
    if info.per_shard_strips is not None:
        strip = 16 if "strip" in c["name"] else 32 if "retries" in c["name"] else 64
        assert sum(info.per_shard_strips) >= -(-info.routed_rows // strip)


def test_dc_spans_match_reference(dc_case):
    """``dist.shuffle`` (rows, retries, factor), one
    ``dist.shuffle_overflow_retry`` a retry and ``dist.shard_scan`` (tile
    counts): the same events with the same attributes, in order."""

    def events(tr):
        return [(e.name, e.attrs) for e in tr.events()]

    got, want = events(dc_case["ttr"]), events(dc_case["jtr"])
    assert got == want
    names = [n for n, _ in got]
    assert names[-2:] == ["dist.shuffle", "dist.shard_scan"]
    assert names.count("dist.shuffle_overflow_retry") == dc_case["info"].retries


def test_dc_without_equality_atom_raises():
    _, trel = table(0)
    with pytest.raises(ValueError, match="no same-attribute equality atom"):
        tdist.detect_dc_sharded_info(trel, DC_NO_EQ[1], trel.valid, trel.valid, MESH,
                                     n_shards=4)
    with pytest.raises(ValueError, match="n_shards must be >= 2"):
        tdist.detect_dc_sharded_info(trel, DC_EQ[1], trel.valid, trel.valid, MESH)


# ----------------------------------------------------------------- FD path
def fd_table(seed, n=90, cap=128):
    rng = np.random.default_rng(seed)
    data = {
        "zip": rng.integers(-6, 9, n).astype(np.int32),
        "city": rng.integers(0, 5, n).astype(np.int32),
        "a": rng.integers(0, 4, n).astype(np.int32),
        "b": rng.choice(np.array([0.0, -0.0, 2.5], np.float32), n),
        "y": rng.integers(0, 12, n).astype(np.float32),
    }
    jrel = jmake(data, capacity=cap, overlay=["zip", "city", "y"], k=4, rules=["f"])
    return jrel, relation_from_numpy(relation_to_numpy(jrel), device="cpu")


# name -> (lhs, rhs, seed, k, n_shards, strip rows); k 4 overflows on y
FD_CASES = {
    "one-attribute lhs, both groupings": ("zip", "city", 7, 8, 4, 16),
    "multi-attribute lhs with a -0.0 key, overflow": (("a", "b"), "y", 8, 4, 4, None),
}


@pytest.fixture(scope="module", params=list(FD_CASES), ids=list(FD_CASES))
def fd_case(request):
    lhs, rhs, seed, k, n_shards, strip = FD_CASES[request.param]
    jrel, trel = fd_table(seed)
    scope = np.random.default_rng(seed).random(trel.capacity) < 0.85
    want, winfo = jdist.detect_fd_sharded_info(
        jrel, JFD("f", lhs, rhs), jnp.asarray(scope), jax_mesh(), k=k,
        n_shards=n_shards, strip_rows=strip,
    )
    tscope = torch.from_numpy(scope)
    got, info = tdist.detect_fd_sharded_info(
        trel, FD("f", lhs, rhs), tscope, MESH, k=k, n_shards=n_shards, strip_rows=strip,
    )
    dense = tcore.detect_fd(trel, FD("f", lhs, rhs), tscope, k=k)
    return dict(name=request.param, want=want, winfo=winfo, got=got, info=info, dense=dense)


@pytest.mark.parametrize("against", ["reference", "port dense"])
def test_fd_sharded_matches(fd_case, against):
    c = fd_case
    want = c["want"] if against == "reference" else c["dense"]
    for field in want._fields:
        g, w = getattr(c["got"], field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert_bits(g, w, f"{c['name']} {field}")
    if against == "reference":
        assert dataclasses.asdict(c["info"]) == dataclasses.asdict(c["winfo"])
    assert bool(c["got"].violated.any())
    if "overflow" in c["name"]:
        assert bool(c["got"].overflow) and c["got"].lhs_cand is None


# ----------------------------------------------------------------- shuffle
def shuffle_inputs(keys, valid, n_shards=4):
    keys = np.asarray(keys, np.int32).reshape(n_shards, -1)
    valid = np.asarray(valid, bool).reshape(n_shards, -1)
    payload = np.stack([keys * 3 + 1, np.arange(keys.size, dtype=np.int32).reshape(keys.shape)],
                       axis=-1)
    return keys, payload, valid


def same_shuffle(got, want):
    for field in ("keys", "payload", "valid", "src"):
        assert_bits(getattr(got, field), getattr(want, field), field)
    assert bool(host(got.overflow)) == bool(host(want.overflow))


@given(
    keys=st.lists(st.integers(-(2**31), 2**31 - 1) | st.integers(-9, 9), min_size=48,
                  max_size=48),
    valid=st.lists(st.booleans(), min_size=48, max_size=48),
    factor=st.sampled_from([0.5, 1.0, 2.0]),
)
@settings(**SETTINGS)
def test_shuffle_matches_reference_and_host(keys, valid, factor):
    keys, payload, valid = shuffle_inputs(keys, valid)
    got = tshuffle.shuffle_by_key(torch.from_numpy(keys), torch.from_numpy(payload),
                                  torch.from_numpy(valid), MESH, capacity_factor=factor)
    want = jshuffle.shuffle_by_key(jnp.asarray(keys), jnp.asarray(payload), jnp.asarray(valid),
                                   jax_mesh(), capacity_factor=factor)
    same_shuffle(got, want)
    same_shuffle(got, jshuffle.shuffle_by_key_host(keys, payload, valid, 4, factor))
    same_shuffle(got, tshuffle.shuffle_by_key_host(keys, payload, valid, 4, factor))


def test_shuffle_negative_keys_overflow_and_src():
    """Negative keys route by Python's modulo; a skewed shard keeps its first
    rows in flat order and flags the overflow; ``src`` inverts the routing
    and empty slots hold ``n_shards * n``."""
    keys = np.array([-1, -5, 7, -8, 3, 3, 3, 3, 3, -2147483648, 2147483647, 0], np.int32)
    valid = np.ones(12, bool)
    valid[2] = False
    k, p, v = shuffle_inputs(keys, valid, n_shards=3)
    got = tshuffle.shuffle_by_key(torch.from_numpy(k), torch.from_numpy(p), torch.from_numpy(v),
                                  MESH, capacity_factor=1.0)
    same_shuffle(got, tshuffle.shuffle_by_key_host(k, p, v, 3, 1.0))
    assert bool(got.overflow)
    src, gv, gk = host(got.src), host(got.valid), host(got.keys)
    assert (src[~gv] == 12).all()
    assert (gk[gv] == keys[src[gv]]).all()
    assert all(int(key) % 3 == s for s in range(3) for key in gk[s][gv[s]])
    # the routing's modulo is Python's, in both of torch's spellings
    t = torch.from_numpy(keys)
    assert (torch.remainder(t, 3).numpy() == keys.astype(np.int64) % 3).all()
    assert ((t % 3).numpy() == keys.astype(np.int64) % 3).all()


def test_shuffle_refuses_a_tensor_off_the_mesh():
    k, p, v = shuffle_inputs(np.arange(8), np.ones(8, bool))
    mesh = hints.Mesh([["cpu"]], ("data", "model"))
    with pytest.raises(ValueError, match="outside"):
        tshuffle.shuffle_by_key(torch.from_numpy(k).to("meta"), torch.from_numpy(p),
                                torch.from_numpy(v), mesh)


def test_combine_keys_matches_reference():
    """int32 wrap of ``h * 1_000_003 ^ c``, -0.0 folded onto +0.0, int8 and
    float columns viewed as float32."""
    rng = np.random.default_rng(3)
    cols = [
        rng.integers(-(2**31), 2**31 - 1, 64, dtype=np.int64).astype(np.int32),
        rng.choice(np.array([0.0, -0.0, np.nan, np.inf, 1e30], np.float32), 64),
        rng.integers(-128, 127, 64).astype(np.int8),
    ]
    got = tdist._combine_keys([torch.from_numpy(c) for c in cols])
    want = jdist._combine_keys([jnp.asarray(c) for c in cols])
    assert_bits(got, want)


# ------------------------------------------------------- dispatch, report
def test_will_shard_matches_reference():
    tfd, jfd = FD("f", "dept", "salary"), JFD("f", "dept", "salary")
    for (jr, tr) in (DC_EQ, DC_NO_EQ, (jfd, tfd)):
        for mesh in (None, "one"):
            for n in (None, 1, 2, 4):
                want = jcore.will_shard(jr, None if mesh is None else jax_mesh(), n)
                assert tcore.will_shard(tr, None if mesh is None else MESH, n) == want


def test_detect_auto_dispatch_and_aliases(monkeypatch):
    """No mesh or no equality key takes the dense scan (the sharded entries
    are never called); a mesh and a key take the sharded one and carry its
    info; the deprecated aliases give what ``detect_auto`` gives."""
    _, trel = table(0)
    v = trel.valid
    dense = tcore.detect_dc(trel, DC_EQ[1], v, v)
    sharded = tcore.detect_auto(trel, DC_EQ[1], v, v, mesh=MESH, n_shards=4)
    assert isinstance(sharded.info, tdist.ShardedDetectInfo)
    for g, w in zip(dc_outputs(sharded.detection), dc_outputs(dense)):
        assert_bits(g, w)
    det, info = tcore.detect_dc_auto_info(trel, DC_EQ[1], v, v, mesh=MESH, n_shards=4,
                                          strip_rows=16)
    assert info.per_shard_strips is not None
    for g, w in zip(dc_outputs(det), dc_outputs(dense)):
        assert_bits(g, w)
    tfd = FD("f", "dept", "salary")
    fd_dense = tcore.detect_fd(trel, tfd, v, k=4)
    fd_det, fd_info = tcore.detect_fd_auto_info(trel, tfd, v, k=4, mesh=MESH, n_shards=4)
    assert fd_info.n_shards == 4
    assert_bits(fd_det.rhs_cand, fd_dense.rhs_cand)
    assert_bits(tcore.detect_fd_auto(trel, tfd, v, k=4, mesh=MESH, n_shards=4).lhs_count,
                fd_dense.lhs_count)

    def boom(*a, **k):
        raise AssertionError("the sharded path was taken")

    monkeypatch.setattr(tdist, "detect_dc_sharded_info", boom)
    monkeypatch.setattr(tdist, "detect_fd_sharded_info", boom)
    for mesh, rule, n in ((None, DC_EQ[1], 4), (MESH, DC_NO_EQ[1], 4), (MESH, DC_EQ[1], None)):
        res = tcore.detect_auto(trel, rule, v, v, mesh=mesh, n_shards=n)
        assert res.info is None
        assert_bits(res.detection.t1_count, tcore.detect_dc(trel, rule, v, v).t1_count)
    assert_bits(tcore.detect_dc_auto(trel, DC_EQ[1], v, v).t2_count, dense.t2_count)
    assert tcore.detect_fd_auto_info(trel, tfd, v, k=4, mesh=MESH)[1] is None
    assert_bits(tcore.detect_fd_auto(trel, tfd, v, k=4).rhs_count, fd_dense.rhs_count)


@pytest.mark.parametrize("n_rows,n_shards,factor", [(1024, 16, 2.0), (100, 1, 2.0),
                                                     (131_072, 16, 1.5), (7, 3, 2.0)])
def test_pair_count_report_matches_reference(n_rows, n_shards, factor):
    assert (tdist.pair_count_report(n_rows, n_shards, factor)
            == jdist.pair_count_report(n_rows, n_shards, factor))
    with pytest.raises(ValueError):
        tdist.pair_count_report(10, 0)


def test_default_n_shards_and_mesh_rules():
    assert tdist.default_n_shards(MESH) == jdist.default_n_shards(jax_mesh()) == 1
    assert MESH.shape == dict(jax_mesh().shape)
    assert hints.dp_axes(MESH) == ()
    with pytest.raises(NotImplementedError, match="data-parallel extent 2"):
        hints.Mesh([["cpu"], ["cpu"]], ("data", "model"))
    with pytest.raises(ValueError, match="not present"):
        hints.Mesh([[f"cuda:{torch.cuda.device_count()}"]], ("data", "model"))
    with pytest.raises(ValueError, match="twice"):
        hints.Mesh([["cpu", "cpu"]], ("data", "model"))
    with pytest.raises(ValueError, match="dims"):
        hints.Mesh(["cpu"], ("data", "model"))
    assert hints.holds(MESH, "cpu") and not hints.holds(MESH, "meta")


# ------------------------------------------------------ the sharded kernel
def sharded_inputs(seed, n_shards=3, cap=40, occupancy=(30, 0, 17)):
    """Routed-layout inputs: each shard's rows a valid prefix of its slots."""
    rng = np.random.default_rng(seed)
    valid = np.zeros((n_shards, cap), bool)
    for s, c in enumerate(occupancy):
        valid[s, :c] = True
    price = rng.integers(0, 12, (n_shards, cap)).astype(np.float32)
    disc = rng.integers(-5, 5, (n_shards, cap)).astype(np.int32)
    rs = valid & (rng.random((n_shards, cap)) < 0.8)
    cs = valid & (rng.random((n_shards, cap)) < 0.8)
    return price, disc, rs, cs


OPS = ["<", ">="]


def sharded_args(price, disc, rs, cs, lib):
    flip = jflip if lib is jnp else flip_op
    flipped = [flip(o) for o in OPS]
    red1 = [tcore._T1_REDUCE[o] for o in OPS]
    red2 = [tcore._T1_REDUCE[o] for o in flipped]
    if lib is jnp:
        cols = [jnp.asarray(price), jnp.asarray(disc)]
        return cols, cols, OPS, flipped, jnp.asarray(rs), jnp.asarray(cs), red1, red2
    cols = [torch.from_numpy(price), torch.from_numpy(disc)]
    return cols, cols, OPS, flipped, torch.from_numpy(rs), torch.from_numpy(cs), red1, red2


def flat_output(out):
    t1c, t1s, t2c, t2s = out
    return [t1c, *t1s, t2c, *t2s]


def test_interpret_pallas_under_vmap_matches_sharded_plain():
    """The reference's Pallas pair scan (interpret mode) under ``vmap`` over
    the shards, each on blocks [0, hi) x [0, hi), against the port's plain
    sharded scan; one shard holds no row, and hi is below the shard's
    block count."""
    block, hi = 16, 2
    price, disc, rs, cs = sharded_inputs(0)
    l, r, ops, flipped, jrs, jcs, red1, red2 = sharded_args(price, disc, rs, cs, jnp)

    def one(args):
        lc, rc, a, b = args
        res = jops.dc_pair_scan(lc, rc, ops, flipped, a, b, red1, red2, block=block,
                                force="interpret", row_blocks=(0, hi), col_blocks=(0, hi))
        return [res.t1_count, *res.t1_stat, res.t2_count, *res.t2_stat]

    want = jax.vmap(one)((tuple(l), tuple(r), jrs, jcs))
    got = flat_output(dc_pairs.dc_pair_scan_sharded(
        *sharded_args(price, disc, rs, cs, torch), block, hi))
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert_bits(g, w, f"output {i}")
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("block,hi", [(16, 2), (8, 5), (64, 1)])
def test_flat_layout_worklists_match_per_shard_scans(block, hi):
    """What the one launch computes, on the CPU: the pair scan over the flat
    layout (``shard_layout``) with shard s's worklist offset by
    ``s * nb_local``, read back by ``shard_unlayout``, equals the plain
    sharded scan shard for shard."""
    price, disc, rs, cs = sharded_inputs(block)
    args = sharded_args(price, disc, rs, cs, torch)
    want = flat_output(dc_pairs.dc_pair_scan_sharded_plain(*args, block, hi))
    l, r, ops, flipped, trs, tcs, red1, red2 = args
    fl, fr, frs, fcs, nb_local = dc_pairs.shard_layout(l, r, trs, tcs, block)
    assert fl[0] is fr[0] and frs.shape[0] == 3 * nb_local * block
    n_shards, cap = trs.shape
    per = []
    for s in range(n_shards):
        ids = np.arange(hi, dtype=np.int32) + s * nb_local
        out = flat_output(dc_pairs.dc_pair_scan_plain(fl, fr, ops, flipped, frs, fcs, red1,
                                                      red2, block, ids, ids))
        per.append([dc_pairs.shard_unlayout(x, n_shards, cap)[s] for x in out])
    for i, w in enumerate(want):
        assert_bits(torch.stack([p[i] for p in per]), w, f"output {i}")
    with pytest.raises(ValueError, match="hi"):
        dc_pairs.dc_pair_scan_sharded(*args, block, nb_local + 1)
