"""Detection, repair, merge and the group-by operators: the port against the
reference on the same numpy inputs.

Exact: every ``FDDetectResult``/``DCDetectResult`` field (tile telemetry
included), candidate deltas, merged overlays, checked bits, repaired
values and accuracy counts.  Float group-by aggregates are compared with
``rtol=1e-6``, and only there: the two packages sum probabilities in a
different order."""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import detect as jdet
from repro.core import operators as jopr
from repro.core import repair as jrep
from repro.core import update as jupd
from repro.core.accuracy import repair_accuracy as jacc
from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom
from repro.core.relation import make_relation as jmake
from repro_torch.core import detect as tdet
from repro_torch.core import operators as topr
from repro_torch.core import repair as trep
from repro_torch.core import update as tupd
from repro_torch.core.accuracy import repair_accuracy as tacc
from repro_torch.core.constraints import DC, FD, Atom
from repro_torch.core.relation import make_relation as tmake
from repro_torch.dist.hints import Mesh
from repro_torch.testing import relation_from_numpy, relation_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

SETTINGS = dict(max_examples=10, deadline=None)


def same(a, b, what=""):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def same_fields(ref, port, what=""):
    assert ref._fields == port._fields
    for name, a, b in zip(ref._fields, ref, port):
        if isinstance(a, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y, f"{what}.{name}")
        elif isinstance(a, int):
            assert a == b, (what, name, a, b)
        else:
            same(a, b, f"{what}.{name}")


def relations(data, overlay, rules=(), capacity=None):
    kw = dict(overlay=overlay, k=4, rules=list(rules), capacity=capacity)
    return jmake(data, **kw), tmake(data, device="cpu", **kw)


def lineorder(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "orderkey": rng.integers(0, n // 4, n),
        "suppkey": rng.integers(0, 5, n),
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "disc": rng.integers(0, 20, n).astype(np.float32),
    }


# ------------------------------------------------------------------- detect
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("two_lhs", [False, True])
def test_detect_fd_all_fields(seed, two_lhs):
    data = lineorder(40, seed)
    jrel, trel = relations(data, ["orderkey", "suppkey"], capacity=48)
    lhs = ("orderkey", "disc") if two_lhs else "orderkey"
    scope = np.random.default_rng(seed).random(48) < 0.8
    ref = jdet.detect_fd(jrel, JFD("f", lhs, "suppkey"), jnp.asarray(scope), k=3)
    port = tdet.detect_fd(trel, FD("f", lhs, "suppkey"), torch.from_numpy(scope), k=3)
    same_fields(ref, port, "fd")


DC_CASES = {
    "price<,disc>": [("price", "<", "price"), ("disc", ">", "disc")],
    "fd-as-dc": [("orderkey", "==", "orderkey"), ("suppkey", "!=", "suppkey")],
    "int8 disc<=": [("disc", "<=", "disc")],
    "cross-attr": [("price", "<", "disc")],
}


@pytest.mark.parametrize("case", sorted(DC_CASES))
@pytest.mark.parametrize("encode", [True, False])
@pytest.mark.parametrize("restr", [
    {},
    dict(row_block_ids=np.array([0, 2], np.int32)),
    dict(row_blocks=(1, 3), col_block_ids=np.array([1], np.int32)),
])
def test_detect_dc_all_fields(case, encode, restr):
    """Every field, including ``tiles_launched``, ``tiles_total`` and
    ``bytes_moved`` (which reflect the encoded operand widths)."""
    data = lineorder(60, 3)
    jrel, trel = relations(data, list(data), capacity=64)
    atoms = DC_CASES[case]
    jdc = JDC("d", [JAtom(*a) for a in atoms])
    tdc = DC("d", [Atom(*a) for a in atoms])
    rng = np.random.default_rng(5)
    rs, cs = rng.random(64) < 0.7, rng.random(64) < 0.9
    ref = jdet.detect_dc(jrel, jdc, jnp.asarray(rs), jnp.asarray(cs), block=16,
                         encode=encode, **restr)
    port = tdet.detect_dc(trel, tdc, torch.from_numpy(rs), torch.from_numpy(cs),
                          block=16, encode=encode, **restr)
    same_fields(ref, port, case)
    ja = jdet.detect_auto(jrel, jdc, jnp.asarray(rs), jnp.asarray(cs), block=16, encode=encode)
    ta = tdet.detect_auto(trel, tdc, torch.from_numpy(rs), torch.from_numpy(cs), block=16,
                          encode=encode)
    assert ta.info is None and ja.info is None
    same_fields(ja.detection, ta.detection, case)


def test_detect_auto_rejects_mesh():
    """A mesh that spreads data over two devices (the reference's shard_map
    branch) is refused: the port shards logically on one device."""
    _, trel = relations(lineorder(8, 0), ["suppkey"])
    with pytest.raises(NotImplementedError):
        tdet.detect_auto(trel, FD("f", "orderkey", "suppkey"), trel.valid,
                         mesh=Mesh([["cpu"], ["cpu"]], ("data", "model")), n_shards=2)


# ------------------------------------------------------------------- repair
def test_fd_and_dc_repair_candidates_and_apply():
    data = lineorder(40, 7)
    jrel, trel = relations(data, list(data), rules=["f", "d"], capacity=48)
    scope = np.random.default_rng(1).random(48) < 0.7
    jfd, tfd = JFD("f", "orderkey", "suppkey"), FD("f", "orderkey", "suppkey")
    jd = jdet.detect_fd(jrel, jfd, jnp.asarray(scope))
    td = tdet.detect_fd(trel, tfd, torch.from_numpy(scope))
    jdeltas = jrep.fd_repair_candidates(jrel, jfd, jd, jnp.asarray(scope))
    tdeltas = trep.fd_repair_candidates(trel, tfd, td, torch.from_numpy(scope))
    atoms = DC_CASES["price<,disc>"]
    jdc, tdc = JDC("d", [JAtom(*a) for a in atoms]), DC("d", [Atom(*a) for a in atoms])
    jdd = jdet.detect_dc(jrel, jdc, jnp.asarray(scope), jrel.valid, block=16)
    tdd = tdet.detect_dc(trel, tdc, torch.from_numpy(scope), trel.valid, block=16)
    jdeltas += jrep.dc_repair_candidates(jrel, jdc, jdd, jnp.asarray(scope))
    tdeltas += trep.dc_repair_candidates(trel, tdc, tdd, torch.from_numpy(scope))
    assert [a for a, _ in jdeltas] == [a for a, _ in tdeltas]
    for (attr, jc), (_, tc) in zip(jdeltas, tdeltas):
        same_fields(jc, tc, attr)
    jrel2 = jupd.mark_checked(jupd.apply_candidates(jrel, jdeltas), "f", jnp.asarray(scope))
    trel2 = tupd.mark_checked(tupd.apply_candidates(trel, tdeltas), "f", torch.from_numpy(scope))
    a, b = relation_to_numpy(jrel2), relation_to_numpy(trel2)
    for field in ("cand", "ccount", "ckind", "checked"):
        for k in a[field]:
            same(a[field][k], b[field][k], f"{field}.{k}")
    for rule in ("f", "d", "never"):
        same(jupd.unchecked(jrel2, rule), tupd.unchecked(trel2, rule), rule)
    for attr in data:
        same(jrep.repaired_value(jrel2, attr), trep.repaired_value(trel2, attr), attr)
    truth_np = {k: np.resize(v, 48).astype(np.asarray(jrel.columns[k]).dtype)
                for k, v in lineorder(40, 8).items()}
    ref = jacc(jrel2, {k: jnp.asarray(v) for k, v in truth_np.items()})
    port = tacc(trel2, {k: torch.from_numpy(v) for k, v in truth_np.items()})
    assert tuple(ref) == tuple(port)


@st.composite
def cand_sets(draw):
    """Two per-row candidate sets with duplicate values, equal counts (tie
    order), both range kinds and signed zeros."""
    rows, k = 5, draw(st.integers(1, 4))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    vals = np.array([-0.0, 0.0, 1.0, 2.5, -3.0], np.float32)

    def one():
        return (rng.choice(vals, (rows, k)),
                rng.integers(0, 3, (rows, k)).astype(np.float32),
                rng.integers(0, 3, (rows, k)).astype(np.int8))

    return one(), one(), draw(st.integers(1, 6))


@given(cand_sets())
@settings(**SETTINGS)
def test_merge_candidates(sets):
    """The Lemma-4 merge: dedupe-sum, range tightening (-0.0 below +0.0, as
    XLA orders them), and the stable top-k of -counts."""
    a, b, k = sets
    ref = jupd.merge_candidates(*[jnp.asarray(x) for x in a + b], k)
    port = tupd.merge_candidates(*[torch.from_numpy(x) for x in a + b], k)
    for name, x, y in zip(("values", "counts", "kinds"), ref, port):
        same(x, y, name)


# ------------------------------------------------------------------ operators
@pytest.mark.parametrize("agg,value", [("count", None), ("sum", "price"), ("avg", "disc")])
@pytest.mark.parametrize("keys", [("suppkey",), ("suppkey", "disc")])
def test_groupby_agg(agg, value, keys):
    """Probabilistic single keys spread their mass over candidates;
    multi-keys group on primary values.  Keys and group counts are exact,
    float sums within rtol=1e-6 (summation order differs)."""
    data = lineorder(40, 9)
    jrel, trel = relations(data, list(data), rules=["f"], capacity=48)
    fd_j, fd_t = JFD("f", "orderkey", "suppkey"), FD("f", "orderkey", "suppkey")
    jd = jdet.detect_fd(jrel, fd_j, jrel.valid)
    td = tdet.detect_fd(trel, fd_t, trel.valid)
    jrel = jupd.apply_candidates(jrel, jrep.fd_repair_candidates(jrel, fd_j, jd, jrel.valid))
    trel = tupd.apply_candidates(trel, trep.fd_repair_candidates(trel, fd_t, td, trel.valid))
    mask = np.random.default_rng(2).random(48) < 0.8
    spec_j = jopr.GroupBySpec(keys, agg, value)
    spec_t = topr.GroupBySpec(keys, agg, value)
    ref = jopr.groupby_agg(jrel, jnp.asarray(mask) & jrel.valid, spec_j)
    port = topr.groupby_agg(trel, torch.from_numpy(mask) & trel.valid, spec_t)
    assert ref.keys() == port.keys()
    for name in ref:
        if name in ("count", "agg"):
            np.testing.assert_allclose(np.asarray(ref[name]), port[name].numpy(), rtol=1e-6)
        else:
            same(ref[name], port[name], name)
    for attr in ("price", "suppkey"):
        np.testing.assert_allclose(np.asarray(jopr.expected_value(jrel, attr)),
                                   topr.expected_value(trel, attr).numpy(), rtol=1e-6)
    for attr in ("suppkey", "price"):
        for x, y in zip(jopr.key_candidates(jrel, attr), topr.key_candidates(trel, attr)):
            same(x, y, attr)


def test_filter_and_fingerprint():
    import dataclasses

    data = lineorder(30, 4)
    jrel = jmake(data, overlay=["price"], k=2)
    ccount = np.array(jrel.ccount["price"])
    ckind = np.array(jrel.ckind["price"])
    ccount[:5] = 1.0
    ckind[:5, 1] = 1  # (-inf, bound) range candidates
    jrel = dataclasses.replace(
        jrel, ccount={"price": jnp.asarray(ccount)}, ckind={"price": jnp.asarray(ckind)}
    )
    trel = relation_from_numpy(relation_to_numpy(jrel), device="cpu")
    preds = [("price", ">=", 20.0), ("suppkey", "!=", 3), ("disc", "<", 10.0)]
    jp = tuple(jopr.Pred(*p) for p in preds)
    tp = tuple(topr.Pred(*p) for p in preds)
    same(jopr.filter_mask(jrel, jp), topr.filter_mask(trel, tp))
    q_j = jopr.Query("t", preds=jp, project=("orderkey",),
                     groupby=jopr.GroupBySpec(("suppkey",), "sum", "price"))
    q_t = topr.Query("t", preds=tp, project=("orderkey",),
                     groupby=topr.GroupBySpec(("suppkey",), "sum", "price"))
    assert jopr.query_fingerprint(q_j) == topr.query_fingerprint(q_t)
    assert q_j.attrs == q_t.attrs
