"""Join queries: the port's ``Daisy`` against the reference's ``Daisy`` on
the same numpy inputs, query by query, and the port's join operators
against the reference's.

After every query the ``JoinState`` (tables, row ids per table with the
free slots' padding, ``valid``, ``overflow``), the ``ExecReport``
(``result_size``, ``recheck_violations``, ``join_overflow``, notes and
every ``StepReport``), each table's overlay, checked bits and columns, the
scope versions and the engine's counters must be exactly equal.  Group-by
keys and group counts are exact; float aggregates are compared with
``rtol=1e-6`` (the packages sum in a different order)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import operators as jopr
from repro.core.constraints import FD as JFD
from repro.core.executor import Daisy as JDaisy, DaisyConfig as JConfig
from repro.core.operators import GroupBySpec as JGroupBy, JoinClause as JJoin
from repro.core.operators import Pred as JPred, Query as JQuery
from repro.core.relation import make_relation as jmake
from repro.data.generators import inject_fd_errors, ssb_lineorder, suppliers
from repro_torch.core import operators as topr
from repro_torch.core.constraints import FD
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.operators import GroupBySpec, JoinClause, Pred, Query
from repro_torch.data import generators as tgen
from repro_torch.obs.trace import Tracer
from repro_torch.testing import relation_from_numpy, relation_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


LA = 0  # conftest's city code for Los Angeles


def _query(spec, pkg):
    """One query in either package from a neutral description:
    ``(table, preds, joins, groupby)`` with joins as
    ``(right, left_on, right_on, right_preds)``."""
    if pkg == "jax":
        P, J, G, Q = JPred, JJoin, JGroupBy, JQuery
    else:
        P, J, G, Q = Pred, JoinClause, GroupBySpec, Query
    table, preds, joins, groupby = spec
    return Q(
        table,
        preds=tuple(P(*p) for p in preds),
        joins=tuple(J(r, lo, ro, tuple(P(*p) for p in rp)) for r, lo, ro, rp in joins),
        groupby=None if groupby is None else G(*groupby),
    )


def _same_arrays(a, b, what):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8),
                                  err_msg=what)


def same_join_state(jd, td, jres, tres, rules, what):
    jr, tr = jres.report, tres.report
    assert (jr.result_size, jr.recheck_violations, jr.join_overflow, jr.notes) == (
        tr.result_size, tr.recheck_violations, tr.join_overflow, tr.notes), what
    assert [s.asdict() for s in jr.steps] == [s.asdict() for s in tr.steps], what
    js, ts = jres.join, tres.join
    assert js.tables == ts.tables, what
    assert js.rows.keys() == ts.rows.keys(), what
    for t in js.rows:
        _same_arrays(js.rows[t], ts.rows[t], f"{what} rows[{t}]")
    _same_arrays(js.valid, ts.valid, f"{what} valid")
    _same_arrays(js.overflow, ts.overflow, f"{what} overflow")
    for table in jd.db:
        a, b = relation_to_numpy(jd.db[table]), relation_to_numpy(td.db[table])
        for field in ("cand", "ccount", "ckind", "checked", "columns"):
            assert a[field].keys() == b[field].keys(), (what, table, field)
            for k in a[field]:
                x, y = a[field][k], b[field][k]
                assert x.dtype == y.dtype, (what, table, field, k)
                np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                              err_msg=f"{what} {table}.{field}.{k}")
    deps = [(t, r.name) for t, rs in rules.items() for r in rs]
    assert jd.scope_versions(deps) == td.scope_versions(deps), what
    assert jd.clean_version == td.clean_version, what
    assert (jd.detect_calls, jd.repair_calls, jd.detect_pairs) == (
        td.detect_calls, td.repair_calls, td.detect_pairs), what
    assert (jres.groups is None) == (tres.groups is None), what
    if jres.groups is not None:
        assert jres.groups.keys() == tres.groups.keys(), what
        for k, v in jres.groups.items():
            if k in ("count", "agg"):
                np.testing.assert_allclose(np.asarray(v), tres.groups[k].numpy(), rtol=1e-6)
            else:
                _same_arrays(v, tres.groups[k], f"{what} groups.{k}")


def run_both(jdb, rule_specs, queries, **cfg):
    """Drive both engines through ``queries`` from the same relations (the
    port's built from the reference's arrays), holding them equal after
    each query; returns the port's results."""
    tdb = {t: relation_from_numpy(relation_to_numpy(r), device="cpu") for t, r in jdb.items()}
    jrules = {t: [JFD(*r) for r in rs] for t, rs in rule_specs.items()}
    trules = {t: [FD(*r) for r in rs] for t, rs in rule_specs.items()}
    jd = JDaisy(jdb, jrules, JConfig(**cfg))
    td = Daisy(tdb, trules, DaisyConfig(**cfg), device="cpu")
    out = []
    for i, spec in enumerate(queries):
        jres = jd.execute(_query(spec, "jax"))
        tres = td.execute(_query(spec, "torch"))
        same_join_state(jd, td, jres, tres, trules, f"query {i} {spec}")
        out.append(tres)
    return out


# ------------------------------------------------ Example 6 / Table 4 cases
EX6_RULES = {"cities": [("phi1", "zip", "city")], "employee": [("phi2", "phone", "zip")]}
EX6_JOIN = ("cities", [("city", "==", LA)], [("employee", "zip", "zip", [])], None)


@pytest.mark.parametrize("case", ["table4e", "groupby", "sequence"])
def test_example6_join_tables(join_tables, case):
    """The conftest ``join_tables`` cases of ``tests/test_join_clean.py``:
    the Table 4e pairs, the 4d relaxed select, phi2's repairs, Lemma 5's
    re-check and the join group-by."""
    by_name = ("cities", [("city", "==", LA)], [("employee", "zip", "zip", [])],
               (("name",), "count", None, "employee"))
    queries = {
        "table4e": [EX6_JOIN],
        "groupby": [by_name],
        "sequence": [EX6_JOIN, by_name, ("cities", [("zip", "==", 9001)],
                                         [("employee", "zip", "zip", [])], None)],
    }[case]
    res = run_both(join_tables, EX6_RULES, queries, join_capacity=64, use_cost_model=False)
    first = res[0]
    li = first.join.rows["cities"].numpy()
    ri = first.join.rows["employee"].numpy()
    pairs = {(int(a), int(b)) for a, b, ok in zip(li, ri, first.join.valid.numpy()) if ok}
    assert pairs == {(0, 0), (1, 0), (1, 1), (1, 2)}
    assert first.report.recheck_violations == 0 and not first.report.join_overflow


# ------------------------------------------------------ fig13's join shapes
N_LO, N_SUP = 2048, 64


def fig13_db(seed=31, n_lo=N_LO, n_sup=N_SUP):
    """fig13's ``build_db``: lineorder with FD orderkey -> suppkey and
    suppliers with FD address -> suppkey, 10% of rows edited in each."""
    lo = ssb_lineorder(n_lo, n_lo // 8, n_sup, seed=seed)
    ds_lo = inject_fd_errors(lo, "orderkey", "suppkey", 1.0, 0.1, n_sup, seed=seed + 1)
    sup = suppliers(n_sup, seed=seed + 2)
    ds_sup = inject_fd_errors(sup, "address", "suppkey", 1.0, 0.1, n_sup, seed=seed + 3)
    return {
        "lineorder": jmake(ds_lo.data, overlay=["orderkey", "suppkey"], k=8, rules=["phi"]),
        "suppliers": jmake(ds_sup.data, overlay=["address", "suppkey"], k=8, rules=["psi"]),
    }


FIG13_RULES = {"lineorder": [("phi", "orderkey", "suppkey")],
               "suppliers": [("psi", "address", "suppkey")]}


def range_joins(nq, n_sup=N_SUP):
    edges = np.linspace(0, n_sup, nq + 1).astype(int)
    return [("lineorder", [("suppkey", ">=", int(a)), ("suppkey", "<", int(b))],
             [("suppliers", "suppkey", "suppkey", [])], None)
            for a, b in zip(edges[:-1], edges[1:])]


REGION_GROUPBY = ("lineorder", [("suppkey", ">=", 0)],
                  [("suppliers", "suppkey", "suppkey", [])],
                  (("region",), "count", None, "suppliers"))


def test_fig13_range_joins_and_region_groupby():
    """fig13's shapes: six range joins over suppkey, then fig15's join
    group-by by supplier region."""
    res = run_both(fig13_db(), FIG13_RULES, range_joins(6) + [REGION_GROUPBY],
                   join_capacity=16384, use_cost_model=False)
    assert all(r.report.recheck_violations == 0 for r in res)
    assert not any(r.report.join_overflow for r in res)
    assert res[-1].groups["num_groups"] > 0


def test_fig13_join_overflow_and_sum_groupby():
    """A capacity that the answers overflow, per row block and in total:
    the truncated pairs, their padding and the overflow flags are equal
    too; a sum group-by over a lineorder value rides the lineage."""
    q_sum = ("lineorder", [("suppkey", "<", 20)], [("suppliers", "suppkey", "suppkey", [])],
             (("region",), "sum", "quantity", None))
    res = run_both(fig13_db(), FIG13_RULES, range_joins(6)[:1] + [q_sum],
                   join_capacity=96, join_row_block=512, use_cost_model=False)
    assert res[0].report.join_overflow and res[1].report.join_overflow


def test_two_chained_joins():
    """Two ``JoinClause``s: the chained branch of ``_join_once`` gathers the
    first join's lineage and joins it with a third table."""
    db = fig13_db()
    regions = {"region": np.arange(5, dtype=np.int32), "zone": np.array([0, 0, 1, 1, 2], np.int32)}
    db["regions"] = jmake(regions, k=8)  # a clean dimension table, no rule
    rules = dict(FIG13_RULES)
    chain = [("suppliers", "suppkey", "suppkey", []), ("regions", "region", "region", [])]
    queries = [
        ("lineorder", [("suppkey", ">=", 10), ("suppkey", "<", 21)], chain, None),
        ("lineorder", [("orderkey", "<", 30)], chain, (("zone",), "count", None, "regions")),
        ("lineorder", [("suppkey", ">=", 40)], chain[:1] + [
            ("regions", "region", "region", [("zone", "==", 1)])], None),
    ]
    res = run_both(db, rules, queries, join_capacity=16384, use_cost_model=False)
    assert res[0].join.tables == ("lineorder", "suppliers", "regions")
    assert all(int(r.join.valid.sum()) > 0 for r in res)


def test_join_span_counts_joins():
    db = {t: relation_from_numpy(relation_to_numpy(r), device="cpu")
          for t, r in fig13_db(seed=3, n_lo=256, n_sup=8).items()}
    tracer = Tracer()
    daisy = Daisy(db, {t: [FD(*r) for r in rs] for t, rs in FIG13_RULES.items()},
                  DaisyConfig(use_cost_model=False), tracer=tracer, device="cpu")
    daisy.execute(_query(range_joins(1, n_sup=8)[0], "torch"))
    spans = [e for e in tracer.events() if e.name == "daisy.execute"]
    assert spans and spans[-1].attrs["joins"] == 1


def test_suppliers_is_the_reference_copy():
    for seed in (1, 33):
        a, b = suppliers(50, seed=seed), tgen.suppliers(50, seed=seed)
        assert a.keys() == b.keys()
        for k in a:
            _same_arrays(a[k], torch.from_numpy(b[k]), k)


# ------------------------------------------------------------- operators
def _keys(rng, n, k, hi, p_alive=0.7):
    vals = rng.integers(0, hi, (n, k)).astype(np.int32)
    alive = rng.random((n, k)) < p_alive
    return vals, alive


@pytest.mark.parametrize("cap_out,row_block", [(40, 16), (7, 16), (300, 64), (1000, 1000)])
def test_prob_equijoin_matches_reference(cap_out, row_block):
    """At (7, 16) a block overflows, at (40, 16) the total does; the kept
    pairs, the padding ``(n_l, n_r)`` and the flag are bit-identical."""
    rng = np.random.default_rng(cap_out)
    n_l, n_r = 70, 23
    lv, la = _keys(rng, n_l, 3, 9)
    rv, ra = _keys(rng, n_r, 2, 9)
    ml, mr = rng.random(n_l) < 0.8, rng.random(n_r) < 0.8
    want = jopr.prob_equijoin(jnp.asarray(lv), jnp.asarray(la), jnp.asarray(ml),
                              jnp.asarray(rv), jnp.asarray(ra), jnp.asarray(mr),
                              cap_out, row_block)
    t = torch.from_numpy
    got = topr.prob_equijoin(t(lv), t(la), t(ml), t(rv), t(ra), t(mr), cap_out, row_block)
    for w, g, name in zip(want, got, ("li", "ri", "valid", "overflow")):
        _same_arrays(w, g, name)
    if cap_out == 7:
        assert bool(got[3])


def test_overlap_matrix_and_float_keys():
    """The sort-merge's pairs are the true entries of the reference's
    masked overlap matrix (its K_l x K_r loop), and the join agrees with
    the reference on float keys with NaN and signed zeros (NaN matches
    nothing, -0.0 matches +0.0)."""
    rng = np.random.default_rng(4)
    special = np.array([np.nan, 0.0, -0.0, 1.0, 2.5], np.float32)
    lv, rv = rng.choice(special, (30, 2)), rng.choice(special, (11, 3))
    la, ra = rng.random((30, 2)) < 0.8, rng.random((11, 3)) < 0.8
    ml, mr = np.ones(30, bool), rng.random(11) < 0.9
    j = jnp.asarray
    t = torch.from_numpy
    overlap = np.asarray(jopr.candidate_overlap_matrix(j(lv), j(la), j(rv), j(ra)))
    want_keys = np.flatnonzero(overlap & ml[:, None] & mr[None, :])
    got_keys = topr._overlap_pairs(t(lv), t(la), t(ml), t(rv), t(ra), t(mr))
    _same_arrays(want_keys, got_keys, "overlap")
    want = jopr.prob_equijoin(j(lv), j(la), j(ml), j(rv), j(ra), j(mr), 400, 8)
    got = topr.prob_equijoin(t(lv), t(la), t(ml), t(rv), t(ra), t(mr), 400, 8)
    for w, g, name in zip(want, got, ("li", "ri", "valid", "overflow")):
        _same_arrays(w, g, name)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=8, deadline=None)
def test_dedupe_pairs_keeps_first_occurrence(seed):
    rng = np.random.default_rng(seed)
    n = 64
    li = rng.integers(0, 5, n).astype(np.int32)
    ri = rng.integers(0, 4, n).astype(np.int32)
    v = rng.random(n) < 0.8
    want = jopr.dedupe_pairs(jnp.asarray(li), jnp.asarray(ri), jnp.asarray(v))
    got = topr.dedupe_pairs(torch.from_numpy(li), torch.from_numpy(ri), torch.from_numpy(v))
    _same_arrays(want, got, "dedupe")
