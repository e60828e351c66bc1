"""The slice as a whole: the port's ``Daisy`` against the reference's
``Daisy`` on the same workloads, query by query.

After every query the answer mask, every overlay array (``cand``,
``ccount``, ``ckind``), the checked bits, each ``StepReport.asdict()``, the
plan notes, the scope versions and the clean version must be exactly equal.
Group-by keys and group counts are exact; float aggregates are compared with
``rtol=1e-6`` (the packages sum probabilities in a different order)."""

import gc
import jax
import numpy as np
import pytest
import torch

from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom
from repro.core.executor import Daisy as JDaisy, DaisyConfig as JConfig
from repro.core.operators import GroupBySpec as JGroupBy, Pred as JPred, Query as JQuery
from repro.core.relation import make_relation as jmake
from repro.data.generators import inject_dc_errors, inject_fd_errors, ssb_lineorder
from repro_torch.core.constraints import DC, FD, Atom
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.operators import GroupBySpec, Pred, Query
from repro_torch.core.relation import make_relation as tmake
from repro_torch.data import generators as tgen
from repro_torch.dist.hints import Mesh
from repro_torch.obs.trace import Tracer
from repro_torch.testing import relation_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


def _q(spec, pkg):
    """Build one query in either package from a neutral description."""
    P, Q, G = (JPred, JQuery, JGroupBy) if pkg == "jax" else (Pred, Query, GroupBySpec)
    preds = tuple(P(*p) for p in spec.get("preds", ()))
    g = spec.get("groupby")
    return Q("t", preds=preds, groupby=None if g is None else G(*g))


def _rules(specs, pkg):
    F, D, A = (JFD, JDC, JAtom) if pkg == "jax" else (FD, DC, Atom)
    out = []
    for spec in specs:
        if spec[0] == "fd":
            out.append(F(spec[1], spec[2], spec[3]))
        else:
            out.append(D(spec[1], [A(*a) for a in spec[2]]))
    return out


def same_state(jd, td, jres, tres, rules, what):
    np.testing.assert_array_equal(np.asarray(jres.mask), tres.mask.numpy(), err_msg=what)
    assert [s.asdict() for s in jres.report.steps] == [s.asdict() for s in tres.report.steps], what
    assert jres.report.notes == tres.report.notes, what
    assert jres.report.result_size == tres.report.result_size, what
    a, b = relation_to_numpy(jd.db["t"]), relation_to_numpy(td.db["t"])
    for field in ("cand", "ccount", "ckind", "checked", "columns"):
        assert a[field].keys() == b[field].keys()
        for k in a[field]:
            x, y = a[field][k], b[field][k]
            assert x.dtype == y.dtype, (what, field, k)
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                          err_msg=f"{what} {field}.{k}")
    deps = [("t", r) for r in rules]
    assert jd.scope_versions(deps) == td.scope_versions(deps), what
    assert jd.clean_version == td.clean_version, what
    assert (jd.detect_calls, jd.repair_calls, jd.detect_pairs, jd.tiles_launched,
            jd.tiles_skipped) == (td.detect_calls, td.repair_calls, td.detect_pairs,
                                  td.tiles_launched, td.tiles_skipped), what
    if jres.groups is not None:
        assert jres.groups.keys() == tres.groups.keys()
        for k, v in jres.groups.items():
            if k in ("count", "agg"):
                np.testing.assert_allclose(np.asarray(v), tres.groups[k].numpy(), rtol=1e-6)
            else:
                np.testing.assert_array_equal(np.asarray(v), tres.groups[k].numpy(), err_msg=k)


def run_both(data, overlay, rule_specs, queries, k=4, **cfg):
    """Drive both engines through ``queries``, holding them equal after each;
    returns the modes the port's steps took."""
    names = [s[1] for s in rule_specs]
    jrel = jmake(data, overlay=overlay, k=k, rules=names)
    trel = tmake(data, overlay=overlay, k=k, rules=names, device="cpu")
    jd = JDaisy({"t": jrel}, {"t": _rules(rule_specs, "jax")}, JConfig(k=k, **cfg))
    td = Daisy({"t": trel}, {"t": _rules(rule_specs, "torch")}, DaisyConfig(k=k, **cfg),
               device="cpu")
    modes = []
    for i, spec in enumerate(queries):
        jres = jd.execute(_q(spec, "jax"))
        tres = td.execute(_q(spec, "torch"))
        same_state(jd, td, jres, tres, names, f"query {i} {spec}")
        modes += [s.mode for s in tres.report.steps]
    return modes


LA, SF, NY = 0, 1, 2
CITIES = {"zip": np.array([9001, 9001, 9001, 10001, 10001]), "city": np.array([LA, SF, LA, SF, NY])}


@pytest.mark.parametrize("first", ["rhs", "lhs", "groupby"])
def test_cities_fd(first):
    """Table 2a with FD zip -> city: rhs and lhs filters (Examples 2, 3),
    the bare group-by pushdown (full clean) and re-queries that skip."""
    queries = {
        "rhs": [dict(preds=[("city", "==", LA)])],
        "lhs": [dict(preds=[("zip", "==", 9001)])],
        "groupby": [dict(groupby=(("city",), "count"))],
    }[first] + [
        dict(preds=[("zip", "==", 10001)]),
        dict(preds=[("city", "!=", NY)]),
        dict(groupby=(("city",), "count")),
        dict(preds=[("zip", "==", 9001)]),
    ]
    modes = run_both(CITIES, ["zip", "city"], [("fd", "zip_city", "zip", "city")],
                     queries, use_cost_model=False)
    assert "skipped" in modes


@pytest.mark.parametrize("lemma1", [False, True])
def test_cities_fd_lemma1_and_cost_model(lemma1):
    queries = [dict(preds=[("city", "==", LA)]), dict(preds=[("zip", ">=", 9001)]),
               dict(preds=[("city", "==", NY)])]
    run_both(CITIES, ["zip", "city"], [("fd", "zip_city", "zip", "city")], queries,
             lemma1_fast_path=lemma1, expected_queries=3)


SALARY = {
    "salary": np.array([1000.0, 3000.0, 2000.0], np.float32),
    "tax": np.array([0.1, 0.2, 0.3], np.float32),
    "age": np.array([31, 32, 43]),
}


@pytest.mark.parametrize("threshold", [0.5, 2.0])
def test_salary_tax_dc(threshold):
    """Example 4's DC; the threshold steers Algorithm 2 to the incremental
    matrix strips (0.5) or the full clean (2.0)."""
    dc = ("dc", "dc_sal_tax", [("salary", "<", "salary"), ("tax", ">", "tax")])
    queries = [dict(preds=[("salary", ">=", 2000.0)]), dict(preds=[("tax", "<", 0.25)]),
               dict(preds=[("salary", ">=", 2000.0)])]
    modes = run_both(SALARY, ["salary", "tax"], [dc], queries, use_cost_model=False,
                     dc_partitions=4, accuracy_threshold=threshold)
    assert modes[0] == ("full" if threshold > 1 else "incremental")


def lineorder_workload(n=384, seed=21):
    """Small SSB lineorder with FD orderkey -> suppkey errors and fig12's
    price/discount DC errors on one table."""
    clean = ssb_lineorder(n, n // 8, 12, seed=seed)
    order = np.argsort(clean["extended_price"])
    d = np.sort(clean["discount"])[::-1]
    clean["discount"] = d[np.argsort(order)].astype(np.float32)
    ds = inject_fd_errors(clean, "orderkey", "suppkey", 1.0, 0.1, n_values=12, seed=seed + 1)
    return inject_dc_errors(ds.data, "discount", 0.05, 0.3, seed=seed + 2).data


RULES = [
    ("fd", "fd_os", "orderkey", "suppkey"),
    ("dc", "dc_pd", [("extended_price", "<", "extended_price"), ("discount", ">", "discount")]),
]


@pytest.mark.parametrize("cfg", [
    dict(use_cost_model=False, accuracy_threshold=0.0),  # incremental DC strips
    dict(expected_queries=4, accuracy_threshold=0.3),  # cost model + Algorithm 2
    dict(expected_queries=4, accuracy_threshold=0.0, strip_rows=128, kernel_encodings=False),
])
def test_lineorder_fd_and_dc(cfg):
    data = lineorder_workload()
    edges = np.linspace(0, 48, 4).astype(int)
    prices = np.linspace(1000, 5000, 4)
    queries = []
    for (a, b), (p, q) in zip(zip(edges[:-1], edges[1:]), zip(prices[:-1], prices[1:])):
        queries.append(dict(preds=[("orderkey", ">=", int(a)), ("orderkey", "<", int(b))]))
        queries.append(dict(preds=[("extended_price", ">=", float(p)),
                                   ("extended_price", "<", float(q))]))
    queries.append(dict(groupby=(("suppkey",), "sum", "extended_price")))
    modes = run_both(data, ["orderkey", "suppkey", "extended_price", "discount"], RULES,
                     queries, k=8, dc_partitions=16, dc_block=64, **cfg)
    assert {"incremental", "skipped"} & set(modes)


def test_generators_are_the_reference_copies():
    a = ssb_lineorder(100, 20, 5, seed=3)
    b = tgen.ssb_lineorder(100, 20, 5, seed=3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    fa = inject_fd_errors(a, "orderkey", "suppkey", 0.5, 0.2, seed=4)
    fb = tgen.inject_fd_errors(b, "orderkey", "suppkey", 0.5, 0.2, seed=4)
    da = inject_dc_errors(a, "discount", 0.1, 0.3, seed=5)
    db = tgen.inject_dc_errors(b, "discount", 0.1, 0.3, seed=5)
    for x, y in ((fa, fb), (da, db)):
        np.testing.assert_array_equal(x.error_rows, y.error_rows)
        for k in x.data:
            np.testing.assert_array_equal(x.data[k], y.data[k])
            np.testing.assert_array_equal(x.truth[k], y.truth[k])


def test_unported_paths_raise_and_tracer_spans():
    rel = tmake(CITIES, overlay=["zip", "city"], rules=["zip_city"], device="cpu")
    rules = {"t": [FD("zip_city", "zip", "city")]}
    # sharded detection runs logical shards on one device: a mesh spreading
    # data over two devices is refused
    with pytest.raises(NotImplementedError):
        Daisy({"t": rel}, rules, DaisyConfig(mesh=Mesh([["cpu"], ["cpu"]], ("data", "model"))),
              device="cpu")
    tracer = Tracer()
    daisy = Daisy({"t": rel}, rules, DaisyConfig(use_cost_model=False), tracer=tracer,
                  device="cpu")
    daisy.execute(Query("t", preds=(Pred("zip", "==", 9001),)))
    names = {e.name for e in tracer.events()}
    assert {"daisy.execute", "clean.relax", "clean.detect", "clean.repair", "clean.mark"} <= names
    # join queries are ported (tests/test_torch_join.py); the span counts them
    assert [e.attrs["joins"] for e in tracer.events() if e.name == "daisy.execute"] == [0]
