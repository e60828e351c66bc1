"""The offline baseline: the port's ``OfflineCleaner`` against the
reference's on the same numpy inputs, and the FD guarantee inside the port.

After ``clean_all`` every table's overlay (``cand``, ``ccount``, ``ckind``),
checked bits and columns must be bit-identical to the reference's, and so
must each later answer's mask and step reports.  The FD guarantee of
``tests/test_executor.py`` (Daisy's incremental answers equal the offline
answers, §1 contribution 1) must hold for the port's own two engines."""

import gc

import jax
import numpy as np
import pytest
import torch

from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom
from repro.core.executor import DaisyConfig as JConfig
from repro.core.offline import OfflineCleaner as JOffline
from repro.core.operators import Pred as JPred, Query as JQuery
from repro.core.relation import make_relation as jmake
from repro.data.generators import inject_dc_errors, inject_fd_errors, ssb_lineorder
from repro_torch.core.constraints import DC, FD, Atom
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.offline import OfflineCleaner
from repro_torch.core.operators import Pred, Query
from repro_torch.core.relation import make_relation as tmake
from repro_torch.testing import relation_from_numpy, relation_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


def same_db(jdb, tdb, what):
    assert jdb.keys() == tdb.keys()
    for table in jdb:
        a, b = relation_to_numpy(jdb[table]), relation_to_numpy(tdb[table])
        for field in ("cand", "ccount", "ckind", "checked", "columns"):
            assert a[field].keys() == b[field].keys(), (what, table, field)
            for k in a[field]:
                x, y = a[field][k], b[field][k]
                assert x.dtype == y.dtype, (what, table, field, k)
                np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                              err_msg=f"{what} {table}.{field}.{k}")


def _rules(specs, pkg):
    F, D, A = (JFD, JDC, JAtom) if pkg == "jax" else (FD, DC, Atom)
    return [F(*s[1:]) if s[0] == "fd" else D(s[1], [A(*a) for a in s[2]]) for s in specs]


def _queries(specs, pkg):
    P, Q = (JPred, JQuery) if pkg == "jax" else (Pred, Query)
    return [Q("t", preds=tuple(P(*p) for p in preds)) for preds in specs]


def offline_both(jrel, rule_specs, queries, **cfg):
    """Clean the same relation with both cleaners, hold them equal, then
    answer ``queries`` with both; returns the port's cleaner."""
    trel = relation_from_numpy(relation_to_numpy(jrel), device="cpu")
    joff = JOffline({"t": jrel}, {"t": _rules(rule_specs, "jax")}, JConfig(**cfg))
    toff = OfflineCleaner({"t": trel}, {"t": _rules(rule_specs, "torch")}, DaisyConfig(**cfg))
    joff.clean_all()
    toff.clean_all()
    same_db(joff.db, toff.db, "after clean_all")
    for i, (jq, tq) in enumerate(zip(_queries(queries, "jax"), _queries(queries, "torch"))):
        jres, tres = joff.execute(jq), toff.execute(tq)
        np.testing.assert_array_equal(np.asarray(jres.mask), tres.mask.numpy(),
                                      err_msg=f"query {i}")
        assert [s.asdict() for s in jres.report.steps] == [
            s.asdict() for s in tres.report.steps]
        same_db(joff.db, toff.db, f"query {i}")
    return toff


LA, SF, NY = 0, 1, 2
CITIES = {"zip": np.array([9001, 9001, 9001, 10001, 10001]),
          "city": np.array([LA, SF, LA, SF, NY])}
CITY_QUERIES = [[("city", "==", LA)], [("zip", "==", 9001)], [("zip", "==", 10001)],
                [("city", "!=", NY)]]
CITY_RULES = [("fd", "zip_city", "zip", "city")]


def test_cities_offline_matches_reference(cities_rel):
    offline_both(cities_rel, CITY_RULES, CITY_QUERIES)


def lineorder(n=384, seed=21):
    """Small SSB lineorder with FD orderkey -> suppkey errors and fig12's
    price/discount DC errors on one table."""
    clean = ssb_lineorder(n, n // 8, 12, seed=seed)
    order = np.argsort(clean["extended_price"])
    d = np.sort(clean["discount"])[::-1]
    clean["discount"] = d[np.argsort(order)].astype(np.float32)
    ds = inject_fd_errors(clean, "orderkey", "suppkey", 1.0, 0.1, n_values=12, seed=seed + 1)
    return inject_dc_errors(ds.data, "discount", 0.05, 0.3, seed=seed + 2).data


LO_OVERLAY = ["orderkey", "suppkey", "extended_price", "discount"]
LO_RULES = [("fd", "fd_os", "orderkey", "suppkey"),
            ("dc", "dc_pd", [("extended_price", "<", "extended_price"),
                             ("discount", ">", "discount")])]
LO_QUERIES = [[("orderkey", ">=", 0), ("orderkey", "<", 16)],
              [("suppkey", "==", 3)],
              [("extended_price", ">=", 2000.0), ("extended_price", "<", 3000.0)],
              [("discount", ">", 0.25)]]


def test_lineorder_fd_and_dc_offline_matches_reference():
    """One table with an FD and a DC: the DC clean is one full-matrix scan."""
    jrel = jmake(lineorder(), overlay=LO_OVERLAY, k=8, rules=["fd_os", "dc_pd"])
    toff = offline_both(jrel, LO_RULES, LO_QUERIES, k=8, dc_block=64)
    for name in ("fd_os", "dc_pd"):
        assert bool(toff.db["t"].checked[name].all())


@pytest.mark.parametrize("workload", ["cities", "lineorder"])
def test_fd_guarantee_inside_the_port(workload):
    """Daisy's incremental answers equal the offline answers, query by
    query, for FD rules (the port's Daisy against the port's cleaner)."""
    if workload == "cities":
        data, overlay, rules, queries, k = CITIES, ["zip", "city"], CITY_RULES, CITY_QUERIES, 4
    else:
        data, overlay, k = lineorder(seed=5), ["orderkey", "suppkey"], 8
        rules, queries = LO_RULES[:1], LO_QUERIES[:2] + [
            [("orderkey", ">=", 30)], [("suppkey", "<", 4)]]
    names = [r[1] for r in rules]

    def rel():
        return tmake(data, overlay=overlay, k=k, rules=names, device="cpu")

    daisy = Daisy({"t": rel()}, {"t": _rules(rules, "torch")},
                  DaisyConfig(k=k, use_cost_model=False), device="cpu")
    off = OfflineCleaner({"t": rel()}, {"t": _rules(rules, "torch")}, DaisyConfig(k=k))
    off.clean_all()
    for i, q in enumerate(_queries(queries, "torch")):
        np.testing.assert_array_equal(daisy.execute(q).mask.numpy(),
                                      off.execute(q).mask.numpy(), err_msg=f"query {i}")


def test_offline_runs_on_the_relations_device():
    off = OfflineCleaner({"t": tmake(CITIES, overlay=["zip", "city"], rules=["zip_city"],
                                     device="cpu")},
                         {"t": _rules(CITY_RULES, "torch")})
    off.clean_all()
    res = off.execute(Query("t", preds=(Pred("city", "==", LA),)))
    assert res.mask.device.type == "cpu" and off._engine.device.type == "cpu"
