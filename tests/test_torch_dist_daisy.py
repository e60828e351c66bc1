"""A mesh-configured ``Daisy`` in the port (DESIGN.md §8, §10) against the
JAX reference's mesh-configured ``Daisy`` and the port's dense one.

One short workload runs on three engines built from the same numpy table
(an FD zip -> city and a DC keyed on ``dept``): the reference with a
one-device JAX mesh and ``detect_shards=4``, the port with
``dist.hints.Mesh`` on the CPU and the same shard count, and the port
without a mesh.  It holds range queries, a group-by, an append (whose
ingest-delta stays dense), background strip and group increments, and the
background cleaner's priorities.  The sharded port must equal the
reference query by query in masks, overlays, checked bits, step reports,
ledger versions, ``sharded_info`` and the cost models' observed detect
cost, and the dense port in masks, overlays and step modes.  The
reference run is shared by every test of the file.
"""

import dataclasses
import gc
import types

import jax
import numpy as np
import pytest
import torch

import repro.service as jservice
from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom
from repro.core.executor import Daisy as JDaisy, DaisyConfig as JConfig
from repro.core.operators import GroupBySpec as JGroupBy, Pred as JPred, Query as JQuery
from repro.core.relation import make_relation as jmake
import repro_torch.service as tservice
from repro_torch.core.constraints import DC, FD, Atom
from repro_torch.core.cost import sharded_detect_cost
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.operators import GroupBySpec, Pred, Query
from repro_torch.core.relation import make_relation as tmake
from repro_torch.dist.hints import one_device_mesh
from repro_torch.testing import engine_state, state_differences

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end."""
    yield
    jax.clear_caches()
    gc.collect()


REF = types.SimpleNamespace(
    make=jmake, Daisy=JDaisy, Config=JConfig, Query=JQuery, Pred=JPred, GroupBy=JGroupBy,
    DC=JDC, FD=JFD, Atom=JAtom, svc=jservice, kw={},
)
PORT = types.SimpleNamespace(
    make=tmake, Daisy=Daisy, Config=DaisyConfig, Query=Query, Pred=Pred, GroupBy=GroupBySpec,
    DC=DC, FD=FD, Atom=Atom, svc=tservice, kw={"device": "cpu"},
)
RULES = ("fz", "phi")
N, CAP, APPEND = 200, 256, 24


def data(seed, n):
    rng = np.random.default_rng(seed)
    zip_ = rng.integers(0, 12, n).astype(np.int32)
    city = (zip_ // 3 + (rng.random(n) < 0.1) * rng.integers(1, 3, n)).astype(np.int32)
    return {
        "zip": zip_, "city": city,
        "dept": rng.integers(0, 5, n).astype(np.int32),
        "salary": rng.integers(1, 40, n).astype(np.float32),
        "tax": rng.integers(1, 40, n).astype(np.float32) / 10.0,
    }


def build(p, mesh):
    rel = p.make(data(0, N), capacity=CAP, overlay=["zip", "city", "salary", "tax"], k=4,
                 rules=list(RULES), **p.kw)
    fd = p.FD("fz", "zip", "city")
    dc = p.DC("phi", [p.Atom("dept", "==", "dept"), p.Atom("salary", "<", "salary"),
                      p.Atom("tax", ">", "tax")])
    cfg = p.Config(k=4, mesh=mesh, detect_shards=None if mesh is None else 4, dc_block=64,
                   strip_rows=64, dc_partitions=4, expected_queries=6)
    return p.Daisy({"t": rel}, {"t": [fd, dc]}, cfg, **p.kw)


def queries(p):
    return [
        p.Query("t", preds=(p.Pred("salary", ">=", 25.0),)),
        p.Query("t", preds=(p.Pred("zip", "<", 4),)),
        p.Query("t", groupby=p.GroupBy(("city",), "count")),
        p.Query("t", preds=(p.Pred("salary", "<", 12.0), p.Pred("dept", "==", 2))),
        p.Query("t", preds=(p.Pred("tax", ">", 1.5),)),
    ]


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def record(daisy, res):
    """What one query leaves behind, as host values."""
    rel = daisy.db["t"]
    out = {"mask": None if res.mask is None else host(res.mask)}
    for field in ("cand", "ccount", "ckind", "checked"):
        for k, v in getattr(rel, field).items():
            out[f"{field}.{k}"] = host(v)
    for k, v in (res.groups or {}).items():
        out[f"groups.{k}"] = host(v)
    out["steps"] = [s.asdict() for s in res.report.steps]
    out["versions"] = [daisy.scope_version("t", r) for r in RULES]
    out["clean_version"] = daisy.clean_version
    return out


def sharded_view(daisy):
    """``sharded_info`` and each rule's observed and effective detect cost."""
    info = {f"{t}/{r}": dataclasses.asdict(i) for (t, r), i in daisy.sharded_info.items()}
    costs = {f"{t}/{r}": (cm.df_observed, cm.df_effective) for (t, r), cm in daisy.cost.items()}
    return info, costs


def priorities(p, daisy):
    return [dataclasses.asdict(s) for s in p.svc.BackgroundCleaner(daisy).cold_scopes()]


def run(p, mesh):
    daisy = build(p, mesh)
    log = []
    for q in queries(p)[:3]:
        log.append(("query", record(daisy, daisy.execute(q))))
    log.append(("sharded", sharded_view(daisy)))
    log.append(("priorities", priorities(p, daisy)))
    daisy.ingest("t", data(1, APPEND))
    for q in queries(p)[3:]:
        log.append(("query", record(daisy, daisy.execute(q))))
    for rule, kw in (("phi", dict(max_strips=1)), ("fz", dict(max_rows=40)),
                     ("phi", dict(max_strips=2))):
        step = daisy.clean_scope_increment("t", rule, **kw)
        log.append(("increment", None if step is None else step.asdict()))
    log.append(("sharded", sharded_view(daisy)))
    log.append(("priorities", priorities(p, daisy)))
    return daisy, log


@pytest.fixture(scope="module")
def runs():
    return {
        "reference": run(REF, _jax_mesh()),
        "port": run(PORT, one_device_mesh("cpu")),
        "port dense": run(PORT, None),
    }


def _jax_mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        x, y = (a.view(np.uint8), b.view(np.uint8)) if a.dtype.kind == "f" else (a, b)
        np.testing.assert_array_equal(x, y, err_msg=what)
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


def test_sharded_daisy_matches_reference(runs):
    (jd, jlog), (td, tlog) = runs["reference"], runs["port"]
    assert [e[0] for e in tlog] == [e[0] for e in jlog]
    for i, ((kind, got), (_, want)) in enumerate(zip(tlog, jlog)):
        same(got, want, f"{i} {kind}")
    assert state_differences(engine_state(td), engine_state(jd)) == []


def test_sharded_daisy_reports_the_sharded_path(runs):
    _, log = runs["port"]
    steps = [s for kind, rec in log if kind == "query" for s in rec["steps"]]
    steps += [rec for kind, rec in log if kind == "increment" and rec is not None]
    detected = [s for s in steps if s["mode"] != "skipped"]
    assert detected and {s["rule"] for s in detected} == set(RULES)
    for s in detected:
        assert s["detect_path"] == ("dense" if s["mode"] == "ingest-delta" else "sharded"), s
    info, costs = [rec for kind, rec in log if kind == "sharded"][-1]
    assert set(info) == {"t/fz", "t/phi"}
    assert all(c[0] is not None and c[1] <= c[0] for c in costs.values())
    assert info["t/phi"]["n_shards"] == 4 and info["t/phi"]["per_shard_strips"] is not None


def test_sharded_daisy_matches_dense_daisy(runs):
    """The same answers, overlays, checked bits and step modes as the port
    without a mesh (tile counts and the detect path differ by design)."""
    (sd, slog), (dd, dlog) = runs["port"], runs["port dense"]
    for i, ((kind, s), (_, d)) in enumerate(zip(slog, dlog, strict=True)):
        if kind == "query":
            for k in s:
                if k != "steps":
                    same(s[k], d[k], f"{i} {k}")
            assert [x["mode"] for x in s["steps"]] == [x["mode"] for x in d["steps"]]
            assert [x["repaired"] for x in s["steps"]] == [x["repaired"] for x in d["steps"]]
        elif kind == "increment":
            assert (s is None) == (d is None)
            if s is not None:
                assert (s["mode"], s["repaired"]) == (d["mode"], d["repaired"])
    assert dd.sharded_info == {}
    a, b = engine_state(sd), engine_state(dd)
    diff = state_differences(a, b)
    assert set(diff) <= {"ledger", "counters"}, diff


def test_cost_model_observes_the_sharded_routing(runs):
    """Each rule's cost model holds the cheapest observed sharded detect
    price (``sharded_detect_cost`` of a routing it ran), which the
    background cleaner's ranking reads; the dense engine observes none."""
    (sd, slog), (dd, _) = runs["port"], runs["port dense"]
    for key, cm in sd.cost.items():
        price = sharded_detect_cost(sd.sharded_info[key], n_rows=cm.n)
        assert cm.df_observed is not None and cm.df_observed <= price
        assert cm.df_effective == min(cm.df, cm.df_observed)
        assert dd.cost[key].df_observed is None
    ranked = [rec for kind, rec in slog if kind == "priorities"]
    assert ranked[0] and {(x["table"], x["rule"]) for x in ranked[0]} <= {("t", r) for r in RULES}


def test_mesh_must_hold_the_engines_device():
    rel = tmake(data(0, 8), overlay=["zip", "city"], k=4, rules=["fz"], device="cpu")
    # a mesh over another device than the engine's (built by hand: no such
    # device is present on a CPU-only machine)
    elsewhere = types.SimpleNamespace(devices=np.array([torch.device("meta")], dtype=object),
                                      axis_names=("data",), shape={"data": 1})
    with pytest.raises(ValueError, match="does not hold"):
        Daisy({"t": rel}, {"t": [FD("fz", "zip", "city")]}, DaisyConfig(mesh=elsewhere),
              device="cpu")
