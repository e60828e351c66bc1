"""Streaming ingest and background increments in the port against the
reference (DESIGN.md §10-§12).

The same numpy rows go through the JAX package and the port (on the CPU)
op by op: ``append_rows``, ``Daisy.ingest`` and the ingest-delta steps the
next cleaning steps drain.  After every op the answer masks, the
``StepReport``s and ``IngestReport``s, every relation array (bit for bit),
the work ledger (cold counts, fresh strips, queued deltas, versions) and
the work counters must be equal.  The DC scope uses 8-row blocks, so an
append that starts off a block boundary gives the delta's pair scan a
first fresh col block holding old rows, and a growing append widens the
kernel grid.  The reference's regime (``tests/test_ingest.py``) holds too:
a chunked ingest cleaned after each append equals a rebuild over all rows,
in both packages.  Background increments (``clean_scope_increment``: FD
row budgets, DC strip budgets of 1, 2 and every cold strip) are held
against the reference increment by increment, before and after an append.
"""

import gc
import types
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.core import relation as jrelation
from repro.core import detect as jdetect
from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom
from repro.core.executor import Daisy as JDaisy, DaisyConfig as JConfig
from repro.core.ledger import TABLE_ROWS_RULE
from repro.core.operators import GroupBySpec as JGroupBy, Pred as JPred, Query as JQuery
from repro_torch.core import detect as tdetect
from repro_torch.core import relation as trelation
from repro_torch.core.constraints import DC, FD, Atom
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.operators import GroupBySpec, Pred, Query
from repro_torch.testing import (
    engine_state,
    relation_from_numpy,
    relation_to_numpy,
    state_differences,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end."""
    yield
    jax.clear_caches()
    gc.collect()


PKGS = {
    "jax": types.SimpleNamespace(
        Daisy=JDaisy, Config=JConfig, FD=JFD, DC=JDC, Atom=JAtom, Pred=JPred,
        Query=JQuery, GroupBy=JGroupBy, make=jrelation.make_relation,
    ),
    "torch": types.SimpleNamespace(
        Daisy=partial(Daisy, device="cpu"), Config=DaisyConfig, FD=FD, DC=DC, Atom=Atom,
        Pred=Pred, Query=Query, GroupBy=GroupBySpec,
        make=partial(trelation.make_relation, device="cpu"),
    ),
}
OVERLAY = ["zip", "city", "beds", "quality"]


def rules(p):
    return [
        p.FD("zc", "zip", "city"),
        p.DC("bq", [p.Atom("beds", "<", "beds"), p.Atom("quality", ">", "quality")]),
    ]


def make_daisy(p, data, block=8, capacity=None):
    rel = p.make(data, capacity=capacity, overlay=OVERLAY, k=8, rules=["zc", "bq"])
    # accuracy_threshold=2.0: auto DC steps resolve to full cleans, so a
    # streamed and a rebuilt run execute the same plan shape
    cfg = p.Config(use_cost_model=False, accuracy_threshold=2.0, dc_block=block,
                   strip_rows=block)
    return p.Daisy({"h": rel}, {"h": rules(p)}, cfg)


def table(n, seed, float_quality=False):
    """Cluster-disjoint hospital rows (a city value lives in one zip group),
    small value ranges: the regime where streamed == rebuilt holds."""
    rng = np.random.default_rng(seed)
    zips = rng.integers(0, 4, n).astype(np.int32)
    quality = rng.integers(0, 40, n)
    return {
        "zip": zips,
        "city": (zips * 8 + rng.integers(0, 6, n)).astype(np.int32),
        "beds": rng.integers(0, 40, n).astype(np.int32),
        "quality": quality.astype(np.float32 if float_quality else np.int32),
    }


def rows(data, lo, hi):
    return {k: v[lo:hi] for k, v in data.items()}


def query(p, spec):
    if spec == "groupby":  # bare group-by: the FD's pushdown full clean
        return p.Query("h", groupby=p.GroupBy(keys=("city",), agg="count"))
    col, op, val = spec
    return p.Query("h", preds=(p.Pred(col, op, val),))


FULL_CLEAN = ("groupby", ("beds", ">=", 0))
# one capacity for every pair that does not grow, so the reference's compiled
# code is shared across the tests
CAPACITY = 64


class Pair:
    """One ``Daisy`` of each package over the same rows, driven op by op."""

    def __init__(self, data, block=8, capacity=CAPACITY):
        self.d = {name: make_daisy(p, data, block, capacity) for name, p in PKGS.items()}
        self.check("construction")

    def check(self, what):
        j, t = (engine_state(self.d[n]) for n in ("jax", "torch"))
        bad = state_differences(j, t)
        assert not bad, f"{what}: state differs at {bad}"

    def execute(self, spec):
        out = {}
        for name, p in PKGS.items():
            res = self.d[name].execute(query(p, spec))
            out[name] = (np.asarray(res.mask) if name == "jax" else res.mask.numpy(),
                         [s.asdict() for s in res.report.steps], res.report.notes)
        np.testing.assert_array_equal(out["jax"][0], out["torch"][0], err_msg=str(spec))
        assert out["jax"][1:] == out["torch"][1:], spec
        self.check(f"after {spec}")
        return out["torch"][1]

    def increment(self, rule, **budget):
        reps = {n: self.d[n].clean_scope_increment("h", rule, **budget) for n in PKGS}
        got = [None if r is None else r.asdict() for r in reps.values()]
        assert got[0] == got[1], (rule, budget)
        assert self.d["jax"].cold_count("h", rule) == self.d["torch"].cold_count("h", rule)
        self.check(f"after increment {rule} {budget}")
        return got[1]

    def ingest(self, chunk):
        reps = {n: self.d[n].ingest("h", chunk).asdict() for n in PKGS}
        assert reps["jax"] == reps["torch"]
        self.check(f"after ingest at {reps['torch']['start']}")
        return reps["torch"]


# --------------------------------------------------------------- append_rows
BASE_ROWS, BASE_CAPACITY = 20, 64
APPEND_DATA = table(BASE_ROWS + 250, seed=7, float_quality=True)


@pytest.fixture(scope="module")
def cleaned_base():
    """A reference relation (int and float columns) with overlays and
    checked bits from one full clean, and the port's copy of it."""
    rel = jrelation.make_relation(rows(APPEND_DATA, 0, BASE_ROWS), capacity=BASE_CAPACITY,
                                  overlay=OVERLAY, k=8, rules=["zc", "bq"])
    d = JDaisy({"h": rel}, {"h": rules(PKGS["jax"])}, JConfig(use_cost_model=False))
    for spec in FULL_CLEAN:
        d.execute(query(PKGS["jax"], spec))
    jrel = d.db["h"]
    return jrel, relation_from_numpy(relation_to_numpy(jrel), device="cpu")


@pytest.mark.parametrize("new,capacity", [
    (7, 64),     # fits in the spare capacity
    (60, 128),   # grows to the next power of two
    (250, 512),  # crosses two powers of two: 64 -> 512
], ids=["fits", "grows", "two-powers"])
def test_append_rows_matches_reference(cleaned_base, new, capacity):
    jrel, trel = cleaned_base
    n = BASE_ROWS
    old = relation_to_numpy(trel)
    jnew, jstart = jrelation.append_rows(jrel, rows(APPEND_DATA, n, n + new))
    tnew, tstart = trelation.append_rows(trel, rows(APPEND_DATA, n, n + new))
    assert jstart == tstart == n
    assert tnew.capacity == jnew.capacity == capacity
    a, b = relation_to_numpy(jnew), relation_to_numpy(tnew)
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert b["valid"][: n + new].all() and not b["valid"][n + new:].any()
    for field in ("columns", "cand", "ccount", "ckind", "orig", "checked"):
        for k in a[field]:
            assert a[field][k].dtype == b[field][k].dtype, (field, k)
            np.testing.assert_array_equal(a[field][k].view(np.uint8), b[field][k].view(np.uint8),
                                          err_msg=f"{field}.{k}")
    # the old rows' state is carried bit for bit, and the input is unchanged
    for field in ("ccount", "ckind", "checked"):
        for k, v in old[field].items():
            np.testing.assert_array_equal(b[field][k][:BASE_CAPACITY], v)
    after = relation_to_numpy(trel)
    for field in ("columns", "cand", "orig"):
        for k, v in old[field].items():
            np.testing.assert_array_equal(after[field][k].view(np.uint8), v.view(np.uint8))


def test_append_rows_refuses_what_the_reference_refuses():
    data = table(12, seed=3, float_quality=True)
    jrel = jrelation.make_relation(rows(data, 0, 8), overlay=OVERLAY, k=8)
    trel = trelation.make_relation(rows(data, 0, 8), overlay=OVERLAY, k=8, device="cpu")
    floaty = dict(rows(data, 8, 12), beds=np.full(4, 1.5, np.float32))
    missing = {k: v for k, v in rows(data, 8, 12).items() if k != "beds"}
    ragged = dict(rows(data, 8, 12), beds=data["beds"][8:11])
    for bad in (floaty, missing, ragged):
        with pytest.raises(ValueError):
            jrelation.append_rows(jrel, bad)
        with pytest.raises(ValueError):
            trelation.append_rows(trel, bad)
    # an empty batch changes nothing
    same, start = trelation.append_rows(trel, rows(data, 0, 0))
    assert same is trel and start == 8
    assert trel.has_overlay("beds") and not trel.has_overlay("state")
    assert jrel.has_overlay("beds") == trel.has_overlay("beds")


# --------------------------------------------------------- Daisy.ingest itself
def test_ingest_report_versions_and_checked_bits():
    data = table(30, seed=11)
    pair = Pair(rows(data, 0, 20))
    for spec in FULL_CLEAN:
        pair.execute(spec)
    td = pair.d["torch"]
    before = {r: td.db["h"].checked[r].numpy()[:20].copy() for r in ("zc", "bq")}
    versions = {r: td.ledger.version("h", r) for r in ("zc", "bq")}
    rows_v = td.ledger.version("h", TABLE_ROWS_RULE)
    rep = pair.ingest(rows(data, 20, 30))
    assert (rep["rows"], rep["start"], rep["capacity_before"], rep["capacity"],
            rep["grown"]) == (10, 20, CAPACITY, CAPACITY, False)
    assert sorted(rep["pending_rules"]) == ["bq", "zc"]
    assert rep["versions"][TABLE_ROWS_RULE] == rows_v + 1
    for r in ("zc", "bq"):
        # checked bits are never cleared; only the __rows__ scope moves
        np.testing.assert_array_equal(td.db["h"].checked[r].numpy()[:20], before[r])
        assert td.ledger.version("h", r) == versions[r] == rep["versions"][r]
        scope = td.ledger.scope("h", r)
        assert scope.fresh == {2, 3} and len(scope.pending) == 1
        assert td.ledger.has_pending("h", r)
    # an empty append reports nothing and moves nothing
    empty = pair.ingest(rows(data, 30, 30))
    assert empty["rows"] == 0 and empty["versions"] == {}


# ---------------------------------------------------------- the delta steps
@pytest.mark.parametrize("n_seed,capacity,sizes", [
    (13, CAPACITY, (5,)),    # starts off a block boundary, fits
    (16, CAPACITY, (3, 6)),  # on a boundary, then off one, both fit
    (29, 32, (5, 20)),       # off a boundary and grows 32 -> 64
], ids=["off-boundary", "two-appends", "grows"])
def test_ingest_delta_steps_match_reference(n_seed, capacity, sizes):
    """Each append then an FD query, a DC query and a full clean; every step
    (the ingest-delta steps included) equal in both packages."""
    data = table(n_seed + sum(sizes), seed=n_seed)
    pair = Pair(rows(data, 0, n_seed), capacity=capacity)
    for spec in FULL_CLEAN:
        pair.execute(spec)
    lo = n_seed
    for i, size in enumerate(sizes):
        rep = pair.ingest(rows(data, lo, lo + size))
        assert rep["start"] == lo
        steps = pair.execute(("zip", "==", i % 4))
        assert steps[0]["mode"] == "ingest-delta" and steps[0]["rule"] == "zc"
        steps = pair.execute(("beds", ">=", 20))
        assert steps[0]["mode"] == "ingest-delta" and steps[0]["rule"] == "bq"
        for spec in FULL_CLEAN:
            pair.execute(spec)
        lo += size


def test_two_appends_drain_in_one_step():
    """Deltas queue per append and drain, in append order, at the scope's
    next cleaning step."""
    data = table(40, seed=5)
    pair = Pair(rows(data, 0, 19))
    for spec in FULL_CLEAN:
        pair.execute(spec)
    pair.ingest(rows(data, 19, 27))
    pair.ingest(rows(data, 27, 40))
    assert len(pair.d["torch"].ledger.scope("h", "bq").pending) == 2
    steps = pair.execute(("beds", ">=", 0))
    assert [s["mode"] for s in steps][:1] == ["ingest-delta"]
    assert not pair.d["torch"].ledger.has_pending("h", "bq")


def canonical(daisy, n_rows):
    """Per-attr, per-row sorted (value, kind, count) candidate sets over the
    first ``n_rows`` rows: a capacity-independent state signature."""
    rel = daisy.db["h"]
    out = {}
    for attr in OVERLAY:
        vals, cnts, kinds = (np.asarray(getattr(rel, f)[attr])[:n_rows]
                             for f in ("cand", "ccount", "ckind"))
        out[attr] = [
            sorted((float(v), int(kk), round(float(c), 3))
                   for v, c, kk in zip(vals[r], cnts[r], kinds[r]) if c > 1e-9)
            for r in range(n_rows)
        ]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_ingest_matches_rebuild(seed):
    """The reference's regime, in both packages: streamed == rebuilt, and
    the port's streamed run equals the reference's op by op."""
    rng = np.random.default_rng(100 + seed)
    n_seed = int(rng.integers(4, 12))
    sizes = [int(s) for s in rng.integers(1, 7, int(rng.integers(1, 4)))]
    total = n_seed + sum(sizes)
    data = table(total, seed=200 + seed)
    pair = Pair(rows(data, 0, n_seed))
    for spec in FULL_CLEAN:
        pair.execute(spec)
    lo = n_seed
    for size in sizes:
        pair.ingest(rows(data, lo, lo + size))
        for spec in FULL_CLEAN:
            pair.execute(spec)
        lo += size
    for name, p in PKGS.items():
        rebuilt = make_daisy(p, dict(data), capacity=CAPACITY)
        for spec in FULL_CLEAN:
            rebuilt.execute(query(p, spec))
        streamed = pair.d[name]
        assert canonical(streamed, total) == canonical(rebuilt, total), name
        for r in ("zc", "bq"):
            np.testing.assert_array_equal(
                np.asarray(streamed.db["h"].checked[r])[:total],
                np.asarray(rebuilt.db["h"].checked[r])[:total],
            )


# ------------------------------------------------------- background increments
@pytest.mark.parametrize("budget", [
    dict(max_rows=4), dict(max_rows=16), dict(max_strips=1), dict(max_strips=2),
    dict(max_strips=None),
], ids=["fd-rows-4", "fd-rows-16", "dc-strips-1", "dc-strips-2", "dc-all"])
def test_increments_match_reference(budget):
    """Increment by increment to a warm scope, then an append off a block
    boundary: the pending delta drains at the next increment (which then
    reports its own cleaning step), and the fresh strips come first."""
    rule = "zc" if "max_rows" in budget else "bq"
    data = table(52, seed=17)
    pair = Pair(rows(data, 0, 37))
    modes = []
    while (rep := pair.increment(rule, **budget)) is not None:
        modes.append(rep["mode"])
        assert len(modes) < 40
    assert pair.d["torch"].cold_count("h", rule) == 0
    if rule == "bq":
        # strip increments until the last, which covers every cold strip
        assert modes[-1] == "full" and set(modes[:-1]) <= {"strip"}
        assert len(modes) == (1 if budget["max_strips"] is None
                              else -(-5 // budget["max_strips"]))
    rep = pair.ingest(rows(data, 37, 52))
    assert rule in rep["pending_rules"]
    scope = pair.d["torch"].ledger.scope("h", rule)
    assert scope.fresh and list(scope.cold_strips(fresh_first=True))[:1] == [4]
    assert pair.increment(rule, **budget) is not None
    assert not pair.d["torch"].ledger.has_pending("h", rule)  # drained first
    while pair.increment(rule, **budget) is not None:
        pass
    assert pair.d["torch"].cold_count("h", rule) == 0
    # a warm scope answers its queries without detect work
    steps = pair.execute(("zip", "==", 1) if rule == "zc" else ("beds", ">=", 0))
    assert steps[-1]["mode"] == "skipped"


@pytest.mark.parametrize("restrict", [
    dict(col_blocks=(4, 6)),               # an ingest delta's fresh col range
    dict(col_blocks=(4, 5)),               # one col block, partly fresh
    dict(row_block_ids=np.array([2], np.int32)),      # one strip
    dict(row_block_ids=np.array([0, 5], np.int32)),   # two strips
], ids=["fresh-range", "one-partial-block", "one-strip", "two-strips"])
def test_dc_detect_worklists_match_reference(restrict):
    """``detect_dc`` on the worklist shapes the increments and the deltas
    launch, and ``dc_violation_count``, against the reference: rows checked
    in [0, 37), fresh rows in [37, 45) starting off a block boundary, the
    rest of the capacity padding."""
    data = table(45, seed=23, float_quality=True)
    pair = Pair(rows(data, 0, 45))
    pos = np.arange(CAPACITY)
    checked = (pos < 37) & (pos % 3 != 0)
    fresh = (pos >= 37) & (pos < 45)
    col = fresh if "col_blocks" in restrict else pos < 45
    out = {}
    for name, mod in (("jax", jdetect), ("torch", tdetect)):
        d = pair.d[name]
        rel, rule = d.db["h"], d.rules["h"][1]
        if name == "jax":
            rs, cs = jax.numpy.asarray(checked), jax.numpy.asarray(col)
        else:
            rs, cs = torch.from_numpy(checked), torch.from_numpy(col)
        det = mod.detect_dc(rel, rule, rs, cs, block=8, **restrict)
        out[name] = [np.asarray(det.t1_count), np.asarray(det.t2_count),
                     *(np.asarray(x) for x in det.t1_stat + det.t2_stat),
                     int(mod.dc_violation_count(det)), det.tiles_launched, det.tiles_total]
    assert out["torch"][-3] == out["jax"][-3] and out["torch"][-3] > 0
    assert out["torch"][-2:] == out["jax"][-2:]
    for a, b in zip(out["jax"][:-3], out["torch"][:-3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
