"""Background increments in the port (DESIGN.md §10-§11): the strip-union
identities on the port's own ``Daisy``, and the host pieces the
increments stand on held against the reference.

* The union identities of ``tests/test_ledger.py::TestStripUnionIdentity``,
  on the port: a scope cleaned as a union of bounded DC strip increments,
  or of bounded FD group sweeps, ends row for row where one full pass
  ends, and strip increments interleaved with a foreground query converge
  on the serial state.
* The work ledger (strip geometry, cold counts, fresh strips, queued
  ingest-deltas, re-gridding to a grown capacity, progress), the planner's
  ``probe_step``/``strip_step``, the background priority model and the
  §5.2 cost expressions: the same ops on both packages give the same
  values.  These modules are host Python in both packages.
"""

import gc

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import cost as jcost
from repro.core import ledger as jledger
from repro.core import planner as jplanner
from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom
from repro_torch.core import cost as tcost
from repro_torch.core import ledger as tledger
from repro_torch.core import planner as tplanner
from repro_torch.core.constraints import DC, FD, Atom
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.operators import Pred, Query
from repro_torch.core.relation import make_relation
from repro_torch.testing import ledger_state

torch.set_num_threads(1)
SETTINGS = dict(max_examples=10, deadline=None)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end."""
    yield
    jax.clear_caches()
    gc.collect()


# ------------------------------------------------------ the union identities
DC_PD = DC("pd", [Atom("price", "<", "price"), Atom("disc", ">", "disc")])
FD_AB = FD("r", "a", "b")


def dc_daisy(n, seed, block=8):
    rng = np.random.default_rng(seed)
    price = rng.uniform(0.0, 50.0, n).astype(np.float32)
    disc = (50.0 - price + rng.normal(0, 4.0, n)).astype(np.float32)
    rel = make_relation({"price": price, "disc": disc}, overlay=["price", "disc"], k=8,
                        rules=["pd"], device="cpu")
    return Daisy({"t": rel}, {"t": [DC_PD]},
                 DaisyConfig(use_cost_model=False, dc_block=block, strip_rows=block,
                             dc_partitions=4), device="cpu")


def fd_daisy(n, seed, groups=6):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, groups, n).astype(np.int32)
    b = (a * 10 + rng.integers(0, 3, n)).astype(np.int32)
    rel = make_relation({"a": a, "b": b}, overlay=["a", "b"], k=8, rules=["r"], device="cpu")
    return Daisy({"t": rel}, {"t": [FD_AB]}, DaisyConfig(use_cost_model=False), device="cpu")


def assert_same_state(a, b, attrs):
    for attr in attrs:
        for field in ("cand", "ccount", "ckind"):
            torch.testing.assert_close(getattr(a.db["t"], field)[attr],
                                       getattr(b.db["t"], field)[attr], rtol=0, atol=0)
    for rule, checked in a.db["t"].checked.items():
        assert torch.equal(checked, b.db["t"].checked[rule])


@given(st.integers(10, 60), st.integers(0, 10**6), st.integers(1, 3))
@settings(**SETTINGS)
def test_dc_strip_union_equals_full_pass(n, seed, per_call):
    inc, full = dc_daisy(n, seed), dc_daisy(n, seed)
    steps = 0
    while inc.clean_scope_increment("t", "pd", max_strips=per_call):
        steps += 1
        assert steps < 100
    assert full.clean_scope_increment("t", "pd").mode == "full"
    assert inc.cold_count("t", "pd") == 0
    assert_same_state(inc, full, ("price", "disc"))


@given(st.integers(12, 60), st.integers(0, 10**6), st.integers(4, 16))
@settings(**SETTINGS)
def test_fd_increment_union_equals_full_pass(n, seed, max_rows):
    inc, full = fd_daisy(n, seed), fd_daisy(n, seed)
    steps = 0
    while inc.clean_scope_increment("t", "r", max_rows=max_rows):
        steps += 1
        assert steps < 100
    while full.clean_scope_increment("t", "r"):
        pass
    assert inc.cold_count("t", "r") == 0
    assert_same_state(inc, full, ("a", "b"))


def test_interleaved_query_and_strips_match_serial():
    inter, serial = dc_daisy(48, 3), dc_daisy(48, 3)
    q = Query("t", preds=(Pred("price", ">=", -1.0),))
    inter.clean_scope_increment("t", "pd", max_strips=2)
    assert torch.equal(inter.execute(q).mask, serial.execute(q).mask)
    while inter.clean_scope_increment("t", "pd", max_strips=1):
        pass
    while serial.clean_scope_increment("t", "pd"):
        pass
    assert inter.cold_count("t", "pd") == 0
    assert_same_state(inter, serial, ("price", "disc"))


def test_strip_increment_counts_and_warm_skip():
    """One strip a call: the scope's cold count falls by the strip's rows,
    the ledger's support rises, and a warm scope returns None."""
    d = dc_daisy(32, seed=9)
    scope = d.ledger.scope("t", "pd")
    assert scope.cold_count == 32 and d.cold_count("t", "pd") == 32
    v0 = d.scope_version("t", "pd")
    rep = d.clean_scope_increment("t", "pd", max_strips=1)
    assert rep.mode == "strip" and rep.answer_size == 8
    assert d.scope_version("t", "pd") > v0
    assert scope.cold_count == 24 and len(scope.cold_strips()) == 3
    assert list(scope.cold_block_ids(8)) == [1, 2, 3]
    while d.clean_scope_increment("t", "pd", max_strips=1):
        pass
    assert d.clean_scope_increment("t", "pd") is None
    assert scope.support == 1.0
    assert scope.tiles_launched > 0


# ------------------------------------------------------------- the ledger
def ledger_ops(seed):
    """A random schedule of ledger ops: registrations (growing capacities),
    cold observations, commits, bumps, ingests with and without checked
    rows, pending claims and tile notes."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(10, 40))
    ops = [("register", "t", "r", cap, rng.random(cap) < 0.5)]
    for _ in range(12):
        kind = rng.choice(["commit", "bump", "ingest", "take", "tiles", "register"])
        if kind == "commit":
            ops.append(("commit", "t", "r", rng.random(cap) < 0.3))
        elif kind == "bump":
            ops.append(("bump", "t", str(rng.choice(["r", "__rows__"]))))
        elif kind == "ingest":
            lo = int(rng.integers(0, cap))
            hi = lo + int(rng.integers(1, 20))
            cap = max(cap, 1 << (hi - 1).bit_length())
            checked = rng.random(cap) < 0.4 if rng.random() < 0.7 else None
            ops.append(("record_ingest", "t", "r", cap, rng.random(cap) < 0.5, lo, hi,
                        checked, rng.random(cap) < 0.5))
        elif kind == "take":
            ops.append(("take_pending", "t", "r"))
        elif kind == "tiles":
            ops.append(("tiles", int(rng.integers(0, 9)), int(rng.integers(0, 9))))
        else:
            cap += int(rng.integers(0, 9))
            ops.append(("register", "t", "r", cap, None))
    return ops


def run_ledger(mod, ops):
    ledger = mod.WorkLedger(strip_rows=5, block=4)
    reads = []
    for op in ops:
        name, args = op[0], op[1:]
        if name == "record_ingest":
            t, r, cap, cold, lo, hi, checked, dirty = args
            ledger.record_ingest(t, r, cap, cold, lo, hi, checked=checked, old_dirty=dirty)
        elif name == "take_pending":
            reads.append([(p.lo, p.hi) for p in ledger.take_pending(*args)])
        elif name == "tiles":
            ledger.scope("t", "r").note_tiles(*args)
        else:
            getattr(ledger, name)(*args)
        s = ledger.scope("t", "r")
        reads.append((
            ledger.has_pending("t", "r"), ledger.cold_count("t", "r"),
            ledger.support("t", "r"), ledger.progress(), ledger.versions([("t", "r")]),
            s.cold_strips(fresh_first=True).tolist(), s.cold_block_ids(4).tolist(),
            s.fresh_cold_count, s.strips_done,
            s.strip_blocks(s.cold_strips().tolist() or [0], 4),
            s.strip_block_ids([0, s.n_strips - 1], 4).tolist(),
        ))
        reads.append(ledger_state(ledger))
    return reads


@pytest.mark.parametrize("seed", range(6))
def test_ledger_matches_reference(seed):
    ops = ledger_ops(seed)
    assert run_ledger(tledger, ops) == run_ledger(jledger, ops)


def test_ledger_regrids_a_grown_scope():
    for mod in (tledger, jledger):
        ledger = mod.WorkLedger(strip_rows=8, block=8)
        ledger.bump("t", "r")
        scope = ledger.register("t", "r", 32)
        # growth without a cold mask seeds all-cold, keeping the version
        assert (scope.version, scope.cold_count, scope.support) == (1, 32, 0.0)
        scope.observe_cold(np.zeros(32, bool))
        scope = ledger.register("t", "r", 64)
        assert scope.n_strips == 8 and scope.cold_count == 64
        assert mod.TABLE_ROWS_RULE == "__rows__"
        assert ledger.progress()["t/r"]["strips_total"] == 8
        assert [s.rule for s in ledger.scopes()] == ["r"]


# ---------------------------------------------------------- planner steps
def test_probe_and_strip_steps_match_reference():
    fd_t, fd_j = FD("zc", "zip", "city"), JFD("zc", "zip", "city")
    dc_t = DC("bq", [Atom("beds", "<", "beds"), Atom("quality", ">", "quality")])
    dc_j = JDC("bq", [JAtom("beds", "<", "beds"), JAtom("quality", ">", "quality")])
    for t, j in ((tplanner.probe_step("h", fd_t), jplanner.probe_step("h", fd_j)),
                 (tplanner.strip_step("h", dc_t, np.array([1, 3])),
                  jplanner.strip_step("h", dc_j, np.array([1, 3])))):
        fields = ("table", "placement", "mode", "use_rhs", "preds", "shardable", "strips")
        assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
        assert t.rule.name == j.rule.name
    assert tplanner.strip_step("h", dc_t, [2]).strips == (2,)


# ------------------------------------------------ priorities and the cost model
def test_scope_priorities_match_reference():
    specs = [("t", "r1", 10, 100.0, 0.5, 1.0, False), ("t", "r2", 10, 100.0, 0.5, 1.0, False),
             ("t", "r0", 0, 1e9, 1.0, 1.0, False), ("u", "r3", 5, 100.0, 0.9, 1.0, False),
             ("u", "r4", 0, 10.0, 0.2, 2.0, True), ("v", "r5", 3, 50.0, 0.1, 2.0, False)]
    out = {}
    for mod in (tcost, jcost):
        scopes = [mod.ScopePriority(t, r, cold_rows=c, expected_pairs=e,
                                    touch_probability=p, fresh_boost=f, pending=pe)
                  for t, r, c, e, p, f, pe in specs]
        out[mod] = [(s.rule, s.priority) for s in mod.prioritize_scopes(scopes)]
    assert out[tcost] == out[jcost]
    assert [r for r, _ in out[tcost]] == ["r3", "r1", "r2", "r5", "r4"]


class _Info:
    n_shards = 4
    per_shard_rows = [2, 2, 2, 2]
    routed_rows = 8
    retries = 1
    sharded_pairs = 16


@given(st.integers(1, 10_000), st.integers(0, 500), st.floats(1.0, 8.0),
       st.lists(st.tuples(st.integers(0, 500), st.integers(0, 200),
                          st.floats(0.0, 1e6), st.integers(0, 50)), max_size=8),
       st.integers(1, 60), st.booleans())
@settings(**SETTINGS)
def test_cost_expressions_match_reference(n, eps, p, history, expected, observe):
    """The §5.2 expressions, the Inequality-(1) decision and the sharded
    pricing: the same history gives the same numbers in both packages."""
    out = {}
    for mod in (tcost, jcost):
        cm = mod.CostModel(n=n, epsilon=eps, p=p, df=n * n / 16.0, expected_queries=expected)
        for h in history:
            cm.record(*h)
        if observe:
            cm.observe_detect_cost(mod.sharded_detect_cost(_Info(), n_rows=n))
            cm.observe_progress(0.25)
            cm.observe_tile_sparsity(0.5)
        out[mod] = (
            cm.incremental_query_cost(3, 2, 10.0, 1), cm.incremental_cost_so_far(),
            cm.offline_cost(), cm.df_effective, cm.remaining_full_clean_cost(),
            cm.projected_incremental_remaining(), cm.should_switch_to_full(),
            mod.sharded_detect_cost(_Info()),
        )
    assert out[tcost] == out[jcost]
