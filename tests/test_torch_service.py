"""The query service on the port against the reference (DESIGN.md §9-§14).

Every scenario runs once on each package, on serial schedules driven from
the test thread (``server.drain``, ``cleaner.drain``), and records what a
client sees: each ticket's mask, its cached, shed and staleness tags, the
server's snapshot counters (wall-clock fields left out) and the engine's
whole versioned state.  The two records must be equal, and each scenario
asserts the reference test's own contract on the port's record:

* ``test_service_background.py``: seeded foreground/background
  interleavings answer bit-identically to the serial service; DC
  increments are strip-bounded and yield between strips; background
  commits invalidate exactly the touched cache entries; a DC scope
  full-cleans in one unbounded increment;
* ``test_qos.py``: a shed answer is the cached entry, tagged with its exact
  staleness; nothing sheds without a policy or an entry; an append keeps
  the stored vector comparable; ingest tickets are batch barriers;
* ``test_service_concurrency.py``: eight client threads lose no update
  against a serial run of the port and of the reference;
* ``launch/serve.py --workload queries``: the port's launcher prints the
  reference launcher's counters, with and without streamed ingest.
"""

import gc
import sys
import threading
import types
from functools import partial

import jax
import numpy as np
import pytest
import torch

import repro.service as jservice
from repro.core.constraints import DC as JDC, FD as JFD, Atom as JAtom
from repro.core.executor import Daisy as JDaisy, DaisyConfig as JConfig
from repro.core.operators import GroupBySpec as JGroupBy, Pred as JPred, Query as JQuery
from repro.core.relation import make_relation as jmake
from repro.data.generators import hospital_like as jhospital
from repro.launch import serve as jserve
import repro_torch.service as tservice
from repro_torch.core.constraints import DC, FD, Atom
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.ledger import TABLE_ROWS_RULE
from repro_torch.core.operators import GroupBySpec, Pred, Query, query_fingerprint
from repro_torch.core.relation import make_relation as tmake
from repro_torch.data.generators import hospital_like as thospital
from repro_torch.launch import serve as tserve
from repro_torch.testing import engine_state, state_differences

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
        Query=JQuery, GroupBy=JGroupBy, make=jmake, hospital_like=jhospital, svc=jservice,
    ),
    "torch": types.SimpleNamespace(
        Daisy=partial(Daisy, device="cpu"), Config=DaisyConfig, FD=FD, DC=DC, Atom=Atom,
        Pred=Pred, Query=Query, GroupBy=GroupBySpec, make=partial(tmake, device="cpu"),
        hospital_like=thospital, svc=tservice,
    ),
}
WALL_CLOCK = ("elapsed_s", "queries_per_sec", "idle_fraction")


def counters(snap):
    """A snapshot without its wall-clock fields (latency keeps its counts)."""
    out = {k: v for k, v in snap.items() if k not in WALL_CLOCK}
    out["latency"] = {k: v["count"] for k, v in snap["latency"].items()}
    out["background"] = {k: v for k, v in snap["background"].items() if k != "busy_s"}
    return out


class Record:
    """What one package's run of a scenario showed."""

    def __init__(self):
        self.events = []
        self.daisy = self.server = None

    def ticket(self, t, what=""):
        mask = None if t.result is None or t.kind == "ingest" else t.result.mask
        self.events.append((what, t.kind, t.cached, t.shed, t.staleness,
                            None if mask is None else np.asarray(mask).tobytes(),
                            t.result.asdict() if t.kind == "ingest" else None))

    def note(self, *values):
        self.events.append(values)

    def finish(self):
        self.snapshot = counters(self.server.snapshot()) if self.server else None
        self.state = engine_state(self.daisy)
        return self


def both(scenario, *args):
    """Run ``scenario(pkg, record, *args)`` on each package; the records
    must agree.  Returns the port's record."""
    recs = {}
    for name, p in PKGS.items():
        rec = Record()
        scenario(p, rec, *args)
        recs[name] = rec.finish()
    j, t = recs["jax"], recs["torch"]
    assert len(j.events) == len(t.events)
    for a, b in zip(j.events, t.events):
        assert a == b, f"first difference: {a!r} != {b!r}"
    assert j.snapshot == t.snapshot
    bad = state_differences(j.state, t.state)
    assert not bad, f"engine state differs at {bad}"
    return t


# ------------------------------------------------------------- the workloads
GROUPS, PER = 12, 8
N_DISJOINT = GROUPS * PER
# every table of this file has the launcher's layout (zip, city, beds,
# quality, scopes zc and bq) and capacity, so the reference compiles its
# code once for all of them
CAPACITY = 512


def columns(zipc, city, beds=None, quality=None):
    """The launcher's four columns; beds and quality 0 where not given."""
    zero = np.zeros(len(zipc), np.int32)
    return {"zip": np.asarray(zipc, np.int32), "city": np.asarray(city, np.int32),
            "beds": zero if beds is None else np.asarray(beds, np.int32),
            "quality": (zero if quality is None else np.asarray(quality)).astype(np.float32)}


def table(p, data):
    return p.make(data, capacity=CAPACITY, overlay=["zip", "city", "beds", "quality"], k=8,
                  rules=["zc", "bq"])


def disjoint_daisy(p):
    """Cluster-disjoint groups (the reference's interleaving regime): row 0
    of each group dirty, row 1 clean."""
    rng = np.random.default_rng(5)
    zipc = np.repeat(np.arange(GROUPS, dtype=np.int32), PER)
    city = (zipc * 8).astype(np.int32)
    edit = rng.random(N_DISJOINT) < 0.3
    edit[0::PER] = True
    edit[1::PER] = False
    city[edit] = (zipc[edit] * 8 + rng.integers(1, 8, int(edit.sum()))).astype(np.int32)
    return p.Daisy({"h": table(p, columns(zipc, city))}, {"h": [p.FD("zc", "zip", "city")]},
                   p.Config(use_cost_model=False))


def view(p, g):
    return p.Query("h", preds=(p.Pred("city", "==", g * 8),))


def dc_daisy(p, n=64, seed=7, block=8):
    """A DC scope of n / block cold strips: the backlog strip increments
    work through with bounded pauses."""
    rng = np.random.default_rng(seed)
    beds = rng.integers(0, 50, n)
    quality = 50.0 - beds + rng.normal(0, 4.0, n)
    rel = table(p, columns(np.zeros(n), np.zeros(n), beds, quality))
    dc = p.DC("bq", [p.Atom("beds", "<", "beds"), p.Atom("quality", ">", "quality")])
    return p.Daisy({"t": rel}, {"t": [dc]},
                   p.Config(use_cost_model=False, dc_block=block, strip_rows=block,
                            dc_partitions=4))


def hospital_daisy(p, rows=96, seed=7):
    ds = p.hospital_like(rows, error_frac=0.15, seed=seed)
    rel = table(p, columns(ds.data["zip"], ds.data["city"]))
    return p.Daisy({"h": rel}, {"h": [p.FD("zc", "zip", "city")]},
                   p.Config(use_cost_model=False))


def zq(p, g):
    return p.Query("h", preds=(p.Pred("zip", "==", g),))


# ------------------------------------------------- the serial mixed schedule
def mixed_schedule(p, rec):
    """Queries (FD, DC and a group-by), bounded background increments, two
    appends (the first growing the table, the second starting off a block
    boundary), more queries and a full drain, under a QoS policy.  The
    table is the launcher's (``workload_table``), so the reference's compiled
    code is shared with the launcher test."""
    opts = tserve.ServeOptions(rows=512, ingest_chunks=2, ingest_rows=64)
    seed_rows, chunks, _ = tserve.workload_table(opts)
    rel = p.make(seed_rows, overlay=["zip", "city", "beds", "quality"], k=8,
                 rules=["zc", "bq"])
    rules = [p.FD("zc", "zip", "city"),
             p.DC("bq", [p.Atom("beds", "<", "beds"), p.Atom("quality", ">", "quality")])]
    daisy = p.Daisy({"h": rel}, {"h": rules}, p.Config(use_cost_model=False))
    server = p.svc.QueryServer(daisy, max_batch=4, qos=p.svc.QoSPolicy(overload_depth=6))
    rec.daisy, rec.server = daisy, server
    users = [server.open_session(f"u{i}", max_inflight=64) for i in range(3)]
    pool = [zq(p, g) for g in range(7)] + [
        p.Query("h", groupby=p.GroupBy(keys=("city",), agg="count")),
        p.Query("h", preds=(p.Pred("beds", ">=", 400),)),
        p.Query("h", preds=(p.Pred("quality", "<", 100.0),)),
    ]
    cleaner = p.svc.BackgroundCleaner(daisy, server=server, increment_rows=64,
                                      increment_strips=1)
    # zip views first, so the DC scope is still cold for the increments
    rng = np.random.default_rng(0)
    order = np.concatenate([rng.integers(0, 7, 12), rng.integers(0, len(pool), 12)])

    def burst(idx):
        ts = [server.submit(users[i % 3], pool[q], slo="batch" if i % 4 == 3 else "interactive")
              for i, q in enumerate(idx)]
        server.drain()
        for t in ts:
            rec.ticket(t)

    burst(order[:12])
    for _ in range(2):
        rec.note("increments", cleaner.drain(max_increments=2))
    for c, rows in enumerate(chunks):
        t = server.ingest("h", rows)
        server.drain()
        rec.ticket(t, f"ingest {c}")
    burst(order[12:])
    rec.note("final drain", cleaner.drain())
    rec.note("cold", daisy.cold_count("h", "zc"), daisy.cold_count("h", "bq"))


def test_mixed_serial_schedule_matches_reference():
    rec = both(mixed_schedule)
    ingests = [e for e in rec.events if str(e[0]).startswith("ingest")]
    assert [e[6]["start"] for e in ingests] == [512, 576]
    assert [e[6]["grown"] for e in ingests] == [True, False]
    assert rec.events[-1] == ("cold", 0, 0)
    assert [e[1] for e in rec.events if e[0] == "increments"][0] == 2  # the DC strips
    assert rec.snapshot["ingests"] == 2 and rec.snapshot["errors"] == 0
    assert rec.snapshot["answered"] == 24


# ---------------------------------------------------------- interleavings
def interleaving(p, rec, seed):
    rng = np.random.default_rng(seed)
    daisy = disjoint_daisy(p)
    server = p.svc.QueryServer(daisy)
    cleaner = p.svc.BackgroundCleaner(daisy, server=server, increment_rows=PER)
    rec.daisy, rec.server = daisy, server
    sess = server.open_session("s")
    queries = [int(g) for g in rng.integers(0, GROUPS, 18)]
    answers = []
    it = iter(queries)
    pending = next(it, None)
    while pending is not None:
        if rng.random() < 0.5:
            t = server.submit(sess, view(p, pending))
            server.drain()
            rec.ticket(t)
            answers.append(np.asarray(t.result.mask))
            pending = next(it, None)
        else:
            rec.note("increments", cleaner.drain(max_increments=int(rng.integers(1, 3))))
    # the serial service over the same query order, then converged state
    serial = disjoint_daisy(p)
    for g, got in zip(queries, answers):
        np.testing.assert_array_equal(got, np.asarray(serial.execute(view(p, g)).mask))
    cleaner.drain()
    for g in range(GROUPS):
        serial.execute(view(p, g))
    for attr in ("zip", "city"):
        for field in ("cand", "ccount"):
            np.testing.assert_array_equal(np.asarray(getattr(daisy.db["h"], field)[attr]),
                                          np.asarray(getattr(serial.db["h"], field)[attr]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_interleaving_is_bit_identical_to_serial(seed):
    """Every seed holds the port's interleaving against its serial service;
    seed 0 also runs the reference's (each of its ops costs about 20 times
    the port's on the CPU)."""
    if seed == 0:
        both(interleaving, seed)
    else:
        interleaving(PKGS["torch"], Record(), seed)


def warmed_first_touch(p, rec):
    daisy = disjoint_daisy(p)
    server = p.svc.QueryServer(daisy)
    rec.daisy, rec.server = daisy, server
    rec.note("increments", p.svc.BackgroundCleaner(daisy, server=server,
                                                   increment_rows=N_DISJOINT).drain())
    sess = server.open_session("s")
    ts = [server.submit(sess, view(p, g)) for g in range(GROUPS)]
    server.drain()
    for t in ts:
        rec.ticket(t)


def test_warmed_scope_serves_first_touch_without_detect():
    rec = both(warmed_first_touch)
    assert rec.snapshot["detect_calls"] == 0 and rec.snapshot["background"]["detect_calls"] > 0


# ------------------------------------------------------------ DC background
def dc_preemption(p, rec):
    daisy = dc_daisy(p)
    backlog = len(daisy.ledger.scope("t", "bq").cold_strips())
    cleaner = p.svc.BackgroundCleaner(daisy, increment_strips=1)
    rec.daisy = daisy
    while (rep := cleaner.step()) is not None:
        rec.note(rep.table, rep.rule, rep.step.asdict(), rep.detect_delta, rep.repair_delta,
                 rep.scope_completed)
        assert daisy.lock.acquire(timeout=1.0)
        daisy.lock.release()
    rec.note("backlog", backlog)
    # a second daisy: a pending foreground ticket preempts mid-scope
    d2 = dc_daisy(p)
    server = p.svc.QueryServer(d2)
    c2 = p.svc.BackgroundCleaner(d2, server=server, increment_strips=1)
    rec.server = server
    rec.note("first", c2.drain(max_increments=2), d2.cold_count("t", "bq"))
    t = server.submit(server.open_session("s"), p.Query("t", preds=(p.Pred("beds", ">=", 0),)))
    rec.note("preempted", c2.preempted(), c2.drain())
    server.drain()
    rec.ticket(t)


def test_dc_increments_are_strip_bounded_and_yield():
    rec = both(dc_preemption)
    steps = [e for e in rec.events if e[0] == "t"]
    backlog = dict((e[0], e[1]) for e in rec.events if len(e) == 2)["backlog"]
    assert len(steps) == backlog >= 8
    assert all(e[2]["answer_size"] <= 8 or e[2]["mode"] == "full" for e in steps)
    assert steps[-1][5] and rec.state["counters"][0] > 0
    first = [e for e in rec.events if e[0] == "first"][0]
    assert first[1] == 2 and first[2] > 0
    assert [e for e in rec.events if e[0] == "preempted"][0][1:] == (True, 0)
    assert rec.snapshot["background"]["yields"] == 1


def dc_one_increment(p, rec):
    daisy = dc_daisy(p)
    rec.daisy = daisy
    rep = daisy.clean_scope_increment("t", "bq")
    rec.note(rep.asdict(), daisy.cold_count("t", "bq"))
    d0 = daisy.detect_calls
    got = daisy.execute(p.Query("t", preds=(p.Pred("beds", ">=", 0),)))
    rec.note(got.report.steps[0].mode, daisy.detect_calls - d0, np.asarray(got.mask).tobytes())


def test_dc_scope_full_cleans_in_one_increment():
    rec = both(dc_one_increment)
    assert rec.events[0][0]["mode"] == "full" and rec.events[0][1] == 0
    assert rec.events[1][:2] == ("skipped", 0)


# -------------------------------------------------------------- the cache
def two_table_daisy(p):
    """The disjoint table and a second table of four rows (zip 1 -> city
    5 or 6, zip 2 -> 7 or 8), each with its own FD scope; the second has
    the first's layout, so the reference's compiled code is shared."""
    rel = disjoint_daisy(p).db["h"]
    t2 = table(p, columns([1, 1, 2, 2], [5, 6, 7, 8]))
    fd = p.FD("zc", "zip", "city")
    return p.Daisy({"h": rel, "t2": t2}, {"h": [fd], "t2": [fd]},
                   p.Config(use_cost_model=False))


def cache_exactness(p, rec):
    daisy = two_table_daisy(p)
    server = p.svc.QueryServer(daisy)
    rec.daisy, rec.server = daisy, server
    sess = server.open_session("s")
    qa, qb = view(p, 0), p.Query("t2", preds=(p.Pred("city", "==", 5),))
    qn = p.Query("t2", preds=())  # no rule attribute: only the rows pseudo-dep
    rec.note("deps", p.svc.rule_deps(qn, daisy.rules))
    ts = [server.submit(sess, q) for q in (qa, qb, qn)]
    server.drain()
    assert daisy.clean_scope_increment("t2", "zc") is not None  # t2 only
    ts += [server.submit(sess, q) for q in (qa, qb, qn)]
    server.drain()
    rec.note("stale", server.cache.stale, [e.cached for e in sess.lineage])
    while daisy.clean_scope_increment("h", "zc") is not None:
        pass
    ts += [server.submit(sess, q) for q in (qa, qb, qn)]
    server.drain()
    rec.note("stale", server.cache.stale)
    # equal vectors: a re-execution is bit-identical
    v = daisy.scope_versions(ts[-3].deps)
    again = daisy.execute(qa)
    rec.note("same vector", daisy.scope_versions(ts[-3].deps) == v,
             np.array_equal(np.asarray(again.mask), np.asarray(ts[-3].result.mask)))
    for t in ts:
        rec.ticket(t)


def test_background_commits_invalidate_exactly_the_touched_scopes():
    rec = both(cache_exactness)
    notes = [e for e in rec.events if e[0] in ("deps", "stale", "same vector")]
    assert notes[0][1] == (("t2", TABLE_ROWS_RULE),)
    assert notes[1] == ("stale", 1, [False, False, False, True, False, True])
    assert notes[2] == ("stale", 2)
    assert notes[3] == ("same vector", True, True)
    cached = [e[2] for e in rec.events if e[1] == "query"]
    assert cached[6:] == [False, True, True]


# ---------------------------------------------------------------- the qos
def shed_scenario(p, rec):
    server = p.svc.QueryServer(hospital_daisy(p), max_batch=4,
                               qos=p.svc.QoSPolicy(overload_depth=1))
    rec.daisy, rec.server = server.daisy, server
    s = server.open_session("u", max_inflight=100)
    qa, qb = zq(p, 0), zq(p, 1)
    server.submit(s, qa)
    server.drain()  # qa cached at its post-execution vector
    stored_version, stored = server.cache.peek(query_fingerprint(qa))
    server.submit(s, qb)
    server.drain()  # cleaning qb's cluster advances (h, zc): qa's entry is stale
    current = server.daisy.scope_versions(p.svc.rule_deps(qa, server.daisy.rules))
    expected = p.svc.vector_staleness(stored_version, current)
    t1, t2 = server.submit(s, qb, slo="batch"), server.submit(s, qb, slo="batch")
    shed = server.submit(s, qa, slo="interactive")
    rec.note("shed", shed.shed, shed.event.is_set(), shed.result is stored, expected)
    uncached = server.submit(s, zq(p, 2))  # past the depth, but no entry to serve
    rec.note("uncached", uncached.shed, uncached.event.is_set())
    server.drain()
    for t in (t1, t2, shed, uncached):
        rec.ticket(t)
    # an append bumps (h, __rows__) inside qa's vector: still comparable
    new = p.hospital_like(8, error_frac=0.0, seed=1).data
    rows = columns(new["zip"][:2], new["city"][:2])
    ing = server.ingest("h", rows)
    server.drain()
    rec.ticket(ing, "ingest")
    server.submit(s, qa, slo="batch")
    server.submit(s, qa, slo="batch")
    again = server.submit(s, qa)
    server.drain()
    rec.ticket(again)
    rec.note("session", s.snapshot()["inflight"])


def test_shed_answers_are_tagged_and_bit_identical():
    rec = both(shed_scenario)
    shed = [e for e in rec.events if e[0] == "shed"][0]
    assert shed[1:4] == (True, True, True) and shed[4] > 0
    assert [e for e in rec.events if e[0] == "uncached"][0][1:] == (False, False)
    tickets = [e for e in rec.events if e[1] == "query"]
    assert [(e[3], e[4]) for e in tickets[:2]] == [(False, None)] * 2  # never tagged
    assert tickets[2][3:5] == (True, shed[4])
    assert tickets[3][3:5] == (False, None)
    assert tickets[4][3] and tickets[4][4] >= 1  # shed after the append
    assert rec.snapshot["qos"]["shed"] == 2
    assert rec.events[-1] == ("session", 0)


def no_shed_scenario(p, rec):
    for qos in (None, p.svc.QoSPolicy(overload_depth=0)):
        server = p.svc.QueryServer(hospital_daisy(p), max_batch=4, qos=qos)
        rec.daisy, rec.server = server.daisy, server
        s = server.open_session("u", max_inflight=100)
        server.submit(s, zq(p, 0))
        server.drain()
        ts = [server.submit(s, zq(p, 0)) for _ in range(6)]
        rec.note("queued", [(t.shed, t.event.is_set()) for t in ts])
        server.drain()
        for t in ts:
            rec.ticket(t)


def test_no_shed_without_policy_or_depth():
    rec = both(no_shed_scenario)
    for e in rec.events:
        if e[0] == "queued":
            assert e[1] == [(False, False)] * 6
    assert rec.snapshot.get("qos", {"shed": 0})["shed"] == 0


def test_ingest_barrier_blocks_fair_reordering():
    queue = tservice.FairQueue(tservice.QoSPolicy())
    heavy = tservice.Session(sid="heavy", max_inflight=100)
    light = tservice.Session(sid="light", max_inflight=100)

    def ticket(seq, session, weight=1.0, kind="query"):
        return tservice.Ticket(seq=seq, session=session, query=None, fingerprint=f"q{seq}",
                               slo="interactive", weight=weight, kind=kind)

    pre = [ticket(i, heavy) for i in range(4)]
    for t in pre:
        queue.push(t)
    queue.push(ticket(4, None, kind="ingest"))
    late = ticket(5, light, weight=8.0)
    queue.push(late)
    assert late.start_tag < pre[-1].start_tag
    order, _ = queue.pop_batch(100)
    seqs = [t.seq for t in order]
    assert set(seqs[:4]) == {0, 1, 2, 3} and seqs[4:] == [4, 5]
    assert tservice.vector_staleness((1, 2), (3, 2)) == 2
    assert tservice.vector_staleness((1, 2), (1, 2, 3)) is None


# ------------------------------------------------------------ concurrency
def candidate_state(rel, n):
    state = {}
    for attr in ("zip", "city"):
        vals, probs = np.asarray(rel.cand[attr]), np.asarray(rel.probs(attr))
        state[attr] = [{(int(v), round(float(pr), 5)) for v, pr in zip(vals[r], probs[r]) if pr > 0}
                       for r in range(n)]
    return state


def test_eight_threads_no_lost_updates():
    """Eight client threads through the port's serving thread; the overlays
    equal a serial run of the port and of the reference."""
    p = PKGS["torch"]
    daisy = hospital_daisy(p, rows=128, seed=11)
    server = tservice.QueryServer(daisy, max_batch=8)
    pool = [zq(p, g) for g in range(6)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        run_clients(server, pool)
    finally:
        sys.setswitchinterval(switch)
    snap = server.snapshot()
    assert snap["queries"] == 48 and snap["errors"] == 0
    assert 0 < daisy.clean_version and snap["executions"] < snap["queries"]
    got = candidate_state(daisy.db["h"], 128)
    for name, q in PKGS.items():
        serial = hospital_daisy(q, rows=128, seed=11)
        for g in range(6):
            serial.execute(zq(q, g))
        assert candidate_state(serial.db["h"], 128) == got, name


def run_clients(server, pool):
    serving = threading.Thread(target=server.run, name="serving")
    serving.start()
    errors = []

    def client(tid):
        session = server.open_session(f"user{tid}")
        try:
            for i in range(6):
                assert server.query(session, pool[(tid + i) % 6], timeout=300).mask is not None
        except BaseException as exc:
            errors.append((tid, exc))

    clients = [threading.Thread(target=client, args=(tid,)) for tid in range(8)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    server.stop()
    serving.join(timeout=60)
    assert not any(t.is_alive() for t in clients) and not serving.is_alive()
    assert not errors, errors


# ------------------------------------------------------------- the launcher
DETERMINISTIC = ("  executions", "  detect", "  ingest:", "  user", "  qos:", "    class")


def launcher_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith(DETERMINISTIC)]


def test_run_queries_prints_the_reference_counters(capsys):
    kw = dict(sessions=4, requests=24, rows=512, ingest_chunks=2, ingest_rows=64)
    jserve.run_queries(jserve.ServeOptions(**kw))
    want = launcher_lines(capsys.readouterr().out)
    run = tserve.run_queries(tserve.ServeOptions(device="cpu", **kw))
    got = launcher_lines(capsys.readouterr().out)
    assert got == want and len(got) >= 7
    assert run.snapshot["queries"] == 24 and run.snapshot["ingested_rows"] == 128
    assert int(run.daisy.db["h"].num_rows()) == 640


def test_run_queries_background_invariants():
    """The threaded run has no fixed schedule: every ticket answered, no
    error, and no cold row after a final drain."""
    opts = tserve.ServeOptions(device="cpu", sessions=4, requests=24, rows=512,
                               background=True, ingest_chunks=2, ingest_rows=64, qos=True)
    run = tserve.run_queries(opts)
    assert all(t.event.is_set() and t.error is None for t in run.tickets)
    assert run.snapshot["queries"] == 24 and run.snapshot["errors"] == 0
    run.cleaner.drain()
    assert run.daisy.cold_count("h", "zc") == 0 and run.daisy.cold_count("h", "bq") == 0
    assert not run.server.pending_count()


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--workload", "queries", "--rows", "64", "--requests", "2"])


# --------------------------------------------------------------- the obs
def traced_ingest(p, rec, obs):
    """An FD clean, an append and the query that drains its delta, traced."""
    tracer = obs.Tracer()
    ds = p.hospital_like(100, error_frac=0.15, seed=7)
    data = columns(ds.data["zip"], ds.data["city"])
    rel = table(p, {k: v[:96] for k, v in data.items()})
    daisy = p.Daisy({"h": rel}, {"h": [p.FD("zc", "zip", "city")]},
                    p.Config(use_cost_model=False), tracer)
    rec.daisy = daisy
    daisy.execute(p.Query("h", groupby=p.GroupBy(keys=("city",), agg="count")))
    daisy.ingest("h", {k: v[96:] for k, v in data.items()})
    daisy.execute(zq(p, 0))
    events = tracer.events()
    rec.note([e.name for e in events])
    rec.note(sorted(obs.rollup(events)), len(obs.chrome_trace(events)["traceEvents"]))
    tracer.clear()
    rec.note(len(tracer), tracer.dropped)


def test_traced_spans_and_obs_copies_match_reference():
    import repro.obs as jobs
    import repro_torch.obs as tobs

    recs = {}
    for name, obs in (("jax", jobs), ("torch", tobs)):
        rec = Record()
        traced_ingest(PKGS[name], rec, obs)
        recs[name] = rec.finish()
    assert recs["jax"].events == recs["torch"].events
    names = recs["torch"].events[0][0]
    assert "daisy.ingest" in names and "clean.ingest_delta" in names
    assert recs["torch"].events[-1] == (0, 0)
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    samples = np.random.default_rng(0).lognormal(-5, 2, 500)
    hists = [mod.LatencyHistogram() for mod in (jobs, tobs)]
    for h in hists:
        for x in samples:
            h.observe(float(x))
    assert hists[0].snapshot() == hists[1].snapshot()
