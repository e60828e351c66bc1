"""The port's serving launcher: the query service over the port's ``Daisy``.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload queries \\
        --sessions 8 --requests 40 --rows 2048 --background \\
        --increment-rows 256 --increment-strips 2

A synthetic multi-user analytical workload over ``repro_torch.service``
(DESIGN.md §9): many sessions issue repeated exploratory queries against
one shared, gradually-cleaned ``Daisy`` on the card (``--device cuda``,
the default; ``--device cpu`` runs it on the CPU).  The launcher prints
throughput, cache effectiveness and the detect/repair work amortized per
query, in the reference launcher's format (``repro.launch.serve``), so the
two runs' deterministic lines compare line for line.

* ``--background`` runs the background cleaner (DESIGN.md §10) behind a
  serving thread; ``--increment-rows`` bounds one FD increment (whole lhs
  groups) and ``--increment-strips`` one DC increment (ledger strips,
  DESIGN.md §11; the workload carries a beds/quality DC).
* ``--ingest-chunks``/``--ingest-rows`` hold that many rows back from the
  seed instance and stream them through ``QueryServer.ingest`` between
  query bursts (DESIGN.md §12).
* ``--qos`` turns on weighted-fair queueing and SLO classes, ``--overload``
  stale-serve shedding (DESIGN.md §14); ``--trace`` dumps a Chrome trace
  (DESIGN.md §13).

``run_queries`` returns the run (snapshot, engine, server, cleaner), so a
caller can check what the service left behind.  The reference's
``--workload decode`` waits for the port's other LM configurations.
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class ServeOptions:
    """The query-serving workload knobs, consolidated: one bundle shared by
    the CLI launcher (``--workload queries``) and ``chip_smoke.py``, with the
    reference's meaning for every knob.  ``device`` is where the instance
    lives: ``"cuda"`` (the default, which raises where CUDA is missing) or
    ``"cpu"``.

    ``ingest_chunks`` x ``ingest_rows`` rows are held back from the seed
    instance and streamed through ``QueryServer.ingest`` between query
    bursts — the ingest-while-serving workload (DESIGN.md §12).  Zero
    (the default) serves a fixed instance.

    ``trace`` names a Chrome trace-event JSON to dump the run's spans to
    (DESIGN.md §13): the whole stack — executor, server, background
    cleaner — records into one tracer, the file loads in Perfetto, and
    the launcher prints the per-phase rollup.  None (the default) disables
    tracing entirely (the strict no-op tracer).

    ``qos`` turns on traffic shaping (DESIGN.md §14): the submit queue
    becomes weighted-fair over sessions, requests carry SLO classes (the
    launcher mixes ``interactive`` and ``batch``), and per-class latency
    percentiles are reported.  ``overload_depth`` > 0 additionally arms
    admission control: once the queue is deeper than that, sheddable
    (interactive) requests are answered from the version-vector cache
    with an explicit staleness tag instead of queueing."""

    sessions: int = 4
    requests: int = 40
    rows: int = 1024
    max_batch: int = 8
    background: bool = False
    increment_rows: int = 0  # 0 -> rows // 8 (min 64); whole FD lhs groups
    increment_strips: int = 1  # work-ledger strips per DC increment (§11)
    ingest_chunks: int = 0
    ingest_rows: int = 0
    seed: int = 0
    trace: str | None = None  # Chrome trace JSON output path (§13)
    qos: bool = False  # weighted-fair queue + SLO classes (§14)
    overload_depth: int = 0  # 0 = never shed; >0 arms stale-serve shedding
    device: str = "cuda"  # the torch device the instance lives on

    @property
    def fd_increment_rows(self) -> int:
        """Rows per background FD increment; the 0 default scales with the
        instance size."""
        return self.increment_rows or max(self.rows // 8, 64)

    @property
    def held_back_rows(self) -> int:
        """Rows kept out of the seed instance for streaming ingest."""
        return self.ingest_chunks * self.ingest_rows

    @classmethod
    def from_args(cls, args) -> "ServeOptions":
        """Build from ``main``'s argparse namespace."""
        return cls(
            sessions=args.sessions, requests=args.requests, rows=args.rows,
            max_batch=args.max_batch, background=args.background,
            increment_rows=args.increment_rows,
            increment_strips=args.increment_strips,
            ingest_chunks=args.ingest_chunks, ingest_rows=args.ingest_rows,
            seed=args.seed, trace=args.trace,
            qos=args.qos, overload_depth=args.overload, device=args.device,
        )


@dataclasses.dataclass
class QueriesRun:
    """What ``run_queries`` leaves behind for its caller."""

    snapshot: dict
    seconds: float
    daisy: object
    server: object
    cleaner: Optional[object]
    tickets: List[object]


def workload_table(opts: ServeOptions):
    """The hospital-like table of the workload, seed part and held-back
    chunks, and its rules (the reference launcher's workload, from
    ``opts.seed``)."""
    from repro_torch.core.constraints import Atom, DC, FD
    from repro_torch.data.generators import hospital_like

    # the FULL dataset (seed + held-back stream) in one draw, so the same
    # seed with or without ingest sees the same rows
    total = opts.rows + opts.held_back_rows
    ds = hospital_like(total, error_frac=0.1, seed=opts.seed)
    data = dict(ds.data)
    # a noisy quality score, mostly monotone in beds: the DC says a smaller
    # hospital must not outrank a larger one
    rng_q = np.random.default_rng(opts.seed + 1)
    data["quality"] = (
        data["beds"].astype(np.float32)
        + rng_q.integers(-60, 60, total).astype(np.float32)
    )
    seed_data = {k: v[: opts.rows] for k, v in data.items()}
    chunks = [
        {
            k: v[opts.rows + c * opts.ingest_rows:
                 opts.rows + (c + 1) * opts.ingest_rows]
            for k, v in data.items()
        }
        for c in range(opts.ingest_chunks)
    ]
    rules = [
        FD("zc", "zip", "city"),
        DC("bq", [Atom("beds", "<", "beds"), Atom("quality", ">", "quality")]),
    ]
    return seed_data, chunks, rules


def query_pool(opts: ServeOptions):
    """The exploratory pool: per-neighborhood selections, one overview
    group-by and a DC-overlapping ranking view."""
    from repro_torch.core.operators import GroupBySpec, Pred, Query

    n_zip = max(opts.rows // 20, 4)
    pool = [Query("h", preds=(Pred("zip", "==", g),)) for g in range(n_zip)]
    pool.append(Query("h", groupby=GroupBySpec(keys=("city",), agg="count")))
    pool.append(Query("h", preds=(Pred("beds", ">=", 400),)))
    return pool


def run_queries(opts: ServeOptions) -> QueriesRun:
    from repro_torch.core.executor import Daisy, DaisyConfig
    from repro_torch.core.relation import make_relation
    from repro_torch.obs import Tracer, format_rollup, rollup, write_trace
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.service import BackgroundCleaner, QoSPolicy, QueryServer

    seed_data, chunks, rules = workload_table(opts)
    rel = make_relation(
        seed_data, overlay=["zip", "city", "beds", "quality"], k=8,
        rules=["zc", "bq"], device=opts.device,
    )
    # one tracer for the whole stack: the server and the background cleaner
    # default their seams to the executor's tracer
    tracer = Tracer() if opts.trace else NULL_TRACER
    daisy = Daisy(
        {"h": rel}, {"h": rules},
        DaisyConfig(use_cost_model=False, expected_queries=opts.requests),
        tracer=tracer, device=opts.device,
    )
    policy = QoSPolicy(overload_depth=opts.overload_depth) if opts.qos else None
    server = QueryServer(daisy, max_batch=opts.max_batch, qos=policy)
    cleaner = serving = None
    if opts.background:
        # serving thread + cleaner thread: the cleaner warms cold scopes
        # whenever the submission queue is empty and yields on arrivals
        serving = threading.Thread(target=server.run, name="serving", daemon=True)
        serving.start()
        cleaner = BackgroundCleaner(
            daisy, server=server,
            increment_rows=opts.fd_increment_rows,
            increment_strips=opts.increment_strips,
        ).start()

    pool = query_pool(opts)
    rng = np.random.default_rng(opts.seed)
    # the whole workload is submitted before drain(), so size the per-user
    # inflight bound to the share each session will queue
    inflight = max(opts.requests // opts.sessions + 1, 1)
    sessions = [
        server.open_session(f"user{i}", max_inflight=inflight)
        for i in range(opts.sessions)
    ]
    # slice the request stream into chunk+1 bursts and queue one append
    # between bursts: the ingest ticket is a batch barrier (DESIGN.md §12)
    burst = max(opts.requests // (opts.ingest_chunks + 1), 1)
    t0 = time.perf_counter()
    tickets = []
    next_chunk = 0
    for i in range(opts.requests):
        if i and i % burst == 0 and next_chunk < len(chunks):
            tickets.append(server.ingest("h", chunks[next_chunk]))
            next_chunk += 1
        session = sessions[i % opts.sessions]
        # zipf-ish revisit pattern: hot views dominate
        idx = min(int(rng.zipf(1.7)) - 1, len(pool) - 1)
        # under --qos every 4th request is a batch report
        slo = ("batch" if opts.qos and i % 4 == 3 else "interactive")
        tickets.append(server.submit(session, pool[idx], slo=slo))
    while next_chunk < len(chunks):
        tickets.append(server.ingest("h", chunks[next_chunk]))
        next_chunk += 1
    if cleaner is not None:
        try:
            for t in tickets:
                t.wait(timeout=600)
        finally:
            server.stop()
            cleaner.stop()
            serving.join(timeout=60)
    else:
        server.drain()
    dt = time.perf_counter() - t0

    snap = server.snapshot()
    print(
        f"served {snap['queries']} queries from {opts.sessions} sessions in "
        f"{dt:.2f}s ({snap['queries']/dt:.1f} q/s)"
    )
    print(
        f"  executions {snap['executions']}  cache hits {snap['cache_hits']} "
        f"(hit rate {snap['hit_rate']:.0%})  clean_version {snap['clean_version']}"
    )
    print(
        f"  detect {snap['detect_calls']} / repair {snap['repair_calls']} "
        f"-> {snap['detect_repair_per_query']} invocations amortized per query"
    )
    if snap["ingests"]:
        print(
            f"  ingest: {snap['ingests']} appends, {snap['ingested_rows']} rows "
            f"streamed in, {snap['ingest_pending_deltas']} pending deltas queued "
            f"(final instance {int(daisy.db['h'].num_rows())} rows)"
        )
    if cleaner is not None:
        bg = snap["background"]
        print(
            f"  background: {bg['increments']} increments "
            f"({bg['detect_calls']} detect / {bg['repair_calls']} repair, "
            f"{bg['scopes_completed']} scopes warmed, {bg['yields']} yields) "
            f"serving idle fraction {snap['idle_fraction']:.0%}"
        )
        for scope, prog in snap["ledger"].items():
            print(
                f"  ledger {scope}: {prog['strips_done']}/{prog['strips_total']}"
                f" strips warm, {prog['cold_rows']} cold rows"
            )
    if opts.qos:
        qos = snap["qos"]
        print(
            f"  qos: shed {qos['shed']} ({qos['shed_stale']} stale-tagged, "
            f"total staleness {qos['shed_staleness_total']}), "
            f"cancelled {qos['cancelled']}, "
            f"deadline misses {qos['deadline_misses']}"
        )
        for cls, counts in sorted(qos["by_class"].items()):
            parts = ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
            print(f"    class {cls}: {parts}")
    for s in snap["sessions"][:4]:
        print(f"  {s['sid']}: answered {s['answered']} "
              f"({s['cached_answers']} from cache)")
    for kind, lat in snap.get("latency", {}).items():
        print(
            f"  latency[{kind}]: p50 {lat['p50_s']*1e3:.2f}ms "
            f"p95 {lat['p95_s']*1e3:.2f}ms p99 {lat['p99_s']*1e3:.2f}ms "
            f"({lat['count']} samples)"
        )
    if opts.trace:
        events = tracer.events()
        write_trace(opts.trace, events, origin=tracer.created)
        print(f"  trace: {len(events)} spans -> {opts.trace} "
              f"(Perfetto-loadable; {tracer.dropped} dropped)")
        print(format_rollup(rollup(events)))
    return QueriesRun(snap, dt, daisy, server, cleaner, tickets)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("queries",), default="queries")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the instance (cuda, the default, or cpu)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument(
        "--background", action="store_true",
        help="run the DESIGN.md §10 background cleaner behind the serving loop",
    )
    ap.add_argument(
        "--increment-rows", type=int, default=0,
        help="rows per background FD increment (0 = rows/8; whole lhs groups)",
    )
    ap.add_argument(
        "--increment-strips", type=int, default=1,
        help="work-ledger strips per background DC increment (DESIGN.md §11)",
    )
    ap.add_argument(
        "--ingest-chunks", type=int, default=0,
        help="appends to stream through QueryServer.ingest mid-workload "
             "(DESIGN.md §12; 0 = fixed instance)",
    )
    ap.add_argument(
        "--ingest-rows", type=int, default=0,
        help="rows per streamed append (held back from the seed instance)",
    )
    ap.add_argument(
        "--qos", action="store_true",
        help="weighted-fair queueing + SLO classes on the submit queue "
             "(DESIGN.md §14); the launcher mixes interactive and batch "
             "requests and reports per-class latency",
    )
    ap.add_argument(
        "--overload", type=int, default=0, metavar="DEPTH",
        help="queue depth past which sheddable requests are answered from "
             "the cache with a staleness tag instead of queueing "
             "(DESIGN.md §14; 0 = never shed)",
    )
    ap.add_argument(
        "--trace", default=None, metavar="OUT.json",
        help="dump a Chrome trace-event JSON of the serving run (DESIGN.md §13)",
    )
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run_queries(ServeOptions.from_args(args))


if __name__ == "__main__":
    main()
