"""Trace export and per-phase cost rollups (DESIGN.md §13); the port's own
copy of ``repro.obs.export``.

``chrome_trace`` renders a tracer's events as Chrome trace-event JSON
(the ``{"traceEvents": [...]}`` container), loadable directly in
Perfetto / ``chrome://tracing``: one complete-event (``"ph": "X"``) per
span with microsecond timestamps relative to the tracer's creation, one
track per recording thread (plus synthetic tracks like the server's
queue-wait), and the span attrs under ``args``.  ``events_from_chrome``
inverts it, so a dumped trace round-trips back into ``SpanEvent``s for
offline analysis (tools/trace_summary.py).

``rollup`` is the per-phase cost attribution: for every span name, the
inclusive total, the **exclusive self-time** (inclusive minus the time
spent in child spans — computed by stack subtraction per thread, valid
because spans on one thread are well-nested, see obs/trace.py), the
count, and the slowest instance.  Self-times of all phases sum to the
wall-clock the trace actually covers, which is what lets the serving
benchmarks gate "the rollup explains >= 90% of the serving loop"
(``coverage``).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import SpanEvent


def chrome_trace(events: Iterable[SpanEvent], origin: float = 0.0) -> Dict:
    """Chrome trace-event JSON object for a list of spans.

    ``origin`` (a ``perf_counter`` value, typically ``Tracer.created``)
    becomes timestamp zero.  Zero-duration events export as instants
    (``"ph": "i"``); thread tracks carry name metadata so Perfetto labels
    them."""
    tids: Dict[str, int] = {}
    out: List[Dict] = []
    for ev in events:
        tid = tids.setdefault(ev.thread, len(tids) + 1)
        rec = {
            "name": ev.name,
            "cat": ev.name.partition(".")[0],
            "ts": (ev.t0 - origin) * 1e6,
            "pid": 1,
            "tid": tid,
            "args": dict(ev.attrs),
        }
        if ev.dur > 0.0:
            rec["ph"] = "X"
            rec["dur"] = ev.dur * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        out.append(rec)
    meta = [
        {
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": thread},
        }
        for thread, tid in tids.items()
    ]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def events_from_chrome(trace: Dict) -> List[SpanEvent]:
    """Invert ``chrome_trace``: rebuild ``SpanEvent``s (seconds, origin-
    relative) from a trace-event JSON object."""
    names = {
        rec["tid"]: rec["args"]["name"]
        for rec in trace.get("traceEvents", ())
        if rec.get("ph") == "M" and rec.get("name") == "thread_name"
    }
    out = []
    for rec in trace.get("traceEvents", ()):
        if rec.get("ph") not in ("X", "i"):
            continue
        out.append(SpanEvent(
            name=rec["name"],
            t0=rec["ts"] / 1e6,
            dur=rec.get("dur", 0.0) / 1e6,
            thread=names.get(rec.get("tid"), str(rec.get("tid"))),
            attrs=dict(rec.get("args", {})),
        ))
    return out


def write_trace(path: str, events: Iterable[SpanEvent],
                origin: float = 0.0) -> str:
    """Dump a Perfetto-loadable trace JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(events, origin=origin), f)
    return path


def load_trace(path: str) -> List[SpanEvent]:
    """Load a trace written by ``write_trace`` back into events."""
    with open(path) as f:
        return events_from_chrome(json.load(f))


def rollup(events: Iterable[SpanEvent]) -> Dict[str, Dict[str, float]]:
    """Per-phase attribution: name -> {count, total_s, self_s, max_s}.

    ``total_s`` is inclusive; ``self_s`` subtracts each span's direct
    children (per-thread stack walk over t0-sorted spans), so self-times
    across phases partition the covered wall-clock without double
    counting nested phases (clean.detect inside serve.execute inside a
    step).  Phases whose spans carry tile attrs (the block-sparse DC
    scans, DESIGN.md §15) additionally aggregate ``tiles_launched`` /
    ``tiles_skipped`` sums, so the rollup attributes launch work, not
    just wall-clock."""
    by_thread: Dict[str, List[SpanEvent]] = {}
    for ev in events:
        by_thread.setdefault(ev.thread, []).append(ev)
    out: Dict[str, Dict[str, float]] = {}
    for spans in by_thread.values():
        spans.sort(key=lambda e: (e.t0, -e.dur))
        stack: List[Tuple[float, SpanEvent]] = []  # (end, span)
        selfs = {id(ev): ev.dur for ev in spans}
        for ev in spans:
            while stack and stack[-1][0] <= ev.t0 + 1e-12:
                stack.pop()
            if stack:
                selfs[id(stack[-1][1])] -= ev.dur
            stack.append((ev.t0 + ev.dur, ev))
        for ev in spans:
            agg = out.setdefault(
                ev.name, {"count": 0, "total_s": 0.0, "self_s": 0.0, "max_s": 0.0}
            )
            agg["count"] += 1
            agg["total_s"] += ev.dur
            agg["self_s"] += max(selfs[id(ev)], 0.0)
            agg["max_s"] = max(agg["max_s"], ev.dur)
            for key in ("tiles_launched", "tiles_skipped"):
                val = ev.attrs.get(key)
                if isinstance(val, (int, float)):
                    agg[key] = agg.get(key, 0) + int(val)
    return out


def _merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    iv.sort()
    merged: List[Tuple[float, float]] = []
    for lo, hi in iv:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def coverage(
    events: Iterable[SpanEvent],
    windows: Sequence[Tuple[float, float]],
    exclude_threads: Optional[Sequence[str]] = None,
) -> float:
    """Fraction of the wall-clock ``windows`` (perf_counter intervals)
    covered by the union of span intervals — the "does the trace explain
    where the time went" gate.  ``exclude_threads`` drops synthetic
    tracks (queue-wait overlaps real serving spans by construction)."""
    excl = set(exclude_threads or ())
    spans = _merge_intervals(
        [(e.t0, e.t0 + e.dur) for e in events if e.dur > 0 and e.thread not in excl]
    )
    wins = _merge_intervals([(lo, hi) for lo, hi in windows if hi > lo])
    total = sum(hi - lo for lo, hi in wins)
    if total <= 0.0:
        return 0.0
    covered = 0.0
    i = 0
    for wlo, whi in wins:
        while i < len(spans) and spans[i][1] <= wlo:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < whi:
            covered += min(spans[j][1], whi) - max(spans[j][0], wlo)
            j += 1
    return covered / total


def top_spans(events: Iterable[SpanEvent], k: int = 10) -> List[SpanEvent]:
    """The ``k`` slowest individual spans, slowest first."""
    return sorted(events, key=lambda e: e.dur, reverse=True)[:k]


def format_rollup(roll: Dict[str, Dict[str, float]]) -> str:
    """Human-readable per-phase table, largest self-time first.  Phases
    that aggregated tile attrs get a trailing launched/skipped column."""
    tiles = any("tiles_launched" in agg for agg in roll.values())
    header = f"{'phase':<28} {'count':>7} {'total':>10} {'self':>10} {'max':>10}"
    if tiles:
        header += f" {'tiles l/s':>17}"
    lines = [header]
    for name, agg in sorted(roll.items(), key=lambda kv: -kv[1]["self_s"]):
        line = (
            f"{name:<28} {agg['count']:>7d} {agg['total_s']*1e3:>8.1f}ms "
            f"{agg['self_s']*1e3:>8.1f}ms {agg['max_s']*1e3:>8.1f}ms"
        )
        if tiles and "tiles_launched" in agg:
            line += (
                f" {int(agg['tiles_launched']):>8d}/"
                f"{int(agg.get('tiles_skipped', 0)):<8d}"
            )
        lines.append(line)
    return "\n".join(lines)
