#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, every phase

Phases, each of which must pass or the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernel (``src/repro_torch/csrc/dc_pairs.cu``) with nvcc;
3. the kernel against its plain PyTorch version on the card, bit for bit,
   over dtypes, worklists, ragged sizes, partial scopes, NaN and signed
   zeros; then its time, the plain version's time and its bound at
   n = 131,072 on the full worklist;
4. the FD path (rule orderkey -> suppkey): the port's ``Daisy`` on the card
   against the same engine on the CPU at 65,536 rows, query by query; then
   SSB lineorder at scale factor 1 (6,000,000 rows), 20 range queries;
5. the DC path (fig12's price/discount DC at 2% violations) at 131,072
   rows, once through the kernel and once with the plain version forced,
   answers and overlays bit-identical, kernel launches counted.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM yardsticks of the kernel's bound.  Bytes: HBM3 at 3.35 TB/s
# (NVIDIA data sheet).  Operations: the data sheet's 67 TFLOP/s of float32
# outside the tensor cores counts a fused multiply-add as two; a compare or
# a min/max is one instruction per lane, so the issue rate is half of it:
# 132 SMs x 128 float32 lanes x 1.98 GHz boost = 33.5e12 per second.  The
# timed case compares float32 columns; int32 compares issue on 64 lanes per
# SM and would halve the rate again.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 132 * 128 * 1.98e9

FD_SMALL_ROWS = 65_536
SF1_ROWS, SF1_ORDERKEYS, SF1_SUPPKEYS = 6_000_000, 1_500_000, 2_000
DC_ROWS = 131_072
N_QUERIES = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# ------------------------------------------------------------------ phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# ------------------------------------------------------------------ helpers
def bits(t):
    """Bit pattern of a tensor, for exact comparison (NaNs are canonical)."""
    import torch

    if t.dtype in (torch.float32,):
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def max_abs_err(a, b) -> float:
    import torch

    x, y = a.to(torch.float64), b.to(torch.float64)
    same = (x == y) | (x.isnan() & y.isnan())  # equal infinities included
    diff = torch.where(same, 0.0, (x - y).abs())
    diff = torch.where(diff.isnan(), float("inf"), diff)  # NaN against a number
    return float(diff.max()) if diff.numel() else 0.0


def same_scan(got, want, what: str) -> float:
    """Hold two ``DCPairScanResult``s bit for bit; returns the max abs error."""
    import torch

    err = 0.0
    pairs = [(got.t1_count, want.t1_count), (got.t2_count, want.t2_count)]
    pairs += list(zip(got.t1_stat, want.t1_stat)) + list(zip(got.t2_stat, want.t2_stat))
    for g, w in pairs:
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{what}: dtype/shape {g.dtype}{tuple(g.shape)} != {w.dtype}{tuple(w.shape)}")
        err = max(err, max_abs_err(g, w))
        if not torch.equal(bits(g), bits(w)):
            fail(f"{what}: kernel differs from the plain version (max abs err {err})")
    return err


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phase 3
def scan_case(cols_l, cols_r, ops, rs, cs, block=256, **restr):
    from repro_torch.core.constraints import flip_op
    from repro_torch.core.detect import _T1_REDUCE
    from repro_torch.kernels import ops as kops

    flipped = [flip_op(o) for o in ops]
    return lambda: kops.dc_pair_scan(
        cols_l, cols_r, ops, flipped, rs, cs,
        [_T1_REDUCE[o] for o in ops], [_T1_REDUCE[o] for o in flipped],
        block=block, **restr,
    )


def kernel_phase(dev):
    import numpy as np
    import torch

    from repro_torch.kernels import dc_pairs

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scope(n, p):
        return t(rng.random(n) < p)

    cases = []
    n = DC_ROWS
    price = t(rng.uniform(1000, 5000, n).astype(np.float32))
    disc = t((0.5 - (price.cpu().numpy() - 1000) / 8000 + rng.normal(0, 0.02, n)).astype(np.float32))
    full_scope = torch.ones(n, dtype=torch.bool, device=dev)
    timing_case = scan_case([price, disc], [price, disc], ["<", ">"], full_scope, full_scope)
    cases.append((f"f32 price<,disc> n={n} full", timing_case))
    m = 50_000  # ragged: not a multiple of 256
    key = t(rng.integers(0, 3000, m).astype(np.int32))
    val = t(rng.integers(0, 5, m).astype(np.int32))
    cases.append(("FD-as-DC int32 ==,!= ragged", scan_case(
        [key, val], [key, val], ["==", "!="], scope(m, 0.9), scope(m, 0.9))))
    i8 = t(rng.integers(-128, 128, 20_000).astype(np.int8))
    i16 = t(rng.integers(-3000, 3000, 20_000).astype(np.int16))
    bf = t(rng.integers(-200, 200, 20_000).astype(np.float32) / 4).to(torch.bfloat16)
    cases.append(("int8 <=,>=", scan_case([i8], [i8], ["<="], scope(20_000, 0.8), scope(20_000, 0.8))))
    cases.append(("int16 code ==", scan_case([i16], [i16], ["=="], scope(20_000, 0.8), scope(20_000, 0.8))))
    cases.append(("bf16 >,int8 !=", scan_case(
        [bf, i8], [bf, i8], [">", "!="], scope(20_000, 0.8), scope(20_000, 0.8))))
    nb = -(-n // 256)
    rows = np.flatnonzero(rng.random(nb) < 0.3).astype(np.int32)
    colsb = np.flatnonzero(rng.random(nb) < 0.5).astype(np.int32)
    cases.append(("partial worklist", scan_case(
        [price, disc], [price, disc], ["<", ">"], scope(n, 0.7), scope(n, 0.7),
        row_block_ids=rows, col_block_ids=colsb)))
    cases.append(("row strip (lo, hi)", scan_case(
        [price, disc], [price, disc], ["<=", ">="], full_scope, full_scope, row_blocks=(7, 19))))
    for r in (1, 31, 257, 1000):
        a = t(rng.integers(0, 6, r).astype(np.int32))
        cases.append((f"ragged n={r}", scan_case([a], [a], ["<"], scope(r, 0.7), scope(r, 0.7), block=64)))
    special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 2.5], np.float32)
    z = t(rng.choice(special, 3000))
    w = t(rng.choice(special, 3000))
    cases.append(("NaN and signed zeros !=,<", scan_case(
        [z, w], [z, w], ["!=", "<"], scope(3000, 0.9), scope(3000, 0.9), block=128)))
    cases.append(("mixed int32/f32 atom", scan_case(
        [key[:3000]], [z], ["<="], scope(3000, 0.9), scope(3000, 0.9))))

    err = 0.0
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    for name, fn in cases:
        got = fn()
        with dc_pairs.plain_version():
            want = fn()
        torch.cuda.synchronize()
        e = same_scan(got, want, name)
        err = max(err, e)
        log(f"kernel == plain: {name}: bit-identical (launched tiles {got.tiles.launched})")
    empty = scan_case([price], [price], ["<"], full_scope, full_scope,
                      row_block_ids=np.array([], np.int32))()
    launched = dc_pairs.LAUNCHES["dc_pair_scan"] - before
    if launched != len(cases):
        fail(f"{launched} launches for {len(cases)} cases + one empty worklist")
    if bool(empty.t1_count.any()) or not bool((empty.t1_stat[0] == -float("inf")).all()):
        fail("empty worklist does not give identities")
    log("kernel == plain: empty worklist: identities, no launch")

    ms = cuda_ms(timing_case, 5)
    with dc_pairs.plain_version():
        plain_ms = cuda_ms(timing_case, 1)
    res = timing_case()
    bound_ms, bound_by, detail = scan_bound(
        [price, disc], [price, disc], ["<", ">"], full_scope, full_scope, res
    )
    log(f"dc_pair_scan n={n} full worklist: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {detail})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def scan_bound(l_cols, r_cols, ops, rs, cs, res, block=256):
    """Least time for the scan's work on an H100: bytes (each input read once,
    each output written once) over HBM bandwidth vs operations over the
    32-bit instruction issue rate.  Operations count what this run's data needs:
    per role, one comparison per atom for every pair in the tiles the block
    bounds cannot rule out, plus a count and a min/max per atom for every
    violating pair."""
    import torch

    from repro_torch.core.constraints import flip_op
    from repro_torch.kernels import dc_pairs

    n = l_cols[0].shape[0]
    nb = -(-n // block)
    distinct, l_idx, r_idx = dc_pairs.distinct_columns(l_cols, r_cols)
    pad = nb * block - n
    cols = [torch.nn.functional.pad(c, (0, pad)) for c in distinct]
    rsp = torch.nn.functional.pad(rs, (0, pad))
    csp = torch.nn.functional.pad(cs, (0, pad))
    b = [[dc_pairs._block_bounds(c, s, red, nb, block) for c in cols]
         for s, red in ((rsp, "min"), (rsp, "max"), (csp, "min"), (csp, "max"))]
    pairs = 0
    for role_ops, li, ri in ((ops, l_idx, r_idx), ([flip_op(o) for o in ops], r_idx, l_idx)):
        ok = torch.ones((nb, nb), dtype=torch.bool, device=rs.device)
        for op, x, y in zip(role_ops, li, ri):
            ok &= dc_pairs._tile_possible(
                op, b[0][x][:, None], b[1][x][:, None], b[2][y][None, :], b[3][y][None, :]
            )
        pairs += int(ok.sum()) * block * block
    violating = int(res.t1_count.sum()) + int(res.t2_count.sum())
    n_atoms = len(ops)
    ops_count = pairs * n_atoms + violating * (n_atoms + 1)
    in_bytes = sum(c.numel() * c.element_size() for c in distinct) + 2 * n
    out_bytes = 2 * 4 * n + sum(
        s.numel() * s.element_size() for s in res.t1_stat + res.t2_stat
    )
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S * 1e3
    detail = f"{ops_count:.3e} ops, {in_bytes + out_bytes} bytes"
    if t_ops >= t_bytes:
        return t_ops, "operations", detail
    return t_bytes, "bytes", detail


# ------------------------------------------------------------- Daisy helpers
def daisy_state(daisy, result, rules):
    """Host copy of everything a query leaves behind, for exact comparison."""
    import numpy as np

    rel = daisy.db["t"]
    state = {"mask": result.mask.cpu().numpy()}
    for field in ("cand", "ccount", "ckind", "checked"):
        for k, v in getattr(rel, field).items():
            state[f"{field}.{k}"] = v.cpu().numpy()
    state["steps"] = [s.asdict() for s in result.report.steps]
    state["versions"] = [daisy.scope_version("t", r.name) for r in rules]
    state["clean_version"] = daisy.clean_version
    if result.groups is not None:
        for k, v in result.groups.items():
            state[f"groups.{k}"] = np.asarray(v.cpu().numpy())
    return state


def same_state(a, b, what: str, float_groups_rtol: float | None = None) -> None:
    import numpy as np

    if a.keys() != b.keys():
        fail(f"{what}: different state keys")
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            if float_groups_rtol is not None and k in ("groups.count", "groups.agg"):
                np.testing.assert_allclose(x, y, rtol=float_groups_rtol, err_msg=f"{what} {k}")
            elif x.dtype != y.dtype or not np.array_equal(
                x.view(np.uint8) if x.dtype.kind == "f" else x,
                y.view(np.uint8) if y.dtype.kind == "f" else y,
            ):
                fail(f"{what}: {k} differs")
        elif x != y:
            fail(f"{what}: {k}: {x} != {y}")


def range_queries(col, edges, as_float):
    from repro_torch.core.operators import Pred, Query

    cast = float if as_float else int
    return [
        Query("t", preds=(Pred(col, ">=", cast(lo)), Pred(col, "<", cast(hi))))
        for lo, hi in zip(edges[:-1], edges[1:])
    ]


# ------------------------------------------------------------------ phase 4
def fd_workload(n, n_orderkeys, n_suppkeys, device):
    from repro_torch.core.constraints import FD
    from repro_torch.core.relation import make_relation
    from repro_torch.data.generators import inject_fd_errors, ssb_lineorder

    clean = ssb_lineorder(n, n_orderkeys, n_suppkeys, seed=0)
    ds = inject_fd_errors(clean, "orderkey", "suppkey", frac_groups=1.0,
                          frac_rows=0.1, n_values=n_suppkeys, seed=1)
    rel = make_relation(ds.data, overlay=["orderkey", "suppkey"], k=8,
                        rules=["fd_os"], device=device)
    return rel, FD("fd_os", "orderkey", "suppkey")


def fd_phase(dev):
    import numpy as np
    import torch

    from repro_torch.core.executor import Daisy, DaisyConfig
    from repro_torch.core.operators import GroupBySpec, Query

    def queries(n_orderkeys):
        edges = np.linspace(0, n_orderkeys, N_QUERIES + 1).astype(int)
        return range_queries("orderkey", edges, as_float=False) + [
            Query("t", groupby=GroupBySpec(("suppkey",), "count"))
        ]

    n_ok = FD_SMALL_ROWS // 4
    runs = {}
    for device in ("cpu", dev):
        rel, fd = fd_workload(FD_SMALL_ROWS, n_ok, SF1_SUPPKEYS, device)
        daisy = Daisy({"t": rel}, {"t": [fd]}, DaisyConfig(expected_queries=N_QUERIES),
                      device=device)
        runs[device] = [daisy_state(daisy, daisy.execute(q), [fd]) for q in queries(n_ok)]
    for i, (a, b) in enumerate(zip(runs["cpu"], runs[dev])):
        # group-by float sums are accumulated with atomics on the card
        same_state(a, b, f"FD {FD_SMALL_ROWS} rows query {i} cuda vs cpu",
                   float_groups_rtol=1e-6)
    log(f"FD path {FD_SMALL_ROWS} rows: cuda == cpu on {len(runs['cpu'])} queries "
        f"(modes {[s['mode'] for st in runs[dev] for s in st['steps']]})")

    t0 = time.perf_counter()
    rel, fd = fd_workload(SF1_ROWS, SF1_ORDERKEYS, SF1_SUPPKEYS, dev)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    daisy = Daisy({"t": rel}, {"t": [fd]}, DaisyConfig(expected_queries=N_QUERIES), device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    log(f"FD SF1: {SF1_ROWS} rows, {SF1_ORDERKEYS} orderkeys, {SF1_SUPPKEYS} suppkeys; "
        f"data {t_data:.3f} s, Daisy init (stats) {t_init:.3f} s")
    times, modes = [], []
    for i, q in enumerate(queries(SF1_ORDERKEYS)[:N_QUERIES]):
        t0 = time.perf_counter()
        res = daisy.execute(q)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        step = res.report.steps[0]
        modes.append(step.mode)
        if res.mask.shape[0] != SF1_ROWS or res.report.result_size <= 0:
            fail(f"FD SF1 query {i}: empty or misshapen answer")
        log(f"FD SF1 query {i}: {dt * 1e3:.3f} ms mode={step.mode} answer={step.answer_size} "
            f"extra={step.extra} repaired={step.repaired} result={res.report.result_size}")
    for name in ("orderkey", "suppkey"):
        c = daisy.db["t"].ccount[name]
        if not bool(torch.isfinite(c).all()) or bool((c < 0).any()):
            fail(f"FD SF1: bad candidate counts on {name}")
    log(f"FD SF1: total {sum(times):.3f} s over {N_QUERIES} queries, "
        f"mean {np.mean(times) * 1e3:.3f} ms, modes {modes}")


# ------------------------------------------------------------------ phase 5
def dc_workload(device):
    import numpy as np

    from repro_torch.core.constraints import DC, Atom
    from repro_torch.core.relation import make_relation
    from repro_torch.data.generators import inject_dc_errors, ssb_lineorder

    clean = ssb_lineorder(DC_ROWS, 128, 16, seed=21)
    # monotone-consistent clean data: discount decreasing in price (fig12)
    order = np.argsort(clean["extended_price"])
    d = np.sort(clean["discount"])[::-1]
    clean["discount"] = d[np.argsort(order)].astype(np.float32)
    ds = inject_dc_errors(clean, "discount", 0.02, 0.3, seed=22)
    rel = make_relation(ds.data, overlay=["extended_price", "discount"], k=8,
                        rules=["dc_pd"], device=device)
    dc = DC("dc_pd", [Atom("extended_price", "<", "extended_price"),
                      Atom("discount", ">", "discount")])
    return rel, dc


def dc_run(dev):
    import numpy as np
    import torch

    from repro_torch.core.executor import Daisy, DaisyConfig

    rel, dc = dc_workload(dev)
    daisy = Daisy({"t": rel}, {"t": [dc]},
                  DaisyConfig(dc_partitions=16, accuracy_threshold=0.3,
                              expected_queries=N_QUERIES, use_cost_model=False),
                  device=dev)
    states, times = [], []
    for q in range_queries("extended_price", np.linspace(1000, 5000, N_QUERIES + 1), True):
        t0 = time.perf_counter()
        res = daisy.execute(q)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        states.append(daisy_state(daisy, res, [dc]))
    return states, times


def dc_phase(dev):
    from repro_torch.kernels import dc_pairs

    dc_pairs.reset_launch_counts()
    states, times = dc_run(dev)
    launches = dc_pairs.LAUNCHES["dc_pair_scan"]
    if launches <= 0:
        fail("DC path ran without launching the dc_pair_scan kernel")
    with dc_pairs.plain_version():
        plain_states, plain_times = dc_run(dev)
    for i, (a, b) in enumerate(zip(states, plain_states)):
        same_state(a, b, f"DC query {i} kernel vs plain")
    modes = [s["mode"] for st in states for s in st["steps"]]
    tiles = sum(s["tiles_launched"] for st in states for s in st["steps"])
    log(f"DC path {DC_ROWS} rows: kernel run == plain run on {len(states)} queries; "
        f"kernel launches {launches}, tiles {tiles}, modes {modes}")
    log(f"DC path: kernel run {sum(times):.3f} s, plain run {sum(plain_times):.3f} s; "
        f"per query ms (kernel) {[round(t * 1e3, 3) for t in times]}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import dc_pairs
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})", file=sys.stderr)
        return 2
    if not os.path.abspath(dc_pairs.__file__).startswith(os.path.join(HERE, "src") + os.sep):
        print(f"chip_smoke: repro_torch imported from outside this checkout "
              f"({dc_pairs.__file__})", file=sys.stderr)
        return 2
    dev = "cuda"
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    path = dc_pairs.build_library(verbose_ptxas=True)
    log(f"built {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.2f} s")
    for line in dc_pairs.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    measured = kernel_phase(dev)
    fd_phase(dev)
    launches = dc_phase(dev)
    record = dict(
        name="dc_pair_scan", route="cuda", source="src/repro_torch/csrc/dc_pairs.cu",
        replaces="src/repro/kernels/dc_pairs.py:445", launches=launches,
        library_ms=None, **measured,
    )
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
