#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, every phase

Phases, each of which must pass or the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels (``src/repro_torch/csrc/dc_pairs.cu``,
   ``flash_attention.cu``, ``flash_attention_wgmma.cu`` and
   ``semijoin.cu``) with nvcc, one process each, at once; log what
   ``ptxas`` says of registers and spills, and fail if any of the DC scan's
   ten instantiations spills;
3. the DC pair scan against its plain PyTorch version on the card, bit for
   bit, over dtypes, worklists, ragged sizes, partial scopes, NaN and signed
   zeros, then over every case of ``kernels/dc_scan_check.py`` (each
   specialised atom count and the generic path up to 8 atoms over 16
   columns, integer extremes, int32 above 2**24 in a float atom, blocks 1,
   64, 100 and 1,024, 7 col chunks over 50 col blocks, a one-row-block
   strip, and the worklists of background increments and ingest deltas:
   1, 2 and 16 one-block strips x every col block of a grid that has just
   doubled, with pad values past its valid prefix, an append's fresh rows
   starting off a block boundary as the col range, and one partly fresh
   col block alone); two launches of the timing case and a one-chunk launch give the
   same bits; then its time (the call, and the kernel alone by
   ``torch.profiler``), the plain version's time and its bound at
   n = 131,072 on the full worklist;
4. the DC role scan (the same kernel with role t2 compiled out) against its
   plain version, bit for bit, over the same kinds of cases and the same
   check cases, two launches of its timing case bit-identical; then its
   time, the plain version's and its bound on fig12's DC at n = 131,072,
   one role;
5. the semijoin kernel (a hash build and probe) against its plain version
   and ``torch.isin``, bit for bit, at the reference kernel tests' shapes,
   with an all-false key mask, INT32_MIN, INT32_MAX, -1 and 0 as keys,
   heavy duplicates (a copy masked out while its twin is in), keys that
   are multiples of the table size, m = 0, every key masked out, n = 0 and
   200,000 queries over SF1's 1,500,000-orderkey domain; then its time,
   the plain version's, ``torch.isin``'s and its bound at SF1 size
   (6,000,000 lineorder orderkeys against 75,000 keys), where it must be
   no slower than ``torch.isin``;
6. both flash-attention kernels against the plain version on the card
   (float32 ``atol=rtol=2e-5``, bf16 ``atol=3e-2``: the reference tests'
   tolerances), each case checked to launch the kernel ``kernel_variant``
   chooses: the wgmma kernel (bf16, D 64 and 128) over qwen3-4b's prefill
   (contiguous, and as the (b, s, h, d) views the model passes), group
   sizes 1, 4 and 8, D 64 ragged S 300, non-causal Sq 77 against Sk 1000,
   windows 64 at ragged S 500 and 1024 at S 4096, and a uniform V; the
   CUDA-core kernel over float32 I/O, non-causal Sq 1 and 77, D 64, D 256
   in bf16, a uniform V, and the prefill shape; then both kernels' times
   at the prefill shape B 2 x S 2048 in alternating turns, beside the
   plain version's, the ``scaled_dot_product_attention`` yardstick's and
   the bound;
7. the FD path (rule orderkey -> suppkey): the port's ``Daisy`` on the card
   against the same engine on the CPU at 65,536 rows, query by query; then
   SSB lineorder at scale factor 1 (6,000,000 rows), 20 range queries;
8. the DC path (fig12's price/discount DC at 2% violations) at 131,072
   rows, once through the kernel and once with the plain version forced,
   answers and overlays bit-identical, kernel launches counted; then the
   kernel's own device time on the path, a fresh ``Daisy``'s first query
   under ``torch.profiler``;
9. the join path (fig13's lineorder |x| suppliers on suppkey, FDs on both
   tables): 20 range joins and the region group-by on the card against the
   CPU at 65,536 rows, then at SF1 (6,000,000 lineorder rows, 2,000
   suppliers) with no overflow;
10. the offline baseline: ``OfflineCleaner.clean_all`` on the SF1 FD
    workload, its answers equal to Daisy's on the 20 queries of phase 7
    (the FD guarantee), then on the DC workload of phase 8 (one pair-scan
    launch), the cleaned relation bit-identical to a ``clean_all``
    through the plain version;
11. the query service on a serial schedule driven from this thread: the
    launcher's hospital table (FD ``zc``, DC ``bq``) at 8,000 rows, 12
    queries, two ``cleaner.drain(max_increments=2)``, two appends of 1,024
    rows (the first off a block boundary, growing the capacity from 8,000
    to 16,384), 12 more queries and a full drain; on the card, on the card
    under the pair scan's plain version, and on the CPU, every mask,
    overlay, checked bit, step report, ledger entry and snapshot counter
    equal;
12. streaming ingest against stop-the-world rebuilds at scale, the gates of
    ``benchmarks/serve_ingest.py`` rebuilt here: FD zip -> city and DC
    price <, disc >, 131,072 seed rows warm, then 4 appends of 16,384 rows
    (the first doubles the capacity to 262,144); after each, (a) the
    probes' answers and the whole overlay equal a fresh ``Daisy``'s over
    the same rows, (b) the round's DC pairs are exactly checked x new +
    new x total, (c) no checked strip went cold; then one more append and
    ``torch.profiler``'s time of the pair scan on its ingest delta and on
    a one-strip increment;
13. the port's query-service launcher (``launch/serve.py``'s
    ``run_queries``) at 131,072 + 4 x 8,192 rows: 8 sessions, 400
    requests, the background cleaner (16 strips an increment) and QoS, on
    a serving and a cleaner thread, under ``torch.profiler`` for the
    device's busy share; every ticket answered, no error, and no cold row
    after a final drain;
14. qwen3-4b at its published width (36 layers, d_model 2560, vocab
   151,936) with weights from a seed: in float32 compute, prefill(256) then
   decode(token 256) against forward(257) at the last position, and
   prefill(256) and forward(257), every position, through the CUDA-core
   kernel against the plain attention version at the reference's
   ``atol=rtol=2e-3``; in bf16 compute, ``prefill`` of B 2 x 2048 tokens
   (exactly 36 launches of the wgmma kernel) and 32 greedy
   ``decode_step``s, the same prefill through the plain attention version
   (logits within 5% of the largest), and each of the 36 layers' live
   (q, k, v), captured in one more prefill, through the kernel against the
   plain version at bf16 ``atol=3e-2``; then ``torch.profiler``'s device
   time of that prefill and of four more decode steps on the main run's
   cache;
15. the ``ServeEngine`` at that width, a functional smoke: 8 requests of
   8-16 prompt tokens, 16 new tokens each, through 4 slots.

Each main path (FD, DC, join, offline, ingest, service, the LM prefill and
decode, the engine) runs with every kernel's launch count at 0, read just
after; the
counts must be as ``PATH_LAUNCHES`` says, and the role scan, the semijoin
and the CUDA-core flash kernel lie on none of them.  The line before the
last is a JSON object describing each kernel, its launches summed over
the paths and given per path; the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA
device, or without the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# Attention's products are bf16 at the main path's shapes: the tensor cores'
# dense bf16 rate (NVIDIA data sheet, H100 SXM).
PEAK_BF16_FLOPS = 989e12

F32_TOL = dict(atol=2e-5, rtol=2e-5)  # the reference tests' float32 tolerance
BF16_TOL = dict(atol=3e-2, rtol=0.0)  # and their bf16 tolerance
LM_BATCH, LM_PROMPT, LM_DECODE = 2, 2048, 32
# decode steps profiled after the main run, on its cache (one warm-up more)
LM_PROFILE_STEPS = 4
LM_CHECK_PROMPT = 256
# Prefill logits through the kernel against the plain attention version:
# both are bf16 networks whose attention outputs round apart, so logits
# agree within 5% of the largest logit magnitude.
LM_PLAIN_REL_TOL = 0.05
# prefill(s) + decode against forward(s + 1) in float32 compute: the
# reference's tolerance (tests/test_arch_smoke.py)
LM_F32_TOL = dict(atol=2e-3, rtol=2e-3)
ENGINE_REQUESTS, ENGINE_SLOTS, ENGINE_NEW = 8, 4, 16

FD_SMALL_ROWS = 65_536
SF1_ROWS, SF1_ORDERKEYS, SF1_SUPPKEYS = 6_000_000, 1_500_000, 2_000
DC_ROWS = 131_072
N_QUERIES = 20
# semijoin at SF1: lineorder's orderkeys against the orderkeys one range
# query's answer relaxes to (one twentieth of SF1's 1,500,000)
SEMIJOIN_KEYS = SF1_ORDERKEYS // N_QUERIES
# join queries: 100 suppkeys each; the capacity holds the largest answer
# (the region group-by joins every lineorder row)
JOIN_CAPACITY = 1 << 24
# the query service's phases: the serial schedule (the launcher's hospital
# table, grown by two appends from 8,000 rows of capacity to 16,384), the
# serving-ingest regime at scale (strips and appends of 16,384 rows), and
# the launcher itself with its background cleaner, streamed ingest and QoS
SERIAL_ROWS, SERIAL_CHUNK, SERIAL_QUERIES = 8_000, 1_024, 12
INGEST_ROWS, INGEST_CHUNK, INGEST_APPENDS = 131_072, 16_384, 4
SERVICE_ROWS, SERVICE_CHUNK, SERVICE_REQUESTS = 131_072, 8_192, 400
# Launches each main path must make (None: at least one); a kernel not
# named launches none there.  dc_role_scan and semijoin lie on no path:
# only their kernels.ops entry points call them.  The LM prefill's 36
# attention calls are bf16 at head dim 128: the wgmma kernel's; the
# CUDA-core flash kernel (float32, other head dims) lies on no path.
PATH_LAUNCHES = {
    "fd": {}, "dc": {"dc_pair_scan": None}, "join": {}, "offline": {"dc_pair_scan": 1},
    "ingest": {"dc_pair_scan": None}, "service": {"dc_pair_scan": None},
    "lm": {"flash_attention_wgmma": 36}, "engine": {},
}


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
def max_abs_err(a, b) -> float:
    import torch

    x, y = a.to(torch.float64), b.to(torch.float64)
    same = (x == y) | (x.isnan() & y.isnan())  # equal infinities included
    diff = torch.where(same, 0.0, (x - y).abs())
    diff = torch.where(diff.isnan(), float("inf"), diff)  # NaN against a number
    return float(diff.max()) if diff.numel() else 0.0


def same_flat(got, want, what: str) -> float:
    """Hold two flat scan outputs (counts, then stats, role by role) bit for
    bit; returns the max abs error."""
    from repro_torch.kernels import dc_scan_check as dsc

    differs = dsc.same_bits(got, want)
    if differs:
        fail(f"{what}: kernel differs from the plain version: {differs}")
    return max([0.0] + [max_abs_err(g, w) for g, w in zip(got, want)])


def pair_flat(res):
    """A ``DCPairScanResult`` as a flat scan output."""
    return (res.t1_count, *res.t1_stat, res.t2_count, *res.t2_stat)


def same_scan(got, want, what: str) -> float:
    """Hold two ``DCPairScanResult``s bit for bit; returns the max abs error."""
    return same_flat(pair_flat(got), pair_flat(want), what)


def _counted():
    from repro_torch.kernels import dc_pairs, flash_attention, semijoin

    return dc_pairs, semijoin, flash_attention


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for module in _counted():
        module.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launches since the last ``reset_counts``."""
    out = {}
    for module in _counted():
        out.update(module.LAUNCHES)
    return out


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
    from repro_torch.kernels import dc_scan_check as dsc

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

    err = max(err, scan_check_cases(dev, both=True))

    res = timing_case()
    again = timing_case()
    torch.cuda.synchronize()
    same_scan(again, res, "timing case, second launch against the first")
    same_flat(dsc.scan(dsc.timing_inputs(dev), True, chunks=1), pair_flat(res),
              "timing case in one col chunk against the default chunking")
    log("dc_pair_scan timing case: two launches bit-identical, and one col chunk against "
        "the default chunking")
    ms = cuda_ms(timing_case, 5)
    kernel_ms = scan_kernel_ms(timing_case, 3)
    with dc_pairs.plain_version():
        plain_ms = cuda_ms(timing_case, 1)
    bound_ms, bound_by, detail = scan_bound(
        [price, disc], [price, disc], ["<", ">"], full_scope, full_scope,
        [res.t1_count, res.t2_count], res.t1_stat + res.t2_stat,
    )
    log(f"dc_pair_scan n={n} full worklist: call {ms:.3f} ms (the kernel alone {kernel_ms:.3f} "
        f"ms of device time), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {detail})")
    return dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def scan_check_cases(dev, both: bool) -> float:
    """Every case of ``kernels.dc_scan_check`` (each instantiation, every
    dtype, NaN and signed zeros, integer extremes, blocks 1 to 1,024, an
    uneven col chunking, a one-row-block strip, a sparse worklist) through
    the kernel against the plain version, bit for bit, one launch each."""
    from repro_torch.kernels import dc_pairs
    from repro_torch.kernels import dc_scan_check as dsc

    name = "dc_pair_scan" if both else "dc_role_scan"
    err = 0.0
    for case in dsc.CASES:
        before = dc_pairs.LAUNCHES[name]
        _, got, want = dsc.check_case(case, dev, both)
        if dc_pairs.LAUNCHES[name] != before + 1:
            fail(f"{name} {case.name}: {dc_pairs.LAUNCHES[name] - before} launches, not one")
        err = max(err, same_flat(got, want, f"{name} {case.name}"))
        log(f"{name} == plain: {case.name}: bit-identical")
    return err


def event_device_us(e) -> float:
    """A profiler event's own device time in microseconds (the attribute's
    name differs between PyTorch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_top(prof, k: int):
    """The ``k`` profiled kernels with the most device time: (name, ms)."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -event_device_us(e))
    return [(e.key[:60], round(event_device_us(e) / 1e3, 3)) for e in kernels[:k]]


def named_device_us(prof, name_part: str):
    """(device microseconds, launches) of the profiled kernels whose name
    holds ``name_part``."""
    import torch

    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and name_part in e.key]
    return sum(event_device_us(e) for e in hits), sum(e.count for e in hits)


def scan_kernel_ms(fn, reps: int) -> float:
    """Device time a call of ``fn`` spends in the DC scan kernel itself
    (``torch.profiler``), without the key preparation and decode around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return named_device_us(prof, "dc_scan_kernel")[0] / 1e3 / reps


def scan_bound(l_cols, r_cols, ops, rs, cs, counts, stats, both=True, block=256):
    """Least time for the scan's work on an H100: bytes (each input read once,
    each output written once) over HBM bandwidth vs operations over the
    32-bit instruction issue rate.  Operations count what this run's data needs:
    per role (one for the role scan, two for the pair scan), one comparison
    per atom for every pair in the tiles the block bounds cannot rule out,
    plus a count and a min/max per atom for every violating pair."""
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
    roles = [(ops, l_idx, r_idx)]
    if both:
        roles.append(([flip_op(o) for o in ops], r_idx, l_idx))
    pairs = 0
    for role_ops, li, ri in roles:
        ok = torch.ones((nb, nb), dtype=torch.bool, device=rs.device)
        for op, x, y in zip(role_ops, li, ri):
            ok &= dc_pairs._tile_possible(
                op, b[0][x][:, None], b[1][x][:, None], b[2][y][None, :], b[3][y][None, :]
            )
        pairs += int(ok.sum()) * block * block
    violating = sum(int(c.sum()) for c in counts)
    n_atoms = len(ops)
    ops_count = pairs * n_atoms + violating * (n_atoms + 1)
    in_bytes = sum(c.numel() * c.element_size() for c in distinct) + 2 * n
    out_bytes = len(roles) * 4 * n + sum(s.numel() * s.element_size() for s in stats)
    return bound(ops_count, in_bytes + out_bytes)


def bound(ops_count, nbytes):
    """(ms, "operations" or "bytes", detail): the larger of ``ops_count``
    32-bit operations at the issue rate and ``nbytes`` at HBM bandwidth."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S * 1e3
    detail = f"{ops_count:.3e} ops, {nbytes} bytes"
    if t_ops >= t_bytes:
        return t_ops, "operations", detail
    return t_bytes, "bytes", detail


# ------------------------------------------------------------------ phase 4
def role_case(l_cols, r_cols, ops, rs, cs, reduces=None, block=256, **restr):
    from repro_torch.core.detect import _T1_REDUCE
    from repro_torch.kernels import ops as kops

    reduces = reduces or [_T1_REDUCE[o] for o in ops]
    return lambda: kops.dc_role_scan(l_cols, r_cols, ops, rs, cs, reduces, block=block,
                                     **restr)


def same_role(got, want, what: str) -> float:
    """Hold two role-scan outputs ``(count, stats)`` bit for bit."""
    return same_flat((got[0], *got[1]), (want[0], *want[1]), what)


def role_scan_phase(dev):
    import numpy as np
    import torch

    from repro_torch.kernels import dc_pairs

    rng = np.random.default_rng(3)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scope(n, p):
        return t(rng.random(n) < p)

    n = DC_ROWS
    price = t(rng.uniform(1000, 5000, n).astype(np.float32))
    disc = t((0.5 - (price.cpu().numpy() - 1000) / 8000 + rng.normal(0, 0.02, n)).astype(np.float32))
    full = torch.ones(n, dtype=torch.bool, device=dev)
    timing_case = role_case([price, disc], [price, disc], ["<", ">"], full, full)
    m = 20_000
    i8 = t(rng.integers(-128, 128, m).astype(np.int8))
    i16 = t(rng.integers(-3000, 3000, m).astype(np.int16))
    i32 = t(rng.integers(-500, 500, m).astype(np.int32))
    bf = t(rng.integers(-200, 200, m).astype(np.float32) / 4).to(torch.bfloat16)
    f32 = t(rng.uniform(-10, 10, m).astype(np.float32))
    nb = -(-n // 256)
    rows = np.flatnonzero(rng.random(nb) < 0.3).astype(np.int32)
    colsb = np.flatnonzero(rng.random(nb) < 0.5).astype(np.int32)
    special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 2.5], np.float32)
    z, w = t(rng.choice(special, 3000)), t(rng.choice(special, 3000))
    cases = [
        (f"fig12 f32 price<,disc> n={n} full", timing_case),
        ("int8 <", role_case([i8], [i8], ["<"], scope(m, 0.8), scope(m, 0.8))),
        ("int16 ==", role_case([i16], [i16], ["=="], scope(m, 0.8), scope(m, 0.8))),
        ("int32 three atoms <=,!=,>", role_case(
            [i32, i16, i8], [i8, i32, i32], ["<=", "!=", ">"], scope(m, 0.8), scope(m, 0.9))),
        ("bf16 >=", role_case([bf], [bf], [">="], scope(m, 0.8), scope(m, 0.8))),
        ("f32 three atoms !=,<,>=", role_case(
            [f32, bf, f32], [f32, f32, bf], ["!=", "<", ">="], scope(m, 0.8), scope(m, 0.8))),
        ("row strip (lo, hi)", role_case(
            [price, disc], [price, disc], ["<=", ">="], full, full, row_blocks=(7, 19))),
        ("col strip (lo, hi)", role_case(
            [price], [price], ["<"], scope(n, 0.7), full, col_blocks=(100, 140))),
        ("row x col worklist", role_case(
            [price, disc], [price, disc], ["<", ">"], scope(n, 0.7), scope(n, 0.7),
            row_block_ids=rows, col_block_ids=colsb)),
        ("NaN and signed zeros !=,< (min, max)", role_case(
            [z, w], [w, z], ["!=", "<"], scope(3000, 0.9), scope(3000, 0.9),
            reduces=["min", "max"], block=128)),
        ("NaN and signed zeros <= (max)", role_case(
            [z], [z], ["<="], scope(3000, 0.9), scope(3000, 0.9), reduces=["max"], block=128)),
    ]
    for r in (1, 257, 1000):
        a = t(rng.integers(0, 6, r).astype(np.int32))
        cases.append((f"ragged n={r}", role_case([a], [a], ["<"], scope(r, 0.7), scope(r, 0.7),
                                                 block=64)))
    err = 0.0
    before = dc_pairs.LAUNCHES["dc_role_scan"]
    for name, fn in cases:
        got = fn()
        with dc_pairs.plain_version():
            want = fn()
        torch.cuda.synchronize()
        err = max(err, same_role(got, want, f"role scan {name}"))
        log(f"role scan == plain: {name}: bit-identical")
    empty = role_case([price], [price], ["<"], full, full,
                      row_block_ids=np.array([], np.int32))()
    launched = dc_pairs.LAUNCHES["dc_role_scan"] - before
    if launched != len(cases):
        fail(f"{launched} role-scan launches for {len(cases)} cases + one empty worklist")
    if bool(empty[0].any()) or not bool((empty[1][0] == -float("inf")).all()):
        fail("role scan: empty worklist does not give identities")
    log("role scan == plain: empty worklist: identities, no launch")

    err = max(err, scan_check_cases(dev, both=False))

    count, stats = timing_case()
    again = timing_case()
    torch.cuda.synchronize()
    err = max(err, same_role(again, (count, stats), "role timing case, second launch"))
    log("dc_role_scan timing case: two launches bit-identical")
    ms = cuda_ms(timing_case, 5)
    kernel_ms = scan_kernel_ms(timing_case, 3)
    with dc_pairs.plain_version():
        plain_ms = cuda_ms(timing_case, 1)
    bound_ms, bound_by, detail = scan_bound(
        [price, disc], [price, disc], ["<", ">"], full, full, [count], stats, both=False)
    log(f"dc_role_scan n={n} full worklist, one role: call {ms:.3f} ms (the kernel alone "
        f"{kernel_ms:.3f} ms of device time), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {detail})")
    return dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# ------------------------------------------------------------------ phase 5
def semijoin_bound(query, query_mask, keys, keys_mask):
    """Least time of the membership test on these inputs, whatever the
    method: the bytes (query, keys, both masks read once, the output
    written once) against the operations of a hash join over this run's
    data (one insert for each live key, one probe for each live query) at
    the 32-bit issue rate.  The kernel's own brute-force compares are not
    the function's work: ``torch.isin`` does the same in far less."""
    ops_count = int(keys_mask.sum()) + int(query_mask.sum())
    nbytes = query.numel() * 4 + query_mask.numel() * 2 + keys.numel() * 4 + keys_mask.numel()
    return bound(ops_count, nbytes)


def semijoin_phase(dev):
    import numpy as np
    import torch

    from repro_torch.data.generators import ssb_lineorder
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import semijoin as sj

    rng = np.random.default_rng(4)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def masks(n, m, pq=0.8, pk=0.8):
        return t(rng.random(n) < pq), t(rng.random(m) < pk)

    cases = []
    for n, m in ((5, 7), (64, 64), (100, 257), (513, 100)):  # tests/test_kernels.py
        q, k = t(rng.integers(0, 40, n).astype(np.int32)), t(rng.integers(0, 40, m).astype(np.int32))
        qm, km = masks(n, m)
        for block in (64, 256):
            cases.append((f"n={n} m={m} block={block}", (q, qm, k, km), block))
    q, k = t(np.arange(10, dtype=np.int32)), t(np.arange(10, dtype=np.int32))
    cases.append(("all-false key mask", (q, t(np.ones(10, bool)), k, t(np.zeros(10, bool))), 512))
    q = t(rng.integers(0, 50_000, 200_000).astype(np.int32))
    k = t(rng.integers(0, 50_000, 5_000).astype(np.int32))
    qm, km = masks(200_000, 5_000, 0.9, 0.7)
    cases.append(("n=200000 m=5000 block=512", (q, qm, k, km), 512))
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    extremes = np.array([lo, hi, -1, 0], np.int32)
    q = t(np.concatenate([extremes, extremes + np.array([1, -1, -1, 1], np.int32),
                          rng.integers(lo, hi, 1000, dtype=np.int64).astype(np.int32)]))
    k = t(np.concatenate([extremes, rng.integers(-5, 5, 50).astype(np.int32)]))
    cases.append(("INT32_MIN, INT32_MAX, -1, 0 as keys",
                  (q, t(np.ones(q.shape[0], bool)), k, t(np.ones(k.shape[0], bool))), 512))
    # every key value 20 times, one copy of each masked out and its twins in,
    # and values whose every copy is out
    vals = rng.integers(0, 3_000, 1_500).astype(np.int32)
    k_np = np.repeat(vals, 20)
    km_np = np.ones(k_np.shape[0], bool)
    km_np[::20] = False
    km_np[np.isin(k_np, vals[:100])] = False
    perm = rng.permutation(k_np.shape[0])
    q = t(rng.integers(0, 3_500, 50_000).astype(np.int32))
    cases.append(("heavy duplicates", (q, t(rng.random(50_000) < 0.9), t(k_np[perm]),
                                       t(km_np[perm])), 512))
    slots = sj.table_slots(4_000)
    q = t((rng.integers(-40, 40, 20_000) * slots).astype(np.int32))
    k = t((np.arange(-20, 20) * slots).astype(np.int32).repeat(100))
    cases.append((f"keys multiples of the table size {slots}",
                  (q, t(np.ones(20_000, bool)), k, t(np.ones(4_000, bool))), 512))
    q = t(rng.integers(0, 100, 1000).astype(np.int32))
    empty_k = t(np.zeros(0, np.int32))
    cases.append(("m=0", (q, t(np.ones(1000, bool)), empty_k, t(np.zeros(0, bool))), 512))
    k = t(rng.integers(0, 100, 500).astype(np.int32))
    cases.append(("every key masked out", (q, t(np.ones(1000, bool)), k, t(np.zeros(500, bool))),
                  512))
    cases.append(("n=0", (t(np.zeros(0, np.int32)), t(np.zeros(0, bool)), k,
                          t(np.ones(500, bool))), 512))
    q = t(rng.integers(0, SF1_ORDERKEYS, 200_000).astype(np.int32))
    k = t(rng.integers(0, SF1_ORDERKEYS, SF1_ORDERKEYS).astype(np.int32))
    cases.append((f"n=200000 m={SF1_ORDERKEYS} (SF1's orderkey domain)",
                  (q, t(np.ones(200_000, bool)), k, t(np.ones(SF1_ORDERKEYS, bool))), 512))

    err = 0.0
    sj.reset_launch_counts()
    for name, args, block in cases:
        got = kops.semijoin(*args, block=block)
        with sj.plain_version():
            want = kops.semijoin(*args, block=block)
        library = torch.isin(args[0], args[2][args[3]]) & args[1]
        torch.cuda.synchronize()
        if got.dtype != torch.bool or got.shape != args[0].shape or not torch.equal(got, want):
            fail(f"semijoin {name}: kernel differs from the plain version")
        if not torch.equal(got, library):
            fail(f"semijoin {name}: kernel differs from torch.isin")
        err = max(err, max_abs_err(got.to(torch.float32), want.to(torch.float32)))
        log(f"semijoin == plain == torch.isin: {name}: bit-identical ({int(got.sum())} hits)")
    launched = sum(1 for _, args, _ in cases if args[0].shape[0] > 0)  # n = 0 launches nothing
    if sj.LAUNCHES["semijoin"] != launched:
        fail(f"{sj.LAUNCHES['semijoin']} semijoin launches for {launched} cases with queries")

    query = t(ssb_lineorder(SF1_ROWS, SF1_ORDERKEYS, SF1_SUPPKEYS, seed=0)["orderkey"])
    keys = t(rng.permutation(SEMIJOIN_KEYS).astype(np.int32))
    query_mask = torch.ones_like(query, dtype=torch.bool)
    keys_mask = torch.ones_like(keys, dtype=torch.bool)
    args = (query, query_mask, keys, keys_mask)
    got = kops.semijoin(*args, block=512)
    with sj.plain_version():
        want = kops.semijoin(*args, block=512)
    library = torch.isin(query, keys[keys_mask]) & query_mask
    if not torch.equal(got, want) or not torch.equal(got, library):
        fail("semijoin at SF1: kernel, plain version and torch.isin disagree")
    ms = cuda_ms(lambda: kops.semijoin(*args, block=512), 20)
    with sj.plain_version():
        plain_ms = cuda_ms(lambda: kops.semijoin(*args, block=512), 1)
    library_ms = cuda_ms(lambda: torch.isin(query, keys[keys_mask]) & query_mask, 20)
    bound_ms, bound_by, detail = semijoin_bound(*args)
    log(f"semijoin n={SF1_ROWS} m={SEMIJOIN_KEYS} ({int(got.sum())} hits; table "
        f"{sj.table_slots(SEMIJOIN_KEYS)} slots): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"torch.isin {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {detail})")
    if not ms <= library_ms:
        fail(f"semijoin at SF1: the kernel ({ms:.4f} ms) is slower than torch.isin "
             f"({library_ms:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# ------------------------------------------------------------------ phase 6
def attention_bound(q, k, causal, window):
    """Least time of one attention call on an H100: the larger of its bf16
    FLOPs (4 D per visible query-key pair and head: the QK^T and PV
    products, counted over the pairs this call's mask leaves) over the
    tensor cores' rate and its bytes (q, k, v read once, o written once)
    over HBM bandwidth."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qpos = range(sq)
    pairs = 0
    for i in qpos:
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    flops = 4 * d * pairs * b * hq
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    detail = f"{flops:.4e} flops, {nbytes} bytes"
    if t_ops >= t_bytes:
        return t_ops, "operations", detail, flops
    return t_bytes, "bytes", detail, flops


def flash_phase(dev):
    """Both flash kernels against the plain version, then their times at
    the prefill shape in alternating turns.  Returns the measured record of
    each kernel, by its ``LAUNCHES`` name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(dtype, b, hq, hkv, sq, sk, d):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]

    def bshd_views(dtype, b, hq, hkv, s, d):
        """q, k, v as ``attend_full`` passes them: (b, h, s, d) views of
        (b, s, h, d) tensors, read through their strides."""
        return [torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
                for h in (hq, hkv, hkv)]

    def uniform(dtype, d):
        ones = torch.ones((1, 1, 128, d), device=dev, dtype=dtype)
        return [ones, ones, torch.full_like(ones, 3.0)]

    bf16, f32 = torch.bfloat16, torch.float32
    B, S = LM_BATCH, LM_PROMPT
    prefill_case = qkv(bf16, B, 32, 8, S, S, 128)
    # (name, (q, k, v), causal, window, the kernel the wrapper must choose)
    cases = [
        ("qwen3-4b prefill B2 Hq32 Hkv8 D128 S2048 bf16 causal", prefill_case, True, None, "wgmma"),
        ("(b,s,h,d) views B2 Hq32 Hkv8 D128 S2048 bf16 causal",
         bshd_views(bf16, B, 32, 8, S, 128), True, None, "wgmma"),
        ("group 1 (Hq8 Hkv8) bf16 S512", qkv(bf16, 2, 8, 8, 512, 512, 128), True, None, "wgmma"),
        ("group 4 (Hq32 Hkv8) bf16 S512", qkv(bf16, 2, 32, 8, 512, 512, 128), True, None, "wgmma"),
        ("group 8 (Hq8 Hkv1) bf16 S512", qkv(bf16, 2, 8, 1, 512, 512, 128), True, None, "wgmma"),
        ("D64 bf16 ragged S300 causal", qkv(bf16, 2, 8, 2, 300, 300, 64), True, None, "wgmma"),
        ("non-causal Sq77 Sk1000 bf16", qkv(bf16, 2, 32, 8, 77, 1000, 128), False, None, "wgmma"),
        ("window 64 ragged S500 bf16", qkv(bf16, 2, 8, 2, 500, 500, 128), True, 64, "wgmma"),
        ("window 1024 at S4096 bf16", qkv(bf16, 1, 8, 2, 4096, 4096, 128), True, 1024, "wgmma"),
        ("(b,s,h,d) views D64 S300 bf16", bshd_views(bf16, 2, 8, 2, 300, 64), True, None, "wgmma"),
        ("uniform V bf16 D128", uniform(bf16, 128), True, None, "wgmma"),
        ("f32 I/O Hq32 Hkv8 D128 S1024 causal", qkv(f32, 1, 32, 8, 1024, 1024, 128), True, None,
         "cuda_core"),
        ("non-causal Sq1 Sk1000 f32", qkv(f32, 2, 32, 8, 1, 1000, 128), False, None, "cuda_core"),
        ("non-causal Sq77 Sk1000 f32", qkv(f32, 2, 32, 8, 77, 1000, 128), False, None, "cuda_core"),
        ("D64 f32 S512 causal", qkv(f32, 2, 4, 4, 512, 512, 64), True, None, "cuda_core"),
        ("D256 bf16 S130", qkv(bf16, 2, 8, 2, 130, 130, 256), True, None, "cuda_core"),
        ("uniform V f32 D32", uniform(f32, 32), True, None, "cuda_core"),
    ]

    err = {v: 0.0 for v in fa.KERNEL_NAME}
    fa.reset_launch_counts()
    for name, (q, k, v), causal, window, variant in cases:
        if fa.kernel_variant(q.dtype, q.shape[-1]) != variant:
            fail(f"flash {name}: kernel_variant chose "
                 f"{fa.kernel_variant(q.dtype, q.shape[-1])}, not {variant}")
        before = dict(fa.LAUNCHES)
        got = kops.flash_attention(q, k, v, causal=causal, window=window)
        launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        with fa.plain_version():
            want = kops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if launched != {n: int(n == fa.KERNEL_NAME[variant]) for n in fa.LAUNCHES}:
            fail(f"flash {name}: launches {launched}, not one of the {variant} kernel")
        if got.dtype != q.dtype or got.shape != q.shape:
            fail(f"flash {name}: {got.dtype}{tuple(got.shape)}")
        if not bool(torch.isfinite(got).all()):
            fail(f"flash {name}: non-finite output")
        tol = F32_TOL if q.dtype == f32 else BF16_TOL
        if name == "uniform V f32 D32":
            tol = dict(atol=0.0, rtol=1e-6)  # the reference test's own
            want = torch.full_like(got, 3.0)
        e = max_abs_err(got.float(), want.float())
        try:
            torch.testing.assert_close(got.float(), want.float(), **tol)
        except AssertionError as exc:
            fail(f"flash {name}: kernel differs from the plain version: {exc}")
        err[variant] = max(err[variant], e)
        log(f"flash == plain: {name} ({variant} kernel): max abs err {e:.3e} (tolerance {tol})")

    q, k, v = prefill_case
    # the prefill shape through the CUDA-core kernel too, as the timing below runs it
    got = fa.flash_attention_cuda_core(q, k, v, causal=True)
    with fa.plain_version():
        want = kops.flash_attention(q, k, v, causal=True)
    try:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    except AssertionError as exc:
        fail(f"flash prefill case through the CUDA-core kernel: {exc}")
    e = max_abs_err(got.float(), want.float())
    err["cuda_core"] = max(err["cuda_core"], e)
    log(f"flash == plain: prefill case through the CUDA-core kernel: max abs err {e:.3e}")
    if fa.LAUNCHES["flash_attention"] != 1 + sum(c[-1] == "cuda_core" for c in cases):
        fail(f"{fa.LAUNCHES} flash launches for {len(cases) + 1} cases")

    kernels = {"wgmma": fa.flash_attention_wgmma, "cuda_core": fa.flash_attention_cuda_core}
    turns = []  # (variant, ms): new, old, old, new
    for variant in ("wgmma", "cuda_core", "cuda_core", "wgmma"):
        turns.append((variant, cuda_ms(lambda: kernels[variant](q, k, v, causal=True), 10)))
    with fa.plain_version():
        plain_ms = cuda_ms(lambda: kops.flash_attention(q, k, v, causal=True), 3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 10)
    bound_ms, bound_by, detail, flops = attention_bound(q, k, True, None)
    ms = {v: sum(t for w, t in turns if w == v) / 2 for v in kernels}
    log(f"flash_attention B{B} Hq32 Hkv8 D128 S{S} bf16 causal, turns (wgmma, cuda_core, "
        f"cuda_core, wgmma) {[round(t, 4) for _, t in turns]} ms: wgmma kernel "
        f"{ms['wgmma']:.4f} ms ({flops / ms['wgmma'] / 1e9:.1f} TFLOP/s), CUDA-core kernel "
        f"{ms['cuda_core']:.3f} ms, plain {plain_ms:.3f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {detail}); wgmma / sdpa "
        f"{ms['wgmma'] / library_ms:.2f}, wgmma / bound {ms['wgmma'] / bound_ms:.2f}")
    return {
        fa.KERNEL_NAME[v]: dict(max_abs_err=err[v], ms=ms[v],
                                turns_ms=[t for w, t in turns if w == v], plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        for v in kernels
    }


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


# ------------------------------------------------------------------ phase 7
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
    times, modes, masks = [], [], []
    sf1_queries = queries(SF1_ORDERKEYS)[:N_QUERIES]
    for i, q in enumerate(sf1_queries):
        t0 = time.perf_counter()
        res = daisy.execute(q)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        masks.append(res.mask)
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
    return sf1_queries, masks, sum(times)


# ------------------------------------------------------------------ phase 8
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


def dc_daisy(dev):
    """A fresh ``Daisy`` over the DC workload, and its 20 price-range queries."""
    import numpy as np

    from repro_torch.core.executor import Daisy, DaisyConfig

    rel, dc = dc_workload(dev)
    daisy = Daisy({"t": rel}, {"t": [dc]},
                  DaisyConfig(dc_partitions=16, accuracy_threshold=0.3,
                              expected_queries=N_QUERIES, use_cost_model=False),
                  device=dev)
    queries = range_queries("extended_price", np.linspace(1000, 5000, N_QUERIES + 1), True)
    return daisy, dc, queries


def dc_run(dev):
    import torch

    daisy, dc, queries = dc_daisy(dev)
    states, times = [], []
    for q in queries:
        t0 = time.perf_counter()
        res = daisy.execute(q)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        states.append(daisy_state(daisy, res, [dc]))
    return states, times


def dc_phase(dev):
    """The DC path's launch counts (the kernel run's) and its time."""
    from repro_torch.kernels import dc_pairs

    reset_counts()
    states, times = dc_run(dev)
    counts = read_counts()
    launches = counts["dc_pair_scan"]
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
    path_ms, path_launches, wall_ms, busy_ms, top = dc_query0_profile(dev)
    log(f"DC path query 0 of a fresh Daisy under torch.profiler: dc_scan_kernel "
        f"{path_ms:.3f} ms of device time in {path_launches} launch(es), on fig12's data "
        f"(2% violations); the query {wall_ms:.3f} ms, kernels busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}); top {top}")
    return counts, sum(times), path_ms


def dc_query0_profile(dev):
    """The scan kernel's device time on the DC path itself: a fresh
    ``Daisy``'s first query (the one that cleans), under ``torch.profiler``,
    read by the kernel's name; with the query's wall time, its kernels'
    busy time and the five largest kernels.  No warm-up call: a second run
    of the query would find the scope clean and skip."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    daisy, _, queries = dc_daisy(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        daisy.execute(queries[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us, launches = named_device_us(prof, "dc_scan_kernel")
    if launches < 1:
        fail("the profiled DC query 0 shows no dc_scan_kernel launch")
    busy_us, top = named_device_us(prof, ""), device_top(prof, 5)
    return us / 1e3, launches, wall_ms, busy_us[0] / 1e3, top


# ------------------------------------------------------------------ phase 9
def join_workload(n_rows, device):
    """fig13's tables at ``n_rows`` lineorder rows (orderkeys a quarter of
    the rows, as SF1's 1,500,000 of 6,000,000) and SF1's 2,000 suppliers:
    FD orderkey -> suppkey on lineorder and FD address -> suppkey on
    suppliers, 10% of rows edited in each, overlays of k = 8."""
    from repro_torch.core.constraints import FD
    from repro_torch.core.relation import make_relation
    from repro_torch.data.generators import inject_fd_errors, ssb_lineorder, suppliers

    lo = ssb_lineorder(n_rows, n_rows // 4, SF1_SUPPKEYS, seed=0)
    ds_lo = inject_fd_errors(lo, "orderkey", "suppkey", 1.0, 0.1, SF1_SUPPKEYS, seed=1)
    sup = suppliers(SF1_SUPPKEYS, seed=2)
    ds_sup = inject_fd_errors(sup, "address", "suppkey", 1.0, 0.1, SF1_SUPPKEYS, seed=3)
    db = {
        "lineorder": make_relation(ds_lo.data, overlay=["orderkey", "suppkey"], k=8,
                                   rules=["phi"], device=device),
        "suppliers": make_relation(ds_sup.data, overlay=["address", "suppkey"], k=8,
                                   rules=["psi"], device=device),
    }
    rules = {"lineorder": [FD("phi", "orderkey", "suppkey")],
             "suppliers": [FD("psi", "address", "suppkey")]}
    return db, rules


def join_queries():
    """20 range joins over suppkey, 100 suppkeys each, then fig13's join
    group-by by supplier region over every lineorder row."""
    import numpy as np

    from repro_torch.core.operators import GroupBySpec, JoinClause, Pred, Query

    join = (JoinClause("suppliers", "suppkey", "suppkey"),)
    edges = np.linspace(0, SF1_SUPPKEYS, N_QUERIES + 1).astype(int)
    qs = [Query("lineorder", preds=(Pred("suppkey", ">=", int(a)), Pred("suppkey", "<", int(b))),
                joins=join) for a, b in zip(edges[:-1], edges[1:])]
    qs.append(Query("lineorder", preds=(Pred("suppkey", ">=", 0),), joins=join,
                    groupby=GroupBySpec(keys=("region",), agg="count", table="suppliers")))
    return qs


def join_state(daisy, res):
    """Host copy of a join answer, its report and both tables' overlays."""
    state = {f"rows.{t}": r.cpu().numpy() for t, r in res.join.rows.items()}
    state["valid"] = res.join.valid.cpu().numpy()
    state["overflow"] = res.join.overflow.cpu().numpy()
    state["report"] = res.report.asdict()
    for table in daisy.db:
        rel = daisy.db[table]
        for field in ("cand", "ccount", "ckind", "checked"):
            for k, v in getattr(rel, field).items():
                state[f"{table}.{field}.{k}"] = v.cpu().numpy()
    if res.groups is not None:
        for k, v in res.groups.items():
            state[f"groups.{k}"] = v.cpu().numpy()
    return state


def join_phase(dev):
    import torch

    from repro_torch.core.executor import Daisy, DaisyConfig

    cfg = DaisyConfig(join_capacity=JOIN_CAPACITY, join_row_block=2048, use_cost_model=False)
    runs = {}
    for device in ("cpu", dev):
        db, rules = join_workload(FD_SMALL_ROWS, device)
        daisy = Daisy(db, rules, cfg, device=device)
        runs[device] = [join_state(daisy, daisy.execute(q)) for q in join_queries()]
    for i, (a, b) in enumerate(zip(runs["cpu"], runs[dev])):
        same_state(a, b, f"join {FD_SMALL_ROWS} rows query {i} cuda vs cpu",
                   float_groups_rtol=1e-6)
    log(f"join path {FD_SMALL_ROWS} rows: cuda == cpu on {len(runs['cpu'])} queries "
        f"(answers {[st['report']['result_size'] for st in runs[dev]]})")
    del runs

    t0 = time.perf_counter()
    db, rules = join_workload(SF1_ROWS, dev)
    daisy = Daisy(db, rules, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"join SF1: lineorder {SF1_ROWS} rows, suppliers {SF1_SUPPKEYS} rows; data and "
        f"Daisy init {time.perf_counter() - t0:.3f} s; join_capacity {cfg.join_capacity}, "
        f"join_row_block {cfg.join_row_block}")
    times, sizes = [], []
    for i, q in enumerate(join_queries()):
        t0 = time.perf_counter()
        res = daisy.execute(q)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        rep = res.report
        sizes.append(rep.result_size)
        if rep.join_overflow or bool(res.join.overflow):
            fail(f"join SF1 query {i} overflowed the capacity {cfg.join_capacity}")
        if rep.recheck_violations != 0:
            fail(f"join SF1 query {i}: {rep.recheck_violations} re-check violations "
                 "(Lemma 5 predicts 0)")
        if rep.result_size <= 0 or res.join.rows["lineorder"].shape[0] != cfg.join_capacity:
            fail(f"join SF1 query {i}: empty or misshapen answer")
        what = "group-by region" if q.groupby is not None else "range join"
        log(f"join SF1 query {i} ({what}): {dt * 1e3:.3f} ms, result {rep.result_size}, "
            f"recheck_violations {rep.recheck_violations}, join_overflow {rep.join_overflow}, "
            f"steps {[(s.table, s.mode, s.answer_size, s.extra, s.repaired) for s in rep.steps]}")
    groups = res.groups
    if int(groups["num_groups"]) != 5 or not bool(torch.isfinite(groups["count"]).all()):
        fail(f"join SF1 group-by: {int(groups['num_groups'])} regions")
    log(f"join SF1: first-touch query {times[0] * 1e3:.3f} ms, later range joins "
        f"{[round(t * 1e3, 3) for t in times[1:N_QUERIES]]} ms, group-by "
        f"{times[-1] * 1e3:.3f} ms; largest answer {max(sizes)} of capacity "
        f"{cfg.join_capacity}; region counts {groups['count'][:5].tolist()}")
    del daisy, db, res
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 10
def offline_phase(dev, fd_queries, fd_masks, fd_daisy_s, dc_daisy_s):
    import torch

    from repro_torch.core.offline import OfflineCleaner
    from repro_torch.kernels import dc_pairs

    rel, fd = fd_workload(SF1_ROWS, SF1_ORDERKEYS, SF1_SUPPKEYS, dev)
    off = OfflineCleaner({"t": rel}, {"t": [fd]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off.clean_all()
    torch.cuda.synchronize()
    t_clean = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (q, want) in enumerate(zip(fd_queries, fd_masks)):
        got = off.execute(q).mask
        if not torch.equal(got, want):
            fail(f"offline FD SF1 query {i}: answer differs from Daisy's in "
                 f"{int((got ^ want).sum())} rows (the FD guarantee)")
    torch.cuda.synchronize()
    t_queries = time.perf_counter() - t0
    log(f"offline FD SF1: clean_all {t_clean:.3f} s, then {len(fd_queries)} queries "
        f"{t_queries:.3f} s; answers == Daisy's on every query (Daisy's 20 queries took "
        f"{fd_daisy_s:.3f} s)")
    del off, rel

    rel, dc = dc_workload(dev)
    off = OfflineCleaner({"t": rel}, {"t": [dc]})
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off.clean_all()
    torch.cuda.synchronize()
    t_dc = time.perf_counter() - t0
    launches = dc_pairs.LAUNCHES["dc_pair_scan"] - before
    if launches != 1 or not bool(off.db["t"].checked["dc_pd"][: DC_ROWS].all()):
        fail(f"offline DC clean_all: {launches} pair-scan launches, not one over the full worklist")
    rel_plain, _ = dc_workload(dev)
    off_plain = OfflineCleaner({"t": rel_plain}, {"t": [dc]})
    with dc_pairs.plain_version():
        off_plain.clean_all()
    same_relation(off.db["t"], off_plain.db["t"], "offline DC clean_all, kernel vs plain")
    log(f"offline DC {DC_ROWS} rows: clean_all {t_dc:.3f} s with {launches} dc_pair_scan "
        f"launch (Daisy's 20 queries: {dc_daisy_s:.3f} s); the relation == the plain "
        f"version's clean_all, bit for bit")


def same_relation(a, b, what: str) -> None:
    """Hold two relations' columns, overlays, checked bits and valid rows
    bit for bit."""
    import numpy as np

    from repro_torch.testing import relation_to_numpy

    x, y = relation_to_numpy(a), relation_to_numpy(b)
    for field in ("columns", "cand", "ccount", "ckind", "orig", "checked"):
        if x[field].keys() != y[field].keys():
            fail(f"{what}: {field} keys differ")
        for k in x[field]:
            u, v = x[field][k], y[field][k]
            if u.dtype != v.dtype or u.shape != v.shape or not np.array_equal(
                    u.view(np.uint8), v.view(np.uint8)):
                fail(f"{what}: {field}[{k}] differs")
    if not np.array_equal(x["valid"], y["valid"]):
        fail(f"{what}: valid differs")


# ------------------------------------------------------------------ phase 11
def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def serial_schedule(dev):
    """The query service on a fixed schedule driven from this thread: a
    burst of queries, two ``cleaner.drain(max_increments=2)``, two appends
    (the first off a block boundary and growing the table), another burst
    and a full drain, over the launcher's hospital table (FD ``zc``, DC
    ``bq``).  Returns everything a client and the engine show, as host
    values."""
    import numpy as np

    from repro_torch.core.executor import Daisy, DaisyConfig
    from repro_torch.core.relation import make_relation
    from repro_torch.launch.serve import ServeOptions, query_pool, workload_table
    from repro_torch.service import BackgroundCleaner, QoSPolicy, QueryServer
    from repro_torch.testing import engine_state

    per_burst = SERIAL_QUERIES
    opts = ServeOptions(rows=SERIAL_ROWS, ingest_chunks=2, ingest_rows=SERIAL_CHUNK, device=dev)
    seed_rows, chunks, rules = workload_table(opts)
    rel = make_relation(seed_rows, overlay=["zip", "city", "beds", "quality"], k=8,
                        rules=["zc", "bq"], device=dev)
    daisy = Daisy({"h": rel}, {"h": rules}, DaisyConfig(use_cost_model=False), device=dev)
    server = QueryServer(daisy, max_batch=8, qos=QoSPolicy())
    cleaner = BackgroundCleaner(daisy, server=server, increment_rows=opts.fd_increment_rows,
                                increment_strips=1)
    pool = query_pool(opts)
    # a few hot zips first (so the DC scope stays cold for the increments),
    # then the DC view and the group-by too, in a seeded order
    picks = [pool[i] for i in (0, 1, 2, 3, len(pool) - 1, len(pool) - 2)]
    rng = np.random.default_rng(0)
    order = np.concatenate([rng.integers(0, 4, per_burst),
                            rng.integers(0, len(picks), per_burst)])
    sessions = [server.open_session(f"user{i}", max_inflight=4 * per_burst) for i in range(4)]
    out = {"tickets": [], "increments": []}

    def burst(idx):
        ts = [server.submit(sessions[i % 4], picks[q]) for i, q in enumerate(idx)]
        server.drain()
        for t in ts:
            rep = t.result.report
            out["tickets"].append((t.cached, t.shed, t.staleness, t.result.mask.cpu().numpy(),
                                   [s.asdict() for s in rep.steps], rep.result_size))

    burst(order[:per_burst])
    for _ in range(2):
        out["increments"].append(cleaner.drain(max_increments=2))
    ingests = []
    for rows_c in chunks:
        t = server.ingest("h", rows_c)
        server.drain()
        ingests.append(t.result.asdict())
    out["ingests"] = ingests
    burst(order[per_burst:])
    out["increments"].append(cleaner.drain())
    sync(dev)
    snap = server.snapshot()
    out["snapshot"] = {k: v for k, v in snap.items()
                       if k not in ("elapsed_s", "queries_per_sec", "idle_fraction", "latency")}
    out["snapshot"]["background"].pop("busy_s")
    out["state"] = engine_state(daisy)
    out["cold"] = (daisy.cold_count("h", "zc"), daisy.cold_count("h", "bq"))
    return out


def same_schedule(a, b, what: str) -> None:
    import numpy as np

    from repro_torch.testing import state_differences

    if len(a["tickets"]) != len(b["tickets"]):
        fail(f"{what}: {len(a['tickets'])} tickets against {len(b['tickets'])}")
    for i, (x, y) in enumerate(zip(a["tickets"], b["tickets"])):
        if x[:3] != y[:3] or x[4:] != y[4:] or not np.array_equal(x[3], y[3]):
            fail(f"{what}: ticket {i} differs")
    for key in ("increments", "ingests", "snapshot", "cold"):
        if a[key] != b[key]:
            fail(f"{what}: {key} differs: {a[key]} != {b[key]}")
    bad = state_differences(a["state"], b["state"])
    if bad:
        fail(f"{what}: engine state differs at {bad[:8]}")


def serial_phase(dev):
    """Phase 11: the serial schedule on the card, on the card under the
    pair scan's plain version, and on the CPU: everything equal."""
    from repro_torch.kernels import dc_pairs

    t0 = time.perf_counter()
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    card = serial_schedule(dev)
    launches = dc_pairs.LAUNCHES["dc_pair_scan"] - before
    t_card = time.perf_counter() - t0
    with dc_pairs.plain_version():
        plain = serial_schedule(dev)
    if dc_pairs.LAUNCHES["dc_pair_scan"] - before != launches:
        fail("the plain-version run of the serial schedule launched the kernel")
    cpu = serial_schedule("cpu")
    same_schedule(card, plain, "serial schedule, kernel vs plain version")
    same_schedule(card, cpu, "serial schedule, cuda vs cpu")
    if launches <= 0 or card["cold"] != (0, 0):
        fail(f"serial schedule: {launches} launches, cold rows {card['cold']} after the drain")
    ing = card["ingests"]
    if [r["start"] for r in ing] != [SERIAL_ROWS, SERIAL_ROWS + SERIAL_CHUNK] or \
            [r["capacity"] for r in ing] != [16_384, 16_384] or not ing[0]["grown"]:
        fail(f"serial schedule: unexpected appends {ing}")
    modes = sorted({s["mode"] for t in card["tickets"] for s in t[4]})
    snap = card["snapshot"]
    log(f"service serial schedule {SERIAL_ROWS} + 2 x {SERIAL_CHUNK} rows: cuda == cuda plain "
        f"== cpu on {len(card['tickets'])} tickets, {len(ing)} appends (capacity "
        f"{ing[0]['capacity_before']} -> {ing[0]['capacity']}), increments {card['increments']}; "
        f"masks, overlays, checked bits, step reports, ledger and snapshot counters equal; "
        f"{launches} dc_pair_scan launches; step modes {modes}; executions "
        f"{snap['executions']}, cache hits {snap['cache_hits']}; the cuda run {t_card:.3f} s")


# ------------------------------------------------------------------ phase 12
INGEST_OVERLAY = ["zip", "city", "price", "disc"]


def ingest_data(total, groups, seed=23):
    """The serving-ingest regime's rows (``benchmarks/serve_ingest.py``):
    cluster-disjoint zip -> city, and a noisy-monotone price/disc pair."""
    import numpy as np

    rng = np.random.default_rng(seed)
    zipc = rng.integers(0, groups, total).astype(np.int32)
    city = (zipc * 8 + rng.integers(0, 4, total)).astype(np.int32)
    price = rng.integers(0, 100, total).astype(np.int32)
    disc = (100 - price + rng.integers(-5, 5, total)).astype(np.int32)
    return {"zip": zipc, "city": city, "price": price, "disc": disc}


def ingest_daisy(data, dev):
    from repro_torch.core.constraints import DC, FD, Atom
    from repro_torch.core.executor import Daisy, DaisyConfig
    from repro_torch.core.relation import make_relation

    rules = [FD("zc", "zip", "city"),
             DC("pd", [Atom("price", "<", "price"), Atom("disc", ">", "disc")])]
    rel = make_relation(data, overlay=INGEST_OVERLAY, k=8, rules=["zc", "pd"], device=dev)
    cfg = DaisyConfig(use_cost_model=False, accuracy_threshold=2.0, dc_block=256,
                      strip_rows=INGEST_CHUNK)
    return Daisy({"h": rel}, {"h": rules}, cfg, device=dev)


def ingest_probes():
    from repro_torch.core.operators import GroupBySpec, Pred, Query

    return [Query("h", groupby=GroupBySpec(keys=("city",), agg="count")),
            Query("h", preds=(Pred("price", ">=", 0),))]


def canonical_overlay(daisy, n_rows):
    """Per attribute, each row's live candidates (value, kind, count) sorted
    within the row, over the valid prefix: a capacity- and slot-order-free
    signature of the overlay, as tensors on the device."""
    import torch

    rel = daisy.db["h"]
    out = {}
    for attr in INGEST_OVERLAY:
        v = rel.cand[attr][:n_rows].to(torch.float64)
        k = rel.ckind[attr][:n_rows].to(torch.float64)
        c = rel.ccount[attr][:n_rows].to(torch.float64)
        live = c > 1e-9
        cols = [torch.where(live, x, float("inf")) for x in (v, k, c)]
        for j in (2, 1, 0):  # stable sorts, least significant key first
            idx = torch.sort(cols[j], dim=1, stable=True).indices
            cols = [torch.gather(x, 1, idx) for x in cols]
        out[attr] = tuple(cols)
    return out


def probe_answers(results, n_rows):
    """The probes' answers as host arrays: the group-by's live groups (keys
    and expected counts) and the DC probe's mask over the valid prefix."""
    groups = results[0].groups
    live = groups["count"] > 0
    return (groups["key_city"][live].cpu().numpy(), groups["count"][live].cpu().numpy(),
            results[1].mask[:n_rows].cpu().numpy())


def same_probes(got, want, what):
    import numpy as np

    if not np.array_equal(got[0], want[0]) or not np.array_equal(got[2], want[2]):
        fail(f"{what}: answers differ from the rebuild's")
    # the card sums the expected counts with atomics, in no fixed order
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, err_msg=what)


def dc_pairs_of(results):
    return sum(s.detect_pairs for r in results for s in r.report.steps if s.rule == "pd")


def ingest_phase(dev):
    """Phase 12: streaming ingest against stop-the-world rebuilds at scale,
    with the serving-ingest benchmark's gates, then the pair scan's own
    time on an ingest delta and on a one-strip increment."""
    import torch

    from repro_torch.service import QueryServer

    n0, chunk = INGEST_ROWS, INGEST_CHUNK
    total = n0 + (INGEST_APPENDS + 1) * chunk
    data = ingest_data(total, groups=max(n0 // 16, 4))

    def rows(lo, hi):
        return {k: v[lo:hi] for k, v in data.items()}

    t0 = time.perf_counter()
    daisy = ingest_daisy(rows(0, n0), dev)
    server = QueryServer(daisy, max_batch=8)
    session = server.open_session("probe")

    def probe_round():
        ts = [server.submit(session, q) for q in ingest_probes()]
        server.drain()
        return [t.result for t in ts]

    warm = probe_round()
    if daisy.cold_count("h", "pd") or daisy.cold_count("h", "zc"):
        fail("ingest phase: the seed instance is not warm after the probes")
    sync(dev)
    log(f"ingest phase: {n0} seed rows warm in {time.perf_counter() - t0:.3f} s "
        f"(DC pairs {dc_pairs_of(warm)})")
    n_prev = n0
    for c in range(INGEST_APPENDS):
        lo, hi = n0 + c * chunk, n0 + (c + 1) * chunk
        scope = daisy.ledger.scope("h", "pd")
        checked_before = set(range(scope.n_strips)) - {int(s) for s in scope.cold_strips()}
        t0 = time.perf_counter()
        ticket = server.ingest("h", rows(lo, hi))
        results = probe_round()
        sync(dev)
        t_round = time.perf_counter() - t0
        rep = ticket.result
        if rep.rows != chunk or rep.start != lo:
            fail(f"ingest round {c}: appended {rep.rows} rows at {rep.start}")
        t0 = time.perf_counter()
        rebuilt = ingest_daisy(rows(0, hi), dev)
        reb = [rebuilt.execute(q) for q in ingest_probes()]
        sync(dev)
        t_rebuild = time.perf_counter() - t0
        # (a) answers and the whole overlay equal the rebuild's
        same_probes(probe_answers(results, hi), probe_answers(reb, hi), f"ingest round {c}")
        got, want = canonical_overlay(daisy, hi), canonical_overlay(rebuilt, hi)
        for attr in INGEST_OVERLAY:
            if not all(torch.equal(x, y) for x, y in zip(got[attr], want[attr])):
                fail(f"ingest round {c}: the overlay of {attr!r} differs from the rebuild's")
        for r in ("zc", "pd"):
            if not torch.equal(daisy.db["h"].checked[r][:hi], rebuilt.db["h"].checked[r][:hi]):
                fail(f"ingest round {c}: checked bits of {r} differ from the rebuild's")
        # (b) the round's DC pairs are exactly checked x new + new x total
        pairs, reb_pairs = dc_pairs_of(results), dc_pairs_of(reb)
        if pairs != n_prev * chunk + chunk * hi or pairs >= reb_pairs:
            fail(f"ingest round {c}: DC pairs {pairs}, expected {n_prev} x {chunk} + "
                 f"{chunk} x {hi}, rebuild {reb_pairs}")
        # (c) every strip checked before the append is still checked
        scope = daisy.ledger.scope("h", "pd")
        cold_now = {int(s) for s in scope.cold_strips()}
        if checked_before & cold_now or cold_now or scope.fresh:
            fail(f"ingest round {c}: strips {sorted(cold_now)} cold, fresh {scope.fresh}")
        modes = [s.mode for r in results for s in r.report.steps]
        log(f"ingest round {c}: {hi} rows (capacity {rep.capacity_before} -> {rep.capacity}); "
            f"streamed == rebuilt (answers, overlay, checked bits); DC pairs {pairs} = "
            f"{n_prev} x {chunk} + {chunk} x {hi} against the rebuild's {reb_pairs}; "
            f"append + probes {t_round:.3f} s, rebuild {t_rebuild:.3f} s; modes {modes}")
        n_prev = hi
        del rebuilt, reb
    # the scan's own time: one more append, then one increment that drains
    # its delta (checked x fresh) and cleans one strip (fresh x all)
    lo, hi = n_prev, n_prev + chunk
    server.ingest("h", rows(lo, hi))
    server.drain()
    kernel_ms, wall_ms = increment_profile(daisy)
    if len(kernel_ms) != 2:
        fail(f"ingest timing: {len(kernel_ms)} dc_scan_kernel launches in the increment, not 2")
    delta_pr, strip_pr = 2 * lo * chunk, 2 * chunk * hi
    log(f"ingest timing ({hi} rows): clean_scope_increment(max_strips=1) {wall_ms:.3f} ms; "
        f"dc_scan_kernel {kernel_ms[0]:.3f} ms on the ingest delta ({lo} checked x {chunk} "
        f"fresh, {delta_pr:.3e} pair-roles, {delta_pr / kernel_ms[0] / 1e9:.3f}e12 a second) "
        f"and {kernel_ms[1]:.3f} ms on one strip ({chunk} x {hi}, {strip_pr:.3e} pair-roles, "
        f"{strip_pr / kernel_ms[1] / 1e9:.3f}e12 a second)")
    return dict(delta_ms=kernel_ms[0], strip_ms=kernel_ms[1])


def increment_profile(daisy):
    """``clean_scope_increment("h", "pd", max_strips=1)`` under
    ``torch.profiler``: each dc_scan_kernel launch's device time, in launch
    order, and the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = daisy.clean_scope_increment("h", "pd", max_strips=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if rep is None or rep.mode not in ("strip", "full"):
        fail(f"ingest timing: the increment reported {rep}")
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "dc_scan_kernel" in e.name),
                     key=lambda e: e.time_range.start)
    return [event_device_us(e) / 1e3 for e in kernels], wall_ms


# ------------------------------------------------------------------ phase 13
def service_phase(dev):
    """Phase 13: the port's query-service launcher (``run_queries``) on the
    card at full size, with the background cleaner, streamed ingest and
    QoS, under ``torch.profiler`` for the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import ServeOptions, run_queries

    opts = ServeOptions(sessions=8, requests=SERVICE_REQUESTS, rows=SERVICE_ROWS, max_batch=8,
                        background=True, increment_strips=16, ingest_chunks=4,
                        ingest_rows=SERVICE_CHUNK, qos=True, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run = run_queries(opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    snap = run.snapshot
    daisy = run.daisy
    errors = [t.error for t in run.tickets if t.error is not None]
    if errors or snap["errors"] or not all(t.event.is_set() for t in run.tickets):
        fail(f"service: {snap['errors']} errors, {errors[:2]}")
    if snap["answered"] != SERVICE_REQUESTS or snap["ingested_rows"] != 4 * SERVICE_CHUNK:
        fail(f"service: answered {snap['answered']}, ingested {snap['ingested_rows']}")
    n_rows = int(daisy.db["h"].num_rows())
    if n_rows != SERVICE_ROWS + 4 * SERVICE_CHUNK or daisy.db["h"].capacity != 262_144:
        fail(f"service: {n_rows} rows in a table of capacity {daisy.db['h'].capacity}")
    t0 = time.perf_counter()
    drained = run.cleaner.drain()
    sync(dev)
    t_drain = time.perf_counter() - t0
    cold = (daisy.cold_count("h", "zc"), daisy.cold_count("h", "bq"))
    if cold != (0, 0):
        fail(f"service: cold rows {cold} after the final drain")
    busy_us, launches = named_device_us(prof, "")
    scan_us, scan_launches = named_device_us(prof, "dc_scan_kernel")
    log(f"service: {snap['answered']} tickets answered ({snap['queries']} served, "
        f"{snap['qos']['shed']} shed), 0 errors, {snap['ingested_rows']} rows ingested, "
        f"{n_rows} rows in capacity {daisy.db['h'].capacity}; the run {wall:.3f} s under "
        f"torch.profiler ({snap['queries'] / wall:.1f} q/s); kernels busy {busy_us / 1e3:.3f} ms "
        f"in {launches} launches (idle share {1 - busy_us / 1e6 / wall:.3f}), dc_scan_kernel "
        f"{scan_us / 1e3:.3f} ms in {scan_launches}; final drain {drained} increments "
        f"{t_drain:.3f} s, then 0 cold rows for zc and bq")


# ------------------------------------------------------------------ phase 14
@contextlib.contextmanager
def captured_attention():
    """Within this context every ``kops.flash_attention`` call records its
    (q, k, v, keyword arguments) before it runs: the live inputs of each
    layer's attention, for holding the kernel against the plain version on
    exactly those tensors.  It wraps the dispatch ``attend_full`` calls; the
    model is not changed."""
    from repro_torch.kernels import ops as kops

    seen = []
    inner = kops.flash_attention

    def record(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return inner(q, k, v, **kw)

    kops.flash_attention = record
    try:
        yield seen
    finally:
        kops.flash_attention = inner


def device_profile(fn, reps: int):
    """Kernel time on the card per call of ``fn`` (``torch.profiler``'s CUDA
    activity, summed over kernels) and the five largest kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and event_device_us(e) > 0]
    busy_ms = sum(event_device_us(e) for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -event_device_us(e))[:5]
    return busy_ms, [(e.key[:70], round(event_device_us(e) / 1e3 / reps, 3)) for e in top]


def lm_phase(dev):
    """qwen3-4b at its published width, weights from seed 0 on the card.
    Returns the launch counts of the main path's run (prefill, then greedy
    decode) and the bf16 compute copy of the weights (for the engine)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tt
    from repro_torch.models.params import cast_params, init_params

    cfg = get_config("qwen3-4b").canonicalize(tp=1)
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads, cfg.hd) != (
            36, 2560, 151_936, 32, 8, 128):
        fail(f"qwen3-4b config is not the published one: {cfg}")
    t0 = time.perf_counter()
    master = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(master))
    log(f"qwen3-4b: {n_params} parameters (param_count {cfg.param_count()}), float32 "
        f"master made on the card in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(1)

    # float32 compute: prefill(s) + decode(token s) == forward(s + 1)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = cast_params(master, cfg32)
    s = LM_CHECK_PROMPT
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, s + 1), generator=gen, device=dev)
    before = dict(fa.LAUNCHES)
    full, _ = tt.forward(p32, cfg32, {"tokens": toks})
    pre, cache = tt.prefill(p32, cfg32, {"tokens": toks[:, :s]}, s_max=s + 8,
                            cache_dtype=torch.float32)
    dec, _ = tt.decode_step(p32, cfg32, cache, toks[:, s:s + 1])
    torch.cuda.synchronize()
    launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    if launched != {"flash_attention": 2 * cfg.n_layers, "flash_attention_wgmma": 0}:
        fail(f"f32 forward and prefill launched {launched}: not the CUDA-core kernel a layer")
    e = max_abs_err(dec, full[:, -1])
    try:
        torch.testing.assert_close(dec, full[:, -1], **LM_F32_TOL)
    except AssertionError as exc:
        fail(f"f32 prefill({s}) + decode != forward({s + 1}): {exc}")
    log(f"qwen3-4b f32: prefill({s}) + decode == forward({s + 1}) at the last position, "
        f"max abs err {e:.3e} (tolerance {LM_F32_TOL}; logits up to "
        f"{float(full[:, -1].abs().max()):.3f})")
    # the same float32 network with attention through the plain version: the
    # CUDA-core kernel across all 36 layers, at the reference's tolerance
    with fa.plain_version():
        full_plain, _ = tt.forward(p32, cfg32, {"tokens": toks})
        pre_plain, _ = tt.prefill(p32, cfg32, {"tokens": toks[:, :s]}, s_max=s + 8,
                                  cache_dtype=torch.float32)
    torch.cuda.synchronize()
    for what, got, want in ((f"prefill({s})", pre, pre_plain),
                            (f"forward({s + 1}), every position", full, full_plain)):
        e = max_abs_err(got, want)
        try:
            torch.testing.assert_close(got, want, **LM_F32_TOL)
        except AssertionError as exc:
            fail(f"f32 {what} through the kernel differs from the plain version: {exc}")
        log(f"qwen3-4b f32 {what}: through the CUDA-core kernel == through the plain version, "
            f"max abs err {e:.3e} (tolerance {LM_F32_TOL}; logits up to "
            f"{float(want.abs().max()):.3f})")
    del full, pre, cache, dec, full_plain, pre_plain, p32

    params = cast_params(master, cfg)  # the bf16 compute copy, once
    del master
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"bf16 compute copy made; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    s_max = LM_PROMPT + LM_DECODE + LM_PROFILE_STEPS + 1
    tt.prefill(params, cfg, {"tokens": prompt[:, :128]}, s_max=160)  # warm-up
    torch.cuda.synchronize()

    # the main path: prefill, then greedy decode, counts read right after
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = tt.prefill(params, cfg, {"tokens": prompt}, s_max=s_max)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = read_counts()["flash_attention_wgmma"]
    first = logits.clone()
    out = []
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
        logits, cache = tt.decode_step(params, cfg, cache, tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / LM_DECODE
    counts = read_counts()
    launches = counts["flash_attention_wgmma"]
    if prefill_launches != cfg.n_layers or launches != cfg.n_layers:
        fail(f"prefill launched the wgmma flash kernel {prefill_launches} times and the run "
             f"{launches}, not once a layer ({cfg.n_layers})")
    if first.shape != (LM_BATCH, cfg.vocab_size) or first.dtype != torch.float32:
        fail(f"prefill logits {first.dtype}{tuple(first.shape)}")
    if not bool(torch.isfinite(first).all()) or not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")
    if cache["t"] != LM_PROMPT + LM_DECODE:
        fail(f"cache t {cache['t']} after {LM_DECODE} decode steps")
    toks_out = torch.cat(out, dim=1)
    log(f"qwen3-4b bf16 prefill B{LM_BATCH} x {LM_PROMPT}: {prefill_ms:.3f} ms, "
        f"{prefill_launches} flash launches; {LM_DECODE} greedy decode steps "
        f"{decode_ms:.3f} ms/token (batch {LM_BATCH}); tokens of row 0 "
        f"{toks_out[0, :8].tolist()}...")

    with fa.plain_version():
        t0 = time.perf_counter()
        want, _ = tt.prefill(params, cfg, {"tokens": prompt}, s_max=s_max)
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    e = max_abs_err(first, want)
    scale = float(want.abs().max())
    agree = float((first.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"prefill through the kernel vs the plain version ({plain_prefill_ms:.3f} ms): "
        f"max abs err {e:.4f} on logits up to {scale:.3f} (tolerance "
        f"{LM_PLAIN_REL_TOL} x that); argmax agreement {agree:.2f}")
    if not e <= LM_PLAIN_REL_TOL * scale:
        fail(f"prefill logits through the kernel differ from the plain version by {e}")
    del want

    # layer by layer: each layer's live (q, k, v), captured in one more
    # prefill (not the timed one), through the kernel and the plain version
    with captured_attention() as seen:
        tt.prefill(params, cfg, {"tokens": prompt}, s_max=s_max)
    if len(seen) != cfg.n_layers:
        fail(f"captured {len(seen)} attention calls in a prefill of {cfg.n_layers} layers")
    worst, worst_layer = -1.0, -1
    for layer, (q, k, v, kw) in enumerate(seen):
        got = fa.flash_attention(q, k, v, **kw)
        with fa.plain_version():
            want = fa.flash_attention(q, k, v, **kw)
        try:
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
        except AssertionError as exc:
            # the worst element beside the plain version's float32 value
            # before its cast to bf16
            with fa.plain_version():
                exact = fa.flash_attention(q.float(), k.float(), v.float(), **kw)
            at = tuple(int(i) for i in torch.unravel_index(
                (got.float() - want.float()).abs().argmax(), got.shape))
            fail(f"prefill layer {layer}: the kernel differs from the plain version on the "
                 f"layer's live (q, k, v): {exc}\nat {at}: kernel {float(got[at])}, plain "
                 f"{float(want[at])}, plain in float32 {float(exact[at])}")
        e = max_abs_err(got.float(), want.float())
        if e > worst:
            worst, worst_layer = e, layer
    log(f"prefill layer by layer: {len(seen)} layers' live (q, k, v) {tuple(seen[0][0].shape)} "
        f"through the wgmma kernel == the plain version, largest max abs err {worst:.3e} "
        f"(layer {worst_layer}; tolerance {BF16_TOL})")
    del seen, got, want

    # where the device time goes, against the host-clock times above
    def report(what, wall_ms, fn, reps):
        busy, top = device_profile(fn, reps)
        if busy <= 0:
            log(f"{what} profile: device time not measured (the profiler saw no kernel)")
        else:
            log(f"{what} profile: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms "
                f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}); top {top}")

    report("prefill", prefill_ms,
           lambda: tt.prefill(params, cfg, {"tokens": prompt}, s_max=s_max), 1)
    # greedy decode goes on from the main run, on its cache: the same
    # s_max slots that every timed step attended over
    state = {"logits": logits}

    def step():
        tok = state["logits"].argmax(-1, keepdim=True)
        state["logits"], _ = tt.decode_step(params, cfg, cache, tok)

    t_from = cache["t"]
    report(f"decode step (t {t_from + 1}..{t_from + LM_PROFILE_STEPS} of {s_max} slots)",
           decode_ms, step, LM_PROFILE_STEPS)
    if cache["t"] != t_from + LM_PROFILE_STEPS + 1:
        fail(f"cache t {cache['t']} after the profiled decode steps")
    del cache, logits, state
    torch.cuda.empty_cache()
    return counts, cfg, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------ phase 15
def engine_phase(dev, cfg, params):
    import numpy as np
    import torch

    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(2)
    engine = ServeEngine(cfg, params, max_batch=ENGINE_SLOTS, max_seq=128, device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new=ENGINE_NEW)
            for i, n in enumerate(rng.integers(8, 17, ENGINE_REQUESTS))]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    steps = 0
    while engine.pending or any(sl is not None for sl in engine.slots):
        engine.step()
        steps += 1
        if steps > 1000:
            fail("ServeEngine did not finish in 1000 steps")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not all(r.done and len(r.out) == ENGINE_NEW for r in reqs):
        fail(f"ServeEngine: done {[r.done for r in reqs]}, out {[len(r.out) for r in reqs]}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        fail("ServeEngine produced a token outside the vocabulary")
    n_new = sum(len(r.out) for r in reqs)
    n_prompt = sum(len(r.prompt) for r in reqs)
    log(f"ServeEngine qwen3-4b: {ENGINE_REQUESTS} requests ({n_prompt} prompt tokens, "
        f"{n_new} generated) through {ENGINE_SLOTS} slots in {steps} steps, {dt:.3f} s: "
        f"{n_new / dt:.1f} generated tokens/s, {dt / steps * 1e3:.3f} ms/step")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})", file=sys.stderr)
        return 2
    if not os.path.abspath(build.__file__).startswith(os.path.join(HERE, "src") + os.sep):
        print(f"chip_smoke: repro_torch imported from outside this checkout "
              f"({build.__file__})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # one nvcc for each source, all started together
    t0 = time.perf_counter()
    names = ("dc_pairs", "flash_attention", "flash_attention_wgmma", "semijoin")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(lambda n: build.build_library(n, verbose_ptxas=True), names))
    log(f"built {[os.path.relpath(p, HERE) for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in build.BUILD_LOG[name]["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")
    # every instantiation of the DC scan kernel, without a spill
    dc_ptxas = build.BUILD_LOG["dc_pairs"]["ptxas"]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", dc_ptxas)
    if len(spills) < 10 or any(int(a) or int(b) for a, b in spills):
        fail(f"dc_pairs.cu: {len(spills)} instantiations, spills {spills}")

    dc_measured = kernel_phase(dev)
    role_measured = role_scan_phase(dev)
    semijoin_measured = semijoin_phase(dev)
    flash_measured = flash_phase(dev)
    # the main paths, each driven with every count at 0 and read just after
    # (the DC and LM phases read theirs around their main run)
    paths = {}

    def drive(name, run):
        reset_counts()
        out = run()
        paths[name] = read_counts()
        return out

    fd_queries, fd_masks, fd_daisy_s = drive("fd", lambda: fd_phase(dev))
    paths["dc"], dc_daisy_s, dc_path_ms = dc_phase(dev)
    dc_measured["path_query0_kernel_ms"] = dc_path_ms
    drive("join", lambda: join_phase(dev))
    drive("offline", lambda: offline_phase(dev, fd_queries, fd_masks, fd_daisy_s, dc_daisy_s))
    del fd_masks
    serial_phase(dev)
    dc_measured["ingest_timing"] = drive("ingest", lambda: ingest_phase(dev))
    drive("service", lambda: service_phase(dev))
    paths["lm"], cfg, params = lm_phase(dev)
    drive("engine", lambda: engine_phase(dev, cfg, params))
    for path, counts in paths.items():
        log(f"{path} path launches: {counts}")
        for kernel, n in counts.items():
            want = PATH_LAUNCHES[path].get(kernel, 0)
            if (n <= 0) if want is None else (n != want):
                fail(f"the {path} path launched {kernel} {n} times, expected "
                     f"{'at least one' if want is None else want}")
    measured = {"dc_pair_scan": dc_measured, **flash_measured,
                "dc_role_scan": role_measured, "semijoin": semijoin_measured}
    where = {
        "dc_pair_scan": ("dc_pairs.cu", "dc_pairs.py:445"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:101"),
        "flash_attention_wgmma": ("flash_attention_wgmma.cu", "flash_attention.py:101"),
        "dc_role_scan": ("dc_pairs.cu", "dc_pairs.py:238"),
        "semijoin": ("semijoin.cu", "semijoin.py:32"),
    }
    records = [
        dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
             replaces=f"src/repro/kernels/{tpu}",
             launches=sum(counts[name] for counts in paths.values()),
             path_launches={path: counts[name] for path, counts in paths.items()},
             **measured[name])
        for name, (src, tpu) in where.items()
    ]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
