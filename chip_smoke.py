#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, every phase

Phases, each of which must pass or the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels (``src/repro_torch/csrc/dc_pairs.cu``,
   ``flash_attention.cu``, ``flash_attention_wgmma.cu``,
   ``flash_attention_bwd.cu`` and ``semijoin.cu``) with nvcc, one process
   each, at once; log what ``ptxas`` says of registers and spills, and fail
   if any of the DC scan's ten instantiations, the wgmma flash kernel's
   three (D 64, 128, 256; the same instances write the logsumexp when asked)
   or the backward's twenty-four (three kernels on the CUDA cores at widths
   64, 128 and 256 in float32 and bf16, and three on wgmma at 64 and 128)
   spills, or ptxas ignored a ``setmaxnreg``;
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
   chooses: the wgmma kernel (bf16, D 64, 128 and 256) over qwen3-4b's
   prefill (contiguous, and as the (b, s, h, d) views the model passes),
   group sizes 1, 4 and 8, D 64 ragged S 300, non-causal Sq 77 against Sk
   1000, windows 64 at ragged S 500 and 1024 at S 4096, a uniform V, and
   at D 256 gemma3-12b's global and local (window 1,024) layers at B 2 x
   2048, window 1,024 at ragged S 1,100, the (b, s, h, d) views, a
   uniform V and S 130; the CUDA-core kernel over float32 I/O (S 1,024
   and the prefill shape), non-causal Sq 1 and 77, D 64 and a uniform V,
   and alone on bf16 at the prefill shape and gemma3's global layer; then
   both kernels' times in alternating turns at the prefill shape B 2 x S
   2048 and at gemma3's two shapes, and the CUDA-core kernel's in float32
   at the prefill shape, each beside the plain version's, the
   ``scaled_dot_product_attention`` yardstick's (a boolean band mask for
   the window) and the bound;
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
14. sharded violation detection (a one-device ``dist.hints.Mesh``):
    (a) on fig_dist_detect's relation (DC region ==, price <, discount >;
    FD orderkey -> suppkey) at 131,072 rows over 4,096 regions, the
    sharded DC counts and stats and FD candidate tables equal the dense
    scans at 2, 4, 8 and 16 shards, each sharded DC detect is one
    ``dc_pair_scan`` launch bit-identical to its plain version, the
    comparison space shrinks as shards grow and the strip report covers
    the rows; a copy with 90% of its rows in one region retries its
    shuffle and still equals the dense scans; (b) a mesh-configured
    ``Daisy`` (16 shards) equals the dense ``Daisy`` over 8 range queries
    (answers, overlays, checked bits, versions, step modes), every detect
    step on the sharded path, ``sharded_info`` and the observed detect
    costs filled, one launch a sharded DC detect, and the same run on the
    CPU gives the same state; (c) at 1,048,576 rows over 32,768 regions
    and 16 shards, the shuffle, the one sharded launch (and its kernel
    alone by ``torch.profiler``), the whole sharded detect and the dense
    detect are timed, sharded equal to dense, beside the launch's bound;
15. qwen3-4b at its published width (36 layers, d_model 2560, vocab
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
16. the ``ServeEngine`` at that width, a functional smoke: 8 requests of
   8-16 prompt tokens, 16 new tokens each, through 4 slots;
17. every registered architecture (jamba, falcon-mamba, nemotron, gemma3,
   chatglm3, qwen3, whisper, internvl2, olmoe, qwen2-moe) at its reduced
   widths in float32 compute, weights from a seed: ``forward``,
   ``prefill`` (every cache leaf) and 4 ``decode_step``s on the card
   against the same calls on the CPU at ``atol=rtol=2e-3``, and every MoE
   block's chosen experts equal;
18. olmoe-1b-7b (16 layers), falcon-mamba-7b (64 layers) and
   whisper-large-v3 (32 + 32 layers, 1,500 random encoder frames) at their
   published widths, and gemma3-12b at its published widths cut to one
   pattern unit (5 local layers, window 1,024, and 1 global, head dim 256:
   the wgmma kernel's), weights from seed 0, one at a time: (b) in float32 compute,
   prefill(s) then decode(token s) against forward(s + 1) at the last
   position (an MoE block dropless there), at ``atol=rtol=2e-3``; in bf16,
   the main path: ``prefill`` of B 2 x 2048 tokens (whisper: a 448-token
   decoder prompt) and 32 greedy ``decode_step``s, timed; (a) the same
   prefill through the plain attention version (logits within 5% of the
   largest; an MoE model reports how many expert choices differ); (c) each
   attention call's live (q, k, v), captured in one more prefill, through
   the kernel against the plain version at bf16 ``atol=3e-2``; then
   ``torch.profiler``'s device time of a prefill and of four decode steps;
19. training: (a) the flash-attention backward kernels
   (``csrc/flash_attention_bwd.cu``, built with the others and checked for
   spills) against ``flash_attention_bwd_plain`` on the card, in the
   variant ``bwd_variant`` picks (wgmma for bf16 at D 64 and 128, given
   the wgmma forward's saved logsumexp) and, where that is wgmma, without
   the logsumexp and forced onto the CUDA cores too, float32 at max |err|
   <= 1e-4 x max |ref| and bf16 at <= 2e-2 x max |ref|, over qwen3-4b's
   shape (B 2, Hq 32, Hkv 8, S 2,048, D 128, bf16, causal) on contiguous
   operands and on the (b, s, h, d) views attend_full passes, the same in
   float32 at S 1,024, D 64 non-causal Sq 77 against Sk 1,000, a window of
   64 at ragged S 500 (both on views), gemma3's D 256 with a window of
   1,024 at S 1,100, D 16 and rows that see no key in float32 and bf16 (a
   zero gradient), two launches of each case the same bits; the wgmma
   variant's gradients keep their operands' strides and it allocates no
   more than its outputs and scratch (no operand copied); then, in
   alternating turns at qwen3-4b's shape, the wgmma variant on contiguous
   operands and on views, the CUDA-core variant, the forward kernel with
   and without its logsumexp, SDPA's forward and its forward and backward
   (``scaled_dot_product_attention`` with ``enable_gqa``; its backward is
   the difference) and the plain backward, each beside the bound; (b) reduced qwen3-4b, olmoe-1b-7b and falcon-mamba-7b in float32
   compute: two AdamW steps on the card against the same steps on the CPU
   (loss, grad norm, parameters); (c) the main path ``train``: qwen3-4b at
   its published width cut to 4 of its 36 layers (float32 masters, bf16
   compute, AdamW, remat), B 2 x S 2,048 batches drawn through the port's
   ``CleanDataPipeline`` (Daisy cleaning the corpus metadata on the card),
   five steps of ``launch.train.train`` with a checkpoint after step 3.
   Before it, step 1's loss and gradients through the kernels against
   ``plain_version()``; after it, the loss must have fallen, the run is
   resumed from the checkpoint and its steps 4 and 5 must equal the
   uninterrupted ones bit for bit (loss, lr, grad norm, parameters), and one step is split into forward, backward and
   optimizer (CUDA events) and profiled (``torch.profiler``: idle share),
   beside ``torch.cuda.max_memory_allocated``.

Each main path (FD, DC, join, offline, ingest, service, the sharded
Daisy, each LM model's prefill and decode, the engine, training) runs with
every kernel's launch count at 0, read just after; the counts must be as
``PATH_LAUNCHES`` says: the role scan, the semijoin and the CUDA-core
flash kernel lie on none of them.  The line before the
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
# dense bf16 rate (NVIDIA data sheet, H100 SXM); float32 attention's are
# float32 FMAs, at the data sheet's 67 TFLOP/s outside the tensor cores.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

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
# every registered architecture at its reduced widths: prompt (vision
# prefix included) and decode steps, card against CPU
ARCH_PROMPT, ARCH_DECODE = 16, 4
# the full-width paths: (path, arch, pattern units kept or None for all,
# the prompt of the f32 prefill + decode == forward check); gemma3 keeps one
# 5-local + 1-global unit, and its check prompt passes the 1,024 window so
# the ring buffer wraps.  Whisper's decoder prompt is its 448-token context.
FULL_WIDTH = (
    ("lm_olmoe", "olmoe-1b-7b", None, LM_CHECK_PROMPT),
    ("lm_falcon_mamba", "falcon-mamba-7b", None, LM_CHECK_PROMPT),
    ("lm_whisper", "whisper-large-v3", None, LM_CHECK_PROMPT),
    ("lm_gemma3", "gemma3-12b", 1, 1_100),
)
WHISPER_PROMPT = 448
GEMMA3_WINDOW = 1_024  # gemma3-12b's local layers' window

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
# sharded detection: fig_dist_detect's relation (its region-keyed DC and FD)
# at 131,072 rows over 4,096 regions, its shard counts and strip size; a
# 90%-one-region copy; the mesh-configured Daisy at 16 shards; the timing
# at 1,048,576 rows over 32,768 regions
DIST_ROWS, DIST_REGIONS, DIST_SHARDS, DIST_STRIP = 131_072, 4_096, (2, 4, 8, 16), 256
DIST_SKEW_SHARDS, DIST_DAISY_SHARDS = 8, 16
DIST_BIG_ROWS, DIST_BIG_REGIONS = 1_048_576, 32_768
# Launches each main path must make (None: at least one); a kernel not
# named launches none there.  dc_role_scan and semijoin lie on no path:
# only their kernels.ops entry points call them.  An LM path is one bf16
# prefill and its greedy decode steps, and only the prefill launches (one
# flash call per attention layer; decode attends in plain tensor code):
# * qwen3-4b: 36 layers at head dim 128, the wgmma kernel's;
# * olmoe-1b-7b: 16 layers at head dim 128, the wgmma kernel's;
# * falcon-mamba-7b: 64 Mamba layers, no attention, no kernel;
# * whisper-large-v3: head dim 64, the wgmma kernel's, 32 encoder layers
#   (non-causal), 32 decoder self-attention (causal) and 32 cross-attention
#   calls (non-causal over the encoder's 1,500 frames): 96;
# * gemma3-12b cut to one unit: 5 local and 1 global layer at head dim 256,
#   the wgmma kernel's, 6.
# * training (the "train" path): qwen3-4b at full width cut to 4 layers,
#   five steps under remat: each step runs each layer's forward twice (the
#   step, then its recompute in the backward), the wgmma kernel's 4 x 2 a
#   step, and each layer's backward once (one counted launch of the three
#   backward kernels): 40 and 20.
# The CUDA-core kernel (float32, other head dims) lies on no main path.
TRAIN_UNITS, TRAIN_STEPS, TRAIN_CKPT_AT = 4, 5, 3
PATH_LAUNCHES = {
    "fd": {}, "dc": {"dc_pair_scan": None}, "join": {}, "offline": {"dc_pair_scan": 1},
    "ingest": {"dc_pair_scan": None}, "service": {"dc_pair_scan": None},
    "dist": {"dc_pair_scan": None}, "lm": {"flash_attention_wgmma": 36}, "engine": {},
    "lm_olmoe": {"flash_attention_wgmma": 16}, "lm_falcon_mamba": {},
    "lm_whisper": {"flash_attention_wgmma": 96}, "lm_gemma3": {"flash_attention_wgmma": 6},
    "train": {"flash_attention_wgmma": 2 * TRAIN_UNITS * TRAIN_STEPS,
              "flash_attention_bwd": TRAIN_UNITS * TRAIN_STEPS},
}
# The training phase.  The backward kernels' cases: (label, b, hq, hkv, sq,
# sk, d, dtype name, causal, window, views); with views, q, k, v and do are
# the (b, s, h, d) views attend_full passes.  The first two are timed.
# Tolerances on max |kernel - plain| / max |plain| per gradient: float32 at
# 1e-4 (sums in another order), bf16 at 2e-2 (both sides read the same bf16
# operands; the tensor-core kernels also round P and dS to bf16 for their
# products, within 6.6e-3 at worst on an H100; PERF.md).
FLASH_BWD_CASES = (
    ("qwen3-4b", 2, 32, 8, 2048, 2048, 128, "bfloat16", True, None, False),
    ("qwen3-4b (b, s, h, d) views", 2, 32, 8, 2048, 2048, 128, "bfloat16", True, None, True),
    ("qwen3-4b float32 S 1,024", 2, 32, 8, 1024, 1024, 128, "float32", True, None, False),
    ("D 64 non-causal Sq 77 Sk 1,000", 2, 8, 2, 77, 1000, 64, "bfloat16", False, None, True),
    ("window 64 ragged S 500", 2, 8, 2, 500, 500, 128, "bfloat16", True, 64, True),
    ("gemma3 D 256 window 1,024 S 1,100", 1, 16, 8, 1100, 1100, 256, "bfloat16", True, 1024,
     False),
    ("D 16", 2, 4, 2, 96, 96, 16, "float32", True, None, False),
    ("rows that see no key", 1, 4, 2, 40, 8, 64, "float32", True, 4, False),
    ("rows that see no key bf16", 1, 4, 2, 100, 8, 128, "bfloat16", True, 4, False),
)
FLASH_BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the reduced configs trained on the card against the CPU (float32 compute)
TRAIN_REDUCED = ("qwen3-4b", "olmoe-1b-7b", "falcon-mamba-7b")
# the full-width run: B 2 x S 2,048 from a 1,024-document corpus, AdamW at
# 3e-4 after a one-step warmup (the reference's 100-step warmup would keep
# five steps near lr 0)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_DOCS, TRAIN_LR, TRAIN_WARMUP = 2, 2048, 1024, 3e-4, 1
# step 1 through the kernels against plain_version(): both are bf16 networks
# whose attention outputs round apart; loss within 1e-3 relative, each
# gradient leaf within 5e-2 in relative L2 norm
TRAIN_PLAIN_LOSS_RTOL, TRAIN_PLAIN_GRAD_REL = 1e-3, 5e-2


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
    from repro_torch.kernels import dc_pairs, flash_attention, flash_attention_bwd, semijoin

    return dc_pairs, semijoin, flash_attention, flash_attention_bwd


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
    """Least time of one attention call on an H100: the larger of its FLOPs
    (4 D per visible query-key pair and head: the QK^T and PV products,
    counted over the pairs this call's mask leaves) over the peak rate of
    its dtype (bf16 on the tensor cores, float32 outside them) and its
    bytes (q, k, v read once, o written once) over HBM bandwidth."""
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
    peak = PEAK_F32_FLOPS if q.element_size() == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
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
    # gemma3-12b's attention at the prefill shape: Hq 16, Hkv 8, head dim 256;
    # its global layers causal, its local ones within the window
    gemma_case = qkv(bf16, B, 16, 8, S, S, 256)
    f32_case = [x.float() for x in prefill_case]
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
        ("gemma3 global B2 Hq16 Hkv8 D256 S2048 bf16 causal", gemma_case, True, None, "wgmma"),
        ("gemma3 local B2 Hq16 Hkv8 D256 S2048 bf16 window 1024", gemma_case, True,
         GEMMA3_WINDOW, "wgmma"),
        ("window 1024 ragged S1100 D256 bf16", qkv(bf16, B, 16, 8, 1_100, 1_100, 256), True,
         GEMMA3_WINDOW, "wgmma"),
        ("(b,s,h,d) views D256 S2048 bf16 window 1024", bshd_views(bf16, B, 16, 8, S, 256),
         True, GEMMA3_WINDOW, "wgmma"),
        ("uniform V bf16 D256", uniform(bf16, 256), True, None, "wgmma"),
        ("D256 bf16 S130", qkv(bf16, 2, 8, 2, 130, 130, 256), True, None, "wgmma"),
        ("f32 I/O Hq32 Hkv8 D128 S1024 causal", qkv(f32, 1, 32, 8, 1024, 1024, 128), True, None,
         "cuda_core"),
        ("f32 prefill B2 Hq32 Hkv8 D128 S2048 causal", f32_case, True, None, "cuda_core"),
        ("non-causal Sq1 Sk1000 f32", qkv(f32, 2, 32, 8, 1, 1000, 128), False, None, "cuda_core"),
        ("non-causal Sq77 Sk1000 f32", qkv(f32, 2, 32, 8, 77, 1000, 128), False, None, "cuda_core"),
        ("D64 f32 S512 causal", qkv(f32, 2, 4, 4, 512, 512, 64), True, None, "cuda_core"),
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

    # bf16 through the CUDA-core kernel alone, as the timings below run it:
    # the prefill shape at D 128 and gemma3's global layer at D 256
    for what, (q, k, v) in (("qwen3-4b prefill D128", prefill_case),
                            ("gemma3 global D256", gemma_case)):
        got = fa.flash_attention_cuda_core(q, k, v, causal=True)
        with fa.plain_version():
            want = kops.flash_attention(q, k, v, causal=True)
        try:
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
        except AssertionError as exc:
            fail(f"flash {what} bf16 through the CUDA-core kernel: {exc}")
        e = max_abs_err(got.float(), want.float())
        err["cuda_core"] = max(err["cuda_core"], e)
        log(f"flash == plain: {what} bf16 through the CUDA-core kernel: max abs err {e:.3e}")
    if fa.LAUNCHES["flash_attention"] != 2 + sum(c[-1] == "cuda_core" for c in cases):
        fail(f"{fa.LAUNCHES} flash launches for {len(cases) + 2} cases")

    kernels = {"wgmma": fa.flash_attention_wgmma, "cuda_core": fa.flash_attention_cuda_core}

    def sdpa(q, k, v, window):
        """The library yardstick: causal, or a boolean band mask for a window."""
        if window is None:
            return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True)
        pos = torch.arange(q.shape[2], device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True)

    def timed(label, qkv_, window, variants):
        """The kernels in alternating turns (new, old, old, new), beside the
        plain version, the library call and the bound, on one input."""
        q, k, v = qkv_
        turns = []
        order = variants + variants[::-1]
        for variant in order:
            turns.append((variant, cuda_ms(
                lambda: kernels[variant](q, k, v, causal=True, window=window), 10)))
        with fa.plain_version():
            plain_ms = cuda_ms(lambda: kops.flash_attention(q, k, v, causal=True, window=window),
                               3)
        library_ms = cuda_ms(sdpa(q, k, v, window), 10)
        bound_ms, bound_by, detail, flops = attention_bound(q, k, True, window)
        out = {}
        for variant in variants:
            ts = [t for w, t in turns if w == variant]
            ms = sum(ts) / len(ts)
            out[variant] = dict(ms=ms, turns_ms=ts, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=library_ms)
            log(f"flash_attention {label}: {variant} kernel {ms:.4f} ms (turns "
                f"{[round(t, 4) for t in ts]}; {flops / ms / 1e9:.1f} TFLOP/s), plain "
                f"{plain_ms:.3f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {detail}); / sdpa {ms / library_ms:.2f}, / bound "
                f"{ms / bound_ms:.2f}")
        return out

    both = ["wgmma", "cuda_core"]
    qwen = timed(f"B{B} Hq32 Hkv8 D128 S{S} bf16 causal", prefill_case, None, both)
    gemma = {
        "gemma3 global": timed(f"gemma3 global B{B} Hq16 Hkv8 D256 S{S} bf16 causal",
                               gemma_case, None, both),
        "gemma3 local": timed(f"gemma3 local B{B} Hq16 Hkv8 D256 S{S} bf16 window "
                              f"{GEMMA3_WINDOW}", gemma_case, GEMMA3_WINDOW, both),
    }
    f32_row = timed(f"B{B} Hq32 Hkv8 D128 S{S} float32 causal", f32_case, None,
                    ["cuda_core"])["cuda_core"]
    # the wgmma kernel's record at qwen3-4b's prefill shape, the CUDA-core
    # kernel's in float32 (its dtype on every path); the other shapes beside
    wgmma_rec = dict(max_abs_err=err["wgmma"], **qwen["wgmma"],
                     shapes={label: t["wgmma"] for label, t in gemma.items()})
    core_rec = dict(max_abs_err=err["cuda_core"], **f32_row,
                    shapes={"qwen3-4b bf16 D128": qwen["cuda_core"],
                            **{label: t["cuda_core"] for label, t in gemma.items()}})
    return {fa.KERNEL_NAME["wgmma"]: wgmma_rec, fa.KERNEL_NAME["cuda_core"]: core_rec}


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
def dist_relation(n, n_regions, device, skew=False, seed=13):
    """fig_dist_detect's relation (``benchmarks/fig_dist_detect.py``): orders
    whose price and discount are monotone-consistent within a region, with
    noise that plants inversions inside regions; ``orderkey`` is the region.
    ``skew`` puts 90% of the rows in region 0.  Every rule attribute is in
    the overlay (the benchmark's omits region and orderkey), so that a
    ``Daisy`` can repair them."""
    import numpy as np

    from repro_torch.core.relation import make_relation

    rng = np.random.default_rng(seed)
    region = rng.integers(0, n_regions, n).astype(np.int32)
    price = rng.uniform(1000.0, 5000.0, n).astype(np.float32)
    discount = (6000.0 - price + rng.normal(0, 150.0, n)).astype(np.float32)
    supp = rng.integers(0, 64, n).astype(np.int32)
    if skew:
        region[rng.random(n) < 0.9] = 0
    return make_relation(
        {"region": region, "extended_price": price, "discount": discount,
         "orderkey": region, "suppkey": supp},
        overlay=["region", "extended_price", "discount", "orderkey", "suppkey"], k=8,
        rules=["dc_rpd", "fd_rs"], device=device,
    )


def dist_rules():
    from repro_torch.core.constraints import DC, FD, Atom

    dc = DC("dc_rpd", [Atom("region", "==", "region"),
                       Atom("extended_price", "<", "extended_price"),
                       Atom("discount", ">", "discount")])
    return dc, FD("fd_rs", "orderkey", "suppkey")


def dc_flat(det):
    return (det.t1_count, *det.t1_stat, det.t2_count, *det.t2_stat)


def fd_flat(det):
    return tuple(getattr(det, f) for f in ("violated", "rhs_cand", "rhs_count", "lhs_cand",
                                            "lhs_count", "overflow"))


def same_fd(got, want, what: str) -> None:
    import torch

    for name, g, w in zip(("violated", "rhs_cand", "rhs_count", "lhs_cand", "lhs_count",
                           "overflow"), fd_flat(got), fd_flat(want)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            fail(f"{what}: FD {name} differs")


def dist_equivalence(dev):
    """(a): sharded == dense at 2, 4, 8 and 16 shards (the DC counts and
    stats, the FD candidate tables), the one sharded launch == its plain
    version, fig_dist_detect's gates, and a skewed copy through an overflow
    retry."""
    import torch

    from repro_torch.core.detect import detect_dc, detect_fd
    from repro_torch.dist.detect import detect_dc_sharded_info, detect_fd_sharded_info
    from repro_torch.dist.hints import one_device_mesh
    from repro_torch.kernels import dc_pairs

    mesh = one_device_mesh(dev)
    dc, fd = dist_rules()
    rel = dist_relation(DIST_ROWS, DIST_REGIONS, dev)
    timed = {}
    dense = detect_dc(rel, dc, rel.valid, rel.valid)
    dense_fd = detect_fd(rel, fd, rel.valid, k=8)
    dense_pairs = rel.capacity ** 2
    prev, err = dense_pairs, 0.0
    for shards in DIST_SHARDS:
        before = dc_pairs.LAUNCHES["dc_pair_scan"]
        det, info = detect_dc_sharded_info(rel, dc, rel.valid, rel.valid, mesh, n_shards=shards,
                                           strip_rows=DIST_STRIP)
        if dc_pairs.LAUNCHES["dc_pair_scan"] != before + 1:
            fail(f"dist {shards} shards: {dc_pairs.LAUNCHES['dc_pair_scan'] - before} launches")
        with dc_pairs.plain_version():
            plain, _ = detect_dc_sharded_info(rel, dc, rel.valid, rel.valid, mesh,
                                              n_shards=shards)
        torch.cuda.synchronize()
        err = max(err, same_flat(dc_flat(det), dc_flat(plain),
                                 f"dist {shards} shards, the sharded launch"))
        same_flat(dc_flat(det), dc_flat(dense), f"dist {shards} shards, sharded vs dense DC")
        det_fd, _ = detect_fd_sharded_info(rel, fd, rel.valid, mesh, k=8, n_shards=shards,
                                           strip_rows=DIST_STRIP)
        same_fd(det_fd, dense_fd, f"dist {shards} shards, sharded vs dense")
        if not info.sharded_pairs < dense_pairs or info.sharded_pairs > prev:
            fail(f"dist {shards} shards: pairs {info.sharded_pairs} after {prev} "
                 f"(dense {dense_pairs})")
        prev = info.sharded_pairs
        if sum(info.per_shard_strips) < -(-info.routed_rows // DIST_STRIP):
            fail(f"dist {shards} shards: strip coverage {sum(info.per_shard_strips)}")
        if shards == DIST_DAISY_SHARDS:  # the sharded detect, kernel and plain, timed

            def sharded():
                return detect_dc_sharded_info(rel, dc, rel.valid, rel.valid, mesh,
                                              n_shards=shards)

            timed = dict(rows=DIST_ROWS, n_shards=shards, detect_ms=cuda_ms(sharded, 3))
            with dc_pairs.plain_version():
                timed["plain_detect_ms"] = cuda_ms(sharded, 1)
            log(f"dist {DIST_ROWS} rows, {shards} shards: the sharded DC detect "
                f"{timed['detect_ms']:.3f} ms through the kernel, "
                f"{timed['plain_detect_ms']:.3f} ms through the plain version")
        log(f"dist {DIST_ROWS} rows, {DIST_REGIONS} regions, {shards} shards: sharded == dense "
            f"(DC counts and stats, FD candidates), the launch == plain; pairs "
            f"{info.sharded_pairs} ({dense_pairs / info.sharded_pairs:.1f}x fewer), tiles "
            f"{info.tiles_launched} of {info.tiles_total}, retries {info.retries}, max strips "
            f"a shard {max(info.per_shard_strips)}")
    skewed = dist_relation(DIST_ROWS, DIST_REGIONS, dev, skew=True)
    det, info = detect_dc_sharded_info(skewed, dc, skewed.valid, skewed.valid, mesh,
                                       n_shards=DIST_SKEW_SHARDS)
    same_flat(dc_flat(det), dc_flat(detect_dc(skewed, dc, skewed.valid, skewed.valid)),
              "dist skewed copy, sharded vs dense DC")
    det_fd, fd_info = detect_fd_sharded_info(skewed, fd, skewed.valid, mesh, k=8,
                                             n_shards=DIST_SKEW_SHARDS)
    same_fd(det_fd, detect_fd(skewed, fd, skewed.valid, k=8), "dist skewed copy")
    if info.retries < 1 or fd_info.retries < 1:
        fail(f"dist skewed copy: retries {info.retries} (DC), {fd_info.retries} (FD)")
    log(f"dist skewed copy (90% of rows in region 0), {DIST_SKEW_SHARDS} shards: sharded == "
        f"dense after {info.retries} retries (factor {info.capacity_factor}), rows a shard "
        f"{info.per_shard_rows}")
    return err, timed


def dist_daisy(dev, mesh):
    from repro_torch.core.executor import Daisy, DaisyConfig
    from repro_torch.obs.trace import Tracer

    dc, fd = dist_rules()
    rel = dist_relation(DIST_ROWS, DIST_REGIONS, dev)
    cfg = DaisyConfig(mesh=mesh, detect_shards=None if mesh is None else DIST_DAISY_SHARDS,
                      expected_queries=len(dist_queries()))
    return Daisy({"t": rel}, {"t": [dc, fd]}, cfg, tracer=Tracer(), device=dev), (dc, fd)


def dist_queries():
    import numpy as np

    return (range_queries("extended_price", np.linspace(1000, 5000, 7), True)
            + range_queries("orderkey", np.array([0, 512, 1536]), False))


def dist_run(dev, mesh):
    daisy, rules = dist_daisy(dev, mesh)
    t0 = time.perf_counter()
    states = [daisy_state(daisy, daisy.execute(q), rules) for q in dist_queries()]
    sync(dev)
    return daisy, states, time.perf_counter() - t0


def dist_daisy_phase(dev):
    """(b): a mesh-configured ``Daisy`` (one-device mesh on the card,
    ``detect_shards=16``) against the dense ``Daisy`` query by query, one
    pair-scan launch a sharded DC detect; then the same sharded run on the
    CPU, state for state."""
    from repro_torch.dist.hints import one_device_mesh

    reset_counts()
    daisy, states, wall = dist_run(dev, one_device_mesh(dev))
    counts = read_counts()
    scans = [e for e in daisy.tracer.events()
             if e.name == "dist.shard_scan" and "tiles_launched" in e.attrs]
    if counts["dc_pair_scan"] != len(scans) or not scans:
        fail(f"dist Daisy: {counts['dc_pair_scan']} launches for {len(scans)} sharded DC "
             "detects")
    _, dense, dense_wall = dist_run(dev, None)
    for i, (s, d) in enumerate(zip(states, dense)):
        same_state({k: v for k, v in s.items() if k != "steps"},
                   {k: v for k, v in d.items() if k != "steps"}, f"dist Daisy query {i}")
        if [x["mode"] for x in s["steps"]] != [x["mode"] for x in d["steps"]]:
            fail(f"dist Daisy query {i}: step modes differ")
        for x in s["steps"]:
            if x["mode"] != "skipped" and x["detect_path"] != "sharded":
                fail(f"dist Daisy query {i}: a {x['mode']} step on the {x['detect_path']} path")
    if set(daisy.sharded_info) != {("t", "dc_rpd"), ("t", "fd_rs")}:
        fail(f"dist Daisy: sharded_info holds {sorted(daisy.sharded_info)}")
    observed = {r: daisy.cost[("t", r)].df_observed for r in ("dc_rpd", "fd_rs")}
    if any(v is None for v in observed.values()):
        fail(f"dist Daisy: observed detect costs {observed}")
    modes = [[x["mode"] for x in s["steps"]] for s in states]
    log(f"dist Daisy {DIST_ROWS} rows, {DIST_DAISY_SHARDS} shards: == the dense Daisy on "
        f"{len(states)} queries (answers, overlays, checked bits, versions, modes {modes}); "
        f"{len(scans)} sharded DC detects, {counts['dc_pair_scan']} pair-scan launches; "
        f"sharded run {wall:.3f} s, dense run {dense_wall:.3f} s; observed detect costs "
        f"{observed}")
    _, cpu_states, cpu_wall = dist_run("cpu", one_device_mesh("cpu"))
    for i, (a, b) in enumerate(zip(states, cpu_states)):
        same_state(a, b, f"dist Daisy query {i} cuda vs cpu")
    log(f"dist Daisy: the CPU run == the card's, state for state ({cpu_wall:.3f} s)")
    return counts


def sharded_bound(inp, counts, stats, block):
    """``scan_bound``'s rule over the tiles the sharded launch runs: per
    shard, the tiles of [0, hi) x [0, hi) that the block bounds cannot rule
    out, for both roles; bytes of the routed inputs and outputs."""
    import torch

    from repro_torch.core.constraints import flip_op
    from repro_torch.kernels import dc_pairs

    l_cols, r_cols, ops, rs, cs, hi = (inp["l_cols"], inp["r_cols"], inp["ops"], inp["rs"],
                                       inp["cs"], inp["hi"])
    fl, fr, frs, fcs, nb_local = dc_pairs.shard_layout(l_cols, r_cols, rs, cs, block)
    distinct, l_idx, r_idx = dc_pairs.distinct_columns(fl, fr)
    nb = frs.shape[0] // block
    b = [[dc_pairs._block_bounds(c, s, red, nb, block) for c in distinct]
         for s, red in ((frs, "min"), (frs, "max"), (fcs, "min"), (fcs, "max"))]
    pairs = 0
    n_shards = rs.shape[0]
    for role_ops, li, ri in ((ops, l_idx, r_idx), ([flip_op(o) for o in ops], r_idx, l_idx)):
        for s in range(n_shards):
            blk = slice(s * nb_local, s * nb_local + hi)
            ok = torch.ones((hi, hi), dtype=torch.bool, device=rs.device)
            for op, x, y in zip(role_ops, li, ri):
                ok &= dc_pairs._tile_possible(op, b[0][x][blk, None], b[1][x][blk, None],
                                              b[2][y][None, blk], b[3][y][None, blk])
            pairs += int(ok.sum()) * block * block
    violating = sum(int(c.sum()) for c in counts)
    n_atoms = len(ops)
    ops_count = pairs * n_atoms + violating * (n_atoms + 1)
    in_bytes = sum(c.numel() * c.element_size() for c in dc_pairs.distinct_columns(
        l_cols, r_cols)[0]) + 2 * rs.numel()
    out_bytes = 2 * 4 * rs.numel() + sum(s.numel() * s.element_size() for s in stats)
    return bound(ops_count, in_bytes + out_bytes)


def dist_timing(dev):
    """(c): at 1,048,576 rows and 32,768 regions, 16 shards: the shuffle, the
    one sharded launch (the kernel alone by ``torch.profiler``), the whole
    sharded detect and the dense detect, equal on the card; the launch's
    bound by ``scan_bound``'s rule over the tiles it runs."""
    import torch

    from repro_torch.core.constraints import flip_op
    from repro_torch.core.detect import _T1_REDUCE, detect_dc
    from repro_torch.dist import detect as ddet
    from repro_torch.dist.hints import one_device_mesh
    from repro_torch.kernels import dc_pairs

    mesh = one_device_mesh(dev)
    dc, _ = dist_rules()
    rel = dist_relation(DIST_BIG_ROWS, DIST_BIG_REGIONS, dev)
    shards, block = DIST_DAISY_SHARDS, 256

    def detect():
        return ddet.detect_dc_sharded_info(rel, dc, rel.valid, rel.valid, mesh, n_shards=shards)

    det, info = detect()
    dense = detect_dc(rel, dc, rel.valid, rel.valid)
    torch.cuda.synchronize()
    same_flat(dc_flat(det), dc_flat(dense), f"dist {DIST_BIG_ROWS} rows: sharded vs dense DC")
    # the routed inputs of the one launch, as detect_dc_sharded_info builds them
    attrs = ["region", "extended_price", "discount"]
    payload = [ddet._transport(rel.columns[a]) for a in attrs] + [rel.valid.to(torch.int32)] * 2
    key = ddet._combine_keys([rel.columns["region"]])

    def route():
        return ddet._route(key, payload, rel.valid, mesh, shards, ddet.CAPACITY_FACTOR)

    res, _, _ = route()
    cols = [ddet._untransport(res.payload[..., i], rel.columns[a].dtype)
            for i, a in enumerate(attrs)]
    scope = (res.payload[..., -1] > 0) & res.valid
    ops = [a.op for a in dc.atoms]
    flipped = [flip_op(o) for o in ops]
    red1, red2 = [_T1_REDUCE[o] for o in ops], [_T1_REDUCE[o] for o in flipped]
    nb_local = -(-res.valid.shape[1] // block)
    hi = min(nb_local, max(-(-max(info.per_shard_rows) // block), 1))
    if shards * hi * hi != info.tiles_launched:
        fail(f"dist timing: hi {hi} against {info.tiles_launched} tiles")
    inp = dict(l_cols=cols, r_cols=cols, ops=ops, rs=scope, cs=scope, hi=hi)

    def launch():
        return dc_pairs.dc_pair_scan_sharded(cols, cols, ops, flipped, scope, scope, red1, red2,
                                             block, hi)

    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    t1c, t1s, t2c, t2s = launch()
    launches = dc_pairs.LAUNCHES["dc_pair_scan"] - before
    torch.cuda.synchronize()
    if launches != 1:
        fail(f"dist timing: the sharded scan made {launches} launches")
    launch_ms = cuda_ms(launch, 3)
    kernel_ms = scan_kernel_ms(launch, 3)
    shuffle_ms = cuda_ms(route, 3)
    detect_ms = cuda_ms(detect, 3)
    dense_ms = cuda_ms(lambda: detect_dc(rel, dc, rel.valid, rel.valid), 2)
    bound_ms, bound_by, detail = sharded_bound(inp, [t1c, t2c], list(t1s) + list(t2s), block)
    log(f"dist {DIST_BIG_ROWS} rows, {DIST_BIG_REGIONS} regions, {shards} shards: sharded == "
        f"dense; the shuffle {shuffle_ms:.3f} ms (retries {info.retries}), the one sharded "
        f"launch {launch_ms:.3f} ms a call (the kernel alone {kernel_ms:.3f} ms of device time, "
        f"one launch, {info.tiles_launched} tiles of {info.tiles_total}), "
        f"bound {bound_ms:.4f} ms ({bound_by}; {detail}); the whole sharded detect "
        f"{detect_ms:.3f} ms, the dense detect {dense_ms:.3f} ms "
        f"({info.dense_pairs / info.sharded_pairs:.1f}x the pairs)")
    return dict(rows=DIST_BIG_ROWS, regions=DIST_BIG_REGIONS, n_shards=shards,
                tiles=info.tiles_launched, kernel_ms=kernel_ms, ms=launch_ms,
                bound_ms=bound_ms, bound_by=bound_by, shuffle_ms=shuffle_ms,
                detect_ms=detect_ms, dense_detect_ms=dense_ms)


def dist_phase(dev):
    """Phase 14: sharded violation detection on the card (a)-(c)."""
    err, small = dist_equivalence(dev)
    counts = dist_daisy_phase(dev)
    timing = dist_timing(dev)
    timing["at_131072"] = small
    return counts, err, timing


# ------------------------------------------------------------------ phase 15
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


# ------------------------------------------------------------------ phase 16
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


# ------------------------------------------------------------------ phase 17
@contextlib.contextmanager
def captured_routing():
    """Within this context every MoE block records the experts it chose
    (``moe._top_k``'s int32 indices), in call order.  It wraps the helper
    ``moe_mlp`` calls; the model is not changed."""
    from repro_torch.models import moe

    seen = []
    inner = moe._top_k

    def record(probs, k):
        vals, idx = inner(probs, k)
        seen.append(idx)
        return vals, idx

    moe._top_k = record
    try:
        yield seen
    finally:
        moe._top_k = inner


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if hasattr(tree, "to") else tree


def lm_inputs(cfg, b, s_text, gen, device):
    """Token ids (b, s_text) and the stub frontends' inputs, from ``gen``."""
    import torch

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s_text), generator=gen,
                                     device=gen.device).to(device)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn((b, cfg.vis_tokens, cfg.d_model), generator=gen,
                                            device=gen.device).to(device)
    if cfg.frontend == "audio":
        batch["enc_frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen,
                                          device=gen.device).to(device)
    return batch


def routing_flips(got, want) -> tuple:
    """(choices that differ, choices) between two captured routings."""
    if len(got) != len(want):
        fail(f"routing captured {len(got)} and {len(want)} MoE calls")
    differ = sum(int((g.cpu() != w.cpu()).sum()) for g, w in zip(got, want))
    return differ, sum(w.numel() for w in want)


def archs_phase(dev):
    """Every registered architecture at its reduced widths in float32
    compute: ``forward``, ``prefill`` and ``ARCH_DECODE`` decode steps on
    the card against the same calls on the CPU, and every MoE block's
    chosen experts equal."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.params import cast_params, init_params
    from repro_torch.testing import tree_paths

    worst = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  compute_dtype="float32").canonicalize(tp=1)
        master = init_params(cfg, torch.Generator().manual_seed(17), "cpu")
        s = ARCH_PROMPT - cfg.vis_tokens
        inputs = lm_inputs(cfg, LM_BATCH, s + ARCH_DECODE, torch.Generator().manual_seed(18),
                           "cpu")

        def run(device):
            params = cast_params(_to(master, device), cfg)
            batch = _to(inputs, device)
            pre_batch = dict(batch, tokens=batch["tokens"][:, :s])
            out = {}
            with captured_routing() as routes:
                out["forward"], out["aux"] = tt.forward(params, cfg, batch)
                out["prefill"], cache = tt.prefill(params, cfg, pre_batch,
                                                   s_max=ARCH_PROMPT + ARCH_DECODE,
                                                   cache_dtype=torch.float32)
                for i in range(ARCH_DECODE):
                    out[f"decode {i}"], cache = tt.decode_step(
                        params, cfg, cache, batch["tokens"][:, s + i:s + i + 1])
            for name, leaf in tree_paths(cache).items():
                out[f"cache {name}"] = leaf
            return {k: v.cpu() if hasattr(v, "cpu") else v for k, v in out.items()}, routes

        want, want_routes = run("cpu")
        got, got_routes = run(dev)
        torch.cuda.synchronize()
        err = 0.0
        for name, w in want.items():
            g = got[name]
            if not isinstance(w, torch.Tensor):
                if g != w:
                    fail(f"{arch} reduced: {name} {g} on the card, {w} on the CPU")
                continue
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{arch} reduced: {name} {g.dtype}{tuple(g.shape)} on the card, "
                     f"{w.dtype}{tuple(w.shape)} on the CPU")
            try:
                torch.testing.assert_close(g.float(), w.float(), **LM_F32_TOL)
            except AssertionError as exc:
                fail(f"{arch} reduced: {name} on the card differs from the CPU: {exc}")
            err = max(err, max_abs_err(g.float(), w.float()))
        differ, total = routing_flips(got_routes, want_routes)
        if differ:
            fail(f"{arch} reduced: {differ} of {total} expert choices differ between the card "
                 f"and the CPU (a near-tie in the router)")
        worst[arch] = err
        log(f"{arch} reduced (f32): forward, prefill({s}), {ARCH_DECODE} decode steps and "
            f"{len(want) - 3 - ARCH_DECODE} cache leaves on the card == on the CPU, max abs err "
            f"{err:.3e} (tolerance {LM_F32_TOL}); "
            + (f"{total} expert choices in {len(want_routes)} MoE calls, all equal"
               if want_routes else "no MoE block"))
    return worst


# ------------------------------------------------------------------ phase 18
def full_width_phase(dev, arch, units, check_prompt):
    """One architecture at its published widths (``units`` pattern units,
    or all), weights from seed 0 on the card; checks (a)-(c) and the timed
    prefill and decode.  Returns the main path's launch counts and the
    timings."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tt
    from repro_torch.models.params import cast_params, init_params

    cfg = get_config(arch).canonicalize(tp=1)
    if units is not None:
        cfg = dataclasses.replace(cfg, n_layers=units * len(cfg.pattern))
    prompt_len = WHISPER_PROMPT if cfg.enc_dec else LM_PROMPT
    t0 = time.perf_counter()
    master = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(master))
    log(f"{arch}: {cfg.n_layers} layers{' (cut to ' + str(units) + ' unit)' if units else ''}"
        f" + {cfg.enc_layers} encoder layers, d_model {cfg.d_model}, {n_params} parameters "
        f"(param_count {cfg.param_count()}, active {cfg.active_param_count()}), float32 master "
        f"made on the card in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(1)

    # (b) float32 compute: prefill(s) + decode(token s) == forward(s + 1).
    # An MoE block runs dropless here (capacity_factor = n_experts / top_k):
    # the GShard capacity makes which (token, expert) pairs overflow depend
    # on the batch's token count, so the two sides would differ by design.
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.moe is not None:
        cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    p32 = cast_params(master, cfg32)
    s = check_prompt
    batch = lm_inputs(cfg, LM_BATCH, s + 1, gen, dev)
    full, _ = tt.forward(p32, cfg32, batch)
    _, cache = tt.prefill(p32, cfg32, dict(batch, tokens=batch["tokens"][:, :s]), s_max=s + 8,
                          cache_dtype=torch.float32)
    dec, _ = tt.decode_step(p32, cfg32, cache, batch["tokens"][:, s:s + 1])
    torch.cuda.synchronize()
    e = max_abs_err(dec, full[:, -1])
    try:
        torch.testing.assert_close(dec, full[:, -1], **LM_F32_TOL)
    except AssertionError as exc:
        fail(f"{arch} f32 prefill({s}) + decode != forward({s + 1}): {exc}")
    log(f"{arch} (b) f32: prefill({s}) + decode == forward({s + 1}) at the last position, "
        f"max abs err {e:.3e} (tolerance {LM_F32_TOL}; logits up to "
        f"{float(full[:, -1].abs().max()):.3f})")
    del full, cache, dec, p32, batch

    params = cast_params(master, cfg)  # the bf16 compute copy, once
    del master
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{arch}: bf16 compute copy made; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    batch = lm_inputs(cfg, LM_BATCH, prompt_len, gen, dev)
    s_max = prompt_len + LM_DECODE + LM_PROFILE_STEPS + 1
    tt.prefill(params, cfg, dict(batch, tokens=batch["tokens"][:, :128]), s_max=160)  # warm-up
    torch.cuda.synchronize()

    # the main path: prefill, then greedy decode, counts read right after
    with captured_routing() as routes:
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = tt.prefill(params, cfg, batch, s_max=s_max)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_counts = read_counts()
    first = logits.clone()
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        logits, cache = tt.decode_step(params, cfg, cache, logits.argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / LM_DECODE
    counts = read_counts()
    if counts != prefill_counts:
        fail(f"{arch}: decode launched kernels: {prefill_counts} after prefill, {counts} after")
    vocab = cfg.vocab_padded or cfg.vocab_size
    if first.shape != (LM_BATCH, vocab) or first.dtype != torch.float32:
        fail(f"{arch} prefill logits {first.dtype}{tuple(first.shape)}")
    if not bool(torch.isfinite(first).all()) or not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: non-finite logits")
    if cache["t"] != prompt_len + LM_DECODE:
        fail(f"{arch}: cache t {cache['t']} after {LM_DECODE} decode steps")
    launched = {k: v for k, v in counts.items() if v}
    log(f"{arch} bf16 prefill B{LM_BATCH} x {prompt_len}"
        f"{' + ' + str(cfg.enc_seq) + ' encoder frames' if cfg.enc_dec else ''}: "
        f"{prefill_ms:.3f} ms, launches {launched}; {LM_DECODE} greedy decode steps "
        f"{decode_ms:.3f} ms/token (batch {LM_BATCH}) on {card_line()}")

    # (a) the same prefill with attention through the plain version
    with captured_routing() as plain_routes, fa.plain_version():
        want, _ = tt.prefill(params, cfg, batch, s_max=s_max)
    torch.cuda.synchronize()
    e = max_abs_err(first, want)
    scale = float(want.abs().max())
    agree = float((first.argmax(-1) == want.argmax(-1)).float().mean())
    route_note = ""
    if routes:
        differ, total = routing_flips(routes, plain_routes)
        route_note = (f"; {differ} of {total} expert choices differ between the two "
                      f"prefills")
    log(f"{arch} (a) prefill through the kernels vs the plain version: max abs err {e:.4f} "
        f"on logits up to {scale:.3f} (tolerance {LM_PLAIN_REL_TOL} x that); argmax agreement "
        f"{agree:.2f}{route_note}")
    if not e <= LM_PLAIN_REL_TOL * scale:
        fail(f"{arch}: prefill logits through the kernels differ from the plain version by {e}"
             f"{route_note}")
    del want, routes, plain_routes

    # (c) each attention call's live (q, k, v), captured in one more
    # prefill, through the kernel against the plain version computed in
    # float32 on the same inputs: the value the kernel's bf16 output rounds.
    # (Against the plain version's own bf16 rounding, two correct roundings
    # can sit one bf16 step apart, 0.03125 where |o| >= 4, above the atol.)
    with captured_attention() as seen:
        tt.prefill(params, cfg, batch, s_max=s_max)
    n_calls = sum(counts.values())
    if len(seen) != n_calls:
        fail(f"{arch}: captured {len(seen)} attention calls, the main path launched {n_calls}")
    worst, worst_call, worst_rounded = -1.0, -1, 0.0
    for i, (q, k, v, kw) in enumerate(seen):
        got = fa.flash_attention(q, k, v, **kw).float()
        with fa.plain_version():
            want = fa.flash_attention(q.float(), k.float(), v.float(), **kw)
            rounded = fa.flash_attention(q, k, v, **kw).float()
        try:
            torch.testing.assert_close(got, want, **BF16_TOL)
        except AssertionError as exc:
            fail(f"{arch} attention call {i} {tuple(q.shape)} x {tuple(k.shape)} {kw}: the "
                 f"kernel differs from the plain version on its live (q, k, v): {exc}")
        e = max_abs_err(got, want)
        worst_rounded = max(worst_rounded, max_abs_err(got, rounded))
        if e > worst:
            worst, worst_call = e, i
    shapes = sorted({(tuple(q.shape), tuple(k.shape), kw.get("causal"), kw.get("window"))
                     for q, k, v, kw in seen}, key=str)
    log(f"{arch} (c) {len(seen)} attention calls' live (q, k, v) through the kernel == the "
        f"plain version in float32, largest max abs err {worst:.3e} (call {worst_call}; "
        f"tolerance {BF16_TOL}); against the plain version's bf16 output {worst_rounded:.3e}; "
        f"(q, k, causal, window) {shapes}")
    # the path's attention calls timed one by one (CUDA events, 3 reps
    # after a warm-up), against the sum of their bounds
    if seen:
        attn_ms = sum(cuda_ms(lambda c=c: fa.flash_attention(c[0], c[1], c[2], **c[3]), 3)
                      for c in seen)
        attn_bound = sum(attention_bound(q, k, kw.get("causal", True), kw.get("window"))[0]
                         for q, k, v, kw in seen)
        log(f"{arch} attention: {len(seen)} calls {attn_ms:.3f} ms through the kernel, bound "
            f"{attn_bound:.4f} ms ({attn_ms / attn_bound:.1f} times) on {card_line()}")
    else:
        attn_ms = attn_bound = None
    del seen

    def report(what, wall_ms, fn, reps):
        busy, top = device_profile(fn, reps)
        if busy <= 0:
            log(f"{arch} {what} profile: device time not measured (the profiler saw no kernel)")
            return None
        idle = max(0.0, 1 - busy / wall_ms)
        log(f"{arch} {what} profile: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms (idle share "
            f"{idle:.3f}); top {top}")
        return idle

    prefill_idle = report("prefill", prefill_ms,
                          lambda: tt.prefill(params, cfg, batch, s_max=s_max), 1)
    state = {"logits": logits}

    def step():
        tok = state["logits"].argmax(-1, keepdim=True)
        state["logits"], _ = tt.decode_step(params, cfg, cache, tok)

    decode_idle = report(f"decode step (t {cache['t'] + 1}..{cache['t'] + LM_PROFILE_STEPS})",
                         decode_ms, step, LM_PROFILE_STEPS)
    del params, cache, logits, state, batch, first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts, dict(prefill_ms=prefill_ms, decode_ms=decode_ms, prefill_idle=prefill_idle,
                        decode_idle=decode_idle, attention_ms=attn_ms,
                        attention_bound_ms=attn_bound)


# ------------------------------------------------------------------ phase 19
def visible_pairs(sq, sk, causal, window) -> int:
    """Query-key pairs the mask leaves, per (batch, head)."""
    pairs = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def flash_bwd_bound(q, k, causal, window):
    """Least time of one attention backward on an H100: the larger of its
    FLOPs (five products of 2 D per visible pair and head: Q K^T again,
    dO V^T, P^T dO, dS K and dS^T Q) over the peak rate of its dtype and its
    bytes (q, k, v, o and do read once, dq, dk and dv written once) over HBM
    bandwidth."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    flops = 5 * 2 * d * visible_pairs(sq, sk, causal, window) * b * hq
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * sk * d) * q.element_size()
    peak = PEAK_F32_FLOPS if q.element_size() == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    detail = f"{flops:.4e} flops, {nbytes} bytes"
    if t_ops >= t_bytes:
        return t_ops, "operations", detail, flops
    return t_bytes, "bytes", detail, flops


def requested_bytes() -> int:
    """Bytes requested of PyTorch's CUDA allocator so far, exactly as asked
    (not rounded to its blocks)."""
    import torch

    return torch.cuda.memory_stats()["requested_bytes.all.allocated"]


def flash_bwd_phase(dev):
    """(a): the backward kernels against the plain backward on every case
    of ``FLASH_BWD_CASES``, in the variant ``bwd_variant`` picks (where that
    is wgmma: given the forward's saved logsumexp, then without it, then
    forced onto the CUDA cores), two launches the same bits; the wgmma
    variant writes each gradient in its operand's layout and requests no
    memory but its outputs and scratch (no copy of an operand).  Then, in
    alternating turns at qwen3-4b's shape: both variants, the wgmma one on
    the views too, the forward with and without its logsumexp, the plain
    backward, beside SDPA's backward and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {}
    max_err = 0.0
    timed = {}
    for label, b, hq, hkv, sq, sk, d, dt, causal, window, views in FLASH_BWD_CASES:
        dtype = getattr(torch, dt)
        shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))
        if views:  # (b, s, h, d) tensors seen as (b, h, s, d)
            q, k, v, do = (torch.randn((n, s_, h, d_), generator=gen, device=dev)
                           .to(dtype).transpose(1, 2) for n, h, s_, d_ in shapes)
        else:
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                           for shape in shapes)
        kw = dict(causal=causal, window=window)
        chosen = fab.bwd_variant(dtype, d)
        if chosen == "wgmma":  # the forward kernel's output and saved logsumexp
            o, lse = fa.flash_attention_wgmma(q, k, v, with_lse=True, **kw)
            variants = (("wgmma", lse), ("wgmma without lse", None), ("cuda_core", None))
        else:
            o, lse = fa.flash_attention(q, k, v, **kw), None
            variants = (("cuda_core", None),)
        want = fab.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        for name, given in variants:
            variant = "cuda_core" if name == "cuda_core" else "auto"
            before, base = fab.LAUNCHES["flash_attention_bwd"], requested_bytes()
            got = fab.flash_attention_bwd_cuda(q, k, v, o, do, lse=given, variant=variant, **kw)
            grown = requested_bytes() - base
            again = fab.flash_attention_bwd_cuda(q, k, v, o, do, lse=given, variant=variant, **kw)
            torch.cuda.synchronize()
            if fab.LAUNCHES["flash_attention_bwd"] != before + 2:
                fail(f"flash backward {label} ({name}): "
                     f"{fab.LAUNCHES['flash_attention_bwd'] - before} launches for 2 calls")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"flash backward {label} ({name}): two launches differ")
            if name == "wgmma":
                if [g.stride() for g in got] != [x.stride() for x in (q, k, v)]:
                    fail(f"flash backward {label}: gradient strides "
                         f"{[g.stride() for g in got]}, operands' {[x.stride() for x in (q, k, v)]}")
                sq_pad = -(-sq // fab.SQ_ALIGN) * fab.SQ_ALIGN  # lse2 and Delta
                allowed = sum(g.numel() * 2 for g in got) + 2 * b * hq * sq_pad * 4
                if grown != allowed:
                    fail(f"flash backward {label}: {grown} bytes requested, its outputs and "
                         f"scratch take {allowed}: an operand was copied")
            rels = []
            for grad, g, w in zip(("dq", "dk", "dv"), got, want):
                if g.dtype != dtype or g.shape != w.shape:
                    fail(f"flash backward {label} ({name}) {grad}: {g.dtype}{tuple(g.shape)}")
                e = max_abs_err(g, w)
                ref = float(w.float().abs().max())
                rels.append(e / ref if ref > 0 else e)
                if name == chosen:
                    max_err = max(max_err, e)
            if max(rels) > FLASH_BWD_REL_TOL[dt]:
                fail(f"flash backward {label} ({name}): max |err| / max |ref| (dq, dk, dv) "
                     f"{rels} above {FLASH_BWD_REL_TOL[dt]}")
            if label.startswith("rows that see no key"):
                blind = torch.arange(sq, device=dev) - window + 1 >= sk
                if not blind.any() or (got[0][:, :, blind] != 0).any():
                    fail(f"flash backward ({name}): a row that sees no key has a gradient")
            key = f"{dt} {name.split()[0]}"
            worst[key] = max(worst.get(key, 0.0), max(rels))
            log(f"flash backward == plain: {label} ({dt}, {name}): max |err| / max |ref| (dq, "
                f"dk, dv) {[f'{r:.3e}' for r in rels]}, two launches the same bits"
                + (f", {grown} bytes requested (outputs and scratch)" if name == "wgmma" else ""))
        if label.startswith("qwen3-4b") and dt == "bfloat16":
            timed[views] = (q, k, v, o, do, lse)
        del q, k, v, o, do, lse, got, again, want
    log(f"flash backward: worst max |err| / max |ref| {', '.join(f'{k} {v:.3e}' for k, v in worst.items())} "
        f"(tolerances {FLASH_BWD_REL_TOL})")

    (q, k, v, o, do, lse), (qv, kv_, vv, ov, dov, lsev) = timed[False], timed[True]
    kw = dict(causal=True, window=None)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)

    fns = {
        "wgmma": (lambda: fab.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw), 10),
        "wgmma views": (lambda: fab.flash_attention_bwd_cuda(qv, kv_, vv, ov, dov, lse=lsev,
                                                             **kw), 10),
        "cuda_core": (lambda: fab.flash_attention_bwd_cuda(q, k, v, o, do, variant="cuda_core",
                                                           **kw), 3),
        "forward with lse": (lambda: fa.flash_attention_wgmma(q, k, v, with_lse=True, **kw), 10),
        "forward": (lambda: fa.flash_attention_wgmma(q, k, v, **kw), 10),
        "sdpa forward": (sdpa, 10),
        "sdpa forward and backward": (lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do), 10),
        "plain": (lambda: fab.flash_attention_bwd_plain(q, k, v, o, do, **kw), 2),
    }
    turns = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        fn, reps = fns[name]
        turns[name].append(cuda_ms(fn, reps))
    t = {name: sum(v) / len(v) for name, v in turns.items()}
    # the wgmma variant's three kernels by torch.profiler
    from torch.profiler import ProfilerActivity, profile

    fab.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fab.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
        torch.cuda.synchronize()
    split = {name: named_device_us(prof, name)[0] / 5 / 1e3
             for name in ("bwd_prep_wgmma", "bwd_dkdv_wgmma", "bwd_dq_wgmma")}
    if not any(split.values()):  # the window recorded no kernel of these names
        split = None
    log(f"flash backward wgmma kernels at qwen3-4b's shape (torch.profiler, 5 calls): "
        f"{'not measured' if split is None else {k_: round(v_, 4) for k_, v_ in split.items()}}"
        f" ms a call; top {device_top(prof, 4)}")
    library_ms = t["sdpa forward and backward"] - t["sdpa forward"]
    bound_ms, bound_by, detail, flops = flash_bwd_bound(q, k, True, None)
    fwd_bound_ms = attention_bound(q, k, True, None)[0]
    card = card_line()
    for name in ("wgmma", "wgmma views", "cuda_core", "plain"):
        log(f"flash backward {name} at qwen3-4b's shape (B 2, Hq 32, Hkv 8, S 2048, D 128, bf16, "
            f"causal): {t[name]:.4f} ms (turns {[round(x, 4) for x in turns[name]]}), / bound "
            f"{t[name] / bound_ms:.2f}, / sdpa backward {t[name] / library_ms:.2f}; "
            f"{flops / t[name] / 1e9:.1f} TFLOP/s of the bound's flops on {card}")
    for name in ("forward with lse", "forward"):
        log(f"flash {name} at the same shape: {t[name]:.4f} ms (turns "
            f"{[round(x, 4) for x in turns[name]]}), / bound {t[name] / fwd_bound_ms:.2f}, / sdpa "
            f"forward {t[name] / t['sdpa forward']:.2f} on {card}")
    log(f"flash backward bound {bound_ms:.4f} ms ({bound_by}; {detail}); sdpa backward "
        f"{library_ms:.4f} ms (forward and backward {t['sdpa forward and backward']:.4f}, forward "
        f"{t['sdpa forward']:.4f}); forward with lse / without {t['forward with lse'] / t['forward']:.4f}")
    del q, k, v, o, do, lse, qv, kv_, vv, ov, dov, lsev, qg, kg, vg, timed
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=t["wgmma"], turns_ms=turns["wgmma"],
                views_ms=t["wgmma views"], cuda_core_ms=t["cuda_core"],
                cuda_core_turns_ms=turns["cuda_core"], plain_ms=t["plain"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                sdpa_fwd_bwd_ms=t["sdpa forward and backward"], sdpa_fwd_ms=t["sdpa forward"],
                forward_lse_ms=t["forward with lse"], forward_ms=t["forward"],
                forward_lse_turns_ms=turns["forward with lse"], forward_turns_ms=turns["forward"],
                kernels_ms=split, worst_rel_err=worst)


def train_reduced_phase(dev):
    """(b): reduced configs in float32 compute, two AdamW steps on the card
    against the same two on the CPU, from the same seeded weights and
    batches: loss and grad norm at ``rtol=1e-4``, parameters at ``atol = 2
    lr_t`` plus ``rtol=1e-5`` (tests/test_torch_train.py's reason: AdamW's
    first step turns a gradient near 0 into about +-1)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.train import optim as topt
    from repro_torch.train.steps import make_train_step

    for arch in TRAIN_REDUCED:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  compute_dtype="float32").canonicalize(tp=1)
        master = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        opt_cfg = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
        rng = np.random.default_rng(0)
        toks = [rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32) for _ in range(2)]
        runs = {}
        for where in ("cpu", dev):
            params = topt.tree_map(lambda p: p.to(where, copy=True), master)
            state = topt.init_opt_state(params, opt_cfg)
            step = make_train_step(cfg, opt_cfg, mamba_chunk=8)
            rows = []
            for t in toks:
                t = torch.from_numpy(t).to(where)
                params, state, m = step(params, state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
                rows.append({k: float(v) for k, v in m.items()})
            runs[where] = (rows, topt.tree_items(params))
        worst = 0.0
        for (cm, gm) in zip(runs["cpu"][0], runs[dev][0]):
            for key in ("loss", "grad_norm", "lr"):
                if not np.isclose(gm[key], cm[key], rtol=1e-4, atol=0):
                    fail(f"train {arch} (reduced, float32): {key} on the card {gm[key]} against "
                         f"{cm[key]} on the CPU")
        lr = runs["cpu"][0][-1]["lr"]
        for (path, a), (_, b) in zip(runs["cpu"][1], runs[dev][1]):
            b = b.cpu()
            try:
                torch.testing.assert_close(b, a, atol=2 * lr, rtol=1e-5)
            except AssertionError as exc:
                fail(f"train {arch} (reduced, float32): parameter {path}: {exc}")
            worst = max(worst, max_abs_err(b, a) / lr)
        log(f"train {arch} (reduced, float32): two steps on the card == on the CPU: losses "
            f"{[round(r['loss'], 6) for r in runs[dev][0]]} (CPU "
            f"{[round(r['loss'], 6) for r in runs['cpu'][0]]}), parameters within "
            f"{worst:.3f} lr_t")


def train_step1_check(opts):
    """(c), before the main run: step 1's loss and gradients through the
    kernels against the same through ``plain_version()``, from the run's
    seeded weights and its first batch."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as tl
    from repro_torch.train import optim as topt
    from repro_torch.train.steps import _grads

    cfg, pipe, workload, params = tl.prepare(opts)
    batch = next(pipe.batches(workload, 1))
    loss, grads = _grads(params, cfg, batch, 32)
    with fa.plain_version():
        ploss, pgrads = _grads(params, cfg, batch, 32)
    torch.cuda.synchronize()
    loss, ploss = float(loss), float(ploss)
    if abs(loss - ploss) > TRAIN_PLAIN_LOSS_RTOL * abs(ploss):
        fail(f"train step 1: loss {loss} through the kernels, {ploss} through the plain version")
    rel = {}
    for (path, g), (_, w) in zip(topt.tree_items(grads), topt.tree_items(pgrads)):
        wn = float(w.float().norm())
        rel[path] = float((g.float() - w.float()).norm()) / wn if wn > 0 else float(g.norm())
    worst = max(rel, key=rel.get)
    if rel[worst] > TRAIN_PLAIN_GRAD_REL:
        fail(f"train step 1: gradient {worst} {rel[worst]:.3e} apart (relative L2) through the "
             f"kernels and the plain version")
    log(f"train step 1 through the kernels == plain_version(): loss {loss:.6f} against "
        f"{ploss:.6f}, worst gradient leaf {worst} at {rel[worst]:.3e} relative L2 "
        f"(tolerances {TRAIN_PLAIN_LOSS_RTOL}, {TRAIN_PLAIN_GRAD_REL})")
    del params, grads, pgrads, pipe
    torch.cuda.empty_cache()
    return dict(loss=loss, plain_loss=ploss, worst_grad_rel=rel[worst], worst_grad_leaf=worst)


def train_phase(dev):
    """(c): the main path ``train`` (see the module docstring).  Returns its
    launch counts and its measurements."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train as tl
    from repro_torch.models import transformer as tt
    from repro_torch.train import optim as topt
    from repro_torch.train.steps import make_train_step

    opts = tl.TrainOptions(arch="qwen3-4b", units=TRAIN_UNITS, steps=TRAIN_STEPS,
                           batch_docs=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                           warmup_steps=TRAIN_WARMUP, n_docs=TRAIN_DOCS,
                           ckpt_every=TRAIN_CKPT_AT, device=dev)
    measured = {"step1_vs_plain": train_step1_check(opts)}
    ckpt = tempfile.mkdtemp(prefix="_train_ckpt_", dir=HERE)
    try:
        kept = {}

        def on_step(step, params, opt_state, row):
            if step == TRAIN_CKPT_AT:  # the uninterrupted step 4
                kept["params"] = [p.clone() for p in topt.tree_leaves(params)]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run = tl.train(dataclasses.replace(opts, ckpt_dir=ckpt), on_step=on_step, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        metrics, cfg = run.metrics, run.cfg
        final = topt.tree_leaves(run.params)
        n_params = sum(p.numel() for p in final)
        losses = [m["loss"] for m in metrics]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            fail(f"train: losses {losses} do not fall")
        log(f"train qwen3-4b ({cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} "
            f"parameters, B {TRAIN_BATCH} x S {TRAIN_SEQ}): {TRAIN_STEPS} steps in {wall:.3f} s "
            f"with the pipeline and a checkpoint; losses {[round(x, 4) for x in losses]}, grad "
            f"norms {[round(m['grad_norm'], 4) for m in metrics]}, step seconds "
            f"{[round(m['seconds'], 4) for m in metrics]}; peak memory {peak_gb:.2f} GB; "
            f"cleaning progress {run.pipe.cleaning_progress()}")
        del run
        torch.cuda.empty_cache()

        # the same run restored from its step-3 checkpoint: steps 4 and 5
        # must be the uninterrupted ones, bit for bit
        diffs = {}

        def compare(step, params, opt_state, row):
            if step == TRAIN_CKPT_AT:
                for (path, a), b in zip(topt.tree_items(params), kept.pop("params")):
                    diffs[path] = max_abs_err(a, b)

        t0 = time.perf_counter()
        resumed = tl.train(dataclasses.replace(opts, ckpt_dir=ckpt), on_step=compare, log=log)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        if resumed.start != TRAIN_CKPT_AT or len(resumed.metrics) != TRAIN_STEPS - TRAIN_CKPT_AT:
            fail(f"train resume: restored at {resumed.start}, ran {len(resumed.metrics)} steps")
        for (path, a), b in zip(topt.tree_items(resumed.params), final):
            diffs[f"{path} (step {TRAIN_STEPS})"] = max_abs_err(a, b)
        del final
        worst = max(diffs, key=diffs.get)
        for got, want in zip(resumed.metrics, metrics[TRAIN_CKPT_AT:]):
            if got["loss"] != want["loss"] or got["lr"] != want["lr"]:
                fail(f"train resume: step {got['step'] + 1} loss {got['loss']} lr {got['lr']} "
                     f"against {want['loss']}, {want['lr']} uninterrupted: the forward differs")
            if got["grad_norm"] != want["grad_norm"]:
                fail(f"train resume: step {got['step'] + 1} grad norm {got['grad_norm']} against "
                     f"{want['grad_norm']}: the backward differs")
        if diffs[worst] != 0:
            fail(f"train resume: largest parameter difference {diffs[worst]} at {worst}: the "
                 "update differs")
        log(f"train resume: restored step {TRAIN_CKPT_AT} and ran steps {TRAIN_CKPT_AT + 1}-"
            f"{TRAIN_STEPS} in {resume_s:.3f} s (init, restore, {TRAIN_CKPT_AT} replayed requests, "
            f"{TRAIN_STEPS - TRAIN_CKPT_AT} steps); each == the uninterrupted step: losses "
            f"{[m['loss'] for m in resumed.metrics]}, grad norms "
            f"{[m['grad_norm'] for m in resumed.metrics]}, largest parameter difference "
            f"{diffs[worst]}")

        # one step split into forward, backward and optimizer, and profiled
        params, opt_state = resumed.params, resumed.opt_state
        opt_cfg = topt.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
        gen = torch.Generator(device=dev).manual_seed(3)
        toks = torch.randint(0, min(cfg.vocab_size, 1024), (TRAIN_BATCH, TRAIN_SEQ + 1),
                             generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        split = []
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            tracked = topt.tree_map(lambda p: p.detach().requires_grad_(), params)
            ev[0].record()
            loss, _ = tt.loss_fn(tracked, cfg, batch, mamba_chunk=32)
            ev[1].record()
            grads = torch.autograd.grad(loss, topt.tree_leaves(tracked))
            ev[2].record()
            topt.apply_updates(params, topt.tree_unflatten(params, grads), opt_state, opt_cfg)
            ev[3].record()
            torch.cuda.synchronize()
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
            del tracked, loss, grads
        fwd_ms, bwd_ms, opt_ms = split[-1]
        step_fn = make_train_step(cfg, opt_cfg, mamba_chunk=32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        busy, top = device_profile(lambda: step_fn(params, opt_state, batch), 1)
        idle = max(0.0, 1 - busy / step_ms) if busy > 0 else None
        log(f"train step split (CUDA events): forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, "
            f"optimizer {opt_ms:.3f} ms; one step {step_ms:.3f} ms, kernels busy {busy:.3f} ms "
            f"(idle share {'not measured' if idle is None else f'{idle:.3f}'}); top {top} on "
            f"{card_line()}")
        measured.update(
            losses=losses, grad_norms=[m["grad_norm"] for m in metrics],
            step_s=[m["seconds"] for m in metrics], wall_s=wall, peak_memory_gb=peak_gb,
            resume_s=resume_s, forward_ms=fwd_ms, backward_ms=bwd_ms, optimizer_ms=opt_ms,
            step_ms=step_ms, kernel_busy_ms=busy, idle_share=idle, n_params=n_params)
        del resumed, params, opt_state, step_fn
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts, measured


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
    names = ("dc_pairs", "flash_attention", "flash_attention_wgmma", "flash_attention_bwd",
             "semijoin")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(lambda n: build.build_library(n, verbose_ptxas=True), names))
    log(f"built {[os.path.relpath(p, HERE) for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in build.BUILD_LOG[name]["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")
    # every instantiation of the DC scan kernel, of the wgmma flash kernel
    # (its lse a runtime argument) and of the backward's three kernels (3
    # widths x 2 dtypes on the CUDA cores, 2 widths on wgmma), without a
    # spill, and every setmaxnreg honoured
    for name, n_inst in (("dc_pairs", 10), ("flash_attention_wgmma", 3),
                         ("flash_attention_bwd", 24)):
        ptxas = build.BUILD_LOG[name]["ptxas"]
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ptxas)
        if len(spills) < n_inst or any(int(a) or int(b) for a, b in spills):
            fail(f"{name}.cu: {len(spills)} instantiations, spills {spills}")
        if "setmaxnreg ignored" in ptxas:
            fail(f"{name}.cu: ptxas ignored a setmaxnreg")
    entries = re.findall(r"Compiling entry function '(\w+)'", build.BUILD_LOG["flash_attention_bwd"]["ptxas"])
    for kernel in ("bwd_prep_wgmma", "bwd_dkdv_wgmma", "bwd_dq_wgmma"):
        if sum(kernel in e for e in entries) != 2:
            fail(f"flash_attention_bwd.cu: {kernel} not built at D 64 and 128 ({entries})")

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
    paths["dist"], dist_err, dc_measured["sharded"] = dist_phase(dev)
    dc_measured["max_abs_err"] = max(dc_measured["max_abs_err"], dist_err)
    paths["lm"], cfg, params = lm_phase(dev)
    drive("engine", lambda: engine_phase(dev, cfg, params))
    del params
    torch.cuda.empty_cache()
    archs_phase(dev)
    full_width = {}
    for path, arch, units, check_prompt in FULL_WIDTH:
        paths[path], full_width[arch] = full_width_phase(dev, arch, units, check_prompt)
    log(f"full-width LM timings on {card_line()}: {json.dumps(full_width)}")
    bwd_measured = flash_bwd_phase(dev)
    train_reduced_phase(dev)
    paths["train"], train_measured = train_phase(dev)
    bwd_measured["train"] = train_measured
    for path, counts in paths.items():
        log(f"{path} path launches: {counts}")
        for kernel, n in counts.items():
            want = PATH_LAUNCHES[path].get(kernel, 0)
            if (n <= 0) if want is None else (n != want):
                fail(f"the {path} path launched {kernel} {n} times, expected "
                     f"{'at least one' if want is None else want}")
    measured = {"dc_pair_scan": dc_measured, **flash_measured,
                "dc_role_scan": role_measured, "semijoin": semijoin_measured,
                "flash_attention_bwd": bwd_measured}
    where = {
        "dc_pair_scan": ("dc_pairs.cu", "dc_pairs.py:445"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:101"),
        "flash_attention_wgmma": ("flash_attention_wgmma.cu", "flash_attention.py:101"),
        "dc_role_scan": ("dc_pairs.cu", "dc_pairs.py:238"),
        "semijoin": ("semijoin.cu", "semijoin.py:32"),
        # the gradient of flash_attention_pallas's function, which the
        # reference takes by autodiff of its plain route
        "flash_attention_bwd": ("flash_attention_bwd.cu", "flash_attention.py:101"),
    }
    records = [
        dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
             replaces=f"src/repro/kernels/{tpu}",
             launches=sum(counts.get(name, 0) for counts in paths.values()),
             path_launches={path: counts.get(name, 0) for path, counts in paths.items()},
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
