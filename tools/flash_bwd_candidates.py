#!/usr/bin/env python3
"""Hold candidate builds of the flash backward's wgmma variant against the
plain backward, and time them, in one process on one GPU.

    python3 tools/flash_bwd_candidates.py [--out FILE] [--turns 4] [--reps 20]

Each candidate is ``src/repro_torch/csrc/flash_attention_bwd.cu`` with a
few text edits (``CANDIDATES``): "64-key dQ tiles" streams K and V to the
dQ kernel 64 keys at a time (the committed build takes 128), "three
stages, 64-key dQ tiles" also deepens both kernels' ring of streamed tiles
from two to three.
Every build is made with ``nvcc`` at once (``ptxas -v`` logged) into a
directory of its own.  Each candidate takes every bf16 case of
``chip_smoke.py``'s ``FLASH_BWD_CASES`` at head dim 64 or 128 (the wgmma
variant's; the (b, s, h, d) views where the case says so), given the wgmma forward's saved logsumexp, and is held against
``flash_attention_bwd_plain`` at phase 19's tolerance (max |err| <= 2e-2 x
max |ref| for each gradient) with two launches the same bits; then all are
timed in alternating turns by CUDA events at qwen3-4b's training shape
(B 2, Hq 32, Hkv 8, S 2,048, D 128, causal), and each one's three kernels
by ``torch.profiler``.  Prints one JSON object and writes it to ``--out``;
exits 1 if the committed build fails the check.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (old text, new text) edits of csrc/flash_attention_bwd.cu
CANDIDATES = {
    "committed": [],
    "64-key dQ tiles": [("constexpr int KT_ROWS = 128;", "constexpr int KT_ROWS = 64;")],
    # three stages of 128-key dQ tiles do not fit a block's shared memory
    "three stages, 64-key dQ tiles": [
        ("constexpr int WG_STAGES = 2;", "constexpr int WG_STAGES = 3;"),
        ("constexpr int KT_ROWS = 128;", "constexpr int KT_ROWS = 64;")],
}
KERNELS = ("bwd_prep_wgmma", "bwd_dkdv_wgmma", "bwd_dq_wgmma")


def use_library(fab, build, path) -> None:
    """Make ``fab`` launch the backward kernels of the library at ``path``."""
    keep = build.build_library
    build.build_library = lambda name, verbose_ptxas=False: path
    try:
        fab._bwd_lib = None
        fab._bwd_library()
    finally:
        build.build_library = keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON result here too")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("flash_bwd_candidates: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for label, b, hq, hkv, sq, sk, d, dt, causal, window, views in cs.FLASH_BWD_CASES:
        if dt != "bfloat16" or fab.bwd_variant(torch.bfloat16, d) != "wgmma":
            continue
        # with views, (b, s, h, d) tensors seen as (b, h, s, d), as phase 19 makes them
        q, k, v, do = (torch.randn((n, s_, h, d_) if views else (n, h, s_, d_), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for n, h, s_, d_ in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                                            (b, hq, sq, d)))
        if views:
            q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_wgmma(q, k, v, with_lse=True, **kw)
        want = fab.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        cases.append((label, (q, k, v, o, do), dict(lse=lse, **kw), want))
    timed = next(c for c in cases if c[0] == "qwen3-4b")

    source = (build.CSRC / "flash_attention_bwd.cu").read_text()
    headers = {h.name: h.read_text() for h in build.CSRC.glob("*.cuh")}  # what it includes
    names = list(CANDIDATES)
    result = {"card": cs.card_line(), "cases": [c[0] for c in cases], "candidates": {}}
    with tempfile.TemporaryDirectory() as tmp:
        build.CSRC = build.pathlib.Path(tmp)
        build.BUILD_DIR = build.CSRC / "_build"
        for name, text in headers.items():
            (build.CSRC / name).write_text(text)
        for i, name in enumerate(names):
            text = source
            for old, new in CANDIDATES[name]:
                if text.count(old) != 1:
                    raise SystemExit(f"candidate {name!r}: {old!r} is not in the source once")
                text = text.replace(old, new)
            (build.CSRC / f"flash_attention_bwd_{i}.cu").write_text(text)
        with ThreadPoolExecutor(len(names)) as pool:
            libs = list(pool.map(lambda i: build.build_library(f"flash_attention_bwd_{i}", True),
                                 range(len(names))))
        for i, name in enumerate(names):
            use_library(fab, build, libs[i])
            log = build.BUILD_LOG[f"flash_attention_bwd_{i}"]["ptxas"]
            spills = [m for m in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                            log) if m != ("0", "0")]
            rels, same = {}, True
            for label, ops, kw, want in cases:
                got = fab.flash_attention_bwd_cuda(*ops, **kw)
                again = fab.flash_attention_bwd_cuda(*ops, **kw)
                same = same and all(torch.equal(x, y) for x, y in zip(got, again))
                rels[label] = [cs.max_abs_err(g, w) / float(w.float().abs().max())
                               for g, w in zip(got, want)]
            worst = max(max(r) for r in rels.values())
            result["candidates"][name] = {
                "spills": spills, "setmaxnreg_ignored": "setmaxnreg ignored" in log,
                "rel_err": rels, "same_bits": same,
                "passes": worst <= cs.FLASH_BWD_REL_TOL["bfloat16"] and same and not spills,
            }
            print(f"{name}: worst max |err| / max |ref| {worst:.3e} over {len(cases)} cases "
                  f"(tolerance {cs.FLASH_BWD_REL_TOL['bfloat16']}), two launches the same bits "
                  f"{same}", flush=True)
        _, ops, kw, _ = timed
        for turn in range(args.turns):
            for i in (range(len(names)) if turn % 2 == 0 else reversed(range(len(names)))):
                use_library(fab, build, libs[i])
                ms = cs.cuda_ms(lambda: fab.flash_attention_bwd_cuda(*ops, **kw), args.reps)
                result["candidates"][names[i]].setdefault("ms", []).append(ms)
        for i, name in enumerate(names):
            use_library(fab, build, libs[i])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fab.flash_attention_bwd_cuda(*ops, **kw)
                torch.cuda.synchronize()
            result["candidates"][name]["kernels_ms"] = {
                k: cs.named_device_us(prof, k)[0] / 5 / 1e3 for k in KERNELS}
    result["bound_ms"] = cs.flash_bwd_bound(ops[0], ops[1], True, None)[0]
    for name, rec in result["candidates"].items():
        print(f"{name}: {sum(rec['ms']) / len(rec['ms']):.4f} ms (turns "
              f"{[round(t, 4) for t in rec['ms']]}; bound {result['bound_ms']:.4f} ms), kernels "
              f"{ {k: round(v, 4) for k, v in rec['kernels_ms'].items()} } ms, passes "
              f"{rec['passes']}", flush=True)
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0 if result["candidates"]["committed"]["passes"] else 1


if __name__ == "__main__":
    sys.exit(main())
