#!/usr/bin/env python3
"""Hold candidate builds of the wgmma flash kernel against the plain version
on gemma3-12b's live attention calls, and time them, in one process on one
GPU.

    python3 tools/flash_candidates.py [--out FILE] [--turns 2] [--reps 5]

Each candidate is ``src/repro_torch/csrc/flash_attention_wgmma.cu`` with a
few text edits (``CANDIDATES``); "p_hi and p_lo" feeds the P V product at
head dim 256 both bf16 parts of p, as at 64 and 128, where the committed
kernel feeds the high part alone.  Every build is made with ``nvcc`` at
once (``ptxas -v`` logged) into a directory of its own.  gemma3-12b at its
published widths cut to one pattern unit (``chip_smoke.py``'s ``lm_gemma3``
path: 5 local layers with window 1,024 and 1 global layer, head dim 256),
weights from seed 0, runs one bf16 prefill of B 2 x 2,048 tokens under
``chip_smoke.captured_attention``; each candidate then takes every captured
call's (q, k, v), is held against the plain version in float32 at the bf16
``atol=3e-2`` (phase 18's check (c)), and the 6 calls are timed in
alternating turns by CUDA events.  Prints one JSON object and writes it to
``--out``; exits 1 if the committed build fails the check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (old text, new text) edits of csrc/flash_attention_wgmma.cu
CANDIDATES = {
    "committed": [],
    "p_hi and p_lo": [("constexpr bool kPLo = D != 256;", "constexpr bool kPLo = true;")],
}


def use_library(fa, build, path) -> None:
    """Make ``fa`` launch the wgmma kernel of the library at ``path``."""
    keep = build.build_library
    build.build_library = lambda name, verbose_ptxas=False: path
    try:
        fa._wg_lib = None
        fa._wgmma_library()
    finally:
        build.build_library = keep


def gemma3_calls(cs, dev):
    """The live (q, k, v, keywords) of one gemma3-12b unit's bf16 prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.params import cast_params, init_params

    cfg = get_config("gemma3-12b").canonicalize(tp=1)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    params = cast_params(init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = cs.lm_inputs(cfg, cs.LM_BATCH, cs.LM_PROMPT, gen, dev)
    with cs.captured_attention() as seen:
        tt.prefill(params, cfg, batch, s_max=cs.LM_PROMPT + 8)
    torch.cuda.synchronize()
    return list(seen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON result here too")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    if not torch.cuda.is_available():
        print("flash_candidates: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    dev = "cuda"
    calls = gemma3_calls(cs, dev)
    with fa.plain_version():
        wants = [fa.flash_attention(q.float(), k.float(), v.float(), **kw)
                 for q, k, v, kw in calls]
    source = (build.CSRC / "flash_attention_wgmma.cu").read_text()
    headers = {h.name: h.read_text() for h in build.CSRC.glob("*.cuh")}  # what it includes
    names = list(CANDIDATES)
    result = {"card": cs.card_line(), "calls": [
        [list(q.shape), list(k.shape), kw.get("causal"), kw.get("window")]
        for q, k, v, kw in calls], "candidates": {}}
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
            (build.CSRC / f"flash_attention_wgmma_{i}.cu").write_text(text)
        with ThreadPoolExecutor(len(names)) as pool:
            libs = list(pool.map(
                lambda i: build.build_library(f"flash_attention_wgmma_{i}", True),
                range(len(names))))
        for i, name in enumerate(names):
            use_library(fa, build, libs[i])
            ptxas = [ln.strip() for ln in
                     build.BUILD_LOG[f"flash_attention_wgmma_{i}"]["ptxas"].splitlines()
                     if "registers" in ln or "spill" in ln]
            errs = []
            for (q, k, v, kw), want in zip(calls, wants):
                got = fa.flash_attention_wgmma(q, k, v, **kw).float()
                errs.append(cs.max_abs_err(got, want))
            worst = max(errs)
            result["candidates"][name] = {
                "ptxas": ptxas, "max_abs_err": errs, "passes": worst <= cs.BF16_TOL["atol"],
            }
            print(f"{name}: worst max abs err {worst:.3e} over {len(calls)} calls "
                  f"(tolerance {cs.BF16_TOL['atol']})", flush=True)
        for turn in range(args.turns):
            for i in (range(len(names)) if turn % 2 == 0 else reversed(range(len(names)))):
                use_library(fa, build, libs[i])
                ms = sum(cs.cuda_ms(lambda c=c: fa.flash_attention_wgmma(c[0], c[1], c[2], **c[3]),
                                    args.reps) for c in calls)
                result["candidates"][names[i]].setdefault("calls_ms", []).append(ms)
    bound = sum(cs.attention_bound(q, k, kw.get("causal", True), kw.get("window"))[0]
                for q, k, v, kw in calls)
    result["bound_ms"] = bound
    for name, rec in result["candidates"].items():
        print(f"{name}: {len(calls)} calls {rec['calls_ms']} ms (bound {bound:.4f} ms), "
              f"passes check (c): {rec['passes']}", flush=True)
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0 if result["candidates"]["committed"]["passes"] else 1


if __name__ == "__main__":
    sys.exit(main())
