#!/usr/bin/env python3
"""Time candidate builds of the DC scan kernel against the committed one,
in one process on one GPU.

    python3 tools/dc_scan_candidates.py [--out FILE] [--turns 2] [--reps 5]

Each candidate is ``src/repro_torch/csrc/dc_pairs.cu`` with a few text
edits (``CANDIDATES``): another number of rows a thread holds, another
chunking target, the hold test left to the compiler, or no separate code
for tiles whose partners are all in scope.  Every build is made with
``nvcc`` at once (``ptxas -v`` logged) into a directory of its own, must
pass every case of ``kernels/dc_scan_check.py`` for both scans, and is
timed on that module's timing case (fig12's price/discount DC at
n = 131,072 on the full worklist) in alternating turns: the call by CUDA
events, the kernel alone by ``torch.profiler``.  Prints one JSON object
and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (old text, new text) edits of csrc/dc_pairs.cu
CANDIDATES = {
    "committed": [],
    "no all-in-scope tiles": [
        ("  else if (all) role_tile<N, R, V, kSplit, false, true>(st, buf, vbuf, len4, pbase, loc);\n",
         ""),
    ],
    "4 waves": [("#define DC_WAVES 16", "#define DC_WAVES 4")],
    "hold test in C++": [("if constexpr (N <= 4 && !kSplit && !kDiag) {", "if constexpr (false) {")],
    "rows 8/4": [("#define DC_ROWS_FEW 4", "#define DC_ROWS_FEW 8"),
                 ("#define DC_ROWS_MANY 2", "#define DC_ROWS_MANY 4")],
    "rows 2/2": [("#define DC_ROWS_FEW 4", "#define DC_ROWS_FEW 2")],
}


def use_library(dc_pairs, build, path) -> None:
    """Make ``dc_pairs`` launch the kernels of the library at ``path``."""
    keep = build.build_library
    build.build_library = lambda name, verbose_ptxas=False: path
    try:
        dc_pairs._lib = None
        dc_pairs._library()
    finally:
        build.build_library = keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON result here too")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    if not torch.cuda.is_available():
        print("dc_scan_candidates: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, dc_pairs
    from repro_torch.kernels import dc_scan_check as dsc

    source = (build.CSRC / "dc_pairs.cu").read_text()
    names = list(CANDIDATES)
    with tempfile.TemporaryDirectory() as tmp:
        build.CSRC = build.pathlib.Path(tmp)
        build.BUILD_DIR = build.CSRC / "_build"
        for i, name in enumerate(names):
            text = source
            for old, new in CANDIDATES[name]:
                if text.count(old) != 1:
                    raise SystemExit(f"candidate {name!r}: {old!r} is not in dc_pairs.cu once")
                text = text.replace(old, new)
            (build.CSRC / f"dc_pairs_{i}.cu").write_text(text)
        with ThreadPoolExecutor(len(names)) as pool:
            libs = list(pool.map(lambda i: build.build_library(f"dc_pairs_{i}", True),
                                 range(len(names))))
        result = {"card": cs.card_line(), "candidates": {}}
        ok = True
        for i, name in enumerate(names):
            use_library(dc_pairs, build, libs[i])
            ptxas = [ln.strip() for ln in build.BUILD_LOG[f"dc_pairs_{i}"]["ptxas"].splitlines()
                     if "registers" in ln or "spill" in ln]
            failures = [f"{'pair' if both else 'role'} {case.name}: {err}"
                        for case in dsc.CASES for both in (True, False)
                        for err in [dsc.check_case(case, "cuda", both)[0]] if err]
            ok = ok and not failures
            result["candidates"][name] = {"ptxas": ptxas, "failures": failures}
            print(f"{name}: {len(failures)} failures", flush=True)
        timing = dsc.timing_inputs("cuda")
        for turn in range(args.turns):
            for i in (range(len(names)) if turn % 2 == 0 else reversed(range(len(names)))):
                use_library(dc_pairs, build, libs[i])
                rec = result["candidates"][names[i]]
                for both, label in ((True, "pair"), (False, "role")):
                    def fn():
                        return dsc.scan(timing, both)
                    rec.setdefault(f"{label}_ms", []).append(cs.cuda_ms(fn, args.reps))
                    rec.setdefault(f"{label}_kernel_ms", []).append(
                        cs.scan_kernel_ms(fn, args.reps))
    for name, rec in result["candidates"].items():
        print(f"{name}: pair kernel {rec['pair_kernel_ms']} ms (call {rec['pair_ms']}), "
              f"role kernel {rec['role_kernel_ms']} ms (call {rec['role_ms']})", flush=True)
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
