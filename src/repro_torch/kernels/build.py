"""Build the port's CUDA sources into shared libraries with a plain C
interface, at first use.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``repro_torch/_build/lib<name>_<hash>.so`` (git-ignored), keyed by the
hash of the source and of ``csrc/*.cuh`` so that an edited source or shared
header rebuilds.  The kernel modules load
the result with ``ctypes``.  Builds of different sources may run at once
(one thread each): ``nvcc`` runs as a subprocess.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# per source name: build seconds, ptxas output and library path of the last
# build (or of the library found already built)
BUILD_LOG: Dict[str, dict] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build_library(name: str, verbose_ptxas: bool = False) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` for sm_90a and return the library's path.
    ``verbose_ptxas`` rebuilds even when the library exists, to record what
    ``ptxas`` says of registers and spills in ``BUILD_LOG[name]``."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the headers a source may include
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists() and not verbose_ptxas:
        BUILD_LOG.setdefault(name, {"seconds": None, "ptxas": ""})["path"] = str(out)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{time.monotonic_ns()}.tmp")
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source),
    ]
    if verbose_ptxas:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {
        "seconds": time.perf_counter() - t0, "ptxas": proc.stderr, "path": str(out),
    }
    return out
