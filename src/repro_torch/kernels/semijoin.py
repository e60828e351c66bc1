"""Semijoin membership: the CUDA kernel (a hash build and probe), its
wrapper, and its plain PyTorch version.

For each query key ``query[i]`` (one dictionary-coded column): does any
masked-in key ``keys[j]`` equal it?  The result is ANDed with
``query_mask``.

* ``semijoin`` — the wrapper.  On CPU tensors it runs the plain version; on
  CUDA tensors it launches ``csrc/semijoin.cu`` (it replaces the TPU kernel
  ``repro/kernels/semijoin.py::semijoin_pallas``): a table of
  ``table_slots(m)`` 64-bit slots, cleared, built from the live keys and
  probed by every query on the caller's stream, one counted launch in
  ``LAUNCHES``.  There is no fallback from the card to the plain version;
  ``plain_version()`` forces it explicitly for comparisons.
* ``semijoin_plain`` — the reference oracle's blocked loop over key blocks
  (``repro.kernels.ref.semijoin``), chunked over the queries so that the
  (queries x block) compare stays bounded at any n.

The kernel takes int32 keys (every caller's dictionary codes) and raises on
other dtypes; the plain version takes any dtype (``==``: NaN matches
nothing, -0.0 matches +0.0).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel, counted by the wrapper at each launch
LAUNCHES = {"semijoin": 0}

# queries compared at once by the plain version (x ``block`` bools each)
PLAIN_QUERY_CHUNK = 1 << 20
# the kernel's hash table: at least this many slots, and at most 2**30
MIN_TABLE_SLOTS = 1024
MAX_TABLE_SLOTS = 1 << 30

_state = threading.local()


def reset_launch_counts() -> None:
    """Zero every kernel launch counter."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_version():
    """Within this context the wrapper runs the plain PyTorch version on
    CUDA tensors too (for holding the kernel against it on the card)."""
    prev = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


def semijoin_plain(query, query_mask, keys, keys_mask, block: int = 512) -> torch.Tensor:
    """The plain version: OR the hits of each key block into ``found``."""
    n, m = query.shape[0], keys.shape[0]
    found = torch.zeros((n,), dtype=torch.bool, device=query.device)
    for q0 in range(0, n, PLAIN_QUERY_CHUNK):
        q = query[q0:q0 + PLAIN_QUERY_CHUNK, None]
        hit = found[q0:q0 + PLAIN_QUERY_CHUNK]
        for k0 in range(0, m, block):
            k_t, m_t = keys[k0:k0 + block], keys_mask[k0:k0 + block]
            hit |= ((q == k_t[None, :]) & m_t[None, :]).any(dim=1)
    return found & query_mask


def table_slots(m: int) -> int:
    """Slots of the kernel's open-addressing table for ``m`` keys: the
    least power of two at least ``2 m`` (so the table is at most half full
    and a probe run stays short), and at least ``MIN_TABLE_SLOTS``."""
    if m < 0:
        raise ValueError(f"table_slots: {m} keys")
    return max(MIN_TABLE_SLOTS, 1 << (2 * m - 1).bit_length()) if m else MIN_TABLE_SLOTS


_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.build_library("semijoin")))
            lib.semijoin_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p
            ]
            lib.semijoin_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def _semijoin_cuda(query, query_mask, keys, keys_mask, block: int) -> torch.Tensor:
    """Build a hash table of the live keys and probe it with every query:
    one counted launch.  ``block`` (the plain version's key block) plays no
    part in the kernel and is only checked."""
    dev = query.device
    for name, x in (("query", query), ("keys", keys)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.device != dev:
            raise ValueError(f"semijoin kernel takes 1-D int32 {name} on {dev}, "
                             f"got {x.dtype}{tuple(x.shape)} on {x.device}")
    for name, x, like in (("query_mask", query_mask, query), ("keys_mask", keys_mask, keys)):
        if x.dtype != torch.bool or x.shape != like.shape or x.device != dev:
            raise ValueError(f"semijoin kernel takes a bool {name} shaped like its keys")
    if block < 1:
        raise ValueError(f"block {block} < 1")
    slots = table_slots(keys.shape[0])
    if slots > MAX_TABLE_SLOTS or query.shape[0] >= 2**31:
        raise ValueError(f"semijoin kernel: {query.shape[0]} queries, {keys.shape[0]} keys "
                         "is more than it takes")
    query, query_mask = query.contiguous(), query_mask.contiguous()
    keys, keys_mask = keys.contiguous(), keys_mask.contiguous()
    out = torch.empty_like(query_mask)
    if out.numel() == 0:
        return out  # no query: nothing to launch
    table = torch.empty((slots,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().semijoin_launch(
        query.data_ptr(), query_mask.data_ptr(), keys.data_ptr(), keys_mask.data_ptr(),
        out.data_ptr(), table.data_ptr(), query.shape[0], keys.shape[0], slots, stream,
    )
    if err != 0:
        raise RuntimeError(f"semijoin kernel launch failed: CUDA error {err}")
    LAUNCHES["semijoin"] += 1
    return out


def semijoin(query, query_mask, keys, keys_mask, block: int = 512) -> torch.Tensor:
    """``(n,) bool``: ``query[i]`` appears among the ``keys[j]`` with
    ``keys_mask[j]``, and ``query_mask[i]``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or the plain version inside
    ``plain_version()``)."""
    if query.device.type == "cpu" or getattr(_state, "plain", False):
        return semijoin_plain(query, query_mask, keys, keys_mask, block)
    if query.device.type != "cuda":
        raise ValueError(f"semijoin: no kernel for device {query.device}")
    return _semijoin_cuda(query, query_mask, keys, keys_mask, block)
