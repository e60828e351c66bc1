"""Flash-attention forward: the CUDA kernel, its wrapper, and its plain
PyTorch versions.

Forward attention with an online softmax: q (B, Hq, Sq, D), k and v
(B, Hkv, Sk, D), Hq a multiple of Hkv (GQA maps query head h to kv head
``h // (Hq // Hkv)``), an optional causal mask (key position <= query
position) and sliding window (key position > query position - window).
Scores are scaled by ``1/sqrt(D)`` unless ``scale`` is given; rows that see
no key give 0.  The output has q's dtype.

Three pieces live here, beside each other:

* ``flash_attention`` — the wrapper.  On CPU tensors it runs a plain
  version, routed as the reference's ``ops.flash_attention`` routes its
  ``ref`` mode: ``attention_blocked`` when ``sq >= 1024 and sq % 512 == 0
  and sk % 1024 == 0``, ``attention`` otherwise.  On CUDA tensors it
  launches ``csrc/flash_attention.cu`` and counts the launch in
  ``LAUNCHES``; a failed build or launch raises.  There is no fallback from
  the card to the plain version; ``plain_version()`` forces it explicitly,
  for comparisons on the card.
* ``attention`` — the oracle: softmax over the whole masked score matrix,
  ``-inf`` logits and the ``row_visible`` guard for rows with no key.
* ``attention_blocked`` — the same online-softmax tiling as the TPU kernel
  over (512, 1024) tiles, ``-1e30`` for masked scores and
  ``acc / max(l, 1e-30)``.

Both plain versions compute in float32 and cast back.  The kernel replaces
``repro/kernels/flash_attention.py::flash_attention_pallas`` (line 101).
At prefill shapes it is bound by the tensor cores' bf16 FLOPs; this first
design runs every product as scalar float32 FMAs on the CUDA cores, so it
sits far above that bound (PERF.md).  The library is built with ``nvcc`` at
first use (``kernels.build``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel, counted by the wrapper at each launch
LAUNCHES = {"flash_attention": 0}

_state = threading.local()


def reset_launch_counts() -> None:
    """Zero every kernel launch counter of this module."""
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


# ---------------------------------------------------------- plain versions
def _positions_mask(q0, nq, k0, nk, causal, window, device):
    q_pos = q0 + torch.arange(nq, device=device)
    k_pos = k0 + torch.arange(nk, device=device)
    mask = torch.ones((nq, nk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def _kv_heads(x: torch.Tensor, group: int) -> torch.Tensor:
    x = x.float()
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def attention(q, k, v, causal=True, window=None, scale=None) -> torch.Tensor:
    """Oracle (``repro.kernels.ref.attention``) in float32."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = (q.float() @ _kv_heads(k, group).transpose(-1, -2)) * scale
    mask = _positions_mask(0, sq, 0, sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    # rows with no visible key -> zeros, with a finite softmax for them
    row_visible = mask.any(-1)[:, None]  # (sq, 1)
    probs = torch.softmax(torch.where(row_visible, logits, 0.0), dim=-1)
    probs = torch.where(row_visible, probs, 0.0)
    return (probs @ _kv_heads(v, group)).to(q.dtype)


def attention_blocked(
    q, k, v, causal=True, window=None, scale=None, block_q=512, block_kv=1024
) -> torch.Tensor:
    """Online-softmax tiling (``repro.kernels.ref.attention_blocked``) in
    float32: live temporaries are (b, h, block_q, block_kv)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    block_q = min(block_q, sq)
    block_kv = min(block_kv, sk)
    if sq % block_q or sk % block_kv:
        raise ValueError(f"attention_blocked: seq {sq}/{sk} not a multiple of "
                         f"the blocks {block_q}/{block_kv}")
    kr, vr = _kv_heads(k, group), _kv_heads(v, group)
    out = torch.empty_like(q)
    for q0 in range(0, sq, block_q):
        qt = q[:, :, q0:q0 + block_q].float()
        m = torch.full((b, hq, block_q), NEG_INF, device=q.device)
        lsum = torch.zeros((b, hq, block_q), device=q.device)
        acc = torch.zeros((b, hq, block_q, d), device=q.device)
        for k0 in range(0, sk, block_kv):
            s = (qt @ kr[:, :, k0:k0 + block_kv].transpose(-1, -2)) * scale
            mask = _positions_mask(q0, block_q, k0, block_kv, causal, window, q.device)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vr[:, :, k0:k0 + block_kv]
            m = m_new
        out[:, :, q0:q0 + block_q] = (acc / lsum.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


def flash_attention_plain(q, k, v, causal=True, window=None, scale=None) -> torch.Tensor:
    """The plain version the wrapper runs, routed as the reference's ``ref``
    mode: blocked for long sequences, the oracle otherwise."""
    sq, sk = q.shape[2], k.shape[2]
    if sq >= 1024 and sq % 512 == 0 and sk % 1024 == 0:
        return attention_blocked(q, k, v, causal=causal, window=window, scale=scale)
    return attention(q, k, v, causal=causal, window=window, scale=scale)


# ------------------------------------------------------------------ kernel
class _FaArgs(ctypes.Structure):
    """Mirror of ``FaArgs`` in ``csrc/flash_attention.cu``."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("q_stride", ctypes.c_int64 * 3),  # (batch, head, seq) in elements
        ("k_stride", ctypes.c_int64 * 3),
        ("v_stride", ctypes.c_int64 * 3),
        ("o_stride", ctypes.c_int64 * 3),
        ("b", ctypes.c_int32),
        ("hq", ctypes.c_int32),
        ("hkv", ctypes.c_int32),
        ("sq", ctypes.c_int32),
        ("sk", ctypes.c_int32),
        ("d", ctypes.c_int32),
        ("causal", ctypes.c_int32),
        ("has_window", ctypes.c_int32),
        ("window", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
        ("scale", ctypes.c_float),
    ]


_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.build_library("flash_attention")))
            lib.flash_attention_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.flash_attention_launch.restype = ctypes.c_int
            lib.fa_args_size.restype = ctypes.c_int
            lib.fa_max_head_dim.restype = ctypes.c_int
            if (lib.fa_args_size() != ctypes.sizeof(_FaArgs)
                    or lib.fa_max_head_dim() != MAX_HEAD_DIM):
                raise RuntimeError("csrc/flash_attention.cu and its ctypes mirror disagree")
            _lib = lib
        return _lib


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows of D contiguous elements with 16-byte loads: the
    last dim must be contiguous and every row start 16-byte aligned.  Any
    other layout is copied once."""
    per16 = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % per16 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def _flash_attention_cuda(q, k, v, causal, window, scale) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on {x.device}, "
                             f"q is {q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}, got {d}")
    if b * hq > 65535 or max(sq, sk) >= 2**31:
        raise ValueError(f"flash_attention kernel: shape {tuple(q.shape)} too large")
    if window is not None and not -2**31 < window < 2**31:
        raise ValueError(f"flash_attention kernel: window {window} outside int32")
    # the output is written in (B, Sq, Hq, D) layout, the layout attend_full
    # projects from; the returned tensor is its (B, Hq, Sq, D) view
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    args = _FaArgs()
    for field, x in (("q", q), ("k", k), ("v", v), ("o", out)):
        setattr(args, field, x.data_ptr())
        getattr(args, f"{field}_stride")[:] = list(x.stride()[:3])
    args.b, args.hq, args.hkv, args.sq, args.sk, args.d = b, hq, hkv, sq, sk, d
    args.causal = int(bool(causal))
    args.has_window = int(window is not None)
    args.window = int(window) if window is not None else 0
    args.dtype = _DTYPE_CODE[q.dtype]
    args.scale = scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  Returns (B, Hq, Sq, D) in
    q's dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (or the plain version inside ``plain_version()``)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if q.device.type == "cpu" or getattr(_state, "plain", False):
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    return _flash_attention_cuda(q, k, v, causal, window, scale)
