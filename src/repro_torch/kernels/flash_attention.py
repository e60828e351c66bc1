"""Flash attention: the two forward CUDA kernels, their wrapper with its
autograd, and the plain PyTorch versions.

Forward attention with an online softmax: q (B, Hq, Sq, D), k and v
(B, Hkv, Sk, D), Hq a multiple of Hkv (GQA maps query head h to kv head
``h // (Hq // Hkv)``), an optional causal mask (key position <= query
position) and sliding window (key position > query position - window).
Scores are scaled by ``1/sqrt(D)`` unless ``scale`` is given; rows that see
no key give 0.  The output has q's dtype.

The pieces, beside each other:

* ``flash_attention`` — the wrapper.  On CPU tensors it runs a plain
  version, routed as the reference's ``ops.flash_attention`` routes its
  ``ref`` mode: ``attention_blocked`` when ``sq >= 1024 and sq % 512 == 0
  and sk % 1024 == 0``, ``attention`` otherwise.  On CUDA tensors it
  launches one of two hand-written kernels, as ``kernel_variant`` chooses
  by dtype and head dim, and counts the launch under that kernel's name in
  ``LAUNCHES``:

  - ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 with head dim
    64, 128 or 256, both products on the tensor cores (``wgmma``), K and V
    tiles by TMA into a shared-memory ring.  It reads its operands through TMA
    tensor maps and raises on a layout TMA cannot take (``tma_strides``)
    rather than copying;
  - ``"cuda_core"`` (``csrc/flash_attention.cu``): float32, and bf16 at
    any other head dim up to 256 (a multiple of 8), every product a
    float32 FMA on the CUDA cores.  It copies an operand once where its rows are not 16-byte
    aligned (``_kernel_operand``).

  Each kernel is also callable alone (``flash_attention_wgmma``,
  ``flash_attention_cuda_core``), for timing the two on one input.  A
  failed build or launch raises.  There is no fallback from the card to
  the plain version; ``plain_version()`` forces it explicitly, for
  comparisons on the card.

  Where an operand requires a gradient, the call goes through an autograd
  ``Function``: its forward is the call above and saves q, k, v and the
  output, and, where the backward's wgmma kernels will read it (bf16 at
  head dim 64 or 128), each row's logsumexp, which the wgmma kernel writes
  beside its output on request (``with_lse``); its backward is
  ``kernels.flash_attention_bwd``: the kernels of
  ``csrc/flash_attention_bwd.cu`` on CUDA tensors, the plain backward on
  CPU tensors or when the forward ran inside ``plain_version()``.
* ``attention`` — the oracle: softmax over the whole masked score matrix,
  ``-inf`` logits and the ``row_visible`` guard for rows with no key.
* ``attention_blocked`` — the same online-softmax tiling as the TPU kernel
  over (512, 1024) tiles, ``-1e30`` for masked scores and
  ``acc / max(l, 1e-30)``.
* ``logsumexp`` — each row's logsumexp of its scaled visible scores, in
  natural log, ``+inf`` for a row that sees no key: what the wgmma kernel
  saves for the backward, and what ``flash_attention_plain(with_lse=True)``
  returns beside its output.

Both plain versions compute in float32 and cast back.  Both kernels
replace ``repro/kernels/flash_attention.py::flash_attention_pallas`` (line
101); at prefill shapes the work is bound by the tensor cores' bf16 FLOPs
(PERF.md).  The libraries are built with ``nvcc`` at first use
(``kernels.build``) and loaded with ``ctypes``.
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
# head dims the tensor-core kernel is compiled for
WGMMA_HEAD_DIMS = (64, 128, 256)
# the kernel each kernel_variant launches, as LAUNCHES names it
KERNEL_NAME = {"wgmma": "flash_attention_wgmma", "cuda_core": "flash_attention"}

# launches of each forward CUDA kernel, counted by the wrapper at each launch
# (the backward counts its own, in kernels.flash_attention_bwd)
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0}

# depth of open plain_version() contexts.  Process-wide, not per thread:
# autograd runs a CUDA backward, and the forward it recomputes under
# torch.utils.checkpoint, on a thread of its own.
_plain_depth = 0


def reset_launch_counts() -> None:
    """Zero every kernel launch counter of this module."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_version():
    """Within this context the wrapper runs the plain PyTorch version on
    CUDA tensors too, forward and backward (for holding the kernels against
    it on the card)."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


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


def logsumexp(q, k, causal=True, window=None, scale=None) -> torch.Tensor:
    """(B, Hq, Sq) float32: ln of the sum of exp(scale * q . k) over each
    row's visible keys, ``+inf`` where a row sees none (so that
    exp(s - lse) is exactly 0 there).  The unit and the no-key value of the
    wgmma kernel's saved logsumexp."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = (q.float() @ _kv_heads(k, hq // k.shape[1]).transpose(-1, -2)) * scale
    return _masked_logsumexp(s, _positions_mask(0, sq, 0, sk, causal, window, q.device))


def _masked_logsumexp(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` of scaled scores ``s`` (..., Sq, Sk) over ``mask``."""
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(mask.any(-1), lse, float("inf"))


def flash_attention_plain(q, k, v, causal=True, window=None, scale=None, with_lse=False):
    """The plain version the wrapper runs, routed as the reference's ``ref``
    mode: blocked for long sequences, the oracle otherwise.  With
    ``with_lse``, (out, ``logsumexp``)."""
    sq, sk = q.shape[2], k.shape[2]
    if sq >= 1024 and sq % 512 == 0 and sk % 1024 == 0:
        out = attention_blocked(q, k, v, causal=causal, window=window, scale=scale)
    else:
        out = attention(q, k, v, causal=causal, window=window, scale=scale)
    if with_lse:
        return out, logsumexp(q, k, causal=causal, window=window, scale=scale)
    return out


# ----------------------------------------------------------------- kernels
def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` (tensor cores) for bf16
    with head dim 64, 128 or 256, ``"cuda_core"`` for everything else."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def tma_strides(x: torch.Tensor, name: str, kernel: str = "flash_attention wgmma kernel") -> list:
    """(batch, head, seq) strides, in elements, of a (B, H, S, D) operand
    as a TMA tensor map takes it: the head dim contiguous, the base and
    every other stride a multiple of 16 bytes.  A dim of size 1 is never
    stepped, so its stride is given as the packed one.  Raises
    ``ValueError``, naming ``kernel``, on any other layout (the wgmma
    kernels copy nothing)."""
    per16 = 16 // x.element_size()
    strides = []
    packed = x.shape[-1]
    for dim in (2, 1, 0):
        st = x.stride(dim) if x.shape[dim] > 1 else packed
        strides.insert(0, st)
        packed *= x.shape[dim]
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError(f"{kernel}: {name}'s head dim is not contiguous "
                         f"(strides {tuple(x.stride())})")
    if x.data_ptr() % 16 or any(st % per16 or st <= 0 for st in strides):
        raise ValueError(f"{kernel}: {name} (strides {tuple(x.stride())}, "
                         f"base {x.data_ptr() % 16} bytes past 16) is not a layout TMA takes: "
                         "the base and each stride must be multiples of 16 bytes")
    return strides


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


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")


def _check_kernel_operands(q, k, v, window, kernel: str) -> None:
    """What both kernels need of their operands and arguments."""
    _check_shapes(q, k, v)
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{kernel}: {name} is {x.dtype} on {x.device}, "
                             f"q is {q.dtype} on {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: operands on {q.device}, not on a CUDA device")
    b, hq, sq, _ = q.shape
    if b * hq > 65535 or max(sq, k.shape[2]) >= 2**31:
        raise ValueError(f"{kernel}: shape {tuple(q.shape)} too large")
    if window is not None and not -2**31 < window < 2**31:
        raise ValueError(f"{kernel}: window {window} outside int32")


def _launch_args(struct, operands, q, k, causal, window, scale):
    """Fill ``struct`` (a ctypes mirror): each operand's pointer and
    (batch, head, seq) strides, the shape, the mask and the scale."""
    args = struct()
    for field, (x, strides) in operands.items():
        setattr(args, field, x.data_ptr())
        getattr(args, f"{field}_stride")[:] = strides
    (args.b, args.hq, args.sq, args.d), args.hkv, args.sk = q.shape, k.shape[1], k.shape[2]
    args.causal = int(bool(causal))
    args.has_window = int(window is not None)
    args.window = int(window) if window is not None else 0
    args.scale = scale
    return args


def flash_attention_cuda_core(q, k, v, causal=True, window=None, scale=None) -> torch.Tensor:
    """The CUDA-core kernel (``csrc/flash_attention.cu``) on CUDA tensors:
    float32 or bfloat16, head dim a multiple of 8 up to 256.  One counted
    launch under ``"flash_attention"``."""
    kernel = "flash_attention CUDA-core kernel"
    _check_kernel_operands(q, k, v, window, kernel)
    b, hq, sq, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{kernel} takes float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{kernel} takes head_dim a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    # the output is written in (B, Sq, Hq, D) layout, the layout attend_full
    # projects from; the returned tensor is its (B, Hq, Sq, D) view
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    operands = {f: (x, list(x.stride()[:3]))
                for f, x in (("q", q), ("k", k), ("v", v), ("o", out))}
    args = _launch_args(_FaArgs, operands, q, k, causal, window, scale)
    args.dtype = _DTYPE_CODE[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out


class _FaWgArgs(ctypes.Structure):
    """Mirror of ``FaWgArgs`` in ``csrc/flash_attention_wgmma.cu``."""

    _fields_ = _FaArgs._fields_[:-2] + [("scale", ctypes.c_float), ("lse", ctypes.c_void_p)]


_wg_lib = None


def _wgmma_library():
    global _wg_lib
    with _lib_lock:
        if _wg_lib is None:
            lib = ctypes.CDLL(str(build.build_library("flash_attention_wgmma")))
            lib.fa_wgmma_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.fa_wgmma_launch.restype = ctypes.c_int
            lib.fa_wgmma_args_size.restype = ctypes.c_int
            if lib.fa_wgmma_args_size() != ctypes.sizeof(_FaWgArgs):
                raise RuntimeError(
                    "csrc/flash_attention_wgmma.cu and its ctypes mirror disagree")
            _wg_lib = lib
        return _wg_lib


def flash_attention_wgmma(q, k, v, causal=True, window=None, scale=None, with_lse=False):
    """The tensor-core kernel (``csrc/flash_attention_wgmma.cu``) on CUDA
    tensors: bfloat16 with head dim 64, 128 or 256, in a layout TMA takes
    (``tma_strides``).  With ``with_lse``, (out, lse): the same launch also
    writes each row's logsumexp, (B, Hq, Sq) float32 in ``logsumexp``'s
    unit.  One counted launch under ``"flash_attention_wgmma"``."""
    kernel = "flash_attention wgmma kernel"
    _check_kernel_operands(q, k, v, window, kernel)
    b, hq, sq, d = q.shape
    if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"{kernel} takes bfloat16 with head dim in {WGMMA_HEAD_DIMS}, "
                         f"got {q.dtype} and {d}")
    operands = {f: (x, tma_strides(x, f)) for f, x in (("q", q), ("k", k), ("v", v))}
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    operands["o"] = (out, list(out.stride()[:3]))
    args = _launch_args(_FaWgArgs, operands, q, k, causal, window, scale)
    args.lse = lse.data_ptr() if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _wgmma_library().fa_wgmma_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: error {err}")
    LAUNCHES["flash_attention_wgmma"] += 1
    return (out, lse) if with_lse else out


def _use_plain(q: torch.Tensor) -> bool:
    return bool(_plain_depth) or q.device.type == "cpu"


def _forward(q, k, v, causal, window, scale) -> torch.Tensor:
    if _use_plain(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    kernel = (flash_attention_wgmma if kernel_variant(q.dtype, q.shape[-1]) == "wgmma"
              else flash_attention_cuda_core)
    return kernel(q, k, v, causal=causal, window=window, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward kernel, then the backward
    kernels (or both plain versions, as ``flash_attention_bwd`` routes)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        from repro_torch.kernels import flash_attention_bwd as bwd

        lse = None
        if (not _use_plain(q) and q.device.type == "cuda"
                and bwd.bwd_variant(q.dtype, q.shape[-1]) == "wgmma"):
            # the backward's wgmma kernels read the logsumexp this launch saves
            o, lse = flash_attention_wgmma(q, k, v, causal=causal, window=window, scale=scale,
                                           with_lse=True)
        else:
            o = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.plain = (causal, window, scale), _use_plain(q)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        from repro_torch.kernels import flash_attention_bwd as bwd

        dq, dk, dv = bwd.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window,
                                             scale=scale, lse=lse, plain=ctx.plain)
        return dq, dk, dv, None, None, None


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
    kernel ``kernel_variant`` chooses (or the plain version inside
    ``plain_version()``).  With gradients on and an operand that requires
    one, the result carries the backward kernels' gradient."""
    _check_shapes(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)
