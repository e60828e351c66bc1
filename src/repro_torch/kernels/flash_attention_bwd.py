"""Flash-attention backward: the CUDA kernels of
``csrc/flash_attention_bwd.cu``, their wrapper and the plain PyTorch
version.

The gradient of ``kernels.flash_attention``'s function: given q
(B, Hq, Sq, D), k and v (B, Hkv, Sk, D), the forward's output o and its
gradient do, it returns (dq, dk, dv) in the operands' dtype, with the
forward's GQA map, causal mask and sliding window; a row that sees no key
gets a zero gradient.  The reference has no backward kernel: its training
differentiates the plain route of ``ops.flash_attention`` by autodiff, which
is the function computed here.  ``flash_attention``'s autograd ``Function``
calls ``flash_attention_bwd``:

* on CUDA tensors it launches three kernels (``flash_attention_bwd_cuda``:
  a prep, dK/dV and dQ), counted as one launch under
  ``LAUNCHES["flash_attention_bwd"]``.  ``bwd_variant`` picks their kind:

  - ``"wgmma"``, bf16 at head dim 64 or 128 (qwen3-4b, olmoe, whisper):
    every product on the tensor cores by ``wgmma``, tiles by TMA, P and dS
    rounded to bf16 for their products.  It reads the logsumexp the wgmma
    forward saved (``lse``; where none is given, one more counted launch of
    the forward kernel makes it), so its prep computes only Delta.  Its
    operands are read where they lie, through TMA tensor maps with the
    caller's strides (``wgmma_strides``: the (b, s, h, d) views
    ``attend_full`` passes, the output and its gradient), and dq, dk and dv
    take the operands' own layout; a layout TMA cannot take raises;
  - ``"cuda_core"``, float32 and other head dims (gemma3's 256), or any
    call with ``variant="cuda_core"``: float32 FMAs on the CUDA cores, its
    prep recomputing the logsumexp.  It reads contiguous (B, H, S, D)
    operands, so the wrapper copies those that are not (``_dense``).

  A failed build or launch raises; there is no fallback to the plain
  version or from one variant to the other;
* on CPU tensors, or when the forward ran inside
  ``flash_attention.plain_version()``, it runs ``flash_attention_bwd_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

# launches of the backward, counted by the wrapper at each launch (its three
# kernels count as one, whichever variant runs)
LAUNCHES = {"flash_attention_bwd": 0}
# head dims the wgmma variant is compiled for (bf16 only)
WGMMA_HEAD_DIMS = (64, 128)
# the wgmma variant's scratch rows a (batch, head): Sq rounded up to this
# (csrc/flash_attention_bwd.cu, SQ_ALIGN)
SQ_ALIGN = 128


def reset_launch_counts() -> None:
    """Zero every kernel launch counter of this module."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_bwd_plain(q, k, v, o, do, causal=True, window=None, scale=None, lse=None):
    """The plain backward: (dq, dk, dv) of ``attention`` at (q, k, v), given
    its output ``o`` and the output's gradient ``do``, in float32, cast to
    the operands' dtypes.  The kernels' arithmetic over whole score
    matrices: P = exp(scale * Q K^T - lse) over the visible keys,
    Delta = rowsum(dO * O), dS = P * (dO V^T - Delta), dQ = scale * dS K,
    dK = scale * dS^T Q and dV = P^T dO, summed over each GQA group.  ``lse``
    is the forward's saved logsumexp (``flash_attention.logsumexp``'s unit),
    or None to compute it here.  A row that sees no key has P = 0 and a zero
    gradient."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf, kr, vr, dof = q.float(), fa._kv_heads(k, group), fa._kv_heads(v, group), do.float()
    mask = fa._positions_mask(0, sq, 0, sk, causal, window, q.device)
    s = (qf @ kr.transpose(-1, -2)) * scale
    if lse is None:
        lse = fa._masked_logsumexp(s, mask)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vr.transpose(-1, -2) - delta)
    dq = (ds @ kr) * scale
    dk = ((ds.transpose(-1, -2) @ qf) * scale).view(b, hkv, group, sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(b, hkv, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FaBwdArgs(ctypes.Structure):
    """Mirror of ``FaBwdArgs`` (the CUDA-core variant) in
    ``csrc/flash_attention_bwd.cu``."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("dout", ctypes.c_void_p),
        ("dq", ctypes.c_void_p),
        ("dk", ctypes.c_void_p),
        ("dv", ctypes.c_void_p),
        ("lse", ctypes.c_void_p),
        ("delta", ctypes.c_void_p),
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


_WG_OPERANDS = ("q", "k", "v", "o", "dout", "dq", "dk", "dv")


class _FaBwdWgArgs(ctypes.Structure):
    """Mirror of ``FaBwdWgArgs`` (the wgmma variant) in
    ``csrc/flash_attention_bwd.cu``."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _WG_OPERANDS]
        + [(f"{name}_stride", ctypes.c_int64 * 3) for name in _WG_OPERANDS]
        + [("lse", ctypes.c_void_p), ("lse2", ctypes.c_void_p), ("delta", ctypes.c_void_p)]
        + [(name, ctypes.c_int32) for name in
           ("b", "hq", "hkv", "sq", "sk", "d", "sq_pad", "causal", "has_window", "window")]
        + [("scale", ctypes.c_float)]
    )


_bwd_lib = None


def _bwd_library():
    global _bwd_lib
    with fa._lib_lock:
        if _bwd_lib is None:
            lib = ctypes.CDLL(str(build.build_library("flash_attention_bwd")))
            for fn in (lib.flash_attention_bwd_launch, lib.fa_bwd_wgmma_launch):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.fa_bwd_args_size.restype = ctypes.c_int
            lib.fa_bwd_wgmma_args_size.restype = ctypes.c_int
            lib.fa_bwd_max_head_dim.restype = ctypes.c_int
            if (lib.fa_bwd_args_size() != ctypes.sizeof(_FaBwdArgs)
                    or lib.fa_bwd_wgmma_args_size() != ctypes.sizeof(_FaBwdWgArgs)
                    or lib.fa_bwd_max_head_dim() != fa.MAX_HEAD_DIM):
                raise RuntimeError("csrc/flash_attention_bwd.cu and its ctypes mirror disagree")
            _bwd_lib = lib
        return _bwd_lib


def _dense(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` unless it is contiguous with a 16-byte
    aligned base already (the CUDA-core kernels read packed rows with 16-byte
    loads)."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernels a CUDA backward takes: ``"wgmma"`` (tensor cores) for
    bf16 at head dim 64 or 128, ``"cuda_core"`` (float32 FMAs) for
    everything else."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def wgmma_strides(**operands) -> dict:
    """Each named (B, H, S, D) operand's (batch, head, seq) strides in
    elements, as the wgmma variant's TMA tensor maps read it
    (``flash_attention.tma_strides``); raises ``ValueError`` on a layout TMA
    cannot take.  The variant copies no operand."""
    return {name: fa.tma_strides(x, name, "flash_attention wgmma backward")
            for name, x in operands.items()}


def _check_operands(q, k, v, o, do, window, kernel):
    fa._check_kernel_operands(q, k, v, window, kernel)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{kernel}: {name} is {x.dtype}{tuple(x.shape)} on {x.device}, "
                             f"q is {q.dtype}{tuple(q.shape)} on {q.device}")


def _launch(fn, args, device, kernel):
    err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: error {err}")
    LAUNCHES["flash_attention_bwd"] += 1


def _bwd_cuda_core(q, k, v, o, do, causal, window, scale):
    kernel = "flash_attention CUDA-core backward"
    b, hq, sq, d = q.shape
    if q.dtype not in fa._DTYPE_CODE:
        raise ValueError(f"{kernel} takes float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= fa.MAX_HEAD_DIM:
        raise ValueError(f"{kernel} takes head_dim a multiple of 8 up to {fa.MAX_HEAD_DIM}, "
                         f"got {d}")
    q, k, v, o, do = (_dense(x) for x in (q, k, v, o, do))
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    args = _FaBwdArgs()
    for field, x in (("q", q), ("k", k), ("v", v), ("o", o), ("dout", do), ("dq", dq),
                     ("dk", dk), ("dv", dv), ("lse", lse), ("delta", delta)):
        setattr(args, field, x.data_ptr())
    (args.b, args.hq, args.sq, args.d), args.hkv, args.sk = q.shape, k.shape[1], k.shape[2]
    args.causal = int(bool(causal))
    args.has_window = int(window is not None)
    args.window = int(window) if window is not None else 0
    args.dtype = fa._DTYPE_CODE[q.dtype]
    args.scale = scale
    _launch(_bwd_library().flash_attention_bwd_launch, args, q.device, kernel)
    return dq, dk, dv


def _bwd_wgmma(q, k, v, o, do, lse, causal, window, scale):
    kernel = "flash_attention wgmma backward"
    b, hq, sq, d = q.shape
    operands = {"q": q, "k": k, "v": v, "o": o, "dout": do}
    strides = wgmma_strides(**operands)
    outputs = {"dq": torch.empty_like(q), "dk": torch.empty_like(k), "dv": torch.empty_like(v)}
    dq, dk, dv = outputs.values()
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if lse is None:
        _, lse = fa.flash_attention_wgmma(q, k, v, causal=causal, window=window, scale=scale,
                                          with_lse=True)
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"{kernel}: lse is {lse.dtype}{tuple(lse.shape)} on {lse.device}, "
                         f"not a contiguous float32 ({b}, {hq}, {sq}) on {q.device}")
    sq_pad = -(-sq // SQ_ALIGN) * SQ_ALIGN
    lse2 = torch.empty((b, hq, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    strides.update((name, list(x.stride()[:3])) for name, x in outputs.items())
    args = _FaBwdWgArgs()
    for name, x in {**operands, **outputs}.items():
        setattr(args, name, x.data_ptr())
        getattr(args, f"{name}_stride")[:] = strides[name]
    args.lse, args.lse2, args.delta = lse.data_ptr(), lse2.data_ptr(), delta.data_ptr()
    (args.b, args.hq, args.sq, args.d), args.hkv, args.sk = q.shape, k.shape[1], k.shape[2]
    args.sq_pad = sq_pad
    args.causal = int(bool(causal))
    args.has_window = int(window is not None)
    args.window = int(window) if window is not None else 0
    args.scale = scale
    _launch(_bwd_library().fa_bwd_wgmma_launch, args, q.device, kernel)
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, o, do, causal=True, window=None, scale=None, lse=None,
                             variant="auto"):
    """The backward kernels (``csrc/flash_attention_bwd.cu``) on CUDA
    tensors: (dq, dk, dv) in the operands' dtype, float32 or bfloat16, head
    dim a multiple of 8 up to 256.  ``variant="auto"`` runs the kernels
    ``bwd_variant`` names, ``"cuda_core"`` the CUDA-core ones whatever the
    operands (for timing the two on one input).  ``lse`` is the forward's
    saved logsumexp, which only the wgmma variant reads.  The prep, dK/dV
    and dQ kernels count as one launch under ``"flash_attention_bwd"``."""
    _check_operands(q, k, v, o, do, window, "flash_attention backward kernel")
    if variant not in ("auto", "cuda_core"):
        raise ValueError(f"flash_attention backward: no variant {variant!r}")
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if variant == "auto" and bwd_variant(q.dtype, q.shape[-1]) == "wgmma":
        return _bwd_wgmma(q, k, v, o, do, lse, causal, window, scale)
    return _bwd_cuda_core(q, k, v, o, do, causal, window, scale)


def flash_attention_bwd(q, k, v, o, do, causal=True, window=None, scale=None, lse=None,
                        plain=False):
    """(dq, dk, dv): the plain backward on CPU tensors, inside
    ``flash_attention.plain_version()`` or with ``plain``; the backward kernels on CUDA
    tensors.  ``lse``: the forward's saved logsumexp, or None."""
    if plain or fa._plain_depth or q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal, window=window,
                                         scale=scale, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention backward: no kernel for device {q.device}")
    return flash_attention_bwd_cuda(q, k, v, o, do, causal=causal, window=window, scale=scale,
                                    lse=lse)
