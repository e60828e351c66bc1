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

* on CUDA tensors it launches the three kernels (``flash_attention_bwd_cuda``:
  the logsumexp and Delta prep, dK/dV and dQ), counted as one launch under
  ``LAUNCHES["flash_attention_bwd"]``.  ``bwd_variant`` picks their kind:
  bf16 at head dim 64 or 128 (qwen3-4b, olmoe, whisper) runs them on the
  tensor cores (``mma.sync``, P and dS rounded to bf16 for their
  products); float32 and other head dims (gemma3's 256) run float32 FMAs
  on the CUDA cores.
  The kernels read contiguous (B, H, S, D) operands, so the wrapper makes
  ``.contiguous()`` copies of the (b, s, h, d) views ``attend_full``
  passes, of the output and of its gradient.  A failed build or launch
  raises; there is no fallback to the plain version;
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
# head dims the tensor-core variant is compiled for (bf16 only)
MMA_HEAD_DIMS = (64, 128)
# what the wrapper asks of csrc/flash_attention_bwd.cu (FAB_AUTO, FAB_CUDA_CORE)
VARIANT_CODE = {"auto": 0, "cuda_core": 1}


def reset_launch_counts() -> None:
    """Zero every kernel launch counter of this module."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_bwd_plain(q, k, v, o, do, causal=True, window=None, scale=None):
    """The plain backward: (dq, dk, dv) of ``attention`` at (q, k, v), given
    its output ``o`` and the output's gradient ``do``, in float32, cast to
    the operands' dtypes.  The kernels' arithmetic over whole score
    matrices: P = exp(scale * Q K^T - lse) over the visible keys,
    Delta = rowsum(dO * O), dS = P * (dO V^T - Delta), dQ = scale * dS K,
    dK = scale * dS^T Q and dV = P^T dO, summed over each GQA group.  A row
    that sees no key has P = 0 and a zero gradient."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf, kr, vr, dof = q.float(), fa._kv_heads(k, group), fa._kv_heads(v, group), do.float()
    mask = fa._positions_mask(0, sq, 0, sk, causal, window, q.device)
    s = ((qf @ kr.transpose(-1, -2)) * scale).masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    lse = torch.where(mask.any(-1)[:, None], lse, 0.0)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vr.transpose(-1, -2) - delta)
    dq = (ds @ kr) * scale
    dk = ((ds.transpose(-1, -2) @ qf) * scale).view(b, hkv, group, sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(b, hkv, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FaBwdArgs(ctypes.Structure):
    """Mirror of ``FaBwdArgs`` in ``csrc/flash_attention_bwd.cu``."""

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
        ("variant", ctypes.c_int32),
        ("scale", ctypes.c_float),
    ]


_bwd_lib = None


def _bwd_library():
    global _bwd_lib
    with fa._lib_lock:
        if _bwd_lib is None:
            lib = ctypes.CDLL(str(build.build_library("flash_attention_bwd")))
            lib.flash_attention_bwd_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.flash_attention_bwd_launch.restype = ctypes.c_int
            lib.fa_bwd_args_size.restype = ctypes.c_int
            lib.fa_bwd_max_head_dim.restype = ctypes.c_int
            if (lib.fa_bwd_args_size() != ctypes.sizeof(_FaBwdArgs)
                    or lib.fa_bwd_max_head_dim() != fa.MAX_HEAD_DIM):
                raise RuntimeError("csrc/flash_attention_bwd.cu and its ctypes mirror disagree")
            _bwd_lib = lib
        return _bwd_lib


def _dense(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` unless it is contiguous with a 16-byte
    aligned base already (the backward kernels read packed rows with 16-byte
    loads)."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernels a CUDA backward takes: ``"mma"`` (tensor cores,
    ``mma.sync``) for bf16 at head dim 64 or 128, ``"cuda_core"`` (float32
    FMAs) for everything else."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS:
        return "mma"
    return "cuda_core"


def flash_attention_bwd_cuda(q, k, v, o, do, causal=True, window=None, scale=None,
                             variant="auto"):
    """The backward kernels (``csrc/flash_attention_bwd.cu``) on CUDA
    tensors: (dq, dk, dv) in the operands' dtype, float32 or bfloat16, head
    dim a multiple of 8 up to 256.  ``variant="auto"`` runs the kernels
    ``bwd_variant`` names, ``"cuda_core"`` the CUDA-core ones whatever the
    operands (for timing the two on one input).  Operands are copied to
    contiguous (B, H, S, D) first where they are not.  The prep, dK/dV and
    dQ kernels count as one launch under ``"flash_attention_bwd"``."""
    kernel = "flash_attention backward kernel"
    fa._check_kernel_operands(q, k, v, window, kernel)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{kernel}: {name} is {x.dtype}{tuple(x.shape)} on {x.device}, "
                             f"q is {q.dtype}{tuple(q.shape)} on {q.device}")
    b, hq, sq, d = q.shape
    if q.dtype not in fa._DTYPE_CODE:
        raise ValueError(f"{kernel} takes float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= fa.MAX_HEAD_DIM:
        raise ValueError(f"{kernel} takes head_dim a multiple of 8 up to {fa.MAX_HEAD_DIM}, "
                         f"got {d}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
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
    args.variant = VARIANT_CODE[variant]
    args.scale = scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_library().flash_attention_bwd_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, causal=True, window=None, scale=None, plain=False):
    """(dq, dk, dv): the plain backward on CPU tensors, inside
    ``flash_attention.plain_version()`` or with ``plain``; the backward kernels on CUDA
    tensors."""
    if plain or fa._plain_depth or q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal, window=window,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention backward: no kernel for device {q.device}")
    return flash_attention_bwd_cuda(q, k, v, o, do, causal=causal, window=window, scale=scale)
