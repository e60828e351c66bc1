"""Shared neural layers: norms, RoPE, MLPs, embeddings.

The counterpart of ``repro.models.layers``: pure functions over parameter
dicts of tensors.  The compute dtype is the caller's (parameters are cast
once, at load, by ``params.cast_params``); normalization statistics and
RoPE tables always run in float32, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def apply_norm(x: torch.Tensor, params: dict, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


# -------------------------------------------------------------------- RoPE
def rope_freqs(
    hd: int, theta: float, rotary_dim: Optional[int] = None, device=None
) -> torch.Tensor:
    """(rotary_dim/2,) float32 inverse frequencies."""
    rd = rotary_dim or hd
    return 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd))


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10_000.0,
    mode: str = "standard",
    partial: float = 0.5,
) -> torch.Tensor:
    """Rotary embedding over interleaved pairs ``(x[..., 0::2], x[..., 1::2])``
    (the reference's convention, not Hugging Face's ``rotate_half``).

    x: (..., seq, hd); positions: broadcastable to (..., seq).
    mode 'standard': rotate the full head dim; 'partial': only the first
    ``partial * hd`` dims; 'none' and 'nope': identity.
    """
    if mode in ("none", "nope"):
        return x
    hd = x.shape[-1]
    rd = hd if mode == "standard" else int(hd * partial) // 2 * 2
    freqs = rope_freqs(hd, theta, rd, device=x.device)  # (rd/2,)
    angles = positions[..., None].float() * freqs  # (..., seq, rd/2)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    xr = x[..., :rd].float()
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.stack([out1, out2], dim=-1).reshape(xr.shape)
    if rd == hd:
        return rotated.to(x.dtype)
    return torch.cat([rotated.to(x.dtype), x[..., rd:]], dim=-1)


# --------------------------------------------------------------------- MLPs
def mlp(x: torch.Tensor, params: dict, kind: str) -> torch.Tensor:
    """Position-wise MLP.  kinds: swiglu | sq_relu | gelu.

    swiglu params:  wi (d, 2, f) fused gate ``[:, 0]`` + up ``[:, 1]``, wo (f, d)
    others params:  wi (d, f), wo (f, d)
    """
    wi = params["wi"]
    if kind == "swiglu":
        d, _, f = wi.shape
        gate_up = (x @ wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
        h = F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :]
    elif kind == "sq_relu":
        h = torch.relu(x @ wi).square()
    else:  # gelu, tanh approximation as jax.nn.gelu's default
        h = F.gelu(x @ wi, approximate="tanh")
    return h @ params["wo"]


# --------------------------------------------------------------- embeddings
def embed(tokens: torch.Tensor, table: torch.Tensor, compute_dtype) -> torch.Tensor:
    return table[tokens].to(compute_dtype)


def unembed(x: torch.Tensor, table_f32: torch.Tensor) -> torch.Tensor:
    """Logits in float32 against the (tied) table, already in float32: the
    caller keeps one float32 copy from load time (``params.cast_params``)
    instead of casting the table at every step."""
    return x.float() @ table_f32.T
