"""Mamba-1 selective SSM: the chunked full-sequence mixer and the O(1)
decode step.

The counterpart of ``repro.models.mamba``.  State recurrence (per channel c
of d_in, per state n of N):

    h_t = exp(dt_t * A[c,n]) * h_{t-1} + dt_t * B_t[n] * x_t[c]
    y_t[c] = sum_n C_t[n] * h_t[c,n] + D[c] * x_t[c]

The sequence is split into chunks of length ``chunk`` (padded at the end
with dt = 0 steps: decay exp(0) = 1 and no input, so the state passes
through and the padded outputs are dropped); the chunk boundary state is
carried from chunk to chunk.  Inside a chunk the reference runs the
recurrence as a ``jax.lax.associative_scan``; the port runs the same
associative combine ``(a_l, u_l) . (a_r, u_r) = (a_l a_r, u_l a_r + u_r)``
as a log-depth doubling scan (Hillis-Steele: log2(chunk) passes over the
(b, chunk, d_in, N) tensors).  Both only multiply factors in (0, 1], but
they associate the products differently, so the port is float-close to the
reference, not bit-identical (``tests/test_torch_mamba.py`` states the
tolerance).  ``dt``'s softplus and the whole scan run in float32.

The reference has no Pallas kernel here; the port's is plain PyTorch, and a
hand-written scan kernel is speed work for later (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class MambaState(NamedTuple):
    h: torch.Tensor  # (b, d_in, N) float32
    conv: torch.Tensor  # (b, d_conv - 1, d_in) rolling conv window


def _ssm_params(x: torch.Tensor, params: dict, dt_rank: int, n_state: int):
    """Project x (b, s, d_in) -> (dt, B, C), all float32; dt through a
    float32 softplus (``jax.nn.softplus``: ``logaddexp(dt, 0)``)."""
    proj = x @ params["x_proj"]  # (b, s, r + 2N)
    dt = proj[..., :dt_rank]
    B = proj[..., dt_rank:dt_rank + n_state]
    C = proj[..., dt_rank + n_state:]
    dt = (dt @ params["dt_proj"] + params["dt_bias"]).float()
    dt = torch.logaddexp(dt, torch.zeros((), dtype=torch.float32, device=dt.device))
    return dt, B.float(), C.float()


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prefix: Optional[torch.Tensor]):
    """Depthwise causal conv1d.  x: (b, s, c); w: (c, k)."""
    k = w.shape[1]
    if prefix is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = prefix.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    return sum(xp[:, i:i + x.shape[1], :] * w[:, i] for i in range(k))


def _chunk_scan(a: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + u_t`` along dim 1: returns
    (aa, uu) with ``h_t = aa_t * h_before + uu_t``, by log-depth doubling."""
    n, o = a.shape[1], 1
    while o < n:
        u = torch.cat([u[:, :o], torch.addcmul(u[:, o:], u[:, :-o], a[:, o:])], dim=1)
        a = torch.cat([a[:, :o], a[:, :-o] * a[:, o:]], dim=1)
        o *= 2
    return a, u


def _scan(xin, dt, B, C, A, chunk: int):
    """The chunked scan over (b, s, ·) inputs from h = 0: returns (y (b, s,
    d_in) float32, the final state (b, d_in, N))."""
    b, s, d_in = xin.shape
    n_state = A.shape[-1]
    ch = min(chunk, s)
    n_chunks = -(-s // ch)
    s_pad = n_chunks * ch
    xf = xin.float()
    if s_pad != s:  # dt = 0 steps: the state passes through unchanged
        pad = (0, 0, 0, s_pad - s)
        xf, dt, B, C = (F.pad(t, pad) for t in (xf, dt, B, C))
    h = torch.zeros((b, d_in, n_state), dtype=torch.float32, device=xin.device)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * ch, (c + 1) * ch)
        dtc = dt[:, sl]
        a = torch.exp(dtc[..., None] * A)  # (b, ch, d_in, N)
        u = (dtc * xf[:, sl])[..., None] * B[:, sl, None, :]
        aa, uu = _chunk_scan(a, u)
        h_all = aa * h[:, None] + uu
        ys.append((h_all @ C[:, sl, :, None]).squeeze(-1))  # (b, ch, d_in)
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)[:, :s], h


def mamba_mixer(
    x: torch.Tensor,  # (b, s, d_model)
    params: dict,
    n_state: int,
    d_conv: int,
    chunk: int = 128,
    return_state: bool = False,
):
    """Full-sequence mixer (prefill and forward): (b, s, d_model) in x's
    dtype.  With ``return_state`` also the ``MambaState`` after the last
    token (what decode goes on from): the scan's final state and the last
    ``d_conv - 1`` pre-conv inputs, both float32."""
    d, two, d_in = params["in_proj"].shape
    xz = (x @ params["in_proj"].reshape(d, two * d_in)).unflatten(-1, (two, d_in))
    x_conv, z = xz[..., 0, :], xz[..., 1, :]
    xin = F.silu(_causal_conv(x_conv, params["conv_w"], None) + params["conv_b"])

    dt_rank = params["dt_proj"].shape[0]
    dt, B, C = _ssm_params(xin, params, dt_rank, n_state)
    A = -torch.exp(params["A_log"].float())  # (d_in, N), negative
    y, h = _scan(xin, dt, B, C, A, chunk)
    y = y + params["D"] * xin.float()
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    if not return_state:
        return out
    return out, MambaState(h=h, conv=x_conv[:, -(d_conv - 1):].float())


def mamba_decode_step(
    x: torch.Tensor,  # (b, 1, d_model)
    state: MambaState,
    params: dict,
    n_state: int,
    d_conv: int,
) -> Tuple[torch.Tensor, MambaState]:
    """O(1) single-token step carrying (h, conv window)."""
    d, two, d_in = params["in_proj"].shape
    xz = (x @ params["in_proj"].reshape(d, two * d_in)).unflatten(-1, (two, d_in))
    xin, z = xz[..., 0, :], xz[..., 1, :]  # (b, 1, d_in)
    window = torch.cat([state.conv.to(xin.dtype), xin], dim=1)  # (b, k, d_in)
    w = params["conv_w"]  # (d_in, k)
    conv_out = torch.einsum("bkc,ck->bc", window, w)[:, None] + params["conv_b"]
    xin = F.silu(conv_out)  # (b, 1, d_in)

    dt_rank = params["dt_proj"].shape[0]
    dt, B, C = _ssm_params(xin, params, dt_rank, n_state)
    A = -torch.exp(params["A_log"].float())
    dt_, B_, C_ = dt[:, 0], B[:, 0], C[:, 0]  # (b, d_in), (b, N), (b, N)
    xf = xin[:, 0].float()
    decay = torch.exp(dt_[..., None] * A)  # (b, d_in, N)
    h = decay * state.h + (dt_ * xf)[..., None] * B_[:, None, :]
    y = (h @ C_[..., None]).squeeze(-1) + params["D"] * xf
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    return out, MambaState(h=h, conv=window[:, 1:].to(state.conv.dtype))


def init_mamba_state(b: int, d_in: int, n_state: int, d_conv: int,
                     device="cuda") -> MambaState:
    return MambaState(
        h=torch.zeros((b, d_in, n_state), dtype=torch.float32, device=device),
        conv=torch.zeros((b, d_conv - 1, d_in), dtype=torch.float32, device=device),
    )
