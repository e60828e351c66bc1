"""GQA attention: prefill over the whole sequence and encoder-decoder cross
attention (the flash kernel), one-token decode over a KV cache (plain tensor
code), and the int8 KV cache's quantization.

The counterpart of ``repro.models.attention``, in the same layouts:

activations     (b, s, d)
q/k/v heads     (b, s, h, hd) — the flash kernel reads them as (b, h, s, hd)
                views, with no transposed copy
KV cache        (b, S, kv, hd); int8 values with bf16 (b, S, kv) scales
                under ``kv_quant``

KV heads are padded to the canonicalized count (``cfg.n_kv_heads_padded``)
in the weights; padding heads are exact replicas, and the cache stores only
the true heads (``slice_true_kv``).  The reference's sharding hints are the
identity off a mesh and are dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm


class AttnTemps(NamedTuple):
    q: torch.Tensor  # (b, s, hq, hd)
    k: torch.Tensor  # (b, s, kvp, hd)
    v: torch.Tensor  # (b, s, kvp, hd)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, s, d) @ (d, h, hd) -> (b, s, h, hd)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def qkv_project(
    x: torch.Tensor,
    params: dict,
    positions: torch.Tensor,
    rope: str,
    rope_theta: float,
    partial_rotary: float,
    qk_norm: bool,
) -> AttnTemps:
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = _rope_heads(q, positions, rope_theta, rope, partial_rotary)
    k = _rope_heads(k, positions, rope_theta, rope, partial_rotary)
    return AttnTemps(q, k, v)


def _rope_heads(x, positions, theta, mode, partial):
    """x: (b, s, h, hd); positions: (b, s) or (s,)."""
    if mode in ("none", "nope"):
        return x
    xt = x.transpose(1, 2)  # (b, h, s, hd)
    pos = positions if positions.dim() == 2 else positions[None]
    out = apply_rope(xt, pos[:, None, :], theta, mode, partial)
    return out.transpose(1, 2)


def _project_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(b, s, h, hd) @ (h, hd, d) -> (b, s, d)."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:2], h * hd) @ wo.reshape(h * hd, d)


def attend_full(
    t: AttnTemps,
    causal: bool,
    window: Optional[int],
    params: dict,
) -> torch.Tensor:
    """Prefill attention over the whole sequence, through the flash kernel."""
    o = kops.flash_attention(
        t.q.transpose(1, 2), t.k.transpose(1, 2), t.v.transpose(1, 2),
        causal=causal, window=window,
    )
    return _project_out(o.transpose(1, 2), params["wo"])


def attend_cache(
    x_q: torch.Tensor,  # (b, 1, hq, hd) — new-token query (post-rope)
    cache_k: torch.Tensor,  # (b, S, kvp, hd)
    cache_v: torch.Tensor,  # (b, S, kvp, hd)
    t_pos: int,  # number of valid cache positions
    window: Optional[int],
    params: dict,
    k_scale: Optional[torch.Tensor] = None,  # (b, S, kvp) int8-cache scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token decode: a plain masked stable softmax over the whole cache
    (the reference has no kernel here): ``-inf`` logits where masked, the
    ``max(m, -1e30)`` guard for a row with no visible key, and
    ``p / max(denom, 1e-30)``.  An int8 cache is dequantized by its scales
    in float32."""
    b, _, hq, hd = x_q.shape
    S, kvp = cache_k.shape[1], cache_k.shape[2]
    # padded q heads beyond kv * group are zero-output heads (MHA
    # zero-padding): they attend to nothing; restore them as zeros
    group = max(hq // kvp, 1)
    used_q = kvp * group
    scale = 1.0 / (hd ** 0.5)
    q = x_q[:, 0, :used_q].reshape(b, kvp, group, hd).float()  # (b, kvp, g, hd)
    kf = cache_k.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
    kf = kf.permute(0, 2, 3, 1)  # (b, kvp, hd, S)
    logits = (q @ kf) * scale  # (b, kvp, g, S)
    k_pos = torch.arange(S, device=x_q.device)
    mask = k_pos < t_pos
    if window is not None:
        mask &= k_pos > t_pos - 1 - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    vf = cache_v.float()
    if v_scale is not None:
        vf = vf * v_scale.float()[..., None]
    o = p @ vf.transpose(1, 2)  # (b, kvp, g, hd)
    o = o.reshape(b, 1, used_q, hd).to(x_q.dtype)
    if used_q < hq:
        o = torch.nn.functional.pad(o, (0, 0, 0, hq - used_q))
    return _project_out(o, params["wo"])


def attend_cross(
    x: torch.Tensor,  # (b, s, d) decoder states
    enc_kv: Tuple[torch.Tensor, torch.Tensor],  # (b, se, h, hd) each
    params: dict,
) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): the flash kernel,
    non-causal, over the encoder's keys and values."""
    q = _heads(x, params["wq"])
    k, v = enc_kv
    o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=False)
    return _project_out(o.transpose(1, 2), params["wo"])


def slice_true_kv(k: torch.Tensor, kv_true: int, mha: bool) -> torch.Tensor:
    """Strip padding kv heads before caching.  k: (b, s, kvp, hd).

    MHA zero-padding -> the first kv_true heads are the real ones;
    GQA replicate-padding (consecutive repeats) -> every r-th head.
    """
    kvp = k.shape[2]
    if kvp == kv_true:
        return k
    if mha:
        return k[:, :, :kv_true]
    return k[:, :, :: kvp // kv_true]


def update_cache(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    new_k: torch.Tensor,  # (b, 1, kv, hd)
    new_v: torch.Tensor,
    t_pos: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the new token's k and v at position ``t_pos`` IN PLACE (the
    reference returns updated copies) and return the two caches.  Like
    ``lax.dynamic_update_slice``, a position past the end is clamped to the
    last slot."""
    pos = min(max(int(t_pos), 0), cache_k.shape[1] - 1)
    cache_k[:, pos:pos + 1] = new_k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = new_v.to(cache_v.dtype)
    return cache_k, cache_v


# ------------------------------------------------------------ int8 KV cache
def quantize_kv(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization.  k: (b, s, kv, hd).

    Returns (int8 values, bf16 scales (b, s, kv)).  The values come from the
    float32 scale (round half to even, as ``jnp.round``); only the stored
    scale is rounded to bf16."""
    kf = k.float()
    scale = (kf.abs().amax(-1) / 127.0).clamp_min(1e-8)
    q = torch.round(kf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.float()[..., None]
