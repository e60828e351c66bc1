"""The pattern-unit transformer, for the stacks the port runs: attention
blocks (global and sliding-window local) with dense MLPs.

The counterpart of ``repro.models.transformer``.  The layer stack is
``n_units`` repeats of the config's pattern; parameters are stacked over
the unit axis U, and the units run as a Python loop over U (the reference's
``lax.scan``, without remat: the port serves and does not train yet).

Entry points
------------
forward(params, cfg, batch)            -> (logits, aux)   full sequence
prefill(params, cfg, batch)            -> (logits_last, cache)
decode_step(params, cfg, cache, token) -> (logits, cache)  one-token serve
init_cache(cfg, b, s_max, dtype)       -> cache dict

Dtypes are the reference's: compute in ``cfg.compute_dtype`` (bf16 for the
published configs), logits in float32, a bf16 cache by default in
``prefill``.  ``params`` is the compute copy ``cast_params`` makes once at
load; a master tree raises ``TypeError`` (the reference casts it on every
call, which here would copy every weight at every decode step).  The
cache's ``t`` is a Python int.  Mamba, MoE, the encoder-decoder (and its
learned positions), the vision and audio frontends and the int8 KV cache
raise ``NotImplementedError`` naming the slice that brings them;
``loss_fn`` and training wait too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.attention import (
    attend_cache,
    attend_full,
    qkv_project,
    slice_true_kv,
    update_cache,
)
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import apply_norm, embed, mlp, unembed
from repro_torch.models.params import ComputeParams, check_supported


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _compute_copy(params) -> ComputeParams:
    if not isinstance(params, ComputeParams):
        raise TypeError("forward, prefill and decode_step take the compute copy of the "
                        "parameters: pass cast_params(params, cfg), made once at load")
    return params


def _unit(tree, u: int):
    """The parameters of unit ``u``: every stacked leaf indexed at ``u``."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    return tree[u]


def _layers(params: ComputeParams, cfg: ModelConfig):
    """(unit, pattern position, block spec, block params), in stack order."""
    for u in range(cfg.n_units):
        unit = _unit(params["units"], u)
        for i, blk in enumerate(cfg.pattern):
            yield u, i, blk, unit[f"block_{i}"]


def _mlp_block(x: torch.Tensor, bp: Dict, cfg: ModelConfig) -> torch.Tensor:
    if "mlp" in bp:
        h = apply_norm(x, bp["post_norm"], cfg.norm)
        x = x + mlp(h, bp["mlp"], cfg.mlp)
    return x


def _logits(params: ComputeParams, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return unembed(x, params["unembed_f32"])


def _window(cfg: ModelConfig, blk: BlockSpec) -> Optional[int]:
    return cfg.window if blk.attn_type == "local" else None


# ------------------------------------------------------------------ forward
def forward(
    params: ComputeParams, cfg: ModelConfig, batch: Dict
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  batch: ``tokens`` (b, s) int.
    Returns (logits (b, s, V) float32, aux scalar: 0 without MoE)."""
    check_supported(cfg)
    params = _compute_copy(params)
    x = embed(batch["tokens"], params["embed"], _compute_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for _, _, blk, bp in _layers(params, cfg):
        h = apply_norm(x, bp["pre_norm"], cfg.norm)
        t = qkv_project(h, bp["attn"], positions, cfg.rope, cfg.rope_theta,
                        cfg.partial_rotary, cfg.qk_norm)
        x = x + attend_full(t, causal=True, window=_window(cfg, blk), params=bp["attn"])
        x = _mlp_block(x, bp, cfg)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


# -------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, b: int, s_max: int, dtype=torch.bfloat16,
               device="cuda") -> Dict:
    """Cache dict: ``t`` (int) and, per pattern position, ``k`` and ``v``
    (U, b, S, kv, hd) with the TRUE kv heads (padding heads are exact
    replicas); S is ``min(s_max, window)`` for local blocks (a ring buffer)."""
    check_supported(cfg)
    u, kv, hd = cfg.n_units, cfg.n_kv_heads, cfg.hd
    cache: Dict = {"t": 0}
    for i, blk in enumerate(cfg.pattern):
        s_cache = min(s_max, cfg.window) if blk.attn_type == "local" else s_max
        cache[f"block_{i}"] = {
            name: torch.zeros((u, b, s_cache, kv, hd), dtype=dtype, device=device)
            for name in ("k", "v")
        }
    return cache


def decode_step(
    params: ComputeParams, cfg: ModelConfig, cache: Dict, token: torch.Tensor
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode of ``token`` (b, 1): returns (logits (b, V) float32,
    cache).  The cache is updated IN PLACE (position ``t`` written, ``t``
    advanced) and returned; the reference returns an updated copy."""
    check_supported(cfg)
    params = _compute_copy(params)
    t = int(cache["t"])
    x = embed(token, params["embed"], _compute_dtype(cfg))  # (b, 1, d)
    positions = torch.full((x.shape[0], 1), t, dtype=torch.int32, device=x.device)
    mha = cfg.n_kv_heads == cfg.n_heads
    for u, i, blk, bp in _layers(params, cfg):
        h = apply_norm(x, bp["pre_norm"], cfg.norm)
        tt = qkv_project(h, bp["attn"], positions, cfg.rope, cfg.rope_theta,
                         cfg.partial_rotary, cfg.qk_norm)
        ck, cv = cache[f"block_{i}"]["k"][u], cache[f"block_{i}"]["v"][u]
        new_k = slice_true_kv(tt.k, ck.shape[2], mha)
        new_v = slice_true_kv(tt.v, ck.shape[2], mha)
        s_cache = ck.shape[1]
        if blk.attn_type == "local":
            slot, t_eff = t % s_cache, min(t + 1, s_cache)  # ring buffer
        else:
            slot, t_eff = t, t + 1
        update_cache(ck, cv, new_k, new_v, slot)
        # ring-buffer local windows attend over the whole (small) buffer;
        # global attends over [0, t]
        x = x + attend_cache(tt.q, ck, cv, t_eff, None, bp["attn"])
        x = _mlp_block(x, bp, cfg)
    cache["t"] = t + 1
    return _logits(params, cfg, x[:, 0]), cache


def prefill(
    params: ComputeParams,
    cfg: ModelConfig,
    batch: Dict,
    s_max: Optional[int] = None,
    cache_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Dict]:
    """Run the whole prompt, building the KV cache for decode: returns
    (logits of the last position (b, V) float32, cache)."""
    check_supported(cfg)
    params = _compute_copy(params)
    tokens = batch["tokens"]
    x = embed(tokens, params["embed"], _compute_dtype(cfg))
    b, s = x.shape[0], x.shape[1]
    s_max = s_max or s
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, s_max, cache_dtype, device=x.device)
    mha = cfg.n_kv_heads == cfg.n_heads
    for u, i, blk, bp in _layers(params, cfg):
        h = apply_norm(x, bp["pre_norm"], cfg.norm)
        tt = qkv_project(h, bp["attn"], positions, cfg.rope, cfg.rope_theta,
                         cfg.partial_rotary, cfg.qk_norm)
        x = x + attend_full(tt, causal=True, window=_window(cfg, blk), params=bp["attn"])
        k_true = slice_true_kv(tt.k, cfg.n_kv_heads, mha)
        v_true = slice_true_kv(tt.v, cfg.n_kv_heads, mha)
        ck, cv = cache[f"block_{i}"]["k"][u], cache[f"block_{i}"]["v"][u]
        if blk.attn_type == "local":
            # ring-buffer layout: position p lives at index p % s_cache
            s_cache = ck.shape[1]
            keep = min(s, s_cache)
            shift = (s - s_cache) % s_cache if s > s_cache else 0
            for c, new in ((ck, k_true), (cv, v_true)):
                c[:, :keep] = new[:, s - keep:]
                if shift:
                    c.copy_(torch.roll(c, shift, dims=1))
        else:
            ck[:, :s] = k_true
            cv[:, :s] = v_true
        x = _mlp_block(x, bp, cfg)
    cache["t"] = s
    return _logits(params, cfg, x[:, -1]), cache
