"""The pattern-unit transformer: one model covering every architecture the
reference registers.

The counterpart of ``repro.models.transformer``.  The layer stack is
``n_units`` repeats of the config's pattern (jamba's [mamba x4, attn,
mamba x3] with MoE every other block, gemma3's [local x5, global], ...);
parameters are stacked over the unit axis U, and the units run as a Python
loop over U (the reference's ``lax.scan``).  With ``cfg.remat`` and
gradients on, each unit (and each encoder unit) runs under
``torch.utils.checkpoint`` (non-reentrant): its interior is recomputed in
the backward, so a step holds one unit's activations at a time.  The
reference's two-level grouping (``_group_size``, ``_unit_stack``) is a
memory schedule that changes no number and is not copied.  A block is a
pre-norm residual of its mixer (attention, global or sliding-window local,
or a Mamba mixer), then, in an encoder-decoder, cross attention over the
encoder's output, then its MLP (dense or MoE).  Whisper's encoder runs first (``_run_encoder``) over the
stub frontend's frame embeddings; the vision stub's patch embeddings are
put before the text; ``rope == "none"`` adds a learned position table.

Entry points
------------
forward(params, cfg, batch)            -> (logits, aux)   full sequence
loss_fn(params, cfg, batch)            -> (loss, metrics) training
prefill(params, cfg, batch)            -> (logits_last, cache)
decode_step(params, cfg, cache, token) -> (logits, cache)  one-token serve
init_cache(cfg, b, s_max, dtype)       -> cache dict

Dtypes are the reference's: compute in ``cfg.compute_dtype`` (bf16 for the
published configs; MoE routers and SSM dynamics stay float32), logits in
float32, a bf16 KV cache by default in ``prefill``, float32 Mamba states,
and an int8 KV cache with bf16 scales under ``cfg.kv_quant``.  ``params`` is
the compute copy ``cast_params`` makes once at load; a master tree raises
``TypeError`` (the reference casts it on every call, which here would copy
every weight at every decode step).  The cache's ``t`` is a Python int.
``loss_fn`` alone takes the master tree: it casts it inside, with gradients
on, as the reference does at every step, so the gradient reaches the
float32 masters (and the float32 router and SSM leaves, which the cast
keeps as they are).

The reference's quirks are kept: ``prefill`` stores the KV cache in
``cache_dtype`` even under ``kv_quant`` (only ``decode_step`` quantizes, and
the int8 cache with its scales comes from ``init_cache``), and a prefill's
Mamba state is the one after the prompt's last token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.relation import resolve_device
from repro_torch.models import moe as _moe
from repro_torch.models.attention import (
    attend_cache,
    attend_cross,
    attend_full,
    qkv_project,
    quantize_kv,
    slice_true_kv,
    update_cache,
)
from repro_torch.models.config import BlockSpec, ModelConfig, SSMConfig
from repro_torch.models.layers import apply_norm, embed, mlp, unembed
from repro_torch.models.mamba import MambaState, mamba_decode_step, mamba_mixer
from repro_torch.models.params import ComputeParams, cast_params


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


def _layers(units: Dict, cfg: ModelConfig):
    """(unit, pattern position, block spec, block params), in stack order."""
    for u in range(cfg.n_units):
        unit = _unit(units, u)
        for i, blk in enumerate(cfg.pattern):
            yield u, i, blk, unit[f"block_{i}"]


def _ssm(cfg: ModelConfig) -> SSMConfig:
    return cfg.ssm or SSMConfig()


def _mlp_block(x: torch.Tensor, bp: Dict, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP (MoE or dense) as a residual: (x, aux)."""
    if "moe" in bp:
        h = apply_norm(x, bp["post_norm"], cfg.norm)
        m = cfg.moe
        out, aux = _moe.moe_mlp(h, bp["moe"], m.n_experts, m.top_k, m.capacity_factor,
                                cfg.mlp, n_groups=cfg.moe_groups)
        return x + out, aux
    if "mlp" in bp:
        h = apply_norm(x, bp["post_norm"], cfg.norm)
        x = x + mlp(h, bp["mlp"], cfg.mlp)
    return x, None


def _cross_block(x: torch.Tensor, bp: Dict, cfg: ModelConfig, enc_kv) -> torch.Tensor:
    if enc_kv is not None and "cross" in bp:
        h = apply_norm(x, bp["cross_norm"], cfg.norm)
        x = x + attend_cross(h, enc_kv, bp["cross"])
    return x


def _logits(params: ComputeParams, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return unembed(x, params["unembed_f32"])


def _window(cfg: ModelConfig, blk: BlockSpec) -> Optional[int]:
    return cfg.window if blk.attn_type == "local" else None


def _embed_inputs(params: ComputeParams, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Token embeddings, the vision prefix before them, learned positions."""
    dtype = _compute_dtype(cfg)
    x = embed(batch["tokens"], params["embed"], dtype)
    if cfg.frontend == "vision":
        x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)
    if cfg.rope == "none":
        x = x + params["pos_embed"][:x.shape[1]][None].to(dtype)
    return x


# ------------------------------------------------------------------ encoder
def _run_encoder(params: ComputeParams, cfg: ModelConfig, enc_frames: torch.Tensor):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): non-causal self attention and the MLP, learned positions.
    Returns the encoder output (b, se, d) shared by every decoder layer."""
    enc = params["encoder"]
    dtype = _compute_dtype(cfg)
    x = enc_frames.to(dtype) + enc["pos_embed"][None].to(dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for u in range(cfg.enc_layers):
        x = _remat(cfg, _encoder_unit, x, _unit(enc["units"]["block_0"], u), cfg, positions)
    return apply_norm(x, enc["final_norm"], cfg.norm)


def _encoder_unit(x, up: Dict, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(x, up["pre_norm"], cfg.norm)
    t = qkv_project(h, up["attn"], positions, "none", cfg.rope_theta, 0.5, False)
    x = x + attend_full(t, causal=False, window=None, params=up["attn"])
    h = apply_norm(x, up["post_norm"], cfg.norm)
    return x + mlp(h, up["mlp"], cfg.mlp)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    holds and gradients are on."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _cross_kv(params: ComputeParams, cfg: ModelConfig, enc_out: torch.Tensor):
    """Cross-attention K/V of every decoder unit, computed once: stacked
    (U, b, se, h, hd) pairs (whisper's cross attention has as many kv heads
    as q heads)."""
    cross = params["units"]["block_0"]["cross"]
    k = torch.einsum("bsd,udhk->ubshk", enc_out, cross["wk"])
    v = torch.einsum("bsd,udhk->ubshk", enc_out, cross["wv"])
    return k, v


def _encoder_kv(params: ComputeParams, cfg: ModelConfig, batch: Dict):
    if not cfg.enc_dec:
        return None
    return _cross_kv(params, cfg, _run_encoder(params, cfg, batch["enc_frames"]))


def _mamba_final_state(h: torch.Tensor, mp: Dict, ssm: SSMConfig, chunk: int = 128) -> MambaState:
    """The reference's prefill helper: the Mamba state after consuming h
    (b, s, d).  ``prefill`` takes it from its mixer's own pass
    (``mamba_mixer(..., return_state=True)``), as this does, instead of
    scanning twice."""
    return mamba_mixer(h, mp, ssm.d_state, ssm.d_conv, chunk, return_state=True)[1]


# ------------------------------------------------------------------ forward
def forward(
    params: ComputeParams, cfg: ModelConfig, batch: Dict, mamba_chunk: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  batch: ``tokens`` (b, s_text) int;
    [``enc_frames`` (b, se, d)] audio stub; [``patch_embeds`` (b, vis, d)]
    vision stub.  Returns (logits (b, s, V) float32, aux: the MoE aux loss
    summed over blocks, a float32 0 without MoE)."""
    return _forward(_compute_copy(params), cfg, batch, mamba_chunk)


def _forward(params: ComputeParams, cfg: ModelConfig, batch: Dict, mamba_chunk: int):
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_kv = _encoder_kv(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(cfg.n_units):
        kv_u = None if enc_kv is None else (enc_kv[0][u], enc_kv[1][u])
        x, a = _remat(cfg, _forward_unit, x, _unit(params["units"], u), cfg, positions, kv_u,
                      mamba_chunk)
        aux = aux + a
    return _logits(params, cfg, x), aux


def _forward_unit(x, unit: Dict, cfg: ModelConfig, positions: torch.Tensor, enc_kv,
                  mamba_chunk: int):
    """One pattern unit over the whole sequence: (x, its blocks' MoE aux
    loss summed, a float32 0 without MoE)."""
    ssm = _ssm(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(cfg.pattern):
        bp = unit[f"block_{i}"]
        h = apply_norm(x, bp["pre_norm"], cfg.norm)
        if blk.mixer == "attn":
            t = qkv_project(h, bp["attn"], positions, cfg.rope, cfg.rope_theta,
                            cfg.partial_rotary, cfg.qk_norm)
            x = x + attend_full(t, causal=True, window=_window(cfg, blk), params=bp["attn"])
        else:
            x = x + mamba_mixer(h, bp["mamba"], ssm.d_state, ssm.d_conv, mamba_chunk)
        x = _cross_block(x, bp, cfg, enc_kv)
        x, a = _mlp_block(x, bp, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


def loss_fn(
    params: Dict,
    cfg: ModelConfig,
    batch: Dict,
    aux_weight: float = 0.01,
    mamba_chunk: int = 128,
) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy over ``batch["labels"]`` (b, s) int32,
    masked where a label is negative, plus ``aux_weight`` times the MoE aux
    loss; the vision prefix's logits are dropped.  ``params`` is the master
    tree (cast here, with gradients on) or a compute copy.  Returns (loss,
    {"ce", "aux", "tokens"}), float32 scalars, as the reference's
    ``loss_fn``."""
    logits, aux = _forward(cast_params(params, cfg), cfg, batch, mamba_chunk)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    ce = nll.sum() / denom
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": denom}


# -------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, b: int, s_max: int, dtype=torch.bfloat16,
               device="cuda") -> Dict:
    """Cache dict: ``t`` (int) and, per pattern position, for attention
    ``k`` and ``v`` (U, b, S, kv, hd) with the TRUE kv heads (padding heads
    are exact replicas; S is ``min(s_max, window)`` for local blocks, a ring
    buffer), int8 with bf16 ``k_scale``/``v_scale`` (U, b, S, kv) under
    ``kv_quant``; for Mamba ``h`` (U, b, d_in, N) and ``conv`` (U, b,
    d_conv - 1, d_in) in float32.  An encoder-decoder adds ``cross_k`` and
    ``cross_v`` (U, b, se, hq padded, hd), zero until a prefill fills them."""
    u, kv, hd = cfg.n_units, cfg.n_kv_heads, cfg.hd
    ssm = _ssm(cfg)
    d_in = ssm.expand * cfg.d_model
    device = resolve_device(device)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    cache: Dict = {"t": 0}
    for i, blk in enumerate(cfg.pattern):
        if blk.mixer == "attn":
            s_cache = min(s_max, cfg.window) if blk.attn_type == "local" else s_max
            kv_dt = torch.int8 if cfg.kv_quant else dtype
            c = {name: zeros((u, b, s_cache, kv, hd), kv_dt) for name in ("k", "v")}
            if cfg.kv_quant:
                for name in ("k_scale", "v_scale"):
                    c[name] = zeros((u, b, s_cache, kv), torch.bfloat16)
        else:
            c = {"h": zeros((u, b, d_in, ssm.d_state), torch.float32),
                 "conv": zeros((u, b, ssm.d_conv - 1, d_in), torch.float32)}
        cache[f"block_{i}"] = c
    if cfg.enc_dec:
        hqp = cfg.n_heads_padded or cfg.n_heads
        for name in ("cross_k", "cross_v"):
            cache[name] = zeros((u, b, cfg.enc_seq, hqp, hd), dtype)
    return cache


def decode_step(
    params: ComputeParams, cfg: ModelConfig, cache: Dict, token: torch.Tensor
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode of ``token`` (b, 1): returns (logits (b, V) float32,
    cache).  The cache is updated IN PLACE (position ``t`` written, Mamba
    states replaced, ``t`` advanced) and returned; the reference returns an
    updated copy."""
    params = _compute_copy(params)
    t = int(cache["t"])
    dtype = _compute_dtype(cfg)
    x = embed(token, params["embed"], dtype)  # (b, 1, d)
    if cfg.rope == "none":
        pos = min(t, params["pos_embed"].shape[0] - 1)  # dynamic_slice clamps
        x = x + params["pos_embed"][pos:pos + 1][None].to(dtype)
    positions = torch.full((x.shape[0], 1), t, dtype=torch.int32, device=x.device)
    mha = cfg.n_kv_heads == cfg.n_heads
    ssm = _ssm(cfg)
    for u, i, blk, bp in _layers(params["units"], cfg):
        c = cache[f"block_{i}"]
        h = apply_norm(x, bp["pre_norm"], cfg.norm)
        if blk.mixer == "attn":
            tt = qkv_project(h, bp["attn"], positions, cfg.rope, cfg.rope_theta,
                             cfg.partial_rotary, cfg.qk_norm)
            ck, cv = c["k"][u], c["v"][u]
            new_k = slice_true_kv(tt.k, ck.shape[2], mha)
            new_v = slice_true_kv(tt.v, ck.shape[2], mha)
            scales = {}
            if cfg.kv_quant:
                new_k, new_ks = quantize_kv(new_k)
                new_v, new_vs = quantize_kv(new_v)
            s_cache = ck.shape[1]
            if blk.attn_type == "local":
                slot, t_eff = t % s_cache, min(t + 1, s_cache)  # ring buffer
            else:
                slot, t_eff = t, t + 1
            update_cache(ck, cv, new_k, new_v, slot)
            if cfg.kv_quant:  # the scales' slot, written the same way
                scales = dict(zip(("k_scale", "v_scale"), update_cache(
                    c["k_scale"][u], c["v_scale"][u], new_ks, new_vs, slot)))
            # ring-buffer local windows attend over the whole (small)
            # buffer; global attends over [0, t]
            x = x + attend_cache(tt.q, ck, cv, t_eff, None, bp["attn"], **scales)
        else:
            st = MambaState(c["h"][u], c["conv"][u])
            o, st = mamba_decode_step(h, st, bp["mamba"], ssm.d_state, ssm.d_conv)
            x = x + o
            c["h"][u] = st.h
            c["conv"][u] = st.conv
        if cfg.enc_dec and "cross" in bp:
            hq = apply_norm(x, bp["cross_norm"], cfg.norm)
            q = torch.einsum("bsd,dhk->bshk", hq, bp["cross"]["wq"])
            x = x + attend_cache(q, cache["cross_k"][u], cache["cross_v"][u], cfg.enc_seq,
                                 None, bp["cross"])
        x, _ = _mlp_block(x, bp, cfg)
    cache["t"] = t + 1
    return _logits(params, cfg, x[:, 0]), cache


def prefill(
    params: ComputeParams,
    cfg: ModelConfig,
    batch: Dict,
    s_max: Optional[int] = None,
    cache_dtype=torch.bfloat16,
    mamba_chunk: int = 128,
) -> Tuple[torch.Tensor, Dict]:
    """Run the whole prompt, building the cache for decode: returns (logits
    of the last position (b, V) float32, cache).  The batch is
    ``forward``'s."""
    params = _compute_copy(params)
    x = _embed_inputs(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    s_max = s_max or s
    positions = torch.arange(s, device=x.device)
    # the reference's prefill stashes K/V in cache_dtype even under kv_quant
    cache = init_cache(dataclasses.replace(cfg, kv_quant=False), b, s_max, cache_dtype,
                       device=x.device)
    enc_kv = _encoder_kv(params, cfg, batch)
    mha = cfg.n_kv_heads == cfg.n_heads
    ssm = _ssm(cfg)
    for u, i, blk, bp in _layers(params["units"], cfg):
        c = cache[f"block_{i}"]
        h = apply_norm(x, bp["pre_norm"], cfg.norm)
        if blk.mixer == "attn":
            tt = qkv_project(h, bp["attn"], positions, cfg.rope, cfg.rope_theta,
                             cfg.partial_rotary, cfg.qk_norm)
            x = x + attend_full(tt, causal=True, window=_window(cfg, blk), params=bp["attn"])
            k_true = slice_true_kv(tt.k, cfg.n_kv_heads, mha)
            v_true = slice_true_kv(tt.v, cfg.n_kv_heads, mha)
            ck, cv = c["k"][u], c["v"][u]
            if blk.attn_type == "local":
                # ring-buffer layout: position p lives at index p % s_cache
                s_cache = ck.shape[1]
                keep = min(s, s_cache)
                shift = (s - s_cache) % s_cache if s > s_cache else 0
                for cc, new in ((ck, k_true), (cv, v_true)):
                    cc[:, :keep] = new[:, s - keep:]
                    if shift:
                        cc.copy_(torch.roll(cc, shift, dims=1))
            else:
                ck[:, :s] = k_true
                cv[:, :s] = v_true
        else:
            o, st = mamba_mixer(h, bp["mamba"], ssm.d_state, ssm.d_conv, mamba_chunk,
                                return_state=True)
            x = x + o
            c["h"][u] = st.h
            c["conv"][u] = st.conv
        x = _cross_block(x, bp, cfg, None if enc_kv is None else (enc_kv[0][u], enc_kv[1][u]))
        x, _ = _mlp_block(x, bp, cfg)
    if enc_kv is not None:
        cache["cross_k"] = enc_kv[0].to(cache_dtype)
        cache["cross_v"] = enc_kv[1].to(cache_dtype)
    cache["t"] = s
    return _logits(params, cfg, x[:, -1]), cache
