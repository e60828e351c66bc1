"""Parameters of the LM substrate: initialisation, the compute copy, and the
carry of the reference's parameters into the port.

The tree is the reference's (``repro.models.params``): nested dicts whose
per-layer leaves are stacked over the pattern-unit axis U, e.g.
``units.block_0.attn.wq`` is (U, d, hq, hd).  The layers run as a Python
loop over U (``models.transformer``).

* ``init_params(cfg, generator, device)`` builds the same shapes and dtypes
  as the reference's ``init_params``, head padding included; the values are
  ``randn / sqrt(fan_in)`` from a ``torch.Generator``, not JAX's numbers.  On
  the ``meta`` device nothing is allocated (the full-width shape check).
* ``cast_params(params, cfg)`` makes the compute copy once, at load.
* ``params_from_numpy(tree, cfg, device)`` turns the reference's tree, as
  numpy arrays, into the port's: afterwards both packages compute the same
  function.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.relation import resolve_device
from repro_torch.models.config import ModelConfig, SSMConfig


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class _Init:
    """Draws every initialised leaf from one generator, in a fixed order."""

    def __init__(self, generator: Optional[torch.Generator], device: torch.device):
        self.gen, self.device = generator, device

    def normal(self, shape, dtype, fan_in) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return x.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dtype)

    def full(self, shape, dtype, value) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _norm(init: _Init, cfg: ModelConfig, shape, dtype) -> Dict:
    p = {"scale": init.full(shape, dtype, 1.0)}
    if cfg.norm == "layernorm":
        p["bias"] = init.full(shape, dtype, 0.0)
    return p


def _attn_params(init: _Init, cfg: ModelConfig, u: int, dtype, cross: bool = False) -> Dict:
    """The reference's head padding (``_attn_params``), which preserves the
    model's math exactly: KV heads replicate-pad consecutively (padded head j
    copies true head j // r), except under MHA, where they zero-pad beside
    the q heads; padded q heads get zero wq and wo rows.  Cross attention
    (``cross``) has no qk-norm scales."""
    d, hd = cfg.d_model, cfg.hd
    hq_true, kv_true = cfg.n_heads, cfg.n_kv_heads
    hq = cfg.n_heads_padded or hq_true
    kvp = cfg.n_kv_heads_padded or kv_true
    wq = init.normal((u, d, hq_true, hd), dtype, d)
    if hq > hq_true:
        wq = torch.cat([wq, init.full((u, d, hq - hq_true, hd), dtype, 0.0)], dim=2)
    wk = init.normal((u, d, kv_true, hd), dtype, d)
    wv = init.normal((u, d, kv_true, hd), dtype, d)
    if kvp > kv_true:
        if kv_true == hq_true:
            zeros = init.full((u, d, kvp - kv_true, hd), dtype, 0.0)
            wk = torch.cat([wk, zeros], dim=2)
            wv = torch.cat([wv, zeros], dim=2)
        else:
            if kvp % kv_true:
                raise ValueError(f"{cfg.name}: {kvp} padded kv heads for {kv_true}")
            r = kvp // kv_true
            wk = wk.repeat_interleave(r, dim=2)
            wv = wv.repeat_interleave(r, dim=2)
    wo = init.normal((u, hq_true, hd, d), dtype, hq_true * hd)
    if hq > hq_true:
        wo = torch.cat([wo, init.full((u, hq - hq_true, hd, d), dtype, 0.0)], dim=1)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qk_norm and not cross:
        p["q_norm"] = init.full((u, hd), dtype, 1.0)
        p["k_norm"] = init.full((u, hd), dtype, 1.0)
    return p


def _mlp_params(init: _Init, cfg: ModelConfig, u: int, dtype) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    wi_shape = (u, d, 2, f) if cfg.mlp == "swiglu" else (u, d, f)
    return {"wi": init.normal(wi_shape, dtype, d), "wo": init.normal((u, f, d), dtype, f)}


def _moe_params(init: _Init, cfg: ModelConfig, u: int, dtype) -> Dict:
    """Expert weights over the padded expert count, a float32 router, and
    qwen2-moe's shared experts as one dense MLP of ``n_shared`` widths."""
    m, d = cfg.moe, cfg.d_model
    e, f = m.n_experts_padded or m.n_experts, m.d_ff_expert
    wi_shape = (u, e, d, 2, f) if cfg.mlp == "swiglu" else (u, e, d, f)
    p = {"we_i": init.normal(wi_shape, dtype, d), "we_o": init.normal((u, e, f, d), dtype, f),
         "router": init.normal((u, d, e), torch.float32, d)}
    if m.n_shared:
        fs = f * m.n_shared
        shared_shape = (u, d, 2, fs) if cfg.mlp == "swiglu" else (u, d, fs)
        p["shared_wi"] = init.normal(shared_shape, dtype, d)
        p["shared_wo"] = init.normal((u, fs, d), dtype, fs)
    return p


def _mamba_params(init: _Init, cfg: ModelConfig, u: int, dtype) -> Dict:
    """Mamba-1 mixer weights; ``A_log`` (log 1..N on every channel) and
    ``D`` are float32 whatever the parameter dtype."""
    ssm = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in = ssm.expand * d
    r = ssm.dt_rank or -(-d // 16)
    n = ssm.d_state
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=init.device))
    return {
        "in_proj": init.normal((u, d, 2, d_in), dtype, d),
        "conv_w": init.normal((u, d_in, ssm.d_conv), dtype, ssm.d_conv),
        "conv_b": init.full((u, d_in), dtype, 0.0),
        "x_proj": init.normal((u, d_in, r + 2 * n), dtype, d_in),
        "dt_proj": init.normal((u, r, d_in), dtype, r),
        "dt_bias": init.full((u, d_in), dtype, -4.0),  # softplus ~ 0.018
        "A_log": a_log.expand(u, d_in, n).contiguous(),
        "D": init.full((u, d_in), torch.float32, 1.0),
        "out_proj": init.normal((u, d_in, d), dtype, d_in),
    }


def init_params(
    cfg: ModelConfig, generator: Optional[torch.Generator] = None, device="cuda"
) -> Dict:
    """Parameter tree of ``cfg`` on ``device`` (``"meta"`` allocates nothing):
    the reference's leaves, shapes and dtypes for every block kind (attention
    or Mamba mixer, dense or MoE MLP, cross attention and the encoder of an
    encoder-decoder, learned positions).  ``generator`` defaults to one
    seeded with 0 on the device."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    init = _Init(generator, dev)
    dtype = _dtype(cfg.param_dtype)
    u, d = cfg.n_units, cfg.d_model
    vocab = cfg.vocab_padded or cfg.vocab_size
    params: Dict = {
        "embed": init.normal((vocab, d), dtype, d),
        "final_norm": _norm(init, cfg, (d,), dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((vocab, d), dtype, d)
    if cfg.rope == "none":
        params["pos_embed"] = init.normal((cfg.max_seq, d), dtype, d)
    units: Dict = {}
    for i, blk in enumerate(cfg.pattern):
        bp: Dict = {"pre_norm": _norm(init, cfg, (u, d), dtype)}
        if blk.mixer == "attn":
            bp["attn"] = _attn_params(init, cfg, u, dtype)
        else:
            bp["mamba"] = _mamba_params(init, cfg, u, dtype)
        if blk.moe and cfg.moe is not None:
            bp["post_norm"] = _norm(init, cfg, (u, d), dtype)
            bp["moe"] = _moe_params(init, cfg, u, dtype)
        elif cfg.mlp != "none" and cfg.d_ff > 0:
            bp["post_norm"] = _norm(init, cfg, (u, d), dtype)
            bp["mlp"] = _mlp_params(init, cfg, u, dtype)
        if cfg.enc_dec:
            bp["cross_norm"] = _norm(init, cfg, (u, d), dtype)
            bp["cross"] = _attn_params(init, cfg, u, dtype, cross=True)
        units[f"block_{i}"] = bp
    params["units"] = units
    if cfg.enc_dec:
        eu = cfg.enc_layers
        params["encoder"] = {
            "pos_embed": init.normal((cfg.enc_seq, d), dtype, d),
            "units": {"block_0": {
                "pre_norm": _norm(init, cfg, (eu, d), dtype),
                "attn": _attn_params(init, cfg, eu, dtype),
                "post_norm": _norm(init, cfg, (eu, d), dtype),
                "mlp": _mlp_params(init, cfg, eu, dtype),
            }},
            "final_norm": _norm(init, cfg, (d,), dtype),
        }
    return params


class ComputeParams(dict):
    """The compute copy of a parameter tree, made once by ``cast_params``.
    Besides the tree it holds ``unembed_f32``: the output table in float32
    (the tied embedding of the compute copy), so that logits need no cast of
    the table at each step.  ``forward``, ``prefill`` and ``decode_step``
    take only this."""


# leaves whose numerics need float32 whatever the compute dtype: the MoE
# router (softmax and top-k) and the SSM dynamics
KEEP_F32 = frozenset({"router", "A_log", "D", "dt_bias"})


def _map(tree, fn, key=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(key, tree)


def cast_params(params: Dict, cfg: ModelConfig) -> ComputeParams:
    """Mixed precision: a bf16 copy of the float32 leaves when
    ``cfg.compute_dtype`` is bfloat16, the same tensors otherwise.  Leaves
    named in ``KEEP_F32`` (the MoE router and the SSM dynamics) stay float32,
    as the reference's ``_KEEP_F32`` keeps them."""
    if isinstance(params, ComputeParams):
        return params
    if cfg.compute_dtype == "bfloat16":
        out = ComputeParams(_map(params, lambda key, x: (
            x.to(torch.bfloat16) if x.dtype == torch.float32 and key not in KEEP_F32 else x)))
    else:
        out = ComputeParams(params)
    table = out["embed"] if cfg.tie_embeddings else out["lm_head"]
    out["unembed_f32"] = table.float()
    return out


def params_from_numpy(tree: Dict, cfg: ModelConfig, device="cuda") -> Dict:
    """The port's parameters from the reference's tree given as numpy arrays
    (``np.asarray`` of each leaf; bf16 leaves as ml_dtypes bfloat16).  The
    tree must have the keys, shapes and dtypes ``init_params(cfg)`` has."""
    dev = resolve_device(device)
    want = init_params(cfg, device="meta")

    def convert(path, a, spec):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        if t.shape != spec.shape or t.dtype != spec.dtype:
            raise ValueError(f"{path}: {t.dtype}{tuple(t.shape)}, the config has "
                             f"{spec.dtype}{tuple(spec.shape)}")
        return t.to(dev)

    def walk(path, node, spec):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or node.keys() != spec.keys():
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, the config has {sorted(spec)}")
            return {k: walk(f"{path}.{k}" if path else k, node[k], spec[k]) for k in spec}
        return convert(path, node, spec)

    return walk("", tree, want)
