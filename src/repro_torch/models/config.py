"""Model configuration of the LM substrate, copied from the reference.

The counterpart of ``repro.models.config``: the same ``ModelConfig``,
``BlockSpec``, ``MoEConfig`` and ``SSMConfig`` dataclasses, the same derived
``hd``, ``n_units``, ``sub_quadratic`` and ``has_decoder``, the same TP-degree
``canonicalize`` (KV heads, q heads, vocab and experts padded so every
sharded dim divides the model axis, the pads recorded on the config) and the
same ``param_count`` and ``active_param_count``.  Host logic only: the
port keeps its own copy so that it imports nothing of the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts
    every: int = 1  # MoE replaces the MLP every ``every`` blocks
    capacity_factor: float = 1.25
    n_experts_padded: int = 0  # set by canonicalize (EP divisibility)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One position inside the pattern unit."""

    mixer: str = "attn"  # 'attn' | 'mamba'
    attn_type: str = "global"  # 'global' | 'local'
    moe: bool = False  # MoE MLP at this position?


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp: str = "swiglu"  # 'swiglu' | 'sq_relu' | 'gelu'
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    rope: str = "standard"  # 'standard' | 'partial' | 'none' (learned abs pos)
    rope_theta: float = 10_000.0
    partial_rotary: float = 0.5  # used when rope == 'partial' (chatglm 2d rope)
    qk_norm: bool = False
    window: int = 4096  # sliding window for 'local' attention blocks
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0
    # modality frontend stubs
    frontend: str = "none"  # 'none' | 'audio' | 'vision'
    vis_tokens: int = 0  # vision prefix length (internvl)
    max_seq: int = 32_768  # learned-pos table size when rope == 'none'
    tie_embeddings: bool = True
    param_dtype: str = "float32"  # 'float32' | 'bfloat16'
    compute_dtype: str = "bfloat16"
    remat: bool = True
    kv_quant: bool = False  # int8 KV cache (per-head-token scales)
    moe_groups: int = 1  # GShard dispatch groups (set to the DP degree)
    # training-memory knobs (per-shape overrides live in input shapes)
    optimizer: str = "adamw"  # 'adamw' | 'adafactor'
    # --- canonicalization records (filled by canonicalize) ---
    n_kv_heads_padded: int = 0
    n_heads_padded: int = 0
    vocab_padded: int = 0

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_units(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not a multiple of the "
            f"pattern length {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long contexts: SSM/hybrid, or all-local+KV-linear-global
        decode (gemma3's 5:1 — decode-time attention is KV-linear)."""
        mixers = {b.mixer for b in self.pattern}
        if "mamba" in mixers:
            return True
        local = sum(b.attn_type == "local" for b in self.pattern)
        return local > 0 and local >= len(self.pattern) - 1

    @property
    def has_decoder(self) -> bool:
        return True  # all registered archs decode (whisper via its decoder)

    def canonicalize(self, tp: int) -> "ModelConfig":
        """Pad heads / KV heads / vocab / experts to the TP degree (recorded).

        Padded q heads get zero output-projection rows (harmless replicas);
        padded KV heads are replicas that multiply the cache; both pads are
        charged against the roofline's useful-FLOPs ratio."""
        hp = self.n_heads
        if hp % tp:
            hp = math.ceil(hp / tp) * tp
        kvp = self.n_kv_heads
        if kvp < tp:
            kvp = tp  # replicate-pad KV heads up to the TP degree
        elif kvp % tp:
            kvp = math.ceil(kvp / tp) * tp
        vp = math.ceil(self.vocab_size / (tp * 128)) * (tp * 128)
        moe = self.moe
        if moe is not None:
            ep = math.ceil(moe.n_experts / tp) * tp
            moe = dataclasses.replace(moe, n_experts_padded=ep)
        return dataclasses.replace(
            self, n_heads_padded=hp, n_kv_heads_padded=kvp, vocab_padded=vp, moe=moe
        )

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Exact parameter count of the constructed model (unpadded dims)."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.rope == "none":
            total += self.max_seq * d
        for blk in self.pattern:
            unit = 0
            if blk.mixer == "attn":
                unit += d * self.n_heads * hd  # wq
                unit += 2 * d * self.n_kv_heads * hd  # wk, wv
                unit += self.n_heads * hd * d  # wo
            else:
                ssm = self.ssm or SSMConfig()
                d_in = ssm.expand * d
                dt_rank = ssm.dt_rank or -(-d // 16)
                unit += d * 2 * d_in  # in_proj
                unit += d_in * ssm.d_conv  # conv
                unit += d_in * (dt_rank + 2 * ssm.d_state)  # x_proj
                unit += dt_rank * d_in  # dt_proj
                unit += d_in * ssm.d_state + d_in  # A, D
                unit += d_in * d  # out_proj
            if blk.moe and self.moe is not None:
                m = self.moe
                mult = 3 if self.mlp == "swiglu" else 2
                unit += m.n_experts * mult * d * m.d_ff_expert
                unit += m.n_shared * mult * d * m.d_ff_expert
                unit += d * m.n_experts  # router
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                unit += mult * d * self.d_ff
            unit += 2 * d  # norms
            total += unit * self.n_units
        total += d  # final norm
        if self.enc_dec:
            enc_unit = 4 * d * d + (3 if self.mlp == "swiglu" else 2) * d * self.d_ff + 2 * d
            # cross attention per decoder layer
            total += self.n_layers * (4 * d * d + d)
            total += self.enc_layers * enc_unit + d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        mult = 3 if self.mlp == "swiglu" else 2
        moe_positions = sum(1 for b in self.pattern if b.moe) * self.n_units
        all_e = m.n_experts * mult * self.d_model * m.d_ff_expert
        act_e = (m.top_k + m.n_shared) * mult * self.d_model * m.d_ff_expert
        return self.param_count() - moe_positions * (all_e - act_e)
