"""gemma3-12b [dense] — 5:1 local:global attention interleave, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144, head_dim=256,
sliding window 1024 on local layers.  [hf:google/gemma-3-12b-pt]

long_500k eligible: 40/48 layers are sliding-window (O(s*w)); the 8 global
layers are KV-linear at decode (one token against the cache).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

_PATTERN = tuple(
    BlockSpec(attn_type=("global" if i == 5 else "local")) for i in range(6)
)

CONFIG = ModelConfig(
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    mlp="swiglu",
    rope="standard",
    rope_theta=1_000_000.0,
    window=1024,
    pattern=_PATTERN,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-reduced",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=16,
        mlp="swiglu",
        rope="standard",
        window=32,
        pattern=_PATTERN,
        remat=False,
    )
