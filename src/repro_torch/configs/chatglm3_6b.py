"""chatglm3-6b [dense] — 2d (partial) RoPE, GQA kv=2.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024  [arXiv:2406.12793]

ChatGLM rotates half of each head (2d RoPE) — rope='partial', ratio 0.5.
kv=2 pads to the TP degree (16) for weight sharding; the replication is
recorded against useful FLOPs.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    mlp="swiglu",
    rope="partial",
    partial_rotary=0.5,
    pattern=(BlockSpec(),),
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-reduced",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=224,
        vocab_size=512,
        mlp="swiglu",
        rope="partial",
        partial_rotary=0.5,
        pattern=(BlockSpec(),),
        tie_embeddings=False,
        remat=False,
    )
