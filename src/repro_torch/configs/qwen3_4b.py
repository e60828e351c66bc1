"""qwen3-4b [dense] — qk-norm, GQA.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim=128
[hf:Qwen/Qwen3-4B]
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    mlp="swiglu",
    rope="standard",
    rope_theta=1_000_000.0,
    qk_norm=True,
    pattern=(BlockSpec(),),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-reduced",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        head_dim=16,
        mlp="swiglu",
        rope="standard",
        qk_norm=True,
        pattern=(BlockSpec(),),
        remat=False,
    )
