"""olmoe-1b-7b [moe] — 64 experts, top-8, qk-norm.

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8
[arXiv:2409.02060]
"""

from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    mlp="swiglu",
    rope="standard",
    qk_norm=True,
    pattern=(BlockSpec(moe=True),),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-reduced",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab_size=512,
        mlp="swiglu",
        rope="standard",
        qk_norm=True,
        pattern=(BlockSpec(moe=True),),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
        tie_embeddings=False,
        remat=False,
    )
