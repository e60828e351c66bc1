"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]

60 experts pad to 64 for the 16-way EP mesh (router masks the padding).
"""

from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    mlp="swiglu",
    rope="standard",
    pattern=(BlockSpec(moe=True),),
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4),
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-reduced",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab_size=512,
        mlp="swiglu",
        rope="standard",
        pattern=(BlockSpec(moe=True),),
        moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=64, n_shared=2),
        tie_embeddings=False,
        remat=False,
    )
