"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553  [arXiv:2404.16821]

The vision tower is stubbed: ``input_specs`` provides precomputed
(b, vis_tokens, d) patch embeddings, prepended to the text embeddings.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    mlp="swiglu",
    rope="standard",
    pattern=(BlockSpec(),),
    frontend="vision",
    vis_tokens=256,  # one 448x448 tile -> 256 visual tokens (InternVL2)
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-reduced",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        mlp="swiglu",
        rope="standard",
        pattern=(BlockSpec(),),
        frontend="vision",
        vis_tokens=8,
        tie_embeddings=False,
        remat=False,
    )
