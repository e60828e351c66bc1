"""nemotron-4-340b [dense] — GQA + squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000  [arXiv:2402.16819]

The master weights are bf16 and the optimizer is Adafactor, as the
reference configures the model for training (DESIGN.md §5); the port
serves it and does not train.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp="sq_relu",
    norm="layernorm",
    rope="standard",
    pattern=(BlockSpec(),),
    tie_embeddings=False,
    # bf16 master + Adafactor, the reference's training setting (DESIGN.md §5)
    param_dtype="bfloat16",
    optimizer="adafactor",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-reduced",
        n_layers=4,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=384,
        vocab_size=512,
        mlp="sq_relu",
        norm="layernorm",
        rope="standard",
        pattern=(BlockSpec(),),
        tie_embeddings=False,
        remat=False,
    )
