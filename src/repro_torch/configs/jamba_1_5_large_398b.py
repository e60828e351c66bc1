"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536  [arXiv:2403.19887; hf]

Pattern unit (8 blocks = 1 attention + 7 mamba, Jamba's 1:7 ratio); MoE
replaces the MLP every other block (Jamba: e=2).  The master weights are
bf16 and the optimizer Adafactor, the reference's training setting
(DESIGN.md §5); the port serves the model and does not train.
"""

from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig, SSMConfig

_PATTERN = tuple(
    BlockSpec(mixer=("attn" if i == 4 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mlp="swiglu",
    rope="nope",  # Jamba uses no positional encoding (Mamba carries order)
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
    # bf16 master + Adafactor, the reference's training setting (DESIGN.md §5)
    param_dtype="bfloat16",
    optimizer="adafactor",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp="swiglu",
        rope="nope",
        pattern=_PATTERN,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, every=2),
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
        remat=False,
    )
