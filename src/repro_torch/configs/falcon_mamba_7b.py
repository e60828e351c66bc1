"""falcon-mamba-7b [ssm] — attention-free Mamba-1 stack.

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16
[arXiv:2410.05355]

Pure SSM: every block is a Mamba mixer; d_ff=0 means no separate MLP —
the Mamba block (expand=2 in/out projections + gating) is the whole layer.
We model that by pattern=[mamba] with a pass-through MLP of width 0 being
invalid, so the block omits the MLP entirely (mlp='none').
"""

from repro_torch.models.config import BlockSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    mlp="none",
    rope="nope",
    pattern=(BlockSpec(mixer="mamba"),),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-reduced",
        n_layers=4,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=256,
        mlp="none",
        rope="nope",
        pattern=(BlockSpec(mixer="mamba"),),
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
        remat=False,
    )
