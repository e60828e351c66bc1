"""whisper-large-v3 [audio] — encoder-decoder; conv frontend is a STUB.

32L (decoder) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866, encoder 32L
over 1500 frames.  [arXiv:2212.04356]

The audio frontend (mel + conv) is stubbed: ``input_specs`` provides
precomputed (b, 1500, d) frame embeddings.  Learned absolute positions
(rope='none'); 20 heads pad to 32 for the 16-way TP mesh (zero-row wo).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp="gelu",
    norm="layernorm",
    rope="none",
    max_seq=32_768,  # assignment shapes exercise the backbone at 32k
    pattern=(BlockSpec(),),
    enc_dec=True,
    enc_layers=32,
    enc_seq=1500,
    frontend="audio",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        mlp="gelu",
        norm="layernorm",
        rope="none",
        max_seq=128,
        pattern=(BlockSpec(),),
        enc_dec=True,
        enc_layers=2,
        enc_seq=32,
        frontend="audio",
        remat=False,
    )
