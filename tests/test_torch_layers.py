"""The port's shared layers against ``repro.models.layers``, from the same
numpy inputs (norm scales are not 1): RMS and layer norm, interleaved-pair
RoPE (full, partial, 1-D and 2-D positions), the MLPs, embedding and the
float32 unembedding.  Tolerance: float32 ``atol=rtol=1e-6``."""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

TOL = dict(atol=1e-6, rtol=1e-6)


def arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def same(got: torch.Tensor, want, **tol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = arr(rng, 3, 5, 64), arr(rng, 64) + 1.0
    same(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
         jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_layer_norm():
    rng = np.random.default_rng(1)
    x, w, b = arr(rng, 4, 32, scale=3.0) + 2.0, arr(rng, 32) + 1.0, arr(rng, 32)
    p = {"scale": w, "bias": b}
    same(tl.apply_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                       "layernorm"),
         jl.apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, "layernorm"))


def test_rms_norm_bf16_keeps_dtype():
    rng = np.random.default_rng(2)
    x, w = arr(rng, 2, 16), arr(rng, 16) + 1.0
    got = tl.rms_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w))
    want = jl.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    # same bf16 input values; one bf16 rounding of the float32 result
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("mode", ["standard", "partial"])
@pytest.mark.parametrize("pos2d", [False, True])
def test_apply_rope(mode, pos2d):
    rng = np.random.default_rng(3)
    x = arr(rng, 2, 3, 16, 32)  # (b, h, s, hd)
    if pos2d:  # per-batch positions, broadcast over heads: (b, 1, s)
        pos = rng.integers(0, 64, (2, 1, 16)).astype(np.int32)
    else:
        pos = np.arange(16, dtype=np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, mode)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, mode)
    same(got, want)


def test_apply_rope_qwen3_theta():
    rng = np.random.default_rng(4)
    x = arr(rng, 1, 2, 8, 128)
    pos = np.arange(8, dtype=np.int32)
    same(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0),
         jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0))


def test_rope_freqs():
    got = tl.rope_freqs(128, 1_000_000.0)
    same(got, jl.rope_freqs(128, 1_000_000.0))


@pytest.mark.parametrize("kind", ["swiglu", "sq_relu", "gelu"])
def test_mlp(kind):
    rng = np.random.default_rng(5)
    d, f = 32, 48
    x = arr(rng, 2, 5, d)
    wi = arr(rng, d, 2, f, scale=0.2) if kind == "swiglu" else arr(rng, d, f, scale=0.2)
    p = {"wi": wi, "wo": arr(rng, f, d, scale=0.2)}
    same(tl.mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, kind),
         jl.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, kind))


def test_embed_unembed():
    rng = np.random.default_rng(6)
    table = arr(rng, 50, 16)
    tokens = rng.integers(0, 50, (2, 7)).astype(np.int32)
    x = tl.embed(torch.from_numpy(tokens), torch.from_numpy(table), torch.float32)
    jx = jl.embed(jnp.asarray(tokens), jnp.asarray(table), jnp.float32)
    same(x, jx)
    same(tl.unembed(x, torch.from_numpy(table)), jl.unembed(jx, jnp.asarray(table)))
