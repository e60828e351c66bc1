"""The port's Mamba-1 mixer (``repro_torch.models.mamba``) against the
reference's (``repro.models.mamba``): ``mamba_mixer`` over whole sequences
(chunks that divide the length, a ragged last chunk padded with dt = 0
steps, one chunk longer than the sequence), ``mamba_decode_step`` carried on
from a prefix, and the final state ``_mamba_final_state`` gives prefill's
cache, on the same numpy inputs and weights.

Tolerances: the port's in-chunk scan is a log-depth doubling where the
reference runs ``jax.lax.associative_scan``; both multiply the same decay
factors in (0, 1] in a different association, so float32 results are held
at ``atol=rtol=1e-5`` (the differences measured are below 2e-6), and bf16
at ``atol=3e-2`` (the reference tests' bf16 tolerance)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import transformer as jt
from repro.models.config import SSMConfig as JSSM
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as tt
from repro_torch.models.config import SSMConfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=0)
D, N, K = 32, 4, 4  # d_model, d_state, d_conv
D_IN, R = 2 * D, 2  # expand 2, dt_rank ceil(32 / 16)


def weights(seed, dtype=np.float32):
    """A Mamba block's weights as the reference initialises their shapes,
    with random conv bias, dt bias and A_log so every term matters."""
    rng = np.random.default_rng(seed)

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    p = {
        "in_proj": w(D, 2, D_IN, fan_in=D),
        "conv_w": w(D_IN, K, fan_in=K),
        "conv_b": w(D_IN, fan_in=4),
        "x_proj": w(D_IN, R + 2 * N, fan_in=D_IN),
        "dt_proj": w(R, D_IN, fan_in=R),
        "dt_bias": (-4.0 + rng.standard_normal(D_IN)).astype(np.float32),
        "A_log": np.log(np.arange(1, N + 1, dtype=np.float32))[None].repeat(D_IN, 0)
        + 0.1 * rng.standard_normal((D_IN, N)).astype(np.float32),
        "D": (1.0 + 0.1 * rng.standard_normal(D_IN)).astype(np.float32),
        "out_proj": w(D_IN, D, fan_in=D_IN),
    }
    keep = {"A_log", "D", "dt_bias"}  # float32 under bf16 compute (cast_params)
    jp = {n: jnp.asarray(v, jnp.float32 if n in keep else dtype) for n, v in p.items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = {n: torch.from_numpy(v).to(torch.float32 if n in keep else tdt) for n, v in p.items()}
    return jp, tp


def inputs(seed, b, s):
    return np.random.default_rng(seed + 100).standard_normal((b, s, D)).astype(np.float32)


def ref_mixer(x, jp, chunk):
    return jax.jit(jmamba.mamba_mixer, static_argnums=(2, 3, 4))(x, jp, N, K, chunk)


@pytest.mark.parametrize("s, chunk", [(16, 8), (13, 4), (5, 8)])
def test_mixer_matches_reference(s, chunk):
    jp, tp = weights(s)
    x = inputs(s, 2, s)
    want = ref_mixer(jnp.asarray(x), jp, chunk)
    got, st = tmamba.mamba_mixer(torch.from_numpy(x), tp, N, K, chunk, return_state=True)
    assert got.dtype == torch.float32 and got.shape == (2, s, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the state the mixer hands to decode is the reference's prefill state
    jst = jt._mamba_final_state(jnp.asarray(x), jp, JSSM(d_state=N, d_conv=K), chunk)
    assert st.h.dtype == torch.float32 and st.conv.shape == (2, K - 1, D_IN)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), **F32)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv), **F32)


def test_final_state_matches_reference():
    """``_mamba_final_state`` (the reference's prefill helper, default chunk
    128, longer than this sequence) against the reference's."""
    jp, tp = weights(3)
    x = inputs(3, 2, 11)
    want = jt._mamba_final_state(jnp.asarray(x), jp, JSSM(d_state=N, d_conv=K))
    got = tt._mamba_final_state(torch.from_numpy(x), tp, SSMConfig(d_state=N, d_conv=K))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **F32)
    np.testing.assert_allclose(got.conv.numpy(), np.asarray(want.conv), **F32)


def test_decode_steps_continue_the_prefix():
    """Five decode steps from the prefix's state, against the reference's
    from its own state; and the port's steps equal its own mixer over the
    whole sequence (the recurrence is exact across the prefill boundary)."""
    jp, tp = weights(4)
    x = inputs(4, 2, 12)
    _, st = tmamba.mamba_mixer(torch.from_numpy(x[:, :7]), tp, N, K, 4, return_state=True)
    jst = jt._mamba_final_state(jnp.asarray(x[:, :7]), jp, JSSM(d_state=N, d_conv=K), 4)
    step = jax.jit(jmamba.mamba_decode_step, static_argnums=(3, 4))
    outs = []
    for t in range(7, 12):
        want, jst = step(jnp.asarray(x[:, t:t + 1]), jst, jp, N, K)
        got, st = tmamba.mamba_decode_step(torch.from_numpy(x[:, t:t + 1]), st, tp, N, K)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), **F32)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv), **F32)
        outs.append(got)
    full = tmamba.mamba_mixer(torch.from_numpy(x), tp, N, K, 4)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full[:, 7:].numpy(), **F32)


def test_init_state_and_bf16_mixer():
    """``init_mamba_state``'s zeros, and the mixer and one decode step in
    bf16 compute (float32 A_log, D and dt_bias), in bf16."""
    st = tmamba.init_mamba_state(2, D_IN, N, K, device="cpu")
    assert st.h.shape == (2, D_IN, N) and st.conv.shape == (2, K - 1, D_IN)
    assert st.h.dtype == st.conv.dtype == torch.float32 and not st.h.any()
    jp, tp = weights(6, jnp.bfloat16)
    x = inputs(6, 2, 10)
    want = ref_mixer(jnp.asarray(x, jnp.bfloat16), jp, 4)
    got = tmamba.mamba_mixer(torch.from_numpy(x).to(torch.bfloat16), tp, N, K, 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16)
    jst = jmamba.init_mamba_state(2, D_IN, N, K)
    want, _ = jmamba.mamba_decode_step(jnp.asarray(x[:, :1], jnp.bfloat16), jst, jp, N, K)
    got, _ = tmamba.mamba_decode_step(torch.from_numpy(x[:, :1]).to(torch.bfloat16), st, tp,
                                      N, K)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16)
