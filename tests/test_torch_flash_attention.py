"""Flash attention: the port's plain PyTorch versions (what the wrapper runs
on CPU tensors) against the reference's Pallas kernel in interpret mode,
as ``tests/test_kernels.py`` runs it, and against the reference's jnp
oracles where the Pallas kernel needs block multiples.

Tolerances are the reference tests' own: float32 ``atol=rtol=2e-5``, bf16
``atol=3e-2``.  The two CUDA kernels themselves are held against the plain
version by ``tests/test_torch_cuda.py`` (marked ``gpu``) and by
``chip_smoke.py``; which of them a call takes (``kernel_variant``) and the
layouts the tensor-core kernel refuses (``tma_strides``) are tested here."""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

F32 = dict(atol=2e-5, rtol=2e-5)


def qkv(seed, b, hq, hkv, sq, sk, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, sk, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, sk, d)).astype(dtype)
    return q, k, v


def port(q, k, v, **kw):
    """The port's dispatch on CPU tensors; it must launch nothing."""
    before = dict(fa.LAUNCHES)
    out = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    assert fa.LAUNCHES == before
    return out


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("s", [128, 256])
def test_causal_gqa_matches_pallas(hq, hkv, s):
    q, k, v = qkv(hq * s, 2, hq, hkv, s, s, 64)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True, block_q=64, block_kv=64, interpret=True)
    got = port(q, k, v, causal=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_sliding_window_matches_pallas():
    q, k, v = qkv(5, 1, 2, 2, 256, 256, 32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True, window=64, block_q=64, block_kv=64,
                                  interpret=True)
    got = port(q, k, v, causal=True, window=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_noncausal_matches_pallas():
    q, k, v = qkv(6, 1, 2, 2, 128, 128, 32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=False, block_q=64, block_kv=64, interpret=True)
    got = port(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("hq,hkv,d,window", [
    (2, 2, 64, None),
    (4, 2, 256, 32),   # gemma3's head dim, windowed, as its local layers
])
def test_bf16_io_matches_pallas(hq, hkv, d, window):
    q, k, v = qkv(7, 1, hq, hkv, 128, 128, d)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window, block_q=64,
                                  block_kv=64, interpret=True)
    # the same bf16 values on both sides
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_uniform_v_passes_through():
    q = np.ones((1, 1, 128, 32), np.float32)
    v = np.full((1, 1, 128, 32), 3.0, np.float32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v),
                                  causal=True, block_q=64, block_kv=64, interpret=True)
    got = port(q, q, v, causal=True)
    # the oracle normalises by a softmax whose sum is 1 only to float32
    # rounding, so it holds 3.0 to the float32 tolerance; the kernels'
    # acc / l holds it to 1e-6 (tests/test_kernels.py, tests/test_torch_cuda.py)
    np.testing.assert_allclose(got.numpy(), 3.0, **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (77, 77, True, None),      # ragged S
    (100, 100, True, 16),      # ragged S with a window
    (1, 1000, False, None),    # Sq != Sk, non-causal (decode-like)
    (77, 1000, False, None),
    (40, 24, True, None),      # causal with Sq > Sk: rows past Sk see all keys
])
def test_ragged_and_cross_match_oracle(sq, sk, causal, window):
    q, k, v = qkv(sq + sk, 2, 4, 2, sq, sk, 16)
    want = ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window)
    got = port(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_rows_with_no_visible_key_are_zero():
    # window 0 hides every key: the oracle's row_visible guard gives zeros
    q, k, v = qkv(9, 1, 2, 1, 64, 64, 16)
    want = ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=0)
    got = port(q, k, v, causal=True, window=0)
    assert not got.numpy().any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 300), (False, None)])
def test_long_sequences_route_to_blocked(causal, window):
    """sq >= 1024 with sq % 512 == 0 and sk % 1024 == 0: the blocked online
    softmax, against the reference's blocked path and its oracle."""
    q, k, v = qkv(11, 1, 2, 1, 1024, 1024, 16)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = ref.attention_blocked(jq, jk, jv, causal=causal, window=window)
    oracle = ref.attention(jq, jk, jv, causal=causal, window=window)
    got = port(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)
    blocked = fa.attention_blocked(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal, window=window)
    assert torch.equal(got, blocked)


def test_explicit_scale():
    q, k, v = qkv(12, 1, 4, 2, 64, 64, 32)
    want = ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, scale=0.3)
    got = port(q, k, v, causal=True, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_plain_versions_agree():
    q, k, v = (torch.from_numpy(x) for x in qkv(13, 2, 4, 2, 512, 1024, 32))
    a = fa.attention(q, k, v, causal=False, window=None)
    b = fa.attention_blocked(q, k, v, causal=False, window=None)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_bad_shapes_raise():
    q = torch.zeros(1, 3, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        tops.flash_attention(q, torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8, 8))


def test_launch_counter_starts_at_zero_after_reset():
    fa.LAUNCHES["flash_attention"] = 5
    fa.LAUNCHES["flash_attention_wgmma"] = 3
    fa.reset_launch_counts()
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
def test_kernel_variant_by_dtype_and_head_dim(dtype, d):
    """bf16 at head dim 64, 128 or 256 takes the tensor-core kernel;
    everything else the CUDA-core kernel (which raises on float16 itself)."""
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128, 256) else "cuda_core"
    assert fa.kernel_variant(dtype, d) == want
    assert fa.KERNEL_NAME[want] in fa.LAUNCHES


def test_kernels_refuse_cpu_tensors():
    """Each kernel function launches only on CUDA tensors: called alone on
    CPU tensors it raises, where the dispatch would run the plain version."""
    q, k, v = (torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16) for _ in range(3))
    for kernel in (fa.flash_attention_wgmma, fa.flash_attention_cuda_core):
        with pytest.raises(ValueError, match="CUDA device"):
            kernel(q, k, v)


def test_tma_layout_is_checked_not_copied():
    """The wgmma kernel's operands: (b, h, s, d) views of (b, s, h, d)
    tensors pass with their own strides; a row stride or a base that is
    not a multiple of 16 bytes is refused, not copied."""
    x = torch.zeros((2, 300, 8, 128), dtype=torch.bfloat16).transpose(1, 2)
    assert fa.tma_strides(x, "q") == [300 * 8 * 128, 128, 8 * 128]
    wide = torch.zeros((2, 300, 16, 256), dtype=torch.bfloat16).transpose(1, 2)  # gemma3's
    assert fa.tma_strides(wide, "q") == [300 * 16 * 256, 256, 16 * 256]
    one = torch.zeros((1, 1, 5, 64), dtype=torch.bfloat16)  # size-1 dims: packed strides
    assert fa.tma_strides(one, "k") == [5 * 64, 5 * 64, 64]
    ragged_rows = torch.zeros((1, 2, 16, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        fa.tma_strides(ragged_rows, "q")
    flat = torch.zeros(2 * 16 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 16, 64)  # base 2 bytes past an aligned one
    with pytest.raises(ValueError, match="TMA"):
        fa.tma_strides(shifted, "v")
    with pytest.raises(ValueError, match="contiguous"):
        fa.tma_strides(torch.zeros((1, 2, 64, 16), dtype=torch.bfloat16).transpose(2, 3), "k")
