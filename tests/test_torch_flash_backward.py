"""The gradient of the port's flash attention against the reference's.

The reference has no backward kernel: its training differentiates the plain
route of ``ops.flash_attention`` (``ref.attention``, or
``ref.attention_blocked`` for long sequences) by autodiff.  Here the port's
plain backward (``flash_attention_bwd_plain``) and the autograd ``Function``
that ``flash_attention`` returns through on the CPU are held against
``jax.vjp`` of those functions on the same numpy inputs, in float32 at
``atol = rtol = 1e-5``: both sides compute in float32 and differ only in
the order of their sums.  Cases: causal, windowed, GQA groups 1, 2 and 4,
Sq != Sk (causal and not), and rows that see no key (a zero gradient).  The
backward kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


# (b, hq, hkv, sq, sk, d, causal, window)
CASES = {
    "causal group 1": (2, 2, 2, 24, 24, 16, True, None),
    "causal group 2": (1, 4, 2, 33, 33, 8, True, None),
    "causal group 4": (2, 8, 2, 40, 40, 16, True, None),
    "window 5": (1, 4, 2, 37, 37, 16, True, 5),
    "non-causal sq < sk": (2, 4, 1, 7, 29, 16, False, None),
    "non-causal sq > sk": (1, 2, 1, 30, 11, 8, False, None),
    "causal sq < sk": (1, 4, 4, 12, 30, 8, True, None),
    "rows that see no key": (1, 2, 1, 40, 8, 16, True, 4),
    "non-causal window": (1, 2, 2, 20, 20, 16, False, 6),
}


def inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    return q, k, v, do


def reference_grads(fn, q, k, v, do, **kw):
    """The reference's output and ``jax.vjp`` of ``fn`` at (q, k, v) against
    ``do``, compiled as one function."""

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw), q, k, v)
        return out, vjp(do)

    out, grads = run(*(jnp.asarray(x) for x in (q, k, v, do)))
    return np.array(out), [np.array(g) for g in grads]


def function_grads(q, k, v, do, **kw):
    """Gradients through ``fa.flash_attention`` (the autograd Function)."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **kw)
    return out, torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_backward_matches_reference_vjp(case):
    b, hq, hkv, sq, sk, d, causal, window = CASES[case]
    q, k, v, do = inputs(b, hq, hkv, sq, sk, d)
    out, want = reference_grads(ref.attention, q, k, v, do, causal=causal, window=window)
    got = fab.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, out, do)), causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_function_matches_reference_vjp(case):
    b, hq, hkv, sq, sk, d, causal, window = CASES[case]
    q, k, v, do = inputs(b, hq, hkv, sq, sk, d, seed=1)
    out, want = reference_grads(ref.attention, q, k, v, do, causal=causal, window=window)
    before = {**fa.LAUNCHES, **fab.LAUNCHES}
    got_out, got = function_grads(q, k, v, do, causal=causal, window=window)
    np.testing.assert_allclose(got_out.detach().numpy(), out, **TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
    assert {**fa.LAUNCHES, **fab.LAUNCHES} == before  # the CPU route launches nothing


def test_blocked_route_matches_reference_vjp():
    """Sq >= 1,024 takes ``attention_blocked`` forward in both packages;
    the gradient is the same function's."""
    q, k, v, do = inputs(1, 2, 1, 1024, 1024, 8, seed=2)
    out, want = reference_grads(ref.attention_blocked, q, k, v, do, causal=True)
    got_out, got = function_grads(q, k, v, do, causal=True)
    np.testing.assert_allclose(got_out.detach().numpy(), out, **TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("case", ["causal group 4", "window 5", "rows that see no key"])
def test_function_equals_autograd_through_plain_forward(case):
    b, hq, hkv, sq, sk, d, causal, window = CASES[case]
    q, k, v, do = inputs(b, hq, hkv, sq, sk, d, seed=3)
    _, got = function_grads(q, k, v, do, causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.attention(tq, tk, tv, causal=causal, window=window)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_autograd_through_the_blocked_forward():
    """``attention_blocked`` writes each query block's output into a slice
    of one tensor; autograd goes through those writes, and its gradient is
    the Function's (the plain backward's) one."""
    q, k, v, do = inputs(1, 2, 1, 1024, 1024, 8, seed=5)
    _, got = function_grads(q, k, v, do, causal=True, window=300)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.attention_blocked(tq, tk, tv, causal=True, window=300)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_rows_that_see_no_key_get_zero_gradient():
    b, hq, hkv, sq, sk, d, causal, window = CASES["rows that see no key"]
    q, k, v, do = inputs(b, hq, hkv, sq, sk, d, seed=4)
    out, (dq, dk, dv) = function_grads(q, k, v, do, causal=causal, window=window)
    blind = torch.arange(sq) - window + 1 >= sk  # no key in (q - window, q]
    assert blind.any() and not blind.all()
    assert (out.detach()[:, :, blind] == 0).all()
    assert (dq[:, :, blind] == 0).all()
    assert dq[:, :, ~blind].abs().sum() > 0


def test_bf16_operands_take_bf16_gradients():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in inputs(1, 4, 2, 16, 16, 8))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    want = fab.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(), do)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_no_graph_without_gradients():
    """Serving calls (no operand requires a gradient) take the forward alone."""
    q, k, v, _ = (torch.from_numpy(x) for x in inputs(1, 2, 1, 8, 8, 8))
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fa.attention(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_backward_variant_by_dtype_and_head_dim(dtype, d):
    """bf16 at head dim 64 or 128 takes the tensor-core backward kernels;
    everything else the CUDA-core ones."""
    want = "mma" if dtype == torch.bfloat16 and d in (64, 128) else "cuda_core"
    assert fab.bwd_variant(dtype, d) == want
