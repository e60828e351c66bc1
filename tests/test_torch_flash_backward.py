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
logsumexp the forward saves for the wgmma backward (``with_lse``) is held
against ``jax.nn.logsumexp`` of the reference's masked scores, the plain
backward given it against the same backward computing its own, the
gradient through the (b, s, h, d) views ``attend_full`` passes against
``jax.vjp``, and the wgmma backward's stride helper on the layouts it takes
and refuses.  The backward kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import functools
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


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _reference_lse(q, k, causal, window):
    group = q.shape[1] // k.shape[1]
    sq, sk = q.shape[2], k.shape[2]
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, jnp.repeat(k, group, axis=1)) / np.sqrt(q.shape[-1])
    q_pos, k_pos = jnp.arange(sq), jnp.arange(sk)
    mask = jnp.ones((sq, sk), dtype=bool)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return jax.nn.logsumexp(jnp.where(mask[None, None], logits, -jnp.inf), axis=-1)


def reference_lse(q, k, causal, window):
    """``jax.nn.logsumexp`` over the masked scores ``ref.attention`` forms:
    its einsum, scale and mask, ``-inf`` where masked (so ``-inf`` for a row
    that sees no key)."""
    return np.array(_reference_lse(jnp.asarray(q), jnp.asarray(k), causal=causal, window=window))


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_forward_lse_matches_reference(case):
    """``flash_attention_plain(with_lse=True)``: the output unchanged and
    each row's logsumexp within 1e-5 of the reference's; a row that sees no
    key gets +inf (the reference's logsumexp is -inf there), which makes
    exp(s - lse) exactly 0."""
    b, hq, hkv, sq, sk, d, causal, window = CASES[case]
    q, k, v, _ = inputs(b, hq, hkv, sq, sk, d, seed=6)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window, with_lse=True)
    assert torch.equal(out, fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window))
    want = reference_lse(q, k, causal, window)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    blind = np.isneginf(want)
    assert (case == "rows that see no key") == blind.any()
    assert np.isposinf(lse.numpy()[blind]).all()
    np.testing.assert_allclose(lse.numpy()[~blind], want[~blind], **TOL)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_backward_given_lse_equals_its_own(case):
    """The plain backward given the forward's saved logsumexp against the
    same backward computing its own, within 1e-6."""
    b, hq, hkv, sq, sk, d, causal, window = CASES[case]
    q, k, v, do = (torch.from_numpy(x) for x in inputs(b, hq, hkv, sq, sk, d, seed=7))
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    given = fab.flash_attention_bwd_plain(q, k, v, o, do, lse=lse, **kw)
    own = fab.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    for g, w in zip(given, own):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_function_through_views_matches_reference_vjp(case):
    """The autograd ``Function`` on the (b, s, h, d) views ``attend_full``
    passes (q, k, v transposed, not copied) against ``jax.vjp`` of the
    reference on the same values; each gradient lands in its leaf's
    (b, s, h, d) layout."""
    b, hq, hkv, sq, sk, d, causal, window = CASES[case]
    q, k, v, do = inputs(b, hq, hkv, sq, sk, d, seed=8)
    out, want = reference_grads(ref.attention, q, k, v, do, causal=causal, window=window)
    leaves = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).requires_grad_()
              for x in (q, k, v)]
    got_out = fa.flash_attention(*(x.transpose(1, 2) for x in leaves), causal=causal,
                                 window=window)
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(got_out.detach().numpy(), out, **TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 1, 3), w, **TOL, err_msg=name)


def _layouts():
    """(name, tensor, whether TMA takes it) for a bf16 (2, 4, 24, 64)
    operand."""
    base = torch.zeros((2, 24, 4, 64), dtype=torch.bfloat16)
    padded = torch.zeros((2, 4, 24, 72), dtype=torch.bfloat16)
    ragged = torch.zeros((2, 4, 24, 68), dtype=torch.bfloat16)
    return [
        ("contiguous (b, h, s, d)", torch.zeros((2, 4, 24, 64), dtype=torch.bfloat16), True),
        ("(b, s, h, d) view", base.transpose(1, 2), True),
        ("one head of a fused qkv projection", torch.zeros((2, 24, 12, 64), dtype=torch.bfloat16)
         .transpose(1, 2)[:, 4:8], True),
        ("head dim strided", torch.zeros((2, 4, 64, 24), dtype=torch.bfloat16).transpose(2, 3),
         False),
        ("rows 144 bytes apart", padded[..., :64], True),
        ("rows 136 bytes apart", ragged[..., :64], False),
        ("base 2 bytes past 16", torch.zeros(2 * 4 * 24 * 64 + 1, dtype=torch.bfloat16)[1:]
         .view(2, 4, 24, 64), False),
        ("broadcast gradient", torch.ones((), dtype=torch.bfloat16).expand(2, 4, 24, 64), False),
    ]


@pytest.mark.parametrize("name,x,taken", _layouts(), ids=[c[0] for c in _layouts()])
def test_wgmma_backward_strides(name, x, taken):
    """``wgmma_strides``: the (batch, head, seq) strides TMA reads a layout
    with, or ``ValueError`` naming the operand and the kernel."""
    if taken:
        got = fab.wgmma_strides(dout=x)["dout"]
        for dim, st in zip(range(3), got):
            assert st == x.stride(dim) or x.shape[dim] == 1
        assert got[2] % 8 == 0
    else:
        with pytest.raises(ValueError, match="wgmma backward: dout"):
            fab.wgmma_strides(dout=x)


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
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "cuda_core"
    assert fab.bwd_variant(dtype, d) == want
