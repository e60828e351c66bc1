"""The port's LM substrate against ``repro.models``: ``forward``, ``prefill``
(logits and cache) and ``decode_step`` on the reduced qwen3-4b config, from
the reference's own parameters carried over by ``params_from_numpy`` with
randomised norm scales, and the same token ids.

Tolerances: with float32 compute, ``atol=rtol=2e-3`` — the reference's own
prefill/decode tolerance (``tests/test_arch_smoke.py``); the differences
measured are below 2e-5, and ``TIGHT`` pins that too.  With bf16 compute
(the published dtype), both packages round activations to bf16 at
different places: over 13 seeds the logits (magnitude up to 4) differed by
at most 0.128, so ``atol=0.15`` is stated.  The full-width config is checked without allocating it: its
parameter tree on the ``meta`` device against ``abstract_params``."""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models.params import abstract_params
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.params import cast_params, init_params, params_from_numpy
from repro_torch.testing import tree_paths, tree_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

B, S = 2, 16
REF_TOL = dict(atol=2e-3, rtol=2e-3)
TIGHT = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=0.15, rtol=0)


def configs(tp, compute_dtype="float32", attn_types=None, **changes):
    """The same reduced qwen3-4b config in both packages; ``attn_types``
    replaces the pattern by attention blocks of those types."""
    pair = []
    for get in (jax_get_config, get_config):
        cfg = get("qwen3-4b", reduced=True)
        if attn_types is not None:
            spec = type(cfg.pattern[0])
            changes["pattern"] = tuple(spec(attn_type=a) for a in attn_types)
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype, **changes)
        pair.append(cfg.canonicalize(tp=tp))
    return pair


def shared_params(jcfg, tcfg, seed):
    """The reference's initial parameters with every norm scale randomised
    around 1, as numpy, in both packages (the port's as its compute copy)."""
    tree = tree_to_numpy(jax_init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    for path, leaf in tree_paths(tree).items():
        if path.endswith("scale") or path.endswith("_norm"):
            leaf[...] = 1.0 + 0.5 * rng.standard_normal(leaf.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jp, cast_params(params_from_numpy(tree, tcfg, device="cpu"), tcfg)


def tokens(cfg, seed, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(tree_to_numpy(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_f32_forward_prefill_decode_match_reference(tp):
    jcfg, tcfg = configs(tp)
    jp, tp_ = shared_params(jcfg, tcfg, seed=tp)
    toks = tokens(jcfg, tp, S + 8)

    jl, _ = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, aux = tt.forward(tp_, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (B, S + 8, jcfg.vocab_padded)
    assert float(aux) == 0.0
    close(tl, jl, REF_TOL)
    close(tl, jl, TIGHT)

    batch = {"tokens": toks[:, :S]}
    jl, jc = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(batch["tokens"])}, s_max=S + 8,
                        cache_dtype=jnp.float32)
    tl, tc = tt.prefill(tp_, tcfg, {"tokens": torch.from_numpy(batch["tokens"])},
                        s_max=S + 8, cache_dtype=torch.float32)
    close(tl, jl, TIGHT)
    assert tc["t"] == int(jc["t"]) == S
    for name in ("k", "v"):
        assert tc["block_0"][name].dtype == torch.float32
        close(tc["block_0"][name], jc["block_0"][name], TIGHT)

    for i in range(8):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(tok))
        tl, tc = tt.decode_step(tp_, tcfg, tc, torch.from_numpy(tok))
        assert tl.shape == (B, jcfg.vocab_padded)
        close(tl, jl, REF_TOL)
        close(tl, jl, TIGHT)
    assert tc["t"] == int(jc["t"]) == S + 8


def test_bf16_compute_matches_reference():
    jcfg, tcfg = configs(1, compute_dtype="bfloat16")
    jp, tp_ = shared_params(jcfg, tcfg, seed=7)
    toks = tokens(jcfg, 7, S)
    jl, jc = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tt.prefill(tp_, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tc["block_0"]["k"].dtype == torch.bfloat16  # the reference's default
    close(tl, jl, BF16_TOL)
    tok = tokens(jcfg, 8, 1)
    jl, _ = jt.decode_step(jp, jcfg, jc, jnp.asarray(tok))
    tl, _ = tt.decode_step(tp_, tcfg, tc, torch.from_numpy(tok))
    close(tl, jl, BF16_TOL)


def test_prefill_decode_matches_forward():
    """prefill(s tokens) then decode(token s) equals forward(s+1 tokens) at
    the last position (``tests/test_arch_smoke.py``), in the port alone."""
    _, cfg = configs(2)
    params = cast_params(init_params(cfg, torch.Generator().manual_seed(3), "cpu"), cfg)
    toks = torch.from_numpy(tokens(cfg, 3, S + 1))
    full, _ = tt.forward(params, cfg, {"tokens": toks})
    _, cache = tt.prefill(params, cfg, {"tokens": toks[:, :S]}, s_max=S + 8,
                          cache_dtype=torch.float32)
    dec, _ = tt.decode_step(params, cfg, cache, toks[:, S:S + 1])
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), **REF_TOL)


def test_entry_points_require_the_compute_copy():
    """A master tree is refused: casting it on each call would copy every
    weight at every decode step."""
    _, cfg = configs(1)
    master = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.from_numpy(tokens(cfg, 4, S))
    for call in (lambda p: tt.forward(p, cfg, {"tokens": toks}),
                 lambda p: tt.prefill(p, cfg, {"tokens": toks}),
                 lambda p: tt.decode_step(p, cfg, tt.init_cache(cfg, B, S, device="cpu"),
                                          toks[:, :1])):
        with pytest.raises(TypeError, match="cast_params"):
            call(master)
    logits, _ = tt.prefill(cast_params(master, cfg), cfg, {"tokens": toks})
    assert logits.shape == (B, cfg.vocab_padded)


def test_local_window_ring_buffer_matches_reference():
    """A local (sliding-window) block beside a global one, with prompts
    longer than the window: the ring-buffer cache of prefill and its
    wrap-around in decode."""
    jcfg, tcfg = configs(1, attn_types=("local", "global"), window=6)
    jp, tp_ = shared_params(jcfg, tcfg, seed=11)
    toks = tokens(jcfg, 11, 13 + 5)
    jl, jc = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :13])}, s_max=20,
                        cache_dtype=jnp.float32)
    tl, tc = tt.prefill(tp_, tcfg, {"tokens": torch.from_numpy(toks[:, :13])}, s_max=20,
                        cache_dtype=torch.float32)
    close(tl, jl, TIGHT)
    assert tc["block_0"]["k"].shape[2] == 6  # the ring buffer holds the window
    for blk in ("block_0", "block_1"):
        close(tc[blk]["k"], jc[blk]["k"], TIGHT)
    for i in range(5):
        tok = toks[:, 13 + i:14 + i]
        jl, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(tok))
        tl, tc = tt.decode_step(tp_, tcfg, tc, torch.from_numpy(tok))
        close(tl, jl, TIGHT)
    jf, _ = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tf, _ = tt.forward(tp_, tcfg, {"tokens": torch.from_numpy(toks)})
    close(tf, jf, TIGHT)


def test_full_width_tree_matches_reference():
    """qwen3-4b at its published width: the port's parameter tree (shapes
    and dtypes, on the meta device) equals the reference's abstract tree.
    ``param_count`` gives 4,022,458,880 in both packages; the tree holds
    36 x 2 x 128 qk-norm scales more, which ``param_count`` leaves out."""
    jcfg = jax_get_config("qwen3-4b").canonicalize(tp=1)
    tcfg = get_config("qwen3-4b").canonicalize(tp=1)
    assert tcfg.param_count() == jcfg.param_count() == 4_022_458_880
    want = {p: (tuple(s.shape), str(s.dtype))
            for p, s in tree_paths(abstract_params(jcfg)).items()}
    port = init_params(tcfg, device="meta")
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tree_paths(port).items()}
    assert got == want
    assert all(t.device.type == "meta" for t in tree_paths(port).values())
    assert sum(int(np.prod(s)) for s, _ in got.values()) == 4_022_458_880 + 36 * 2 * 128
    assert (tcfg.n_layers, tcfg.d_model, tcfg.vocab_size) == (36, 2560, 151_936)


@pytest.mark.parametrize("tp", [2, 16])
def test_padded_trees_match_reference(tp):
    """Head and vocab padding under canonicalize: the same shapes."""
    jcfg, tcfg = configs(tp)
    want = {p: tuple(s.shape) for p, s in tree_paths(abstract_params(jcfg)).items()}
    got = {p: tuple(t.shape) for p, t in tree_paths(init_params(tcfg, device="meta")).items()}
    assert got == want


def test_params_from_numpy_rejects_a_foreign_tree():
    jcfg, tcfg = configs(1)
    tree = tree_to_numpy(jax_init_params(jax.random.key(0), jcfg))
    tree["units"]["block_0"]["attn"]["wq"] = tree["units"]["block_0"]["attn"]["wq"][:, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tree, tcfg, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError):
        params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("t_pos", [0, 5, 7, 9])
def test_update_cache_clamps_like_the_reference(t_pos):
    """``lax.dynamic_update_slice`` clamps a start past the end to the last
    slot; the port's in-place write does the same (the engine's shared
    ``t`` can pass ``max_seq``)."""
    rng = np.random.default_rng(t_pos)
    ck, cv = (rng.standard_normal((2, 8, 2, 4)).astype(np.float32) for _ in range(2))
    nk, nv = (rng.standard_normal((2, 1, 2, 4)).astype(np.float32) for _ in range(2))
    want = jattn.update_cache(*(jnp.asarray(x) for x in (ck, cv, nk, nv)), jnp.int32(t_pos))
    got = tattn.update_cache(*(torch.from_numpy(x.copy()) for x in (ck, cv, nk, nv)), t_pos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unknown_architecture_raises():
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("qwen4-9b")
    assert len(ARCH_IDS) == 10 and all(get_config(a) is not None for a in ARCH_IDS)


def test_cast_params_keeps_routers_and_ssm_dynamics_in_f32():
    """Under bf16 compute the MoE router and the SSM's ``A_log``, ``D`` and
    ``dt_bias`` stay float32, keyed on the leaf name as the reference's
    ``_KEEP_F32``; every other float32 leaf becomes bf16 (jamba has all
    four beside attention, Mamba and expert weights)."""
    cfg = dataclasses.replace(get_config("jamba_1_5_large_398b", reduced=True),
                              compute_dtype="bfloat16")
    master = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    compute = cast_params(master, cfg)
    kept = set()
    for path, leaf in tree_paths(compute).items():
        name = path.rsplit(".", 1)[-1]
        if path == "unembed_f32" or name in ("router", "A_log", "D", "dt_bias"):
            assert leaf.dtype == torch.float32, path
            kept.add(name)
        else:
            assert leaf.dtype == torch.bfloat16, path
    assert kept == {"router", "A_log", "D", "dt_bias", "unembed_f32"}
    for path in ("units.block_1.moe.router", "units.block_0.mamba.A_log"):
        assert tree_paths(compute)[path] is tree_paths(master)[path]  # not copied
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert all(t.dtype == torch.float32 for t in tree_paths(cast_params(master, f32)).values())


def test_entry_points_default_to_the_card():
    _, cfg = configs(1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
