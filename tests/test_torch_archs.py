"""The port's LM serving path against ``repro.models`` for the nine
architectures beside qwen3-4b (``tests/test_torch_transformer.py`` holds
that one): jamba (Mamba + attention + MoE), falcon-mamba (pure Mamba),
nemotron (layer norm, squared ReLU), gemma3 (5 local : 1 global), chatglm3
(partial RoPE), whisper (encoder-decoder, learned positions), internvl2
(vision prefix), olmoe and qwen2-moe (MoE, shared experts), each at its
``reduced()`` config with the reference's parameters carried over by
``params_from_numpy`` (norm scales randomised around 1).

For each architecture one module-scoped fixture runs the reference once
(under ``jax.jit``) and the port once, and its cases compare ``forward``'s
logits and aux loss, ``prefill``'s last logits and every cache leaf, and 4
``decode_step``s (logits and the whole cache after them).  Beside them: a
bf16 case, the int8 KV cache (``kv_quant``), whisper with its 4 heads
zero-padded to 16 (``canonicalize(tp=16)``), a ``ServeEngine`` on
falcon-mamba with more requests than slots, the launcher's ``--workload
decode`` against the reference's ``run_decode``, and the full-width
parameter trees.

Tolerances: float32 compute is held at the reference's own prefill/decode
tolerance, ``atol=rtol=2e-3`` (``tests/test_arch_smoke.py``), and at
``TIGHT`` (``atol=rtol=5e-5``), which the differences measured (below 1.2e-5)
pass too.  The int8 cache values and their bf16 scales are bit-identical.
bf16 compute rounds activations at different places in the two packages;
see ``BF16_TOL``."""

import dataclasses
import gc
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.serve as jserve
import repro.serve.engine as jengine
from repro.models import transformer as jt
from repro.models.attention import quantize_kv as jquantize_kv
from repro.models.params import abstract_params
from repro.models.params import init_params as jax_init_params
import repro_torch.configs as tconfigs
import repro_torch.models.params as tparams
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.models.attention import dequantize_kv, quantize_kv
from repro_torch.models.params import cast_params, init_params, params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.testing import tree_paths, tree_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


NEW_ARCHS = [a for a in tconfigs.ARCH_IDS if a != "qwen3_4b"]
B, S, DECODE = 2, 16, 4
REF_TOL = dict(atol=2e-3, rtol=2e-3)
TIGHT = dict(atol=5e-5, rtol=5e-5)
# bf16 compute: the two packages round activations to bf16 at different
# places.  falcon-mamba's logits (magnitude up to 4.8) differed by at most
# 0.060 over 3 seeds, so the qwen3-4b file's atol=0.15 is kept.  No MoE
# config is held at the model level in bf16: there a near-tie in the router
# (float32, on a bf16 input that rounds apart) can pick another expert, and
# olmoe's logits then differed by up to 1.71 in 2 of 3 seeds;
# tests/test_torch_moe.py holds the MoE MLP in bf16 on one input instead.
BF16_TOL = dict(atol=0.15, rtol=0)


def configs(arch, tp=1, **changes):
    """The same reduced config in both packages, float32 compute unless
    ``changes`` says otherwise."""
    changes.setdefault("compute_dtype", "float32")
    return [dataclasses.replace(get(arch, reduced=True), **changes).canonicalize(tp=tp)
            for get in (jconfigs.get_config, tconfigs.get_config)]


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


def batches(cfg, seed, s_text):
    """(tokens (b, s_text + DECODE) int32, the stub frontend's inputs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s_text + DECODE)).astype(np.int32)
    extra = {}
    if cfg.frontend == "vision":
        extra["patch_embeds"] = rng.standard_normal((B, cfg.vis_tokens, cfg.d_model))
    if cfg.frontend == "audio":
        extra["enc_frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
    return toks, {k: v.astype(np.float32) for k, v in extra.items()}


def as_jax(toks, extra):
    return dict({k: jnp.asarray(v) for k, v in extra.items()}, tokens=jnp.asarray(toks))


def as_torch(toks, extra):
    return dict({k: torch.from_numpy(v) for k, v in extra.items()},
                tokens=torch.from_numpy(toks))


def run_both(jcfg, tcfg, seed):
    """Forward over s_text + DECODE tokens, prefill of s_text (S positions
    with the vision prefix), then DECODE decode steps on a float32 cache, in
    both packages: the numpy results, (reference, port) per entry."""
    jp, tp = shared_params(jcfg, tcfg, seed)
    s_text = S - jcfg.vis_tokens
    toks, extra = batches(jcfg, seed, s_text)
    out = {}
    jl, ja = jax.jit(lambda p, b: jt.forward(p, jcfg, b, mamba_chunk=8))(
        jp, as_jax(toks, extra))
    tl, ta = tt.forward(tp, tcfg, as_torch(toks, extra), mamba_chunk=8)
    out["forward"] = (np.asarray(jl), float(ja)), (tl.numpy(), float(ta))
    jl, jc = jax.jit(lambda p, b: jt.prefill(p, jcfg, b, s_max=S + 8,
                                             cache_dtype=jnp.float32, mamba_chunk=8))(
        jp, as_jax(toks[:, :s_text], extra))
    tl, tc = tt.prefill(tp, tcfg, as_torch(toks[:, :s_text], extra), s_max=S + 8,
                        cache_dtype=torch.float32, mamba_chunk=8)
    out["prefill"] = (np.asarray(jl), tree_to_numpy(jc)), (tl.numpy(), tree_to_numpy(tc))
    out["cache_dtypes"] = {p: t.dtype for p, t in tree_paths(tc).items()
                           if isinstance(t, torch.Tensor)}
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    jsteps, tsteps = [], []
    for i in range(DECODE):
        tok = toks[:, s_text + i:s_text + i + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok))
        tl, tc = tt.decode_step(tp, tcfg, tc, torch.from_numpy(tok))
        jsteps.append(np.asarray(jl))
        tsteps.append(tl.numpy())
    out["decode"] = (jsteps, tree_to_numpy(jc)), (tsteps, tree_to_numpy(tc))
    return out


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def same_cache(got, want, tol):
    """Every cache leaf of the port against the reference's: the same keys
    and shapes, the same ``t``, values within ``tol`` (int8 exactly)."""
    got, want = tree_paths(got), tree_paths(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if path == "t":
            assert g == int(w)
            continue
        assert g.shape == np.shape(w), path
        if np.asarray(w).dtype == np.int8:
            assert g.dtype == np.int8, path
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
        else:
            close(g, w, tol)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_run(request):
    jcfg, tcfg = configs(request.param)
    return tcfg, run_both(jcfg, tcfg, seed=NEW_ARCHS.index(request.param))


def test_forward_matches_reference(arch_run):
    cfg, out = arch_run
    (jl, ja), (tl, ta) = out["forward"]
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    assert tl.shape[-1] == (cfg.vocab_padded or cfg.vocab_size)
    close(tl, jl, REF_TOL)
    close(tl, jl, TIGHT)
    if cfg.moe is None:
        assert ta == ja == 0.0
    else:  # the Switch aux loss, summed over the MoE blocks
        assert ta > 0
        np.testing.assert_allclose(ta, ja, **TIGHT)


def test_prefill_logits_and_cache_match_reference(arch_run):
    cfg, out = arch_run
    (jl, jc), (tl, tc) = out["prefill"]
    close(tl, jl, REF_TOL)
    close(tl, jl, TIGHT)
    same_cache(tc, jc, TIGHT)
    for path, dtype in out["cache_dtypes"].items():  # Mamba states float32 too
        assert dtype == torch.float32, path


def test_decode_steps_match_reference(arch_run):
    cfg, out = arch_run
    (jsteps, jc), (tsteps, tc) = out["decode"]
    for j, t in zip(jsteps, tsteps):
        assert t.shape == (B, cfg.vocab_padded or cfg.vocab_size)
        close(t, j, REF_TOL)
        close(t, j, TIGHT)
    same_cache(tc, jc, TIGHT)
    assert tc["t"] == S + DECODE


def test_bf16_compute_matches_reference():
    """falcon-mamba in its published compute dtype: bf16 activations with
    the SSM dynamics (``A_log``, ``D``, ``dt_bias``) kept in float32 by
    ``cast_params``, float32 states in the cache."""
    jcfg, tcfg = configs("falcon_mamba_7b", compute_dtype="bfloat16")
    jp, tp = shared_params(jcfg, tcfg, seed=21)
    assert tp["units"]["block_0"]["mamba"]["dt_bias"].dtype == torch.float32
    toks, _ = batches(jcfg, 21, S)
    jl, jc = jax.jit(lambda p, b: jt.prefill(p, jcfg, b, mamba_chunk=8))(
        jp, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :S])}, mamba_chunk=8)
    assert tc["block_0"]["h"].dtype == torch.float32
    close(tl, jl, BF16_TOL)
    same_cache(tree_to_numpy(tc), tree_to_numpy(jc), BF16_TOL)
    jl, _ = jt.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, S:S + 1]))
    tl, _ = tt.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, S:S + 1]))
    close(tl, jl, BF16_TOL)


def test_quantize_kv_is_bit_identical():
    """int8 values from the float32 scale (half to even), scales stored in
    bf16: a zero row (the 1e-8 floor), exact .5 quotients, extremes."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    k[0, 0, 0] = 0.0
    k[0, 1, 0, :4] = [127.0, 63.5, -0.5, 2.5]  # scale 1: 63.5 -> 64, -0.5 -> 0, 2.5 -> 2
    k[0, 1, 0, 4:] = 0.25
    k[1, 2, 1] = 1e30
    jq, js = jquantize_kv(jnp.asarray(k))
    tq, ts = quantize_kv(torch.from_numpy(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    np.testing.assert_array_equal(tq[0, 1, 0, :4].numpy(), [127, 64, 0, 2])
    back = dequantize_kv(tq, ts).numpy()
    np.testing.assert_allclose(back[0, 1, 0, :4], [127.0, 64.0, 0.0, 2.0])


def test_kv_quant_cache_is_bit_identical():
    """gemma3's local and global blocks over an int8 cache from
    ``init_cache`` (what the engine decodes on), a window of 3 so the ring
    buffer wraps: after each step the logits match and the int8 values and
    bf16 scales written at each slot equal the reference's bit for bit."""
    jcfg, tcfg = configs("gemma3_12b", kv_quant=True, window=3)
    jp, tp = shared_params(jcfg, tcfg, seed=31)
    toks = np.random.default_rng(31).integers(0, jcfg.vocab_size, (B, 6)).astype(np.int32)
    jc = jt.init_cache(jcfg, B, 8, jnp.float32)
    tc = tt.init_cache(tcfg, B, 8, torch.float32, device="cpu")
    assert tc["block_0"]["k"].dtype == torch.int8 and tc["block_0"]["k"].shape[2] == 3
    assert tc["block_5"]["v_scale"].dtype == torch.bfloat16
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    for i in range(toks.shape[1]):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = tt.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, i:i + 1]))
        close(tl, jl, TIGHT)
        for blk in ("block_0", "block_5"):
            for name in ("k", "v"):
                np.testing.assert_array_equal(tc[blk][name].numpy(), np.asarray(jc[blk][name]))
            for name in ("k_scale", "v_scale"):
                np.testing.assert_array_equal(tc[blk][name].view(torch.int16).numpy(),
                                              np.asarray(jc[blk][name]).view(np.int16))


def test_whisper_padded_heads_match_reference():
    """whisper at ``canonicalize(tp=16)``: 4 MHA heads zero-padded to 16 in
    the encoder, the decoder and the cross attention."""
    jcfg, tcfg = configs("whisper_large_v3", tp=16)
    assert (tcfg.n_heads_padded, tcfg.n_kv_heads_padded) == (16, 16)
    out = run_both(jcfg, tcfg, seed=41)
    (jl, _), (tl, _) = out["forward"]
    close(tl, jl, TIGHT)
    (jl, jc), (tl, tc) = out["prefill"]
    close(tl, jl, TIGHT)
    same_cache(tc, jc, TIGHT)
    assert tc["cross_k"].shape == (tcfg.n_units, B, tcfg.enc_seq, 16, tcfg.hd)
    (jsteps, jc), (tsteps, tc) = out["decode"]
    for j, t in zip(jsteps, tsteps):
        close(t, j, TIGHT)
    same_cache(tc, jc, TIGHT)


def run_engine(engine, req_type, prompts, max_new):
    reqs = [req_type(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


def test_engine_keeps_mamba_state_across_requests():
    """falcon-mamba, 5 requests through 2 slots: a request that takes over a
    slot starts from the state its predecessor left (the reference engine
    does not reset it), and the tokens equal the reference engine's."""
    jcfg, tcfg = configs("falcon_mamba_7b")
    jparams = jax_init_params(jax.random.key(51), jcfg)
    tparams_ = params_from_numpy(tree_to_numpy(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(51)
    prompts = [rng.integers(0, jcfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 8, 5)]
    want = run_engine(jengine.ServeEngine(jcfg, jparams, max_batch=2, max_seq=64),
                      jengine.Request, prompts, 6)
    engine = ServeEngine(tcfg, tparams_, max_batch=2, max_seq=64, device="cpu")
    got = run_engine(engine, Request, prompts, 6)
    assert got == want
    # the same prompts, each alone in a fresh engine: the state a later
    # request inherits changes what it generates
    alone = run_engine(ServeEngine(tcfg, tparams_, max_batch=1, max_seq=64, device="cpu"),
                       Request, prompts[2:3], 6)
    assert alone[0] != got[2]


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b", "falcon-mamba-7b"])
def test_launcher_decode_matches_reference(arch, monkeypatch):
    """``python -m repro_torch.launch.serve --workload decode --arch <arch>``
    on the CPU against the reference's ``run_decode``, seed 0 and the default
    6 requests, 16 new tokens and 4 slots: the port's launcher gets the
    reference engine's parameters, and each request's tokens are compared
    from the two engines.  Both launchers run the reduced config in float32
    compute (their ``get_config`` patched alike): in bf16, a near-tie of two
    logits rounds apart in the two packages, and greedy decoding then
    follows another path."""
    for module in (jconfigs, tconfigs):
        get = module.get_config
        monkeypatch.setattr(module, "get_config", lambda a, reduced=False, get=get:
                            dataclasses.replace(get(a, reduced), compute_dtype="float32"))
    seen = {}

    class Recording(jengine.ServeEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen["engine"], seen["requests"] = self, []

        def submit(self, req):
            seen["requests"].append(req)
            super().submit(req)

    monkeypatch.setattr(jengine, "ServeEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve", "--workload", "decode", "--arch", arch])
    jserve.main()
    tcfg = tconfigs.get_config(arch, reduced=True).canonicalize(tp=1)
    ported = params_from_numpy(tree_to_numpy(seen["engine"].params), tcfg, device="cpu")
    monkeypatch.setattr(tparams, "init_params", lambda cfg, generator, device: ported)
    run = tserve.main(["--workload", "decode", "--arch", arch, "--device", "cpu"])
    want = [r.out for r in seen["requests"]]
    assert len(want) == 6 and all(len(o) == 16 for o in want)
    assert [r.out for r in run.requests] == want
    assert run.engine.cfg.compute_dtype == "float32"


@pytest.mark.parametrize("arch, tp", [(a, 1) for a in NEW_ARCHS] + [("whisper_large_v3", 16)])
def test_full_width_tree_matches_reference(arch, tp):
    """Each published config: the port's parameter tree (shapes and dtypes,
    on the meta device) equals the reference's abstract tree, and the
    configs' derived numbers agree; whisper also at tp=16, where its 20
    heads pad to 32."""
    jcfg = jconfigs.get_config(arch).canonicalize(tp=tp)
    tcfg = tconfigs.get_config(arch).canonicalize(tp=tp)
    if tp == 16:
        assert (tcfg.n_heads_padded, tcfg.n_kv_heads_padded) == (32, 32)
    assert tcfg == dataclasses.replace(tcfg, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name not in ("pattern", "moe", "ssm")})
    assert (tcfg.param_count(), tcfg.active_param_count(), tcfg.sub_quadratic,
            tcfg.has_decoder) == (jcfg.param_count(), jcfg.active_param_count(),
                                  jcfg.sub_quadratic, jcfg.has_decoder)
    want = {p: (tuple(s.shape), str(s.dtype))
            for p, s in tree_paths(abstract_params(jcfg)).items()}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tree_paths(init_params(tcfg, device="meta")).items()}
    assert got == want


def test_reduced_trees_init_on_the_cpu():
    """``init_params`` from a generator for every reduced config: the
    reference's leaves, A_log = log(1..N) on every channel, D ones."""
    for arch in tconfigs.ARCH_IDS:
        jcfg, tcfg = configs(arch, tp=2)
        tree = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        want = {p: tuple(s.shape) for p, s in tree_paths(abstract_params(jcfg)).items()}
        assert {p: tuple(t.shape) for p, t in tree_paths(tree).items()} == want, arch
        if tcfg.ssm is not None:
            a_log = tree["units"]["block_0"]["mamba"]["A_log"]
            n = tcfg.ssm.d_state
            assert torch.equal(a_log[0, 0], torch.log(torch.arange(1, n + 1).float()))
            assert torch.equal(tree["units"]["block_0"]["mamba"]["D"],
                               torch.ones_like(tree["units"]["block_0"]["mamba"]["D"]))


def test_decode_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "falcon-mamba-7b"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_cache(tconfigs.get_config("whisper-large-v3", reduced=True), 1, 8)
