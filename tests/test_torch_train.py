"""The port's training against ``repro.train``: the train step, the
optimizers, checkpoints in both directions, the int8 compression contract and
the fault-tolerance helpers.

Both packages start from the reference's initial parameters (carried over by
``params_from_numpy``) and take the same numpy batches, in float32 compute.
Tolerances:

* loss and ``grad_norm``: ``rtol=1e-5``; gradients ``rtol=1e-4`` (with an
  ``atol`` of 1e-6 for elements that sum to about 0): the two packages sum
  in other orders;
* ``lr``: ``rtol=1e-6`` (the cosine is one float32 ulp apart);
* parameters after a step: ``atol = 2 * lr_t`` plus ``rtol=1e-5``.  AdamW's
  first step turns each gradient into about +-1 (m / sqrt(v) with m and v
  from one gradient), so an element whose gradient is near 0 and rounds to
  the other sign in one package moves by up to 2 * lr_t the other way.  The
  measured difference is below 0.1 * lr_t;
* optimizer state: the moments at ``rtol=1e-4, atol=1e-7``, the step
  exactly.  bf16 moments (``adamw_bf16``) at two bf16 ulps of the element
  (``rtol=2**-7``) plus two ulps of the leaf's largest element: a float32
  moment a hair apart can round to the neighbouring bf16 value, and the
  next step's m = 0.9 m + 0.1 g carries that ulp into elements that cancel
  to near 0.
"""

import dataclasses
import functools
import gc
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist import collectives as jcoll
from repro.models import transformer as jt
from repro.models.params import init_params as jax_init_params
from repro.train import checkpoint as jckpt
from repro.train import fault_tolerance as jft
from repro.train import optim as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.dist import collectives as tcoll
from repro_torch.dist.hints import one_device_mesh
from repro_torch.models import transformer as tt
from repro_torch.models.params import params_from_numpy
from repro_torch.testing import tree_to_numpy
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import optim as topt
from repro_torch.train import steps as tsteps

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


B, S = 2, 16
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-7)


def configs(arch="qwen3-4b", **changes):
    """The reduced config of ``arch`` in float32 compute, in both packages."""
    return [dataclasses.replace(get(arch, reduced=True), compute_dtype="float32",
                                **changes).canonicalize(tp=1)
            for get in (jax_get_config, get_config)]


def shared(jcfg, tcfg, seed=0):
    """The reference's initial parameters in both packages (the port's as
    its float32 master tree)."""
    tree = tree_to_numpy(jax_init_params(jax.random.key(seed), jcfg))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tcfg, device="cpu")


def batches(cfg, n, seed=0):
    """``n`` (reference, port) batches of next-token pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        toks[0, -3:] = -1  # padding labels are masked out of the loss
        tokens = np.maximum(toks[:, :-1], 0)
        out.append(({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(toks[:, 1:])},
                    {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(toks[:, 1:])}))
    return out


def flat(tree):
    """Path -> float64 numpy leaf, for a tree of either package."""
    return {k: np.asarray(v, dtype=np.float64) for k, v in topt.tree_items(tree_to_numpy(tree))}


def assert_trees_close(got, want, what, bf16_ulps=None, **tol):
    """Leaf by leaf at ``tol``; with ``bf16_ulps``, plus an ``atol`` of that
    many bf16 ulps of the leaf's largest magnitude (2**-8 of it each)."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        kw = dict(tol)
        if bf16_ulps is not None:
            kw["atol"] = bf16_ulps * 2.0 ** -8 * float(np.abs(w[k]).max(initial=0.0))
        np.testing.assert_allclose(g[k], w[k], err_msg=f"{what} {k}", **kw)


def opt_pair(name):
    kw = dict(name=name, lr=1e-2, warmup_steps=1, total_steps=10)
    return jopt.OptConfig(**kw), topt.OptConfig(**kw)


# ----------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients_match_reference(remat):
    jcfg, tcfg = configs(remat=remat)
    jp, tp = shared(jcfg, tcfg)
    (jb, tb), = batches(jcfg, 1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    tloss, tgrads = tsteps._grads(tp, tcfg, tb, mamba_chunk=128)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    assert_trees_close(tgrads, jgrads, "gradient", **GRAD_TOL)
    _, tm = tt.loss_fn(tp, tcfg, tb)
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * S - 3
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **LOSS_TOL)


def test_loss_fn_takes_the_master_tree_and_forward_does_not():
    _, tcfg = configs()
    tp = params_from_numpy(tree_to_numpy(jax_init_params(jax.random.key(0), configs()[0])),
                           tcfg, device="cpu")
    (_, tb), = batches(tcfg, 1)
    loss, _ = tt.loss_fn(tp, tcfg, tb)
    assert torch.isfinite(loss)
    with pytest.raises(TypeError):
        tt.forward(tp, tcfg, tb)


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("name", ["adamw", "adamw_bf16", "adafactor"])
def test_train_step_matches_reference(name, n_micro):
    """Two steps: loss, grad_norm and lr, then the parameters and the
    optimizer state after each."""
    jcfg, tcfg = configs()
    jp, tp = shared(jcfg, tcfg)
    jo, to = opt_pair(name)
    js, ts = jopt.init_opt_state(jp, jo), topt.init_opt_state(tp, to)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo, n_micro=n_micro))
    tstep = tsteps.make_train_step(tcfg, to, n_micro=n_micro)
    for jb, tb in batches(jcfg, 2):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **LOSS_TOL)
        lr = float(jm["lr"])
        np.testing.assert_allclose(float(tm["lr"]), lr, rtol=1e-6)
        assert_trees_close(tp, jp, "params", atol=2 * lr, rtol=1e-5)
        assert int(ts["step"]) == int(js["step"])
        for key in ts:
            if key == "step":
                continue
            if name == "adamw_bf16":
                assert_trees_close(ts[key], js[key], key, bf16_ulps=2, rtol=2 ** -7)
            else:
                assert_trees_close(ts[key], js[key], key, **STATE_TOL)
    if name == "adamw_bf16":
        assert all(m.dtype == torch.bfloat16 for m in topt.tree_leaves(ts["m"]))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b"])
def test_moe_and_mamba_step_matches_reference(arch):
    """One AdamW step of the MoE config (its aux loss in the loss) and of the
    Mamba config (the gradient through the float32 SSM leaves)."""
    jcfg, tcfg = configs(arch)
    jp, tp = shared(jcfg, tcfg)
    jo, to = opt_pair("adamw")
    (jb, tb), = batches(jcfg, 1)
    _, tm_loss = tt.loss_fn(tp, tcfg, tb, mamba_chunk=8)
    if tcfg.moe is not None:
        _, jm_loss = jax.jit(lambda p, b: jt.loss_fn(p, jcfg, b, mamba_chunk=8))(jp, jb)
        assert float(tm_loss["aux"]) > 0
        np.testing.assert_allclose(float(tm_loss["aux"]), float(jm_loss["aux"]), rtol=1e-5)
    else:
        assert float(tm_loss["aux"]) == 0.0
    jp, _, jm = jax.jit(jsteps.make_train_step(jcfg, jo, mamba_chunk=8))(
        jp, jopt.init_opt_state(jp, jo), jb)
    tp, _, tm = tsteps.make_train_step(tcfg, to, mamba_chunk=8)(
        tp, topt.init_opt_state(tp, to), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **LOSS_TOL)
    assert_trees_close(tp, jp, "params", atol=2 * float(jm["lr"]), rtol=1e-5)


def test_lr_schedule_matches_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    jo, to = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 500):
        np.testing.assert_allclose(float(topt.lr_at(to, torch.tensor(step, dtype=torch.int32))),
                                   float(jopt.lr_at(jo, jnp.int32(step))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_apply_updates_on_a_quadratic_matches_reference(name):
    """The reference's own optimizer test (w^2 / 2 from 3.0, 50 steps), both
    packages side by side, a matrix leaf (weight decay, Adafactor's factored
    v) beside the vector one."""
    rng = np.random.default_rng(5)
    w0 = {"m": rng.standard_normal((6, 5)).astype(np.float32),
          "w": np.full(8, 3.0, np.float32)}
    kw = dict(name=name, lr=0.1, warmup_steps=0, weight_decay=0.01, total_steps=100)
    jo, to = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, w0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    js, ts = jopt.init_opt_state(jp, jo), topt.init_opt_state(tp, to)
    for _ in range(50):
        jp, js, _ = jopt.apply_updates(jp, jp, js, jo)
        tp, ts, _ = topt.apply_updates(tp, {k: v.clone() for k, v in tp.items()}, ts, to)
    assert_trees_close(tp, jp, "params", rtol=1e-4, atol=1e-6)
    assert float(tp["w"].abs().max()) < 1.5


def test_serve_and_prefill_steps_match_reference():
    jcfg, tcfg = configs()
    jp, tp = shared(jcfg, tcfg)
    from repro_torch.models.params import cast_params

    cp = cast_params(tp, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, 9)).astype(np.int32)
    jlast, jcache = jsteps.make_prefill_step(jcfg, s_max=12)(jp, {"tokens": jnp.asarray(toks[:, :8])})
    tlast, tcache = tsteps.make_prefill_step(tcfg, s_max=12)(
        cp, {"tokens": torch.from_numpy(toks[:, :8])})
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=2e-5, rtol=2e-5)
    # decode reads the bf16 cache the prefill step stores: the reference's
    # own prefill/decode tolerance (tests/test_arch_smoke.py)
    jlog, _ = jsteps.make_serve_step(jcfg)(jp, jcache, jnp.asarray(toks[:, 8:]))
    tlog, _ = tsteps.make_serve_step(tcfg)(cp, tcache, torch.from_numpy(toks[:, 8:]))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-3, rtol=2e-3)


# -------------------------------------------------------------- checkpoint
@functools.lru_cache(maxsize=None)
def trained_state(name, steps=1):
    """A (reference, port) pair of the same trained state: reference
    parameters and optimizer state after ``steps`` steps, carried into the
    port (made once a name; the tests only read it)."""
    jcfg, tcfg = configs()
    jp, _ = shared(jcfg, tcfg)
    jo, _ = opt_pair(name)
    js = jopt.init_opt_state(jp, jo)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo))
    for jb, _ in batches(jcfg, steps):
        jp, js, _ = jstep(jp, js, jb)
    jstate = {"params": jp, "opt": js, "extra": {"arch": jcfg.name}}
    np_p = jax.tree.map(np.asarray, jp)
    np_s = jax.tree.map(np.asarray, js)
    tstate = {"params": params_from_numpy(np_p, tcfg, device="cpu"),
              "opt": topt.opt_state_from_numpy(np_s, device="cpu"),
              "extra": {"arch": tcfg.name}}
    return jstate, tstate


def same_tensors(got, want):
    g, w = topt.tree_items(got), topt.tree_items(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, name):
    jstate, tstate = trained_state(name)
    jckpt.save_checkpoint(str(tmp_path), 7, jstate)
    assert tckpt.latest_step(str(tmp_path)) == 7
    like = {"params": tstate["params"], "opt": topt.init_opt_state(tstate["params"],
                                                                   opt_pair(name)[1])}
    out, step = tckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 7 and out["extra"] == {"arch": jstate["extra"]["arch"]}
    same_tensors(out["params"], tstate["params"])
    same_tensors(out["opt"], tstate["opt"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = trained_state("adamw")
    tckpt.save_checkpoint(str(tmp_path), 3, tstate)
    assert jckpt.latest_step(str(tmp_path)) == 3
    out, step = jckpt.restore_checkpoint(str(tmp_path), {"params": jstate["params"],
                                                         "opt": jstate["opt"]})
    assert step == 3
    for tree in ("params", "opt"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     out[tree], jstate[tree])


def test_checkpoint_files_are_the_references_byte_for_byte(tmp_path):
    """With bf16 moments: the reference's own restore cannot read a bf16
    leaf back (``jnp.asarray`` of the 2-byte records ``np.load`` gives), so
    what the port writes is held against what the reference writes, entry
    by entry and byte for byte, and the manifests are equal."""
    jstate, tstate = trained_state("adamw_bf16")
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, jstate)
    tckpt.save_checkpoint(str(tmp_path / "port"), 2, tstate)
    dirs = [tmp_path / d / "step_000002" for d in ("ref", "port")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    assert manifests[1]["trees"]["opt"]["m/embed"]["dtype"] == "bfloat16"
    zips = [zipfile.ZipFile(d / "shard_00000.npz") for d in dirs]
    assert zips[0].namelist() == zips[1].namelist()
    for name in zips[0].namelist():
        assert zips[0].read(name) == zips[1].read(name), name
    for d in ("ref", "port"):
        assert (tmp_path / d / "LATEST").read_text() == "step_000002"


def test_checkpoint_prune_and_missing(tmp_path):
    _, tstate = trained_state("adamw")
    for step in (1, 2, 3, 4):
        tckpt.save_checkpoint(str(tmp_path), step, tstate)
    tckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000003", "step_000004"]
    assert tckpt.latest_step(str(tmp_path)) == 4
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), tstate)


# ------------------------------------------------------------ collectives
def contract(x):
    """DESIGN.md §6 in numpy: scale = amax / 127 (1 for all zeros), q =
    clip(round-half-even(x / scale), -127, 127)."""
    x = np.asarray(x, np.float32)
    amax = np.float32(np.abs(x).max()) if x.size else np.float32(0)
    scale = np.float32(amax / np.float32(127.0)) if amax > 0 else np.float32(1.0)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


QUANT_INPUTS = {
    "normal": np.random.default_rng(0).standard_normal((7, 9)).astype(np.float32),
    "zeros": np.zeros((5,), np.float32),
    "halves": np.array([-127.0, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.0], np.float32),
    "one spike": np.r_[np.full(20, 1e-3, np.float32), np.float32(50.0)],
}


@pytest.mark.parametrize("case", list(QUANT_INPUTS), ids=list(QUANT_INPUTS))
def test_quantize_int8_matches_reference_and_contract(case):
    x = QUANT_INPUTS[case]
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    tq, ts = tcoll.quantize_int8(torch.from_numpy(x))
    cq, cs = contract(x)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy(), cq)
    assert float(ts) == float(js) == float(cs)
    np.testing.assert_array_equal(tcoll.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcoll.dequantize_int8(jq, js)))


def test_compressed_allreduce_carries_the_residual():
    """One rank (the port's mesh): the reduced gradient is the dequantized
    value of gradient + residual, in the gradient's dtype, and the new
    residual is (gradient + residual) - dequantized, in float32, carried
    over three steps."""
    rng = np.random.default_rng(3)
    mesh = one_device_mesh("cpu")
    err = {"a": torch.zeros(6, 4), "b": {"c": torch.zeros(3)}}
    for _ in range(3):
        g = {"a": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)),
             "b": {"c": torch.from_numpy(rng.standard_normal(3).astype(np.float32))
                   .to(torch.bfloat16)}}
        red, new_err = tcoll.grad_allreduce_compressed(g, err, mesh)
        for path, leaf in topt.tree_items(g):
            e = dict(topt.tree_items(err))[path]
            comp = leaf.float().numpy() + e.numpy()
            jq, js = jcoll.quantize_int8(jnp.asarray(comp))
            dq = np.array(jcoll.dequantize_int8(jq, js))
            got_red = dict(topt.tree_items(red))[path]
            got_err = dict(topt.tree_items(new_err))[path]
            assert got_red.dtype == leaf.dtype and got_err.dtype == torch.float32
            np.testing.assert_array_equal(got_red.float().numpy(),
                                          torch.from_numpy(dq).to(leaf.dtype).float().numpy())
            np.testing.assert_array_equal(got_err.numpy(), comp - dq)
        err = new_err


def test_grad_compress_step_needs_mesh_and_residual():
    _, tcfg = configs()
    _, to = opt_pair("adamw")
    with pytest.raises(ValueError):
        tsteps.make_train_step(tcfg, to, grad_compress=True)
    jcfg, _ = configs()
    _, tp = shared(jcfg, tcfg)
    step = tsteps.make_train_step(tcfg, to, grad_compress=True, mesh=one_device_mesh("cpu"))
    (_, tb), = batches(tcfg, 1)
    with pytest.raises(ValueError):
        step(tp, topt.init_opt_state(tp, to), tb)
    state = topt.init_opt_state(tp, to, grad_compress=True)
    _, state, m = step(tp, state, tb)
    assert torch.isfinite(m["loss"]) and int(state["step"]) == 1
    assert max(float(e.abs().max()) for e in topt.tree_leaves(state["gerr"])) > 0


# --------------------------------------------------------- fault tolerance
def test_straggler_monitor_and_elastic_plan_match_reference():
    rng = np.random.default_rng(11)
    times = list(1.0 + 0.05 * rng.standard_normal(60))
    for i in (20, 33, 34, 50):
        times[i] *= 3.0
    jm, tm = jft.StragglerMonitor(), tft.StragglerMonitor()
    for i, dt in enumerate(times):
        assert tm.record(i, dt) == jm.record(i, dt)
    assert tm.flagged == jm.flagged and tm.flagged
    assert (tm.mean, tm.var, tm.n) == (jm.mean, jm.var, jm.n)
    for n, mp in ((512, 8), (509, 8), (16, 16), (100, 3)):
        assert tft.elastic_mesh_plan(n, mp) == jft.elastic_mesh_plan(n, mp)
    with pytest.raises(ValueError):
        tft.elastic_mesh_plan(4, 8)


def test_restarts_and_heartbeats_match_reference():
    for fails in (0, 2, 5):
        runs = []
        for mod in (jft, tft):
            left, slept, restored = [fails], [], []

            def step():
                if left[0]:
                    left[0] -= 1
                    raise RuntimeError("lost a host")

            policy = mod.RetryPolicy(max_restarts=3, backoff_s=0.5)
            try:
                out = mod.run_with_restarts(step, lambda: restored.append(1), policy,
                                            sleep=slept.append)
            except RuntimeError:
                out = "raised"
            runs.append((out, slept, len(restored)))
        assert runs[0] == runs[1]
    jh, th = jft.HeartbeatTracker(timeout_s=10.0), tft.HeartbeatTracker(timeout_s=10.0)
    for h, t in ((0, 1.0), (1, 5.0), (2, 12.0), (0, 14.0)):
        jh.beat(h, t)
        th.beat(h, t)
    for now in (15.0, 20.0, 30.0):
        assert th.dead_hosts(now) == jh.dead_hosts(now)
