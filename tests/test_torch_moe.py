"""The port's MoE MLP (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``): ``_run_rank``, the top-k order and ``moe_mlp``'s
output, aux loss and routing, on the same numpy inputs.

Tolerances: ``_run_rank``, the chosen experts and the slot tables are
exact.  ``moe_mlp`` in float32 is held at ``atol=rtol=1e-5`` (the two
packages' matmuls sum in different orders; the differences measured are
below 1e-6); in bf16 at ``atol=3e-2`` (the reference tests' bf16 tolerance),
with the routing still exact, since the router runs in float32 on the same
bf16 input."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

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


def ref_moe(x, params, n_experts, top_k, capacity_factor, mlp_kind, n_groups=1):
    """The reference's ``moe_mlp`` under ``jax.jit`` (one compile, not one
    per operation)."""
    fn = jax.jit(jmoe.moe_mlp, static_argnums=(2, 3, 4, 5, 6))
    return fn(x, params, n_experts, top_k, capacity_factor, mlp_kind, n_groups)


@pytest.mark.parametrize("ids", [
    [0, 0, 0, 1, 1, 2, 5, 5, 5, 5],
    [3, 3, 3, 3],
    [0, 1, 2, 3, 4],
    [7],
])
def test_run_rank(ids):
    ids = np.asarray(ids, np.int32)
    want = np.asarray(jmoe._run_rank(jnp.asarray(ids)))
    got = tmoe._run_rank(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_breaks_ties_to_the_lower_index():
    """``jax.lax.top_k`` puts the lower index first on ties; the port's
    stable sort does too."""
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2], [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 3)
    gv, gi = tmoe._top_k(torch.from_numpy(probs), 3)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def make_params(rng, d, e_pad, f, mlp_kind, n_shared=0, tie_router=False):
    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2] if len(shape) > 1 else 1)
                ).astype(np.float32)

    if mlp_kind == "swiglu":
        p = {"we_i": w(e_pad, d, 2, f) / np.sqrt(d), "we_o": w(e_pad, f, d)}
    else:
        p = {"we_i": w(e_pad, d, f), "we_o": w(e_pad, f, d)}
    p["router"] = w(d, e_pad)
    if tie_router:  # experts 1 and 2 (and 0 and 3) score every token alike
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 0]
    if n_shared:
        fs = f * n_shared
        p["shared_wi"] = w(d, 2, fs) / np.sqrt(d) if mlp_kind == "swiglu" else w(d, fs)
        p["shared_wo"] = w(fs, d)
    return {n: v.astype(np.float32) for n, v in p.items()}


# (b, s, d, n_experts, e_pad, top_k, f, capacity_factor, mlp, n_groups, n_shared, ties)
CASES = {
    "swiglu top-2": (2, 8, 16, 4, 4, 2, 24, 1.25, "swiglu", 1, 0, False),
    "drops at capacity 0.5": (2, 16, 16, 4, 4, 2, 24, 0.5, "swiglu", 1, 0, False),
    "padded experts 6->8, shared": (2, 8, 16, 6, 8, 2, 16, 1.25, "swiglu", 1, 2, False),
    "gelu, 2 groups": (4, 6, 16, 8, 8, 3, 16, 1.0, "gelu", 2, 0, False),
    "groups fall back to 1": (3, 5, 16, 4, 4, 2, 16, 1.25, "swiglu", 2, 0, False),
    "tied router columns": (2, 8, 16, 4, 4, 2, 16, 0.75, "swiglu", 1, 0, True),
    "one token a group (decode)": (2, 1, 16, 8, 8, 4, 16, 1.25, "swiglu", 2, 0, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_reference(case):
    b, s, d, n_exp, e_pad, k, f, cf, kind, groups, shared, ties = CASES[case]
    rng = np.random.default_rng(len(case))
    params = make_params(rng, d, e_pad, f, kind, shared, ties)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    jout, jaux = ref_moe(jnp.asarray(x), jax.tree.map(jnp.asarray, params), n_exp, k,
                         cf, kind, groups)
    tout, taux = tmoe.moe_mlp(torch.from_numpy(x), {n: torch.from_numpy(v)
                                                    for n, v in params.items()},
                              n_exp, k, cf, kind, n_groups=groups)
    assert tout.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


def test_moe_mlp_bf16_keeps_the_routing_exact():
    """bf16 activations and expert weights with the float32 router, as
    ``cast_params`` leaves them: the same experts, the output at bf16
    tolerance, in the compute dtype."""
    b, s, d, n_exp, k, f = 2, 8, 32, 8, 2, 32
    rng = np.random.default_rng(5)
    params = make_params(rng, d, n_exp, f, "swiglu")
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    jp = {n: jnp.asarray(v, jnp.float32 if n == "router" else jnp.bfloat16)
          for n, v in params.items()}
    tp = {n: torch.from_numpy(v).to(torch.float32 if n == "router" else torch.bfloat16)
          for n, v in params.items()}
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jout, jaux = ref_moe(jx, jp, n_exp, k, 1.25, "swiglu")
    tout, taux = tmoe.moe_mlp(tx, tp, n_exp, k, 1.25, "swiglu")
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32), **BF16)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)
    # the router input is the same bf16 tensor: the chosen experts agree exactly
    jl = jnp.asarray(jx, jnp.float32).reshape(-1, d) @ jp["router"]
    _, want = jax.lax.top_k(jax.nn.softmax(jl, axis=-1), k)
    _, got = tmoe._top_k(torch.softmax(tx.float().reshape(-1, d) @ tp["router"], -1), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_route_tables_match_reference_slot_order():
    """Which (token, k) slots overflow is fixed by the stable order of the
    flattened expert ids: later tokens overflow first, as in the reference."""
    gate_idx = np.array([[[0, 1], [0, 2], [0, 1], [1, 0], [3, 0]]], np.int32)  # (1, 5, 2)
    e_pad, capacity = 4, 2
    token_of_slot, pos, keep, slot_e = tmoe._route(torch.from_numpy(gate_idx), e_pad, capacity)
    # expert 0 is chosen by tokens 0..4: tokens 0 and 1 keep it, 2-4 overflow
    np.testing.assert_array_equal(token_of_slot[0, 0].numpy(), [0, 1])
    np.testing.assert_array_equal(keep[0, :, 0].numpy(), [True, True, False, False, True])
    np.testing.assert_array_equal(keep[0, 3].numpy(), [False, False])
    assert int(slot_e[0, 6]) == e_pad  # token 3's expert 1 (its third user): cut row
    np.testing.assert_array_equal(token_of_slot[0, 3].numpy(), [4, 5])  # 5: the zero row
    assert pos.dtype == torch.int32 and int(pos[0, 2, 0]) == capacity - 1
