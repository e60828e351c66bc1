"""The port's relaxation (Algorithm 1) against the reference's: the extra
rows, the iteration count and the converged flag are exactly equal, on the
paper's Cities example and on random relations."""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import relax as jrelax
from repro.core.constraints import FD as JFD
from repro.core.relation import make_relation as jmake
from repro_torch.core import relax as trelax
from repro_torch.core.constraints import FD
from repro_torch.core.relation import make_relation as tmake

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

SETTINGS = dict(max_examples=10, deadline=None)
N_ROWS = 24


def both_relations(data):
    return jmake(data, overlay=list(data), k=4), tmake(data, overlay=list(data), k=4, device="cpu")


def same_relax(jrel, trel, answer, fd_cols, use_rhs, max_iters=None):
    jfd, tfd = JFD("r", *fd_cols), FD("r", *fd_cols)
    ref = jrelax.relax_fd(jrel, jnp.asarray(answer), jfd, max_iters=max_iters, use_rhs=use_rhs)
    port = trelax.relax_fd(trel, torch.from_numpy(answer), tfd, max_iters=max_iters, use_rhs=use_rhs)
    np.testing.assert_array_equal(np.asarray(ref.extra), port.extra.numpy())
    assert int(ref.iterations) == port.iterations
    assert bool(ref.converged) == port.converged
    return port


CITIES = {"zip": np.array([9001, 9001, 9001, 10001, 10001]), "city": np.array([0, 1, 0, 1, 2])}


@pytest.mark.parametrize("rows", [[0, 2], [0, 1, 2], [3], [4], []])
@pytest.mark.parametrize("use_rhs", [True, False])
def test_cities_examples(rows, use_rhs):
    """Examples 2 and 3 (Table 2a), with and without the rhs expansion."""
    jrel, trel = both_relations(CITIES)
    answer = np.zeros(5, bool)
    answer[rows] = True
    same_relax(jrel, trel, answer, ("zip", "city"), use_rhs)


@given(st.integers(0, 2**31 - 1), st.booleans(), st.booleans(), st.sampled_from([None, 1, 2]))
@settings(**SETTINGS)
def test_random_closure(seed, use_rhs, two_lhs, max_iters):
    """Random chains of shared keys, multi-attribute lhs, truncated loops
    (``max_iters`` 1 or 2 leaves ``converged`` False where the closure is
    longer)."""
    rng = np.random.default_rng(seed)
    data = {
        "a": rng.integers(0, 8, N_ROWS),
        "b": rng.integers(0, 3, N_ROWS),
        "c": rng.integers(0, 8, N_ROWS),
    }
    jrel, trel = both_relations(data)
    answer = rng.random(N_ROWS) < 0.15
    lhs = ("a", "b") if two_lhs else "a"
    same_relax(jrel, trel, answer, (lhs, "c"), use_rhs, max_iters=max_iters)


def test_lemmas_2_and_3():
    assert trelax.default_max_iters(1000) == jrelax.default_max_iters(1000)
    for args in ((100, 5, 10), (100, 0, 10), (10, 5, 8), (10**6, 300, 5000)):
        assert trelax.lemma2_prob(*args) == jrelax.lemma2_prob(*args)
    d = [np.array([3, 4, 5], np.int32), np.array([1.5, 2.5], np.float32)]
    q = [np.array([1, 2], np.int32), np.array([0.5], np.float32)]
    ref = jrelax.lemma3_upper_bound([jnp.asarray(x) for x in d], [jnp.asarray(x) for x in q])
    port = trelax.lemma3_upper_bound([torch.from_numpy(x) for x in d], [torch.from_numpy(x) for x in q])
    assert port.dtype == torch.float32 and float(ref) == float(port)
