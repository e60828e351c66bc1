"""The port's sort-based set/group primitives against the reference's.

The reference sorts multi-column keys with one stable ``lax.sort``; the
port chains stable single-key ``torch.sort``s.  Hypothesis draws duplicate
keys, multi-column keys, signed zeros, NaN and candidate overflow
(groups with more than ``k`` distinct values).  Every output is compared
exactly, including the bit patterns of float values (a -0.0 carried as a
candidate must stay -0.0)."""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import setops as jset
from repro_torch.core import setops as tset

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

SETTINGS = dict(max_examples=10, deadline=None)
# fixed row counts keep the reference's per-shape compilations few; the
# draws vary the contents (duplicates, zeros, NaN, masks, key widths)
N_ROWS, N_SET = 24, 16
FLOATS = np.array([-0.0, 0.0, 1.5, -2.0, np.nan, 7.0], np.float32)


def same(a, b, what=""):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


@st.composite
def keyed_rows(draw):
    n = N_ROWS
    seed = draw(st.integers(0, 2**31 - 1))
    n_keys = draw(st.integers(1, 3))
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(n_keys):
        if i == n_keys - 1 and draw(st.booleans()):
            keys.append(rng.choice(FLOATS, n))
        else:
            keys.append(rng.integers(0, draw(st.integers(1, 6)), n).astype(np.int32))
    mask = rng.random(n) < draw(st.floats(0.2, 1.0))
    return rng, keys, mask


def both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@given(keyed_rows())
@settings(**SETTINGS)
def test_member_in(case):
    rng, keys, qmask = case
    n = keys[0].shape[0]
    m = N_SET
    set_keys = [
        k[rng.integers(0, n, m)] if rng.random() < 0.7 else np.resize(k, m) for k in keys
    ]
    smask = rng.random(m) < 0.6
    jq, tq = both(keys)
    js, ts = both(set_keys)
    same(
        jset.member_in(jq, jnp.asarray(qmask), js, jnp.asarray(smask)),
        tset.member_in(tq, torch.from_numpy(qmask), ts, torch.from_numpy(smask)),
    )


@given(keyed_rows())
@settings(**SETTINGS)
def test_group_info_and_unique_counts(case):
    _, keys, mask = case
    jk, tk = both(keys)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    for a, b in zip(jset.group_info(jk, jm), tset.group_info(tk, tm)):
        same(a, b, "group_info")
    jv, jc, jn = jset.unique_counts(jk, jm)
    tv, tc, tn = tset.unique_counts(tk, tm)
    for a, b in zip(jv, tv):
        same(a, b, "unique values")
    same(jc, tc, "unique counts")
    same(jn, tn, "num_distinct")


@given(keyed_rows(), st.integers(1, 4), st.booleans())
@settings(**SETTINGS)
def test_group_distinct_candidates(case, k, weighted):
    """k as small as 1 exercises the overflow flag and the dropped slots."""
    rng, keys, mask = case
    *key_cols, value = keys if len(keys) > 1 else keys + [keys[0]]
    n = value.shape[0]
    weight = rng.integers(0, 3, n).astype(np.float32) if weighted else None
    jk, tk = both(key_cols)
    jw = None if weight is None else jnp.asarray(weight)
    tw = None if weight is None else torch.from_numpy(weight)
    ref = jset.group_distinct_candidates(jk, jnp.asarray(value), jnp.asarray(mask), k, weight=jw)
    port = tset.group_distinct_candidates(
        tk, torch.from_numpy(value), torch.from_numpy(mask), k, weight=tw
    )
    for name, a, b in zip(("cand", "count", "violated", "overflow"), ref, port):
        same(a, b, name)


def test_signed_zero_keys_group_together():
    """-0.0 and +0.0 are one key in both packages; the candidate carried is
    the first in stable order, with its sign."""
    key = np.array([1, 1, 1, 2], np.int32)
    val = np.array([0.0, -0.0, 3.0, -0.0], np.float32)
    mask = np.ones(4, bool)
    ref = jset.group_distinct_candidates([jnp.asarray(key)], jnp.asarray(val), jnp.asarray(mask), 4)
    port = tset.group_distinct_candidates(
        [torch.from_numpy(key)], torch.from_numpy(val), torch.from_numpy(mask), 4
    )
    for a, b in zip(ref, port):
        same(a, b)
    assert port[1][0, :2].tolist() == [2.0, 1.0]  # {±0: 2 rows, 3.0: 1 row}
