"""The port's relation against the reference's: building, dtypes, padding,
the possible-world predicate, probabilities, and the device contract.

Every comparison here is exact (values, dtypes and bit patterns)."""

import gc
import jax
import numpy as np
import pytest
import torch

from repro.core.relation import make_relation as jmake_relation
from repro_torch.core import relation as trel
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.testing import relation_from_numpy, relation_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()

OPS = ("==", "!=", "<", "<=", ">", ">=")


def assert_same_relation(a, b):
    """Two host-array layouts (``relation_to_numpy``) equal: dtype and bits."""
    np.testing.assert_array_equal(a["valid"], b["valid"])
    for field in ("columns", "cand", "ccount", "ckind", "orig", "checked"):
        assert a[field].keys() == b[field].keys(), field
        for k in a[field]:
            x, y = a[field][k], b[field][k]
            assert x.dtype == y.dtype, (field, k, x.dtype, y.dtype)
            np.testing.assert_array_equal(
                x.view(np.uint8), y.view(np.uint8), err_msg=f"{field}.{k}"
            )


def _data(rng, n):
    return {
        "a": rng.integers(-5, 50, n),  # int64 host -> int32
        "b": rng.uniform(0, 10, n),  # float64 host -> float32
        "c": rng.integers(0, 3, n).astype(np.uint8),
    }


@pytest.mark.parametrize("n,cap", [(5, None), (7, 16), (1, 3)])
def test_make_relation_matches_reference(n, cap):
    rng = np.random.default_rng(n)
    data = _data(rng, n)
    kw = dict(capacity=cap, overlay=["a", "b"], k=4, rules=["r1", "r2"])
    ref = relation_to_numpy(jmake_relation(data, **kw))
    port = trel.make_relation(data, device="cpu", **kw)
    assert port.capacity == (cap or n) and port.k == 4
    assert port.names == ("a", "b", "c")
    assert_same_relation(ref, relation_to_numpy(port))


def test_dtypes_never_widen():
    rel = trel.make_relation(
        {"i": np.arange(4, dtype=np.int64), "f": np.arange(4.0)},
        overlay=["i", "f"], rules=["r"], device="cpu",
    )
    assert rel.columns["i"].dtype == torch.int32
    assert rel.columns["f"].dtype == torch.float32
    assert rel.cand["i"].dtype == torch.int32
    assert rel.ccount["f"].dtype == torch.float32
    assert rel.ckind["f"].dtype == torch.int8
    assert rel.checked["r"].dtype == torch.bool
    assert rel.num_rows().dtype == torch.int32


def test_default_device_is_cuda_and_raises_without_it():
    """No silent CPU: without CUDA the default-device entry points raise."""
    data = {"a": np.arange(3)}
    if torch.cuda.is_available():
        assert trel.make_relation(data).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        trel.make_relation(data)
    rel = trel.make_relation(data, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Daisy({"t": rel}, {"t": []}, DaisyConfig())
    Daisy({"t": rel}, {"t": []}, DaisyConfig(), device="cpu")


def _random_overlay(rng, ref_np, attrs):
    """Give the reference's host arrays a random overlay: values, counts
    (some empty slots) and kinds (value and both range kinds)."""
    cap = ref_np["valid"].shape[0]
    for a in attrs:
        k = ref_np["cand"][a].shape[1]
        dt = ref_np["cand"][a].dtype
        if dt.kind == "f":
            vals = rng.choice(np.array([-1.5, 0.0, -0.0, 2.0, 3.5], np.float32), (cap, k))
        else:
            vals = rng.integers(-3, 6, (cap, k)).astype(dt)
        ref_np["cand"][a] = vals
        ref_np["ccount"][a] = (rng.integers(0, 3, (cap, k)) * rng.integers(0, 2, (cap, k))).astype(np.float32)
        ref_np["ckind"][a] = rng.integers(0, 3, (cap, k)).astype(np.int8)
    return ref_np


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_matches_probs_uncertain(seed):
    """The possible-world predicate over value and range candidates, the
    normalized probabilities and the uncertainty flag, for every op."""
    import jax.numpy as jnp
    from repro.core.relation import Relation as JRelation

    rng = np.random.default_rng(seed)
    n = 12
    data = {
        "a": rng.integers(-3, 6, n),
        "b": rng.choice(np.array([-1.5, 0.0, 2.0, 3.5], np.float32), n),
        "c": rng.integers(0, 4, n),
    }
    host = relation_to_numpy(jmake_relation(data, overlay=["a", "b"], k=3))
    host = _random_overlay(rng, host, ["a", "b"])
    jrel = JRelation(
        {k: jnp.asarray(v) for k, v in host["columns"].items()},
        jnp.asarray(host["valid"]),
        {k: jnp.asarray(v) for k, v in host["cand"].items()},
        {k: jnp.asarray(v) for k, v in host["ccount"].items()},
        {k: jnp.asarray(v) for k, v in host["ckind"].items()},
        {k: jnp.asarray(v) for k, v in host["orig"].items()},
        {},
    )
    prel = relation_from_numpy(host, device="cpu")
    for name, values in (("a", (-1, 0, 2, 2.5)), ("b", (0.0, -0.0, 2.0, 1.0)), ("c", (1, 3))):
        for op in OPS:
            for v in values:
                np.testing.assert_array_equal(
                    np.asarray(jrel.candidate_matches(name, op, v)),
                    prel.candidate_matches(name, op, v).numpy(),
                    err_msg=f"{name} {op} {v}",
                )
    for name in ("a", "b"):
        np.testing.assert_array_equal(
            np.asarray(jrel.probs(name)), prel.probs(name).numpy()
        )
        np.testing.assert_array_equal(
            np.asarray(jrel.is_uncertain(name)), prel.is_uncertain(name).numpy()
        )


def test_masked_keys_and_round_trip():
    import jax.numpy as jnp
    from repro.core.relation import masked_keys as jmasked

    rng = np.random.default_rng(4)
    mask = rng.random(9) < 0.5
    for arr in (rng.integers(-9, 9, 9).astype(np.int32), rng.normal(size=9).astype(np.float32)):
        np.testing.assert_array_equal(
            np.asarray(jmasked(jnp.asarray(arr), jnp.asarray(mask))),
            trel.masked_keys(torch.from_numpy(arr), torch.from_numpy(mask)).numpy(),
        )
    host = relation_to_numpy(
        jmake_relation(_data(rng, 6), capacity=8, overlay=["a"], rules=["x"])
    )
    assert_same_relation(host, relation_to_numpy(relation_from_numpy(host, device="cpu")))


def test_dictionary_codes():
    d = trel.Dictionary(["LA", "SF"])
    assert d.encode("NY") == 2 and d.encode("LA") == 0
    assert d.encode_many(["SF", "NY"]).dtype == np.int32
    assert d.decode(1) == "SF" and len(d) == 3
