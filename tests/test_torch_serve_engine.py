"""The port's continuous-batching ``ServeEngine`` against the reference's,
on the tiny qwen3-4b config in float32 compute (``tests/test_train_serve.py``
runs the reference engine the same way): 5 requests through 2 slots, the
reference's parameters carried over by ``params_from_numpy``.  Every
request must be done and its generated tokens equal, request by request."""

import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.testing import tree_to_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


def tiny(get):
    cfg = get("qwen3-4b", reduced=True).canonicalize(tp=1)
    return dataclasses.replace(cfg, compute_dtype="float32")


def run(engine, req_type, prompts, max_new, eos):
    reqs = [req_type(rid=i, prompt=p, max_new=max_new, eos=eos)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("with_eos", [False, True])
def test_engine_matches_reference(with_eos):
    jcfg, tcfg = tiny(jax_get_config), tiny(get_config)
    jparams = jax_init_params(jax.random.key(1), jcfg)
    tparams = params_from_numpy(tree_to_numpy(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 8, 5)]
    max_new, eos = 6, None
    if with_eos:  # a token the reference generates, so that some request stops on it
        first = run(JaxServeEngine(jcfg, jparams, max_batch=2, max_seq=64), JaxRequest,
                    prompts, max_new, None)
        max_new, eos = 12, first[0][2]
    want = run(JaxServeEngine(jcfg, jparams, max_batch=2, max_seq=64), JaxRequest,
               prompts, max_new, eos)
    engine = ServeEngine(tcfg, tparams, max_batch=2, max_seq=64, device="cpu")
    got = run(engine, Request, prompts, max_new, eos)
    assert got == want
    if eos is None:
        assert all(len(o) == max_new for o in got)
    else:
        assert any(o[-1] == eos and len(o) < max_new for o in got)
    assert engine.cache["block_0"]["k"].dtype == torch.float32


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tiny(get_config)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, {}, max_batch=1, max_seq=8)
