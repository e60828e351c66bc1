"""The port on the card: the CUDA ``dc_pair_scan`` against its plain
PyTorch version, and the whole ``Daisy`` on the card against the same
engine on the CPU.  Every test is marked ``gpu`` and skips without a CUDA
device.  The file imports no JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the shared conftest builds reference relations with
JAX.)  Comparisons are exact."""

import numpy as np
import pytest
import torch

from repro_torch.core.constraints import DC, FD, Atom, flip_op
from repro_torch.core.detect import _T1_REDUCE
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.operators import Pred, Query
from repro_torch.core.relation import make_relation
from repro_torch.data.generators import inject_dc_errors, inject_fd_errors, ssb_lineorder
from repro_torch.kernels import dc_pairs
from repro_torch.kernels import ops as tops
from repro_torch.testing import relation_to_numpy

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    return "cuda"


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int8, torch.bfloat16])
def test_kernel_matches_plain_version(card, dtype):
    rng = np.random.default_rng(1)
    n = 1000
    vals = torch.from_numpy(rng.integers(-50, 50, n).astype(np.float32)).to(dtype).to(card)
    rs = torch.from_numpy(rng.random(n) < 0.8).to(card)
    ops = ["<", "!="]
    args = ([vals, vals], [vals, vals], ops, [flip_op(o) for o in ops], rs, rs,
            [_T1_REDUCE[o] for o in ops], [_T1_REDUCE[flip_op(o)] for o in ops])
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    got = tops.dc_pair_scan(*args, block=256)
    assert dc_pairs.LAUNCHES["dc_pair_scan"] == before + 1
    with dc_pairs.plain_version():
        want = tops.dc_pair_scan(*args, block=256)
    assert dc_pairs.LAUNCHES["dc_pair_scan"] == before + 1
    for g, w in zip((got.t1_count, got.t2_count) + got.t1_stat + got.t2_stat,
                    (want.t1_count, want.t2_count) + want.t1_stat + want.t2_stat):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_daisy_on_card_matches_cpu(card):
    """FD orderkey -> suppkey and fig12's DC on one small lineorder table;
    the DC steps run the kernel on the card and the plain version on the
    CPU."""
    clean = ssb_lineorder(384, 48, 12, seed=21)
    order = np.argsort(clean["extended_price"])
    d = np.sort(clean["discount"])[::-1]
    clean["discount"] = d[np.argsort(order)].astype(np.float32)
    ds = inject_fd_errors(clean, "orderkey", "suppkey", 1.0, 0.1, n_values=12, seed=22)
    data = inject_dc_errors(ds.data, "discount", 0.05, 0.3, seed=23).data
    rules = [FD("fd_os", "orderkey", "suppkey"),
             DC("dc_pd", [Atom("extended_price", "<", "extended_price"),
                          Atom("discount", ">", "discount")])]
    overlay = ["orderkey", "suppkey", "extended_price", "discount"]
    engines = {
        dev: Daisy({"t": make_relation(data, overlay=overlay, k=8,
                                       rules=[r.name for r in rules], device=dev)},
                   {"t": rules}, DaisyConfig(k=8, dc_block=64, accuracy_threshold=0.0),
                   device=dev)
        for dev in ("cpu", card)
    }
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    for col, lo, hi in (("extended_price", 1000.0, 2500.0), ("orderkey", 0, 20),
                        ("extended_price", 2500.0, 5000.0)):
        q = Query("t", preds=(Pred(col, ">=", lo), Pred(col, "<", hi)))
        res = {dev: d.execute(q) for dev, d in engines.items()}
        assert torch.equal(res["cpu"].mask, res[card].mask.cpu())
        assert ([s.asdict() for s in res["cpu"].report.steps]
                == [s.asdict() for s in res[card].report.steps])
        a = relation_to_numpy(engines["cpu"].db["t"])
        b = relation_to_numpy(engines[card].db["t"])
        for field in ("cand", "ccount", "ckind", "checked"):
            for k in a[field]:
                np.testing.assert_array_equal(a[field][k].view(np.uint8),
                                              b[field][k].view(np.uint8))
    assert dc_pairs.LAUNCHES["dc_pair_scan"] > before
