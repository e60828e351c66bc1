"""The port on the card: the CUDA ``dc_pair_scan``, ``dc_role_scan`` (also
over every case of ``kernels/dc_scan_check.py``),
``semijoin`` (a hash build and probe) and the two flash-attention kernels
(the tensor-core ``wgmma`` one for bf16 at head dims 64, 128 and 256,
the CUDA-core one for the rest) against their plain PyTorch versions, the
sharded pair scan (one launch over every logical shard,
``dc_scan_check.SHARDED_CASES``) and sharded detection against the CPU, the
whole ``Daisy`` (SP and join queries) and the offline cleaner on the card
against the same engines on the CPU, and the LM's prefill through the
flash kernel against the same prefill through the plain version.  Every
test is marked ``gpu`` and skips without a CUDA device.  The file imports
no JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the shared conftest builds reference relations with
JAX.)  DC comparisons are exact; attention is compared at the reference
tests' tolerances (float32 ``atol=rtol=2e-5``, bf16 ``atol=3e-2``)."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core.constraints import DC, FD, Atom, flip_op
from repro_torch.core.detect import _T1_REDUCE
from repro_torch.core.executor import Daisy, DaisyConfig
from repro_torch.core.offline import OfflineCleaner
from repro_torch.core.operators import GroupBySpec, JoinClause, Pred, Query
from repro_torch.core.relation import make_relation
from repro_torch.data.generators import (
    inject_dc_errors,
    inject_fd_errors,
    ssb_lineorder,
    suppliers,
)
from repro_torch.kernels import dc_pairs
from repro_torch.kernels import dc_scan_check as dsc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import semijoin as sj
from repro_torch.testing import relation_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.models.params import cast_params, init_params

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


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
        t.view(torch.int32) if t.dtype == torch.float32 else t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int16, torch.int8,
                                   torch.bfloat16])
@pytest.mark.parametrize("restr", [{}, dict(row_blocks=(1, 3)), dict(col_blocks=(0, 2)),
                                   dict(row_block_ids=[3, 0], col_block_ids=[1, 3])])
def test_role_scan_kernel_matches_plain_version(card, dtype, restr):
    """Three atoms over two columns on one side and three on the other,
    n not a multiple of the block."""
    rng = np.random.default_rng(2)
    n = 1000
    cols = [torch.from_numpy(rng.integers(-50, 50, n).astype(np.float32)).to(dtype).to(card)
            for _ in range(3)]
    rs = torch.from_numpy(rng.random(n) < 0.8).to(card)
    cs = torch.from_numpy(rng.random(n) < 0.9).to(card)
    args = ([cols[0], cols[1], cols[0]], cols, ["<", "!=", ">="], rs, cs, ["max", "min", "min"])
    before = dc_pairs.LAUNCHES["dc_role_scan"]
    got_c, got_s = tops.dc_role_scan(*args, block=256, **restr)
    assert dc_pairs.LAUNCHES["dc_role_scan"] == before + 1
    with dc_pairs.plain_version():
        want_c, want_s = tops.dc_role_scan(*args, block=256, **restr)
    assert torch.equal(got_c, want_c)
    for g, w in zip(got_s, want_s):
        assert g.dtype == w.dtype == dtype and torch.equal(_bits(g), _bits(w))


def test_role_scan_kernel_nan_and_signed_zeros(card):
    special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf], np.float32)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.choice(special, 700)).to(card)
    y = torch.from_numpy(rng.choice(special, 700)).to(card)
    ones = torch.ones(700, dtype=torch.bool, device=card)
    for ops, reduces in ((["!="], ["min"]), (["!=", "<"], ["max", "max"]),
                         (["<=", ">="], ["min", "max"])):
        args = ([x, y][:len(ops)], [y, x][:len(ops)], ops, ones, ones, reduces)
        got_c, got_s = tops.dc_role_scan(*args, block=128)
        with dc_pairs.plain_version():
            want_c, want_s = tops.dc_role_scan(*args, block=128)
        assert torch.equal(got_c, want_c)
        for g, w in zip(got_s, want_s):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("both", [True, False], ids=["pair", "role"])
@pytest.mark.parametrize("case", dsc.CASES, ids=[c.name for c in dsc.CASES])
def test_scan_kernel_check_case(card, case, both):
    """Every case of ``kernels/dc_scan_check.py``: each specialised atom
    count and the generic path (8 atoms over 16 distinct columns among
    them), blocks 1, 64, 100 and 1,024, a col list that 7 chunks do not
    divide evenly, a one-row-block strip; one launch, bit for bit."""
    name = "dc_pair_scan" if both else "dc_role_scan"
    before = dc_pairs.LAUNCHES[name]
    err, _, _ = dsc.check_case(case, card, both)
    assert err is None, err
    assert dc_pairs.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("case", dsc.SHARDED_CASES, ids=[c.name for c in dsc.SHARDED_CASES])
def test_sharded_scan_kernel_check_case(card, case):
    """Every case of ``dc_scan_check.SHARDED_CASES``: one launch over 2, 4
    or 16 shards (a shard with no row, hi below a shard's block count, a
    ragged block, the generic path), bit for bit against
    ``dc_pair_scan_sharded_plain``."""
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    err, _, _ = dsc.check_sharded_case(case, card)
    assert err is None, err
    assert dc_pairs.LAUNCHES["dc_pair_scan"] == before + 1


def test_sharded_scan_same_bits_every_chunking(card):
    inp = dsc.sharded_case_inputs(dsc.SHARDED_CASES[2], card)
    first = dsc.sharded_scan(inp)
    for chunks in (1, 5):
        assert dsc.same_bits(dsc.sharded_scan(inp, chunks=chunks), first) is None, chunks


def test_sharded_detect_on_card_matches_cpu(card):
    """The sharded DC and FD detects of a mesh on the card against the same
    on the CPU and the dense scan; one pair-scan launch for all shards."""
    from repro_torch.core.detect import detect_dc, detect_fd
    from repro_torch.dist.detect import detect_dc_sharded_info, detect_fd_sharded_info
    from repro_torch.dist.hints import one_device_mesh

    rng = np.random.default_rng(5)
    n = 6_000
    cols = {"region": rng.integers(0, 300, n).astype(np.int32),
            "price": rng.uniform(1, 100, n).astype(np.float32),
            "disc": rng.uniform(0, 1, n).astype(np.float32),
            "supp": rng.integers(0, 9, n).astype(np.int32)}
    dc = DC("d", [Atom("region", "==", "region"), Atom("price", "<", "price"),
                  Atom("disc", ">", "disc")])
    fd = FD("f", "region", "supp")
    outs = {}
    for dev in ("cpu", card):
        rel = make_relation(cols, overlay=["price", "disc", "supp"], k=4, rules=["d", "f"],
                            device=dev)
        mesh = one_device_mesh(dev)
        before = dc_pairs.LAUNCHES["dc_pair_scan"]
        det, _ = detect_dc_sharded_info(rel, dc, rel.valid, rel.valid, mesh, n_shards=8,
                                        block=256)
        if dev == card:
            assert dc_pairs.LAUNCHES["dc_pair_scan"] == before + 1
        dense = detect_dc(rel, dc, rel.valid, rel.valid)
        fdet, _ = detect_fd_sharded_info(rel, fd, rel.valid, mesh, k=4, n_shards=8)
        fdense = detect_fd(rel, fd, rel.valid, k=4)
        outs[dev] = ([det.t1_count, det.t2_count, *det.t1_stat, *det.t2_stat],
                     [dense.t1_count, dense.t2_count, *dense.t1_stat, *dense.t2_stat],
                     [fdet.violated, fdet.rhs_cand, fdet.rhs_count, fdet.lhs_cand],
                     [fdense.violated, fdense.rhs_cand, fdense.rhs_count, fdense.lhs_cand])
    for side in range(4):
        for g, w in zip(outs[card][side], outs["cpu"][side]):
            assert torch.equal(_bits(g.cpu()), _bits(w))
    for sharded, dense in ((0, 1), (2, 3)):
        for g, w in zip(outs[card][sharded], outs[card][dense]):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("both", [True, False], ids=["pair", "role"])
def test_scan_kernel_same_bits_every_launch_and_chunking(card, both):
    """Chunks merge with integer atomics, which commute: two launches, and
    launches over 1 and 13 col chunks, give the same bits."""
    inp = dsc.timing_inputs(card)
    first = dsc.scan(inp, both)
    for kw in ({}, {"chunks": 1}, {"chunks": 13}):
        assert dsc.same_bits(dsc.scan(inp, both, **kw), first) is None, kw


@pytest.mark.parametrize("n,m,block", [(5, 7, 64), (64, 64, 256), (100, 257, 64),
                                       (513, 100, 256), (70_000, 3_000, 512)])
def test_semijoin_kernel_matches_plain_version(card, n, m, block):
    rng = np.random.default_rng(n)
    q = torch.from_numpy(rng.integers(0, 4 * m, n).astype(np.int32)).to(card)
    k = torch.from_numpy(rng.integers(0, 4 * m, m).astype(np.int32)).to(card)
    qm = torch.from_numpy(rng.random(n) < 0.8).to(card)
    for km in (torch.from_numpy(rng.random(m) < 0.8).to(card),
               torch.zeros(m, dtype=torch.bool, device=card)):
        before = sj.LAUNCHES["semijoin"]
        got = tops.semijoin(q, qm, k, km, block=block)
        assert sj.LAUNCHES["semijoin"] == before + 1
        with sj.plain_version():
            want = tops.semijoin(q, qm, k, km, block=block)
        assert got.dtype == torch.bool and torch.equal(got, want)
        assert torch.equal(got, torch.isin(q, k[km]) & qm)


def _semijoin_edge(name, card):
    rng = np.random.default_rng(7)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if name == "int32 extremes":
        k = np.array([lo, hi, -1, 0], np.int32)
        q = np.concatenate([k, k + np.array([1, -1, -1, 1], np.int32),
                            rng.integers(lo, hi, 500, dtype=np.int64).astype(np.int32)])
        km = np.ones(4, bool)
    elif name == "duplicates, mixed masks":
        k = np.repeat(rng.integers(0, 300, 200).astype(np.int32), 10)
        km = np.ones(k.shape[0], bool)
        km[::10] = False  # one copy of each value out, its twins in
        km[k < 30] = False  # and some values out in every copy
        q = rng.integers(0, 350, 5000).astype(np.int32)
    elif name == "multiples of the table size":
        slots = sj.table_slots(400)
        k = (np.arange(-200, 200) * slots).astype(np.int32)
        q = (rng.integers(-300, 300, 5000) * slots).astype(np.int32)
        km = np.ones(400, bool)
    elif name in ("m=0", "every key masked out"):
        q = rng.integers(0, 50, 300).astype(np.int32)
        k = np.zeros(0 if name == "m=0" else 40, np.int32)
        km = np.zeros(k.shape[0], bool)
    else:  # n=0
        q, k, km = np.zeros(0, np.int32), np.arange(10, dtype=np.int32), np.ones(10, bool)
    qm = rng.random(q.shape[0]) < 0.9
    return [torch.from_numpy(a).to(card) for a in (q, qm, k, km)]


@pytest.mark.parametrize("name", ["int32 extremes", "duplicates, mixed masks",
                                  "multiples of the table size", "m=0", "every key masked out",
                                  "n=0"])
def test_semijoin_kernel_edge_cases(card, name):
    """The hash kernel == the plain version == torch.isin, bit for bit; a
    call with no query launches nothing."""
    q, qm, k, km = _semijoin_edge(name, card)
    before = sj.LAUNCHES["semijoin"]
    got = tops.semijoin(q, qm, k, km)
    assert sj.LAUNCHES["semijoin"] == before + (q.shape[0] > 0)
    with sj.plain_version():
        want = tops.semijoin(q, qm, k, km)
    assert got.dtype == torch.bool and got.shape == q.shape and torch.equal(got, want)
    assert torch.equal(got, torch.isin(q, k[km]) & qm)


def test_semijoin_kernel_raises_on_other_dtypes(card):
    x = torch.zeros(8, dtype=torch.int64, device=card)
    m = torch.ones(8, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="int32"):
        tops.semijoin(x, m, x, m)


def _join_db(dev, n_lo=4096, n_sup=64):
    lo = ssb_lineorder(n_lo, n_lo // 8, n_sup, seed=31)
    ds_lo = inject_fd_errors(lo, "orderkey", "suppkey", 1.0, 0.1, n_sup, seed=32)
    ds_sup = inject_fd_errors(suppliers(n_sup, seed=33), "address", "suppkey", 1.0, 0.1,
                              n_sup, seed=34)
    db = {"lineorder": make_relation(ds_lo.data, overlay=["orderkey", "suppkey"], k=8,
                                     rules=["phi"], device=dev),
          "suppliers": make_relation(ds_sup.data, overlay=["address", "suppkey"], k=8,
                                     rules=["psi"], device=dev)}
    rules = {"lineorder": [FD("phi", "orderkey", "suppkey")],
             "suppliers": [FD("psi", "address", "suppkey")]}
    return db, rules


def test_join_queries_on_card_match_cpu(card):
    """fig13's range joins and the region group-by: equal lineage, reports
    and overlays on the card and on the CPU."""
    engines = {dev: Daisy(*_join_db(dev), DaisyConfig(join_capacity=16384,
                                                      use_cost_model=False), device=dev)
               for dev in ("cpu", card)}
    queries = [Query("lineorder", preds=(Pred("suppkey", ">=", a), Pred("suppkey", "<", a + 16)),
                     joins=(JoinClause("suppliers", "suppkey", "suppkey"),))
               for a in (0, 16, 32)]
    queries.append(Query("lineorder", joins=(JoinClause("suppliers", "suppkey", "suppkey"),),
                         groupby=GroupBySpec(("region",), "count", table="suppliers")))
    for q in queries:
        res = {dev: d.execute(q) for dev, d in engines.items()}
        a, b = res["cpu"], res[card]
        assert a.report.asdict() == b.report.asdict()
        for t in a.join.rows:
            assert torch.equal(a.join.rows[t], b.join.rows[t].cpu())
        assert torch.equal(a.join.valid, b.join.valid.cpu())
        if a.groups is not None:
            torch.testing.assert_close(a.groups["count"], b.groups["count"].cpu(),
                                       rtol=1e-6, atol=0)
        for table in ("lineorder", "suppliers"):
            x = relation_to_numpy(engines["cpu"].db[table])
            y = relation_to_numpy(engines[card].db[table])
            for field in ("cand", "ccount", "ckind", "checked"):
                for k in x[field]:
                    np.testing.assert_array_equal(x[field][k].view(np.uint8),
                                                  y[field][k].view(np.uint8))


def test_offline_on_card_matches_cpu(card):
    """The offline DC clean is one full-matrix kernel launch."""
    clean = ssb_lineorder(2000, 250, 12, seed=21)
    data = inject_dc_errors(clean, "discount", 0.05, 0.3, seed=23).data
    dc = DC("dc_pd", [Atom("extended_price", "<", "extended_price"),
                      Atom("discount", ">", "discount")])
    offs = {}
    for dev in ("cpu", card):
        rel = make_relation(data, overlay=["extended_price", "discount"], k=8,
                            rules=["dc_pd"], device=dev)
        offs[dev] = OfflineCleaner({"t": rel}, {"t": [dc]})
    before = dc_pairs.LAUNCHES["dc_pair_scan"]
    for off in offs.values():
        off.clean_all()
    assert dc_pairs.LAUNCHES["dc_pair_scan"] == before + 1
    a, b = relation_to_numpy(offs["cpu"].db["t"]), relation_to_numpy(offs[card].db["t"])
    for field in ("cand", "ccount", "ckind", "checked"):
        for k in a[field]:
            np.testing.assert_array_equal(a[field][k].view(np.uint8), b[field][k].view(np.uint8))


def _qkv(card, dtype, b, hq, hkv, sq, sk, d, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=card).to(dtype)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("dtype,hq,hkv,sq,sk,d,causal,window", [
    (torch.bfloat16, 32, 8, 256, 256, 128, True, None),   # qwen3-4b heads
    (torch.float32, 32, 8, 256, 256, 128, True, None),
    (torch.bfloat16, 8, 8, 300, 300, 128, True, 64),      # window, ragged S
    (torch.float32, 4, 1, 77, 1000, 128, False, None),    # Sq != Sk
    (torch.float32, 4, 4, 1, 1000, 64, False, None),      # D 64, one query
    (torch.bfloat16, 8, 2, 130, 130, 256, True, None),    # D 256: the wgmma kernel
    (torch.float32, 2, 1, 40, 40, 80, True, None),        # D 80, a multiple of 8
])
def test_flash_kernel_matches_plain_version(card, dtype, hq, hkv, sq, sk, d, causal, window):
    q, k, v = _qkv(card, dtype, 2, hq, hkv, sq, sk, d)
    kernel = fa.KERNEL_NAME[fa.kernel_variant(dtype, d)]
    before = dict(fa.LAUNCHES)
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    with fa.plain_version():
        want = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == {n: before[n] + (n == kernel) for n in before}
    assert got.dtype == dtype and got.shape == q.shape
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 else dict(atol=3e-2, rtol=0)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("hq,hkv,sq,sk,d,causal,window", [
    (8, 8, 512, 512, 128, True, None),      # GQA group 1
    (32, 8, 512, 512, 128, True, None),     # group 4, qwen3-4b's heads
    (8, 1, 512, 512, 128, True, None),      # group 8
    (8, 2, 300, 300, 64, True, None),       # D 64, ragged S
    (32, 8, 77, 1000, 128, False, None),    # non-causal Sq != Sk
    (8, 2, 500, 500, 128, True, 64),        # window, ragged S
    (8, 2, 4096, 4096, 128, True, 1024),    # window 1024 at S 4096
    (4, 2, 1, 300, 64, False, None),        # one query row
    (16, 8, 2048, 2048, 256, True, None),   # D 256: gemma3's global layer
    (16, 8, 1100, 1100, 256, True, 1024),   # its local layer's window, ragged S
    (4, 2, 1, 300, 256, False, None),       # D 256, one query row
])
def test_wgmma_kernel_matches_plain_version(card, hq, hkv, sq, sk, d, causal, window):
    """bf16 at head dim 64, 128 and 256: the tensor-core kernel, one launch
    of it and none of the CUDA-core kernel, at the reference's bf16
    tolerance."""
    q, k, v = _qkv(card, torch.bfloat16, 1 if sq == 4096 else 2, hq, hkv, sq, sk, d, seed=3)
    before = dict(fa.LAUNCHES)
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == {"flash_attention": before["flash_attention"],
                           "flash_attention_wgmma": before["flash_attention_wgmma"] + 1}
    with fa.plain_version():
        want = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


def test_each_flash_variant_counts_its_own_launches(card):
    """One bf16 input through both kernels: each counts under its name."""
    q, k, v = _qkv(card, torch.bfloat16, 1, 4, 2, 256, 256, 128)
    before = dict(fa.LAUNCHES)
    a = tops.flash_attention(q, k, v)
    b = fa.flash_attention_cuda_core(q, k, v)
    assert fa.LAUNCHES == {n: before[n] + 1 for n in before}
    torch.testing.assert_close(a.float(), b.float(), atol=3e-2, rtol=0)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_wgmma(q.float(), k.float(), v.float())


def test_wgmma_kernel_refuses_layouts_tma_cannot_take(card):
    q, k, v = _qkv(card, torch.bfloat16, 1, 2, 1, 64, 64, 64)
    padded = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16, device=card)[..., :64]
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="TMA"):
        tops.flash_attention(padded, k, v)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_reads_strided_views(card, dtype):
    """q, k, v as ``attend_full`` passes them: (b, h, s, d) views of
    (b, s, h, d) tensors, read through their strides with no copy."""
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = [torch.randn((2, 300, h, 128), generator=g, device=card).to(dtype).transpose(1, 2)
               for h in (32, 8, 8)]
    got = tops.flash_attention(q, k, v, causal=True)
    with fa.plain_version():
        want = tops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert got.dtype == dtype and got.shape == q.shape
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 else dict(atol=3e-2, rtol=0)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_flash_kernel_uniform_v(card):
    q = torch.ones((1, 1, 128, 32), device=card)
    v = torch.full((1, 1, 128, 32), 3.0, device=card)
    got = tops.flash_attention(q, q, v, causal=True)
    torch.testing.assert_close(got, torch.full_like(got, 3.0), atol=0, rtol=1e-6)
    # bf16 at head dim 128, the tensor-core kernel: 3.0 is exact in bf16
    qb = torch.ones((1, 1, 128, 128), device=card, dtype=torch.bfloat16)
    got = tops.flash_attention(qb, qb, torch.full_like(qb, 3.0), causal=True)
    torch.testing.assert_close(got.float(), torch.full_like(got.float(), 3.0), atol=3e-2, rtol=0)


def test_flash_kernel_raises_on_what_it_does_not_take(card):
    q, k, v = _qkv(card, torch.float32, 1, 2, 1, 16, 16, 12)
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_attention(q, k, v)
    q, k, v = _qkv(card, torch.float16, 1, 2, 1, 16, 16, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.flash_attention(q, k, v)


def test_prefill_on_card_matches_plain_version(card):
    """The reduced qwen3-4b in bf16 compute: prefill through the kernel (one
    launch a layer) against the same prefill through the plain version."""
    cfg = get_config("qwen3-4b", reduced=True).canonicalize(tp=1)
    params = cast_params(init_params(cfg, torch.Generator(device=card).manual_seed(0), card), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    before = fa.LAUNCHES["flash_attention"]
    logits, cache = tt.prefill(params, cfg, {"tokens": toks})
    assert fa.LAUNCHES["flash_attention"] - before == cfg.n_layers
    with fa.plain_version():
        want, want_cache = tt.prefill(params, cfg, {"tokens": toks})
    # bf16 activations: the two attention outputs round apart and the
    # difference carries through the layers (the CPU parity tests' bf16
    # tolerance); the first layer's cache precedes any attention: equal
    torch.testing.assert_close(logits, want, atol=0.15, rtol=0)
    assert torch.equal(cache["block_0"]["k"][0], want_cache["block_0"]["k"][0])


@pytest.mark.parametrize("dtype,hq,hkv,sq,sk,d,causal,window", [
    (torch.bfloat16, 32, 8, 256, 256, 128, True, None),   # qwen3-4b heads
    (torch.float32, 32, 8, 256, 256, 128, True, None),
    (torch.bfloat16, 8, 2, 77, 1000, 64, False, None),    # Sq != Sk, D 64
    (torch.bfloat16, 8, 2, 300, 300, 128, True, 64),      # window, ragged S
    (torch.bfloat16, 8, 4, 130, 130, 256, True, None),    # D 256
    (torch.float32, 4, 2, 40, 40, 16, True, None),        # D 16
    (torch.float32, 4, 2, 40, 8, 64, True, 4),            # rows that see no key
    (torch.bfloat16, 4, 2, 100, 8, 128, True, 4),         # the same on the tensor cores
])
@pytest.mark.parametrize("variant", ["auto", "cuda_core"])
def test_flash_backward_kernel_matches_plain_version(card, variant, dtype, hq, hkv, sq, sk, d,
                                                     causal, window):
    """The backward kernels against ``flash_attention_bwd_plain`` on the same
    (q, k, v, o, do), in the variant ``bwd_variant`` picks (tensor cores for
    bf16 at D 64 and 128) and forced onto the CUDA cores: max |err| within
    1e-4 (float32) or 2e-2 (bf16) of the largest reference element, one
    counted launch a call, the same bits every launch."""
    from repro_torch.kernels import flash_attention_bwd as fab

    q, k, v = _qkv(card, dtype, 2, hq, hkv, sq, sk, d, seed=5)
    do = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(6),
                     device=card).to(dtype)
    kw = dict(causal=causal, window=window)
    o = tops.flash_attention(q, k, v, **kw)
    before = fab.LAUNCHES["flash_attention_bwd"]
    got = fab.flash_attention_bwd_cuda(q, k, v, o, do, variant=variant, **kw)
    again = fab.flash_attention_bwd_cuda(q, k, v, o, do, variant=variant, **kw)
    assert fab.LAUNCHES["flash_attention_bwd"] == before + 2
    want = fab.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, a)
        assert float((g.float() - w.float()).abs().max()) <= rel * float(w.float().abs().max())


# the bf16 cases of chip_smoke.py's phase 19 that take the wgmma backward:
# (b, hq, hkv, sq, sk, d, causal, window)
WGMMA_BWD_CASES = {
    "qwen3-4b": (2, 32, 8, 2048, 2048, 128, True, None),
    "D 64 non-causal Sq 77 Sk 1,000": (2, 8, 2, 77, 1000, 64, False, None),
    "window 64 ragged S 500": (2, 8, 2, 500, 500, 128, True, 64),
    "rows that see no key": (1, 4, 2, 100, 8, 128, True, 4),
}


def _views(card, b, hq, hkv, sq, sk, d, seed):
    """bf16 q, k, v and do as the (b, s, h, d) tensors attend_full projects,
    seen as (b, h, s, d)."""
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g, device=card).to(torch.bfloat16).transpose(1, 2)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk), (hq, sq))]


@pytest.mark.parametrize("case", list(WGMMA_BWD_CASES), ids=list(WGMMA_BWD_CASES))
def test_wgmma_backward_on_views_matches_plain_version(card, case):
    """The wgmma backward, given the wgmma forward's saved logsumexp, on the
    (b, s, h, d) views: within 2e-2 of the largest element of
    ``flash_attention_bwd_plain``'s gradient, two launches the same bits,
    the gradients in their operands' layout, no memory requested beyond the
    outputs and the (B, Hq, Sq rounded up to 128) float32 scratch (no
    operand copied), a zero gradient for a row that sees no key; without
    the logsumexp the same bits; and the CUDA-core variant runs on the same
    input within the same tolerance."""
    from repro_torch.kernels import flash_attention_bwd as fab

    b, hq, hkv, sq, sk, d, causal, window = WGMMA_BWD_CASES[case]
    q, k, v, do = _views(card, b, hq, hkv, sq, sk, d, seed=11)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_wgmma(q, k, v, with_lse=True, **kw)
    requested = lambda: torch.cuda.memory_stats()["requested_bytes.all.allocated"]  # noqa: E731
    base = requested()
    got = fab.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    sq_pad = -(-sq // fab.SQ_ALIGN) * fab.SQ_ALIGN
    assert requested() - base == sum(g.numel() * 2 for g in got) + 2 * b * hq * sq_pad * 4
    again = fab.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    unsaved = fab.flash_attention_bwd_cuda(q, k, v, o, do, **kw)
    core = fab.flash_attention_bwd_cuda(q, k, v, o, do, variant="cuda_core", **kw)
    want = fab.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    for g, a, u, c, w, x in zip(got, again, unsaved, core, want, (q, k, v)):
        assert g.stride() == x.stride() and torch.equal(g, a) and torch.equal(g, u)
        ref = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2e-2 * ref
        assert float((c.float() - w.float()).abs().max()) <= 2e-2 * ref
    if case == "rows that see no key":
        blind = torch.arange(sq, device=card) - window + 1 >= sk
        assert blind.any() and (got[0][:, :, blind] == 0).all()


def test_wgmma_forward_saves_the_logsumexp(card):
    """``with_lse``: the same output bits, and each row's logsumexp as
    ``flash_attention.logsumexp`` computes it (+inf for a row that sees no
    key) within float32 rounding of sums in another order."""
    for b, hq, hkv, sq, sk, d, causal, window in WGMMA_BWD_CASES.values():
        q, k, v, _ = _views(card, b, hq, hkv, sq, sk, d, seed=12)
        before = fa.LAUNCHES["flash_attention_wgmma"]
        out, lse = fa.flash_attention_wgmma(q, k, v, causal=causal, window=window, with_lse=True)
        plain_out = fa.flash_attention_wgmma(q, k, v, causal=causal, window=window)
        assert fa.LAUNCHES["flash_attention_wgmma"] == before + 2
        assert torch.equal(out, plain_out) and lse.shape == (b, hq, sq)
        want = fa.logsumexp(q, k, causal=causal, window=window)
        assert torch.equal(torch.isinf(lse), torch.isinf(want)) and (lse[torch.isinf(lse)] > 0).all()
        finite = torch.isfinite(want)
        torch.testing.assert_close(lse[finite], want[finite], atol=1e-4, rtol=1e-5)


def test_flash_gradient_through_the_kernels(card):
    """Autograd through ``flash_attention`` on the (b, s, h, d) views the
    model passes: one forward and one backward launch, the gradient of the
    plain version's."""
    from repro_torch.kernels import flash_attention_bwd as fab

    g = torch.Generator(device=card).manual_seed(2)
    base = [torch.randn((2, 200, h, 128), generator=g, device=card).to(torch.bfloat16)
            for h in (16, 4, 4)]
    do = torch.randn((2, 16, 200, 128), generator=g, device=card).to(torch.bfloat16)
    grads = {}
    for plain in (False, True):
        leaves = [x.clone().requires_grad_() for x in base]
        before = (fa.LAUNCHES["flash_attention_wgmma"], fab.LAUNCHES["flash_attention_bwd"])
        with fa.plain_version() if plain else contextlib.nullcontext():
            out = tops.flash_attention(*(x.transpose(1, 2) for x in leaves), causal=True)
            grads[plain] = torch.autograd.grad(out, leaves, do)
        launched = (fa.LAUNCHES["flash_attention_wgmma"] - before[0],
                    fab.LAUNCHES["flash_attention_bwd"] - before[1])
        assert launched == ((0, 0) if plain else (1, 1))
    for a, b in zip(grads[False], grads[True]):
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(b.float().abs().max())


def test_train_step_on_card_matches_cpu(card):
    """Reduced qwen3-4b in float32 compute: two AdamW steps on the card
    against the CPU (parameters at 2 lr_t, tests/test_torch_train.py's
    reason), through the CUDA-core forward and the backward kernels."""
    import dataclasses

    from repro_torch.train import optim as topt
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              compute_dtype="float32").canonicalize(tp=1)
    master = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 33), generator=torch.Generator().manual_seed(1))
    out = {}
    for where in ("cpu", card):
        params = topt.tree_map(lambda p: p.to(where, copy=True), master)
        state = topt.init_opt_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        for t in toks.to(where):
            params, state, m = step(params, state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
        out[where] = (float(m["loss"]), float(m["lr"]), topt.tree_items(params))
    assert out[card][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    for (path, a), (_, b) in zip(out["cpu"][2], out[card][2]):
        torch.testing.assert_close(b.cpu(), a, atol=2 * out["cpu"][1], rtol=1e-5, msg=path)
