"""Check cases for the DC scan kernel on the card.

``CASES`` covers every instantiation of ``csrc/dc_pairs.cu`` (one to four
atoms, and the generic path up to 8 atoms over 16 distinct columns), every
column dtype, NaN, signed zeros, infinities, integer extremes and int32
values above 2**24 in a float atom, blocks 1, 64, 100, 256 and 1,024, a col
list that the chunking does not divide evenly, a one-row-block strip and
sparse worklists.  ``check_case`` runs one case through the kernel and
through the plain version and holds them bit for bit; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run every case, for the pair and the role scan.
``timing_inputs`` is the timing case both of them use.

``SHARDED_CASES`` holds the sharded launch (``dc_pair_scan_sharded``, one
launch over every logical shard of sharded detection) on routed layouts:
2, 4, 16 shards, a shard with no row, ``hi`` below a shard's block count,
int32 and float32 atoms, the generic path and a ragged block;
``check_sharded_case`` holds the launch bit for bit against
``dc_pair_scan_sharded_plain`` and ``sharded_timing_inputs`` is the 16-shard
routing of a 131,072-row table.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import dc_pairs

T1_REDUCE = {"<": "max", "<=": "max", ">": "min", ">=": "min", "==": "min", "!=": "min"}
FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
F32, BF16 = torch.float32, torch.bfloat16
I8, I16, I32 = torch.int8, torch.int16, torch.int32
SPECIAL_F = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.0, -1.0, 2.5],
                     np.float32)
SPECIAL_I = np.array([-(2**31), 2**31 - 1, 2**24 + 1, 2**24, -(2**24) - 1, 0, -1, 127, -128,
                      32767, -32768], np.int64)
TIMING_ROWS = 131_072


class Case(NamedTuple):
    name: str
    l_dtypes: tuple
    r_dtypes: Optional[tuple]  # None: the same columns on both sides
    ops: tuple
    n: int
    block: int = 256
    values: str = "small"  # "small", "special" or "wide"
    scope: float = 0.8  # share of rows in each scope
    restrict: Optional[Callable] = None  # nb, rng -> worklist keyword arguments
    chunks: Optional[int] = None  # col chunks the launch is given (default: fill the card)
    # n, block, rng -> (row scope, col scope, worklist keyword arguments) as
    # numpy; rows at or past ``valid`` hold the pad values (None: none)
    layout: Optional[Callable] = None
    valid: Optional[int] = None


def _sparse(nb, rng):
    return dict(row_block_ids=np.flatnonzero(rng.random(nb) < 0.3).astype(np.int32),
                col_block_ids=np.flatnonzero(rng.random(nb) < 0.5).astype(np.int32))


def _ingest_delta(old, new):
    """An append of rows [old, old + new): the checked old rows (most of
    them) x the fresh rows, over the fresh rows' col-block range."""
    def layout(n, block, rng):
        pos = np.arange(n)
        rs = (pos < old) & (rng.random(n) < 0.9)
        cs = (pos >= old) & (pos < old + new)
        rid = np.unique(np.flatnonzero(rs) // block).astype(np.int32)
        return rs, cs, dict(row_block_ids=rid,
                            col_blocks=(old // block, -(-(old + new) // block)))
    return layout


def _one_partial_col_block(start, valid):
    """One col block alone, in scope from ``start`` (mid-block) to the end
    of the valid prefix; every valid row scanned against it."""
    def layout(n, block, rng):
        pos = np.arange(n)
        return pos < valid, (pos >= start) & (pos < valid), dict(
            col_blocks=(start // block, start // block + 1))
    return layout


def _strips(count, valid):
    """``count`` one-block strips of valid rows x every col block of the
    grid, pad blocks included (a background strip increment)."""
    def layout(n, block, rng):
        pos = np.arange(n)
        rid = np.sort(rng.choice(-(-valid // block), count, replace=False)).astype(np.int32)
        in_strip = np.isin(pos // block, rid)
        return in_strip & (pos < valid), pos < valid, dict(row_block_ids=rid)
    return layout


# a grid that has just doubled: 32,768 rows of capacity, 17,384 valid
GROWN, GROWN_VALID = 32_768, 17_384

CASES: List[Case] = [
    Case("1 atom f32 <", (F32,), None, ("<",), 20_000),
    Case("2 atoms f32 <,>", (F32, F32), None, ("<", ">"), 20_000),
    Case("3 atoms int32/int16/int8 <=,!=,>", (I32, I16, I8), (I8, I32, I32),
         ("<=", "!=", ">"), 20_000),
    Case("4 atoms bf16/f32 ==,!=,>=,<=", (BF16, F32, BF16, F32), (F32, BF16, F32, BF16),
         ("==", "!=", ">=", "<="), 20_000),
    Case("5 atoms (generic)", (I32, F32, I16, BF16, I8), None, ("<", ">", "!=", "<=", ">="),
         8_000),
    Case("8 atoms over 16 columns (generic)", (F32, I32, BF16, I8) * 2, (I16, F32, I32, BF16) * 2,
         ("<", "<=", ">", ">=", "!=", "<", "!=", ">="), 6_000),
    Case("mixed int32/f32 <= above 2**24 (generic)", (I32,), (F32,), ("<=",), 6_000,
         values="wide"),
    Case("NaN, signed zeros, infinities !=,<", (F32, F32), None, ("!=", "<"), 3_000, block=128,
         values="special"),
    Case("NaN, signed zeros bf16 ==,>=", (BF16, BF16), None, ("==", ">="), 3_000, block=128,
         values="special"),
    Case("int extremes int32 <,>=", (I32, I32), None, ("<", ">="), 3_000, values="special"),
    Case("int8/int16 extremes !=,<=", (I8, I16), None, ("!=", "<="), 3_000, values="special"),
    Case("block 1", (I32,), None, ("<",), 300, block=1),
    Case("block 64 ragged", (F32, I32), None, ("<", "!="), 1_000, block=64),
    Case("block 100", (F32, F32), None, ("<=", ">="), 1_234, block=100),
    Case("block 1024", (F32, F32), None, ("<", ">"), 5_000, block=1024),
    Case("7 chunks over 50 col blocks", (F32, F32), None, ("<", ">"), 50 * 256, chunks=7),
    Case("one-row-block strip", (F32, F32), None, ("<", ">"), 65_536, scope=1.0,
         restrict=lambda nb, rng: dict(row_blocks=(100, 101))),
    Case("sparse worklist, partial scopes", (F32, F32), None, ("<", ">"), 40_000, scope=0.7,
         restrict=_sparse),
    Case("ingest delta off a block boundary, int32/f32 <,>", (I32, F32), None, ("<", ">"),
         16_384, layout=_ingest_delta(8_000, 1_024), valid=9_024),
    Case("ingest delta of a grown grid, f32 <,>", (F32, F32), None, ("<", ">"), GROWN,
         layout=_ingest_delta(GROWN_VALID - 1_000, 1_000), valid=GROWN_VALID),
    Case("one partly fresh col block", (I32, F32), None, ("<", ">"), 16_384,
         layout=_one_partial_col_block(8_000, 8_100), valid=8_100),
    Case("1 strip x a grown grid", (I32, F32), None, ("<", ">"), GROWN,
         layout=_strips(1, GROWN_VALID), valid=GROWN_VALID),
    Case("2 strips x a grown grid", (F32, F32), None, ("<=", ">="), GROWN,
         layout=_strips(2, GROWN_VALID), valid=GROWN_VALID),
    Case("16 strips x a grown grid", (I32, F32), None, ("<", ">"), GROWN,
         layout=_strips(16, GROWN_VALID), valid=GROWN_VALID),
]


def _column(rng, dtype, n, values):
    if values == "special":
        pool = SPECIAL_F if dtype.is_floating_point else SPECIAL_I
        if not dtype.is_floating_point:
            info = torch.iinfo(dtype)
            pool = pool[(pool >= info.min) & (pool <= info.max)]
        mixed = np.where(rng.random(n) < 0.5, rng.choice(pool, n), rng.integers(-3, 4, n))
        return torch.from_numpy(mixed.astype(np.float32 if dtype.is_floating_point
                                              else np.int64)).to(dtype)
    if values == "wide":  # int32 values that float32 rounds, and floats near them
        base = rng.integers(2**24 - 40, 2**24 + 40, n)
        if dtype.is_floating_point:
            return torch.from_numpy(base.astype(np.float32))
        return torch.from_numpy(base).to(dtype)
    if dtype.is_floating_point:
        return torch.from_numpy(rng.integers(-200, 200, n).astype(np.float32) / 4).to(dtype)
    return torch.from_numpy(rng.integers(-50, 50, n)).to(dtype)


def case_inputs(case: Case, dev, seed: int = 0) -> dict:
    """The case's columns, scopes and worklist on ``dev``, from a seed."""
    rng = np.random.default_rng(seed)
    n = case.n
    l_cols = [_column(rng, d, n, case.values).to(dev) for d in case.l_dtypes]
    r_cols = (list(l_cols) if case.r_dtypes is None
              else [_column(rng, d, n, case.values).to(dev) for d in case.r_dtypes])
    nb = -(-n // case.block)
    if case.valid is not None:  # the pad values of a relation's spare rows
        for c in {id(c): c for c in l_cols + r_cols}.values():
            c[case.valid:] = float("nan") if c.dtype.is_floating_point else torch.iinfo(c.dtype).max
    if case.layout is not None:
        rs, cs, restrict = case.layout(n, case.block, rng)
        rs, cs = torch.from_numpy(rs).to(dev), torch.from_numpy(cs).to(dev)
    else:
        rs = torch.from_numpy(rng.random(n) < case.scope).to(dev)
        cs = torch.from_numpy(rng.random(n) < case.scope).to(dev)
        restrict = case.restrict(nb, rng) if case.restrict else {}
    from repro_torch.kernels.dc_pairs import resolve_block_ids

    rid = resolve_block_ids(nb, restrict.get("row_blocks"), restrict.get("row_block_ids"))
    cid = resolve_block_ids(nb, restrict.get("col_blocks"), restrict.get("col_block_ids"))
    return dict(l_cols=l_cols, r_cols=r_cols, ops=list(case.ops), rs=rs, cs=cs,
                block=case.block, rid=rid, cid=cid)


def scan(inp: dict, both: bool, chunks: Optional[int] = None):
    """The pair scan (``both``) or the role scan on a case's inputs, as a
    flat tuple of tensors: counts, then stats, role by role.  ``chunks``
    launches the kernel itself over that many col chunks."""
    ops = inp["ops"]
    if both:
        flipped = [FLIP[o] for o in ops]
        red1, red2 = [T1_REDUCE[o] for o in ops], [T1_REDUCE[o] for o in flipped]
    else:  # the role scan takes any reduces: alternate them
        flipped, red1, red2 = None, [("max", "min")[i % 2] for i in range(len(ops))], None
    l_cols, r_cols, rs, cs = inp["l_cols"], inp["r_cols"], inp["rs"], inp["cs"]
    where = (inp["block"], inp["rid"], inp["cid"])
    if chunks:
        out = dc_pairs._scan_cuda(l_cols, r_cols, ops, flipped, rs, cs, red1, red2, *where,
                                  chunks=chunks)
    elif both:
        out = dc_pairs.dc_pair_scan(l_cols, r_cols, ops, flipped, rs, cs, red1, red2, *where)
    else:
        out = dc_pairs.dc_role_scan(l_cols, r_cols, ops, rs, cs, red1, *where)
    flat = []
    for part in out:
        flat.extend(part if isinstance(part, (list, tuple)) else [part])
    return tuple(flat)


def bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def same_bits(got, want) -> Optional[str]:
    """None when two flat scan outputs are identical, else what differs."""
    if len(got) != len(want):
        return f"{len(got)} outputs against {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            return f"output {i}: {g.dtype}{tuple(g.shape)} != {w.dtype}{tuple(w.shape)}"
        if not torch.equal(bits(g), bits(w)):
            bad = int((bits(g) != bits(w)).sum())
            return f"output {i} ({g.dtype}): {bad} elements differ"
    return None


def check_case(case: Case, dev, both: bool):
    """Run ``case`` through the kernel and the plain version; returns
    ``(error or None, kernel output, plain output)``."""
    inp = case_inputs(case, dev)
    got = scan(inp, both, chunks=case.chunks)
    with dc_pairs.plain_version():
        want = scan(inp, both)
    torch.cuda.synchronize()
    return same_bits(got, want), got, want


def timing_inputs(dev) -> dict:
    """fig12's price/discount DC at n = 131,072 on the full worklist: prices
    uniform in [1000, 5000], discounts falling with price plus noise, so
    the block bounds prune almost nothing and about half the pairs
    violate."""
    rng = np.random.default_rng(0)
    n = TIMING_ROWS
    price = rng.uniform(1000, 5000, n).astype(np.float32)
    disc = (0.5 - (price - 1000) / 8000 + rng.normal(0, 0.02, n)).astype(np.float32)
    cols = [torch.from_numpy(price).to(dev), torch.from_numpy(disc).to(dev)]
    full = torch.ones(n, dtype=torch.bool, device=dev)
    nb = n // 256
    ids = np.arange(nb, dtype=np.int32)
    return dict(l_cols=cols, r_cols=cols, ops=["<", ">"], rs=full, cs=full, block=256,
                rid=ids, cid=ids)


# ------------------------------------------------------------ sharded cases
class ShardedCase(NamedTuple):
    name: str
    dtypes: tuple  # atom column dtypes (the same columns on both sides)
    ops: tuple
    n_shards: int
    cap: int  # slots a shard
    block: int = 256
    # slots a shard holds rows in (a prefix, as the shuffle compacts them),
    # as shares of ``cap``; a shard with 0 holds no row
    occupancy: tuple = (0.5,)


SHARDED_CASES: List[ShardedCase] = [
    ShardedCase("2 shards, int32 == and f32 <,>", (I32, F32, F32), ("==", "<", ">"), 2, 3_000,
                occupancy=(0.9, 0.6)),
    ShardedCase("4 shards, hi below the shard's blocks, f32 <,>", (F32, F32), ("<", ">"), 4,
                4_096, occupancy=(0.3, 0.2, 0.35, 0.1)),
    ShardedCase("16 shards, one with no row, int32 <=,!=", (I32, I32), ("<=", "!="), 16, 2_048,
                occupancy=(0.5, 0.0) + (0.45,) * 14),
    ShardedCase("3 shards, block 100, ragged slots", (F32, I32), ("<", ">="), 3, 1_234,
                block=100, occupancy=(1.0, 0.7, 0.2)),
    ShardedCase("4 shards, 5 atoms (generic)", (I32, F32, I16, F32, I32),
                ("==", "<", "!=", ">", "<="), 4, 1_500, occupancy=(0.5, 0.6, 0.4, 0.5)),
    ShardedCase("16 shards of a 131,072-row routing, int32 == and f32 <,>", (I32, F32, F32),
                ("==", "<", ">"), 16, 16_384, occupancy=(0.5,) * 16),
]


def sharded_case_inputs(case: ShardedCase, dev, seed: int = 0) -> dict:
    """A routed layout on ``dev``: ``(n_shards, cap)`` columns whose rows
    fill each shard's slot prefix (zeros past it), scopes inside the
    prefix, and ``hi`` from the fullest shard."""
    rng = np.random.default_rng(seed)
    shape = (case.n_shards, case.cap)
    occ = (list(case.occupancy) * case.n_shards)[: case.n_shards]
    rows = [int(o * case.cap) for o in occ]
    filled = np.arange(case.cap)[None, :] < np.asarray(rows)[:, None]
    cols = []
    for d in case.dtypes:
        c = _column(rng, d, case.n_shards * case.cap, "small").reshape(shape)
        cols.append((c * torch.from_numpy(filled).to(c.dtype)).to(dev))
    rs = torch.from_numpy(filled & (rng.random(shape) < 0.9)).to(dev)
    cs = torch.from_numpy(filled & (rng.random(shape) < 0.8)).to(dev)
    nb_local = -(-case.cap // case.block)
    hi = min(nb_local, max(-(-max(rows) // case.block), 1))
    return dict(l_cols=cols, r_cols=cols, ops=list(case.ops), rs=rs, cs=cs,
                block=case.block, hi=hi)


def sharded_scan(inp: dict, chunks: Optional[int] = None):
    """The sharded pair scan on a case's inputs as a flat tuple (counts, then
    stats, role by role); ``chunks`` launches the kernel itself over that
    many col chunks."""
    ops = inp["ops"]
    flipped = [FLIP[o] for o in ops]
    red1, red2 = [T1_REDUCE[o] for o in ops], [T1_REDUCE[o] for o in flipped]
    args = (inp["l_cols"], inp["r_cols"], ops, flipped, inp["rs"], inp["cs"], red1, red2,
            inp["block"], inp["hi"])
    if chunks:
        out = dc_pairs._sharded_cuda(*args, chunks=chunks)
    else:
        out = dc_pairs.dc_pair_scan_sharded(*args)
    t1c, t1s, t2c, t2s = out
    return (t1c, *t1s, t2c, *t2s)


def check_sharded_case(case: ShardedCase, dev):
    """Run ``case`` through the sharded launch and through its plain version;
    returns ``(error or None, kernel output, plain output)``."""
    inp = sharded_case_inputs(case, dev)
    got = sharded_scan(inp)
    with dc_pairs.plain_version():
        want = sharded_scan(inp)
    torch.cuda.synchronize()
    return same_bits(got, want), got, want


def sharded_timing_inputs(dev) -> dict:
    """The last sharded case: 16 shards of 16,384 slots, half full."""
    return sharded_case_inputs(SHARDED_CASES[-1], dev)
