"""Columnar, fixed-capacity, probabilistic relation (PyTorch).

The counterpart of ``repro.core.relation``: the same columns, overlay and
provenance, held as a dataclass of torch tensors instead of a pytree.

* columns are dense ``int32``/``float32`` tensors of a fixed ``capacity``
  with a validity mask; spare rows hold ``SENTINEL`` (ints) or NaN (floats);
* string attributes are dictionary-encoded to ``int32`` codes host-side
  (``Dictionary``);
* attribute-level uncertainty is a dense overlay: up to ``K`` candidate
  values per cell with float32 *counts* and int8 *kinds*
  (``CAND_VALUE`` / ``CAND_LT`` / ``CAND_GT``);
* ``orig`` keeps the pre-cleaning values, ``checked`` the per-rule bits.

Every tensor of a relation lives on one device.  ``make_relation`` takes
that device and defaults to ``"cuda"``; it raises when CUDA is missing
rather than quietly building the relation on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# Sentinel pushed to the end of sorts; also the "invalid" key.
SENTINEL = np.int32(2**31 - 1)

# Candidate kinds (attribute-level uncertainty cells).
CAND_VALUE = 0  # candidate is a concrete value
CAND_LT = 1  # candidate is the open range (-inf, bound)
CAND_GT = 2  # candidate is the open range (bound, +inf)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) must be available: there is no silent move to the CPU —
    the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


class Dictionary:
    """Host-side string dictionary (string -> int32 code)."""

    def __init__(self, values: Optional[Sequence[str]] = None):
        self._to_code: Dict[str, int] = {}
        self._to_str: List[str] = []
        if values is not None:
            for v in values:
                self.encode(v)

    def encode(self, value: str) -> int:
        code = self._to_code.get(value)
        if code is None:
            code = len(self._to_str)
            self._to_code[value] = code
            self._to_str.append(value)
        return code

    def encode_many(self, values: Sequence[str]) -> np.ndarray:
        return np.asarray([self.encode(v) for v in values], dtype=np.int32)

    def decode(self, code: int) -> str:
        return self._to_str[int(code)]

    def __len__(self) -> int:
        return len(self._to_str)


@dataclasses.dataclass
class Relation:
    """Fixed-capacity columnar relation with a probabilistic overlay.

    columns:   name -> (cap,) primary value per cell.
    valid:     (cap,) bool row validity.
    cand:      name -> (cap, K) candidate values        (overlay attrs only)
    ccount:    name -> (cap, K) float32 candidate counts (0 == empty slot)
    ckind:     name -> (cap, K) int8 candidate kinds (CAND_VALUE/LT/GT)
    orig:      name -> (cap,) provenance: the pre-cleaning original value
    checked:   rule name -> (cap,) bool "tuple checked for this rule"
    """

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor
    cand: Dict[str, torch.Tensor]
    ccount: Dict[str, torch.Tensor]
    ckind: Dict[str, torch.Tensor]
    orig: Dict[str, torch.Tensor]
    checked: Dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def k(self) -> int:
        for v in self.cand.values():
            return int(v.shape[1])
        return 0

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    def num_rows(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def probs(self, name: str) -> torch.Tensor:
        """(cap, K) candidate probabilities (counts normalized per row)."""
        c = self.ccount[name]
        tot = c.sum(dim=1, keepdim=True)
        return torch.where(tot > 0, c / torch.clamp(tot, min=1e-30), 0.0)

    def is_uncertain(self, name: str) -> torch.Tensor:
        """(cap,) bool — cell has >= 2 candidates."""
        return (self.ccount[name] > 0).sum(dim=1) >= 2

    def candidate_matches(self, name: str, op: str, value) -> torch.Tensor:
        """Possible-world predicate: (cap,) bool — does ANY candidate of
        ``name`` satisfy ``op value``?  Range candidates (CAND_LT/CAND_GT)
        qualify when the candidate range overlaps the predicate's set."""
        if name not in self.cand:
            return _apply_op(self.columns[name], op, value)
        cv = self.cand[name]
        ck = self.ckind[name]
        alive = self.ccount[name] > 0
        val_ok = _apply_op(cv, op, value)
        lt_ok = _range_lt_overlaps(cv, op, value)  # candidate == (-inf, cv)
        gt_ok = _range_gt_overlaps(cv, op, value)  # candidate == (cv, +inf)
        ok = torch.where(
            ck == CAND_LT, lt_ok, torch.where(ck == CAND_GT, gt_ok, val_ok)
        )
        any_ok = (ok & alive).any(dim=1)
        no_cand = ~alive.any(dim=1)
        base_ok = _apply_op(self.columns[name], op, value)
        return torch.where(no_cand, base_ok, any_ok)


def _apply_op(x: torch.Tensor, op: str, value) -> torch.Tensor:
    if op == "==":
        return x == value
    if op == "!=":
        return x != value
    if op == "<":
        return x < value
    if op == "<=":
        return x <= value
    if op == ">":
        return x > value
    if op == ">=":
        return x >= value
    raise ValueError(f"unknown op {op!r}")


def _range_lt_overlaps(bound: torch.Tensor, op: str, value) -> torch.Tensor:
    """Does the candidate range (-inf, bound) intersect {x : x op value}?"""
    if op == "==":
        return bound > value
    if op in ("!=", "<", "<="):
        return torch.ones_like(bound, dtype=torch.bool)
    if op in (">", ">="):
        return bound > value
    raise ValueError(op)


def _range_gt_overlaps(bound: torch.Tensor, op: str, value) -> torch.Tensor:
    """Does the candidate range (bound, +inf) intersect {x : x op value}?"""
    if op == "==":
        return bound < value
    if op in ("!=", ">", ">="):
        return torch.ones_like(bound, dtype=torch.bool)
    if op in ("<", "<="):
        return bound < value
    raise ValueError(op)


def make_relation(
    data: Mapping[str, np.ndarray],
    capacity: Optional[int] = None,
    overlay: Sequence[str] = (),
    k: int = 8,
    rules: Sequence[str] = (),
    device="cuda",
) -> Relation:
    """Build a Relation from host numpy columns on ``device``.

    Integer columns become int32 padded with ``SENTINEL``, everything else
    float32 padded with NaN.  ``overlay`` lists attributes that may become
    probabilistic; ``rules`` pre-registers per-rule checked flags."""
    dev = resolve_device(device)
    names = list(data)
    if not names:
        raise ValueError("empty relation")
    n = len(np.asarray(data[names[0]]))
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < rows {n}")

    columns = {}
    for name in names:
        arr = np.asarray(data[name])
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
            pad_val = SENTINEL
        else:
            arr = arr.astype(np.float32)
            pad_val = np.float32(np.nan)
        out = np.full((cap,), pad_val, dtype=arr.dtype)
        out[:n] = arr
        columns[name] = torch.from_numpy(out).to(dev)

    valid = torch.arange(cap, device=dev) < n
    cand, ccount, ckind, orig = {}, {}, {}, {}
    for name in overlay:
        col = columns[name]
        cv = torch.zeros((cap, k), dtype=col.dtype, device=dev)
        cv[:, 0] = col
        cand[name] = cv
        # count 0 everywhere -> "no overlay yet"
        ccount[name] = torch.zeros((cap, k), dtype=torch.float32, device=dev)
        ckind[name] = torch.zeros((cap, k), dtype=torch.int8, device=dev)
        orig[name] = col
    checked = {r: torch.zeros((cap,), dtype=torch.bool, device=dev) for r in rules}
    return Relation(columns, valid, cand, ccount, ckind, orig, checked)


def masked_keys(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace masked-out entries with the sort sentinel (+inf for floats)."""
    if values.dtype == torch.float32:
        return torch.where(mask, values, float("inf"))
    return torch.where(mask, values, int(SENTINEL))

