"""Synthetic dataset generators (the port's own copy of
``repro.data.generators``; numpy only, so both packages draw the same data
from the same seed).

* ``ssb_lineorder``: Star-Schema-Benchmark-style lineorder with a
  configurable orderkey/suppkey cardinality and FD orderkey -> suppkey.
* ``suppliers``: the supplier dimension table for join workloads
  (FD address -> suppkey).
* ``inject_fd_errors``: BART-style error injection — edits a fraction of
  rhs values per lhs group, returning ground truth.
* ``inject_dc_errors``: perturbs values to create inequality-DC violating
  pairs at a requested rate.
* ``hospital_like``: FD zip -> city and zip -> state over a hospital-style
  table with a known clean version (the query service's workload).
* ``token_metadata_relation``: a training corpus's document metadata with
  FD source -> language (the training data pipeline's cleaning target).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DirtyDataset:
    data: Dict[str, np.ndarray]  # dirty columns
    truth: Dict[str, np.ndarray]  # clean ground truth
    error_rows: np.ndarray  # bool mask of edited rows


def ssb_lineorder(
    n: int,
    n_orderkeys: int,
    n_suppkeys: int,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Clean lineorder: suppkey is a function of orderkey (FD holds)."""
    rng = np.random.default_rng(seed)
    order_of_row = rng.integers(0, n_orderkeys, n).astype(np.int32)
    supp_of_order = rng.integers(0, n_suppkeys, n_orderkeys).astype(np.int32)
    return {
        "orderkey": order_of_row,
        "suppkey": supp_of_order[order_of_row],
        "extended_price": rng.uniform(1000, 5000, n).astype(np.float32),
        "discount": rng.uniform(0.0, 0.5, n).astype(np.float32),
        "quantity": rng.integers(1, 50, n).astype(np.int32),
    }


def suppliers(n_suppkeys: int, seed: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    addr = rng.permutation(n_suppkeys).astype(np.int32)  # address -> suppkey
    return {
        "suppkey": np.arange(n_suppkeys, dtype=np.int32),
        "address": addr,
        "region": rng.integers(0, 5, n_suppkeys).astype(np.int32),
    }


def inject_fd_errors(
    data: Dict[str, np.ndarray],
    lhs: str,
    rhs: str,
    frac_groups: float = 1.0,
    frac_rows: float = 0.1,
    n_values: Optional[int] = None,
    seed: int = 2,
) -> DirtyDataset:
    """Edit ``frac_rows`` of the rhs values inside ``frac_groups`` of the lhs
    groups (the paper: "randomly editing 10% of the suppliers that
    correspond to each orderkey"), uniform across the dataset."""
    rng = np.random.default_rng(seed)
    truth = {k: v.copy() for k, v in data.items()}
    dirty = {k: v.copy() for k, v in data.items()}
    values = dirty[rhs]
    n_vals = n_values or (int(values.max()) + 1)
    keys = dirty[lhs]
    uniq = np.unique(keys)
    chosen = rng.random(len(uniq)) < frac_groups
    dirty_groups = set(uniq[chosen].tolist())
    in_dirty_group = np.isin(keys, list(dirty_groups))
    edit = in_dirty_group & (rng.random(len(keys)) < frac_rows)
    # edited value: a different random rhs value
    noise = rng.integers(1, max(n_vals, 2), edit.sum()).astype(values.dtype)
    values[edit] = (values[edit] + noise) % n_vals
    dirty[rhs] = values
    return DirtyDataset(dirty, truth, edit)


def inject_dc_errors(
    data: Dict[str, np.ndarray],
    attr: str = "discount",
    frac_rows: float = 0.1,
    magnitude: float = 0.5,
    seed: int = 3,
) -> DirtyDataset:
    """Perturb ``attr`` upward on a row fraction so (price<, discount>)
    inversions appear (the paper's Fig. 12 setup)."""
    rng = np.random.default_rng(seed)
    truth = {k: v.copy() for k, v in data.items()}
    dirty = {k: v.copy() for k, v in data.items()}
    edit = rng.random(len(dirty[attr])) < frac_rows
    dirty[attr] = dirty[attr].copy()
    dirty[attr][edit] = dirty[attr][edit] + magnitude
    return DirtyDataset(dirty, truth, edit)


def hospital_like(n: int, error_frac: float = 0.05, seed: int = 4) -> DirtyDataset:
    """FD zip -> city / county-style dataset with a known clean version."""
    rng = np.random.default_rng(seed)
    n_zip = max(n // 20, 4)
    zipc = rng.integers(0, n_zip, n).astype(np.int32)
    city_of_zip = rng.integers(0, max(n_zip // 2, 2), n_zip).astype(np.int32)
    state_of_zip = rng.integers(0, 50, n_zip).astype(np.int32)
    data = {
        "zip": zipc,
        "city": city_of_zip[zipc],
        "state": state_of_zip[zipc],
        "beds": rng.integers(10, 500, n).astype(np.int32),
    }
    ds = inject_fd_errors(data, "zip", "city", 1.0, error_frac, seed=seed + 1)
    ds2 = inject_fd_errors(ds.data, "zip", "state", 1.0, error_frac, seed=seed + 2)
    return DirtyDataset(ds2.data, ds.truth, ds.error_rows | ds2.error_rows)


def token_metadata_relation(
    n_docs: int,
    n_sources: int = 64,
    error_frac: float = 0.1,
    seed: int = 5,
) -> DirtyDataset:
    """Training-corpus metadata: doc -> (source, language, quality_score).
    FD source -> language is the cleaning target of the data pipeline
    (a mislabeled language corrupts sampling filters)."""
    rng = np.random.default_rng(seed)
    source = rng.integers(0, n_sources, n_docs).astype(np.int32)
    lang_of_source = rng.integers(0, 16, n_sources).astype(np.int32)
    data = {
        "doc_id": np.arange(n_docs, dtype=np.int32),
        "source": source,
        "language": lang_of_source[source],
        "quality": rng.uniform(0, 1, n_docs).astype(np.float32),
        "length": rng.integers(100, 4096, n_docs).astype(np.int32),
    }
    return inject_fd_errors(data, "source", "language", 1.0, error_frac, seed=seed + 1)
