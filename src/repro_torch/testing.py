"""Carry state across the two packages in parity tests.

``relation_from_numpy`` builds a port ``Relation`` from host arrays — the
``np.asarray`` of every array of a reference relation — so both packages
start from identical state.  It takes plain numpy, never an object of the
reference package.  ``tree_to_numpy`` and ``tree_paths`` carry nested
dicts of arrays (parameters, KV caches, logits) of either package to numpy
for comparison; ``models.params.params_from_numpy`` carries the reference's
parameters into the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.relation import Relation, resolve_device

_FIELDS = ("columns", "cand", "ccount", "ckind", "orig", "checked")


def relation_from_numpy(fields: Mapping[str, object], device="cuda") -> Relation:
    """Build a ``Relation`` from ``fields``: ``valid`` maps to one array and
    each of ``columns``, ``cand``, ``ccount``, ``ckind``, ``orig`` and
    ``checked`` to a dict of arrays.  Dtypes are kept as given."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    kw: Dict[str, object] = {
        name: {k: tensor(v) for k, v in fields[name].items()} for name in _FIELDS
    }
    kw["valid"] = tensor(fields["valid"])
    return Relation(**kw)


def relation_to_numpy(rel) -> Dict[str, object]:
    """The host arrays of a relation of either package, in the layout
    ``relation_from_numpy`` takes (for tests holding two relations equal)."""

    def host(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)

    out: Dict[str, object] = {
        name: {k: host(v) for k, v in getattr(rel, name).items()} for name in _FIELDS
    }
    out["valid"] = host(rel.valid)
    return out


def tree_to_numpy(tree):
    """Host numpy copy of a nested dict of arrays of either package (the
    JAX reference's or the port's); bf16 tensors of the port come back as
    float32, Python scalars stay as they are."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, (int, float)):
        return tree
    return np.array(tree)  # a writable copy


def tree_paths(tree, prefix: str = "") -> Dict[str, object]:
    """Flatten a nested dict into ``{"a.b.c": leaf}``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, object] = {}
    for k, v in tree.items():
        out.update(tree_paths(v, f"{prefix}.{k}" if prefix else k))
    return out


def ledger_state(ledger) -> Dict[str, object]:
    """Everything a work ledger of either package holds, per scope, as
    host values: capacity, version, per-strip cold counts, fresh strips,
    queued ingest-deltas and launch geometry."""
    out: Dict[str, object] = {}
    for s in ledger.scopes():
        out[f"{s.table}/{s.rule}"] = dict(
            capacity=s.capacity, version=s.version,
            cold_per_strip=np.asarray(s.cold_per_strip).tolist(),
            fresh=sorted(int(f) for f in s.fresh),
            pending=[
                (p.lo, p.hi, np.asarray(p.checked).tobytes(),
                 None if p.old_dirty is None else np.asarray(p.old_dirty).tobytes())
                for p in s.pending
            ],
            tiles=(s.tiles_launched, s.tiles_skipped),
        )
    return out


def engine_state(daisy) -> Dict[str, object]:
    """The whole versioned state of a ``Daisy`` of either package as host
    values: every relation's arrays (floats as their bits), the ledger,
    the clean version and the work counters."""
    out: Dict[str, object] = {}
    for table, rel in daisy.db.items():
        fields = relation_to_numpy(rel)
        out[f"{table}.valid"] = fields["valid"]
        for name in _FIELDS:
            for k, v in fields[name].items():
                out[f"{table}.{name}.{k}"] = v
    out["ledger"] = ledger_state(daisy.ledger)
    out["counters"] = (daisy.clean_version, daisy.detect_calls, daisy.repair_calls,
                       daisy.detect_pairs, daisy.tiles_launched, daisy.tiles_skipped)
    return out


def state_differences(a: Dict[str, object], b: Dict[str, object]) -> list:
    """Keys whose values differ between two ``engine_state``s (arrays bit
    for bit, dtype included); empty when the states are identical."""
    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            if (x.dtype != y.dtype or x.shape != y.shape
                    or x.view(np.uint8).tobytes() != y.view(np.uint8).tobytes()):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad
