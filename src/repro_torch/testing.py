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
