"""Key-routed shuffle: the distributed analogue of the paper's partition-
by-key comparison space (Daisy §4.2), in PyTorch.

The counterpart of ``repro.dist.shuffle``.  ``shuffle_by_key`` routes
every valid row to shard ``key % n_shards`` (the modulo of Python and of
``jnp``: the divisor's sign, so negative keys land in ``[0, n_shards)``),
so all rows sharing a key land on exactly one shard.  A shard holds
``capacity_factor * n`` slots; a row's rank within its shard is its order
in the flattened ``(n_shards, n)`` input, so when a skewed key overflows a
shard the first ``cap`` rows in that order survive and ``overflow`` is
set (the caller re-shuffles with a larger factor).  Invalid rows are
never routed.

The ranks come from one stable sort by destination and a count per
destination (the reference builds a ``(total, n_shards + 1)`` one-hot and
cumsums it); the routed layout is written by one scatter per output.
Every slot carries its source row's flat index (``src``, the inverse
permutation); empty slots hold the sentinel ``n_shards * n``.
``shuffle_by_key_host`` is the numpy reference with the same routing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.dist.hints import check_device

CAPACITY_FACTOR = 2.0


class ShuffleResult(NamedTuple):
    """Routed layout: ``(n_shards, cap)`` leading dims, plus the inverse
    permutation ``src`` (flat source row index per slot; ``n_shards * n``
    for empty slots) and the 0-d bool ``overflow``."""

    keys: torch.Tensor  # (n_shards, cap)
    payload: torch.Tensor  # (n_shards, cap, ...)
    valid: torch.Tensor  # (n_shards, cap) bool
    src: torch.Tensor  # (n_shards, cap) int32 flat source index
    overflow: torch.Tensor  # () bool


def _capacity(n_cols: int, capacity_factor: float) -> int:
    return max(int(n_cols * capacity_factor), 1)


def shuffle_by_key_host(
    keys: np.ndarray,
    payload: np.ndarray,
    valid: np.ndarray,
    n_shards: int,
    capacity_factor: float = CAPACITY_FACTOR,
):
    """Numpy reference: same routing (key % n_shards) and capacity."""
    keys = np.asarray(keys)
    payload = np.asarray(payload)
    valid = np.asarray(valid)
    n = keys.shape[1]
    total = keys.shape[0] * n
    cap = _capacity(n, capacity_factor)
    out_k = np.zeros((n_shards, cap), keys.dtype)
    out_p = np.zeros((n_shards, cap) + payload.shape[2:], payload.dtype)
    out_v = np.zeros((n_shards, cap), bool)
    out_src = np.full((n_shards, cap), total, np.int32)
    counts = np.zeros(n_shards, np.int64)
    overflow = False
    for s in range(keys.shape[0]):
        for i in range(n):
            if not valid[s, i]:
                continue
            d = int(keys[s, i]) % n_shards
            if counts[d] >= cap:
                overflow = True
                continue
            out_k[d, counts[d]] = keys[s, i]
            out_p[d, counts[d]] = payload[s, i]
            out_v[d, counts[d]] = True
            out_src[d, counts[d]] = s * n + i
            counts[d] += 1
    return ShuffleResult(out_k, out_p, out_v, out_src, overflow)


def shuffle_by_key(
    keys: torch.Tensor,  # (n_shards, n) int
    payload: torch.Tensor,  # (n_shards, n, ...) rides along
    valid: torch.Tensor,  # (n_shards, n) bool
    mesh,
    capacity_factor: float = CAPACITY_FACTOR,
) -> ShuffleResult:
    """Route rows so each key lives on exactly one shard.

    Returns a ``ShuffleResult`` with the same per-shard layout widened to
    ``capacity_factor * n`` columns, on the inputs' device (one of the
    mesh's).  ``overflow`` is True when some shard received more rows than
    its capacity (those rows are dropped; re-shuffle with a larger factor).
    """
    check_device(mesh, keys, "shuffle_by_key keys")
    n_shards, n = keys.shape
    cap = _capacity(n, capacity_factor)
    total = n_shards * n
    dev = keys.device
    fk = keys.reshape(total)
    fv = valid.reshape(total)
    fp = payload.reshape((total,) + tuple(payload.shape[2:]))
    # invalid rows park in a virtual bucket n_shards and never scatter
    dest = torch.where(fv, torch.remainder(fk, n_shards).to(torch.int64), n_shards)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=n_shards + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty(total, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(total, device=dev) - starts[dest[order]]
    overflow = (counts[:n_shards] > cap).any()
    ok = fv & (rank < cap)
    slot = (dest * cap + rank)[ok]
    out_k = torch.zeros(n_shards * cap, dtype=keys.dtype, device=dev)
    out_k[slot] = fk[ok]
    out_v = torch.zeros(n_shards * cap, dtype=torch.bool, device=dev)
    out_v[slot] = True
    out_p = torch.zeros((n_shards * cap,) + tuple(fp.shape[1:]), dtype=payload.dtype, device=dev)
    out_p[slot] = fp[ok]
    out_src = torch.full((n_shards * cap,), total, dtype=torch.int32, device=dev)
    out_src[slot] = torch.arange(total, dtype=torch.int32, device=dev)[ok]
    return ShuffleResult(
        out_k.reshape(n_shards, cap),
        out_p.reshape((n_shards, cap) + tuple(fp.shape[1:])),
        out_v.reshape(n_shards, cap),
        out_src.reshape(n_shards, cap),
        overflow,
    )
