"""Manifest-driven, atomic checkpoints in the reference's layout
(``repro.train.checkpoint``), so that a checkpoint written by either package
restores in the other:

    ckpt_dir/step_000123/
        manifest.json        step, per tree each leaf's shape and dtype, extra
        shard_00000.npz      every leaf, keyed "params::a/b/c" and "opt::..."
    ckpt_dir/LATEST          text file: "step_000123"  (atomic replace)

Leaf paths are the dict keys joined by ``/``, sorted at every level (the
reference's ``tree_flatten_with_path`` order).  Writes land in
``step_X.tmp``, which is renamed once the manifest is synced.

bf16 leaves (the moments under ``adamw_bf16``) need no ``ml_dtypes``: the
reference's ``np.savez`` writes an ml_dtypes bfloat16 array as 2-byte
records with the ``.npy`` descr ``'<V2'``, and this module writes the same
entry, header and bytes, from the tensor's raw bits; the manifest says
``bfloat16``.  Restore reads the raw 2-byte records (``np.load`` gives them
as ``|V2`` without ml_dtypes) and takes the dtype from the manifest.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optim import tree_items, tree_unflatten

def _host(leaf) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype name); bf16 as its raw 16-bit patterns."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(leaf)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_npy(fid, arr: np.ndarray, dtype_name: str) -> None:
    """What ``np.save`` writes for ``arr``; bf16 raw bits get the descr
    ``'<V2'`` that ``np.save`` gives an ml_dtypes bfloat16 array."""
    header = np.lib.format.header_data_from_array_1_0(arr)
    if dtype_name == "bfloat16":
        header["descr"] = "<V2"
    np.lib.format.write_array_header_1_0(fid, header)
    fid.write(np.ascontiguousarray(arr).tobytes())


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    """state: {'params': tree, 'opt': tree, 'extra': json-able}."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:06d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "trees": {}, "extra": state.get("extra", {})}
    # np.savez's container: stored (uncompressed) entries, zip64 forced
    with zipfile.ZipFile(os.path.join(tmp, "shard_00000.npz"), mode="w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for tree_name in ("params", "opt"):
            if tree_name not in state:
                continue
            leaves = manifest["trees"][tree_name] = {}
            for path, leaf in tree_items(state[tree_name]):
                arr, dtype_name = _host(leaf)
                leaves[path] = {"shape": list(arr.shape), "dtype": dtype_name}
                with zf.open(f"{tree_name}::{path}.npy", "w", force_zip64=True) as fid:
                    _write_npy(fid, arr, dtype_name)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        raw = np.array(arr, copy=True).view(np.int16)
        return torch.from_numpy(raw).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def restore_checkpoint(
    ckpt_dir: str,
    like: Dict[str, Any],
    step: Optional[int] = None,
) -> Tuple[Dict[str, Any], int]:
    """Restore into the structure of ``like`` ({'params': tree, 'opt':
    tree}): new tensors, each on the device of ``like``'s leaf at its path,
    with the manifest's dtype.  Returns (state with 'extra', step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {"extra": manifest.get("extra", {})}
    with np.load(os.path.join(path, "shard_00000.npz")) as data:
        for tree_name in ("params", "opt"):
            if tree_name not in like:
                continue
            dtypes = manifest["trees"][tree_name]
            leaves = []
            for key, leaf in tree_items(like[tree_name]):
                dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
                leaves.append(_tensor(data[f"{tree_name}::{key}"], dtypes[key]["dtype"], dev))
            out[tree_name] = tree_unflatten(like[tree_name], leaves)
    return out, step


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.isdir(os.path.join(ckpt_dir, d))
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
