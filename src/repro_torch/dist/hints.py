"""The port's device mesh and its data-parallel axes.

The counterpart of the mesh side of ``repro.dist.hints`` (``DP_AXES``,
``TP_AXIS``, ``dp_axes``).  The reference configures sharded detection
with a ``jax.sharding.Mesh``; the port has no such object, so ``Mesh`` here
holds what detection reads of one: the axis names, their sizes
(``.shape``, a name -> size mapping as the reference's mesh has) and the
torch devices laid out over them.

Sharded detection on one device runs the reference's logical-shard
branch (``n_shards`` shards in one launch, DESIGN.md §8).  Spreading shards
over several devices is the reference's ``shard_map`` branch, which the
port does not have: a mesh whose data-parallel extent is above 1 raises
``NotImplementedError``, and a mesh naming a device that is not present
raises ``ValueError``.  Activation hints (``hint``) are not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# outer -> inner data-parallel axes; ``pod`` composes with ``data``
DP_AXES = ("pod", "data")
TP_AXIS = "model"


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes present with extent > 1 (outer first)."""
    return tuple(
        a for a in DP_AXES if a in mesh.axis_names and mesh.shape[a] > 1
    )


def _present(dev: torch.device) -> bool:
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        return torch.cuda.is_available() and index < torch.cuda.device_count()
    return False


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over an array of torch devices, e.g.
    ``Mesh(np.array(["cuda"], dtype=object).reshape(1, 1), ("data", "model"))``.

    ``devices`` is any nested sequence or array of devices (or device
    strings) with one dimension per axis name.  Raises ``ValueError`` for a
    device that is not present or listed twice, and ``NotImplementedError``
    for a data-parallel extent above 1."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"mesh devices have {arr.ndim} dims for axes {axis_names}"
            )
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [torch.device(d) for d in arr.reshape(-1)]
        for dev in flat:
            if not _present(dev):
                raise ValueError(f"mesh device {dev} is not present")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, arr.shape))
        extent = int(np.prod([self.shape[a] for a in dp_axes(self)]))
        if extent > 1:
            raise NotImplementedError(
                f"a mesh with data-parallel extent {extent}: sharded detection "
                "across devices is not ported; the port runs logical shards on "
                "one device"
            )
        canon = [_canonical(d) for d in flat]
        if len(set(canon)) != len(canon):
            raise ValueError(f"mesh lists a device twice: {flat}")
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def one_device_mesh(device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh of extent 1 x 1 over ``device``."""
    devs = np.empty((1, 1), dtype=object)
    devs[0, 0] = torch.device(device)
    return Mesh(devs, ("data", "model"))


def holds(mesh, device) -> bool:
    """Whether ``device`` is one of the mesh's devices."""
    dev = _canonical(torch.device(device))
    return any(_canonical(d) == dev for d in mesh.devices.reshape(-1))


def check_device(mesh, tensor: torch.Tensor, what: str) -> None:
    """Raise unless ``tensor`` lives on one of the mesh's devices."""
    if not holds(mesh, tensor.device):
        raise ValueError(f"{what} lives on {tensor.device}, outside {mesh!r}")
