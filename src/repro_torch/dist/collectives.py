"""Compressed cross-replica gradient all-reduce (DESIGN.md §6), the
counterpart of ``repro.dist.collectives``.

Each data-parallel rank quantizes (gradient + carried residual) to int8 with
one per-tensor scale, the dequantized values are mean-reduced over the data
axes, and the quantization error carries into the next step (error
feedback).  The contract:

* **quantization** is symmetric per-tensor int8: ``q = round(x / scale)``
  clipped to [-127, 127], ``scale = amax / 127`` in float32 (``scale = 1`` for
  an all-zero tensor, so zeros round-trip exactly); ``torch.round`` rounds
  half to even, as ``jnp.round`` does;
* **error feedback**: the value quantized is ``gradient + residual`` in
  float32, and the new residual is ``(gradient + residual) - dequantize(q)``,
  a float32 tree of the gradient's shapes that the caller carries
  (``opt_state["gerr"]``);
* **reduction** is the mean over the mesh's data-parallel axes of the
  dequantized value, cast back to the gradient's dtype.

The port's mesh (``dist.hints.Mesh``) has a data-parallel extent of 1 (a
larger one raises ``NotImplementedError`` where the mesh is built), so the
mean is over one rank: the step carries the compression's numerics exactly,
and no bytes cross a wire.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dist.hints import dp_axes
from repro_torch.train.optim import tree_map


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q int8, scale float32 0-dim)."""
    x = g.float()
    amax = x.abs().max() if x.numel() else torch.zeros((), device=x.device)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones((), device=x.device))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def grad_allreduce_compressed(grads, errors, mesh):
    """Mean-reduce a gradient tree over ``mesh``'s data-parallel axes with
    int8 compression and error feedback.  ``errors`` is the residual tree of
    the previous step (zeros at step 0).  Returns (reduced, new_errors)."""
    axes = dp_axes(mesh)
    if axes:
        raise NotImplementedError(
            f"a data-parallel extent above 1 over {axes}: the port runs one rank")

    def per_rank(g, e):
        compensated = g.float() + e
        q, scale = quantize_int8(compensated)
        dq = dequantize_int8(q, scale)
        return dq.to(g.dtype), compensated - dq

    pairs = tree_map(per_rank, grads, errors)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)
