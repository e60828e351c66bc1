"""The train step and the serving steps (the counterpart of
``repro.train.steps``).

``make_train_step`` builds a microbatched (gradient-accumulation) step: the
global batch splits into ``n_micro`` microbatches along its first dim, each
microbatch's gradient is taken by autograd through ``loss_fn`` and summed,
divided by ``n_micro``, into an accumulator in the masters' dtype (float32
masters accumulate in float32, bf16 masters in bf16, as the reference's
scan does), and one optimizer step applies the sum.  The reference donates
the parameters and the optimizer state to its jitted step; here the step
updates the master tensors and the state IN PLACE and returns them.  With
one microbatch the gradients are used as autograd gives them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, loss_fn, prefill
from repro_torch.train.optim import (
    OptConfig, apply_updates, tree_leaves, tree_map, tree_unflatten,
)


def _grads(params, cfg: ModelConfig, batch: Dict, mamba_chunk: int):
    """(loss, gradient tree) of ``loss_fn`` at ``params``: the gradient of
    each master leaf, zeros for a leaf the loss does not reach."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(tracked)
    loss, _ = loss_fn(tracked, cfg, batch, mamba_chunk=mamba_chunk)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(
        params, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    n_micro: int = 1,
    mamba_chunk: int = 128,
    grad_compress: bool = False,
    mesh=None,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), params
    and state updated in place; metrics ``loss``, ``lr`` and ``grad_norm``
    as 0-dim float32 tensors.

    ``grad_compress`` (needs ``mesh``) routes the accumulated gradients
    through the int8 error-feedback all-reduce (``dist.collectives``), the
    residual carried in ``opt_state["gerr"]`` (``init_opt_state(...,
    grad_compress=True)``)."""
    if grad_compress and mesh is None:
        raise ValueError("grad_compress=True requires a mesh")

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = _grads(params, cfg, batch, mamba_chunk)
        else:
            first = tree_leaves(params)[0]
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=first.dtype, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=first.device)
            for i in range(n_micro):
                micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
                         for k, v in batch.items()}
                mloss, mgrads = _grads(params, cfg, micro, mamba_chunk)
                with torch.no_grad():
                    tree_map(lambda a, g: a.add_(g.to(a.dtype) / n_micro), grads, mgrads)
                    loss = loss + mloss / n_micro
                del mgrads
        new_err = None
        if grad_compress:
            from repro_torch.dist.collectives import grad_allreduce_compressed

            if "gerr" not in opt_state:
                raise ValueError(
                    "grad_compress=True needs the error-feedback residual "
                    "opt_state['gerr']: initialize with "
                    "init_opt_state(..., grad_compress=True)")
            grads, new_err = grad_allreduce_compressed(grads, opt_state["gerr"], mesh)
        params, opt_state, opt_metrics = apply_updates(params, grads, opt_state, opt_cfg)
        if new_err is not None:
            opt_state["gerr"] = new_err
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, cache, token) -> (next-token logits, cache); ``params`` is
    the compute copy, and the cache is updated in place."""

    def serve_step(params, cache, token):
        return decode_step(params, cfg, cache, token)

    return serve_step


def make_prefill_step(cfg: ModelConfig, s_max: int, mamba_chunk: int = 128) -> Callable:
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, s_max=s_max, mamba_chunk=mamba_chunk)

    return prefill_step
