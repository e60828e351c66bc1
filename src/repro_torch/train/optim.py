"""Optimizers: AdamW (float32 or bf16 moments) and Adafactor (factored
second moment), the counterpart of ``repro.train.optim``.

State trees mirror the parameter tree (nested dicts of tensors), with the
reference's dtypes: float32 moments (bf16 under ``adamw_bf16``), Adafactor's
float32 row and column factors, an int32 ``step``, and, with
``grad_compress``, the float32 error-feedback residual ``gerr``.  The
per-leaf arithmetic is the reference's (``repro/train/optim.py``): float32
throughout, bias correction as ``b ** step`` in float32, decoupled weight
decay on matrices only, Adafactor's update clipping.

``apply_updates`` runs under ``torch.no_grad()`` and updates the parameters
and the state IN PLACE (the reference's step donates them and returns new
trees); it returns them too.  Its metrics are 0-dim float32 tensors on the
parameters' device, read without a synchronisation until the caller asks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.relation import resolve_device


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adamw_bf16 | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


# ------------------------------------------------------------------- trees
def tree_items(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level (the
    order of ``jax.tree.leaves``), paths joined by ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure whose leaves, in ``tree_items``
    order, are ``leaves``."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        return next(it)

    return fill(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


# ---------------------------------------------------------------- schedule
def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 (``step`` a 0-dim tensor)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ------------------------------------------------------------------- state
def init_opt_state(params, cfg: OptConfig, grad_compress: bool = False) -> Dict:
    """Zero state for ``params`` on the parameters' device.  ``grad_compress``
    adds the int8 all-reduce's error-feedback residual ``gerr`` (float32,
    parameter-shaped)."""
    device = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.name in ("adamw", "adamw_bf16"):
        mdt = torch.bfloat16 if cfg.name == "adamw_bf16" else torch.float32
        state = {
            "step": step,
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        }
    elif cfg.name == "adafactor":
        def vr(p):
            shape = p.shape[:-1] if p.dim() >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        state = {"step": step, "vr": tree_map(vr, params), "vc": tree_map(vc, params)}
    else:
        raise ValueError(cfg.name)
    if grad_compress:
        state["gerr"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


def opt_state_from_numpy(tree, device="cuda") -> Dict:
    """The port's optimizer state from the reference's, given as numpy
    arrays (``np.asarray`` of each leaf; bf16 moments as ml_dtypes bfloat16
    or as the raw 2-byte values ``np.load`` gives without ml_dtypes)."""
    dev = resolve_device(device)

    def convert(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
            t = torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dev)

    return tree_map(convert, tree)


# ---------------------------------------------------------------- clipping
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ----------------------------------------------------------------- updates
def _adamw_leaf(p, g, m, v, cfg: OptConfig, lr, bc1, bc2) -> None:
    m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
    v32 = v.float() * cfg.b2 + torch.square(g) * (1 - cfg.b2)
    delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)
    m.copy_(m32)
    v.copy_(v32)


def _adafactor_leaf(p, g, vr, vc, cfg: OptConfig, lr, decay) -> None:
    g2 = torch.square(g) + 1e-30
    if p.dim() >= 2:
        vr2 = decay * vr + (1 - decay) * g2.mean(-1)
        vc2 = decay * vc + (1 - decay) * g2.mean(-2)
        denom = torch.clamp(vr2.mean(-1, keepdim=True), min=1e-30)
        vhat = vr2[..., :, None] * vc2[..., None, :] / denom[..., None]
    else:
        vr2 = decay * vr + (1 - decay) * g2
        vc2 = vc
        vhat = vr2
    u = g / torch.sqrt(vhat + 1e-30)
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)  # update clipping (rms <= 1)
    u = u / torch.clamp(rms, min=1.0)
    if p.dim() >= 2:
        u = u + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * u)
    vr.copy_(vr2)
    vc.copy_(vc2)


@torch.no_grad()
def apply_updates(params, grads, state: Dict, cfg: OptConfig):
    """One optimizer step, in place: returns (params, state, {"lr",
    "grad_norm"})."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"] += 1
    step = state["step"]
    lr = lr_at(cfg, step)
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    if cfg.name in ("adamw", "adamw_bf16"):
        b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=step.device)
        b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=step.device)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        for p, g, m, v in zip(flat_p, flat_g, tree_leaves(state["m"]), tree_leaves(state["v"])):
            _adamw_leaf(p, g, m, v, cfg, lr, bc1, bc2)
    else:  # adafactor: factored v, no first moment, update clipping
        decay = 1.0 - (step.float() + 1.0) ** -0.8
        for p, g, vr, vc in zip(flat_p, flat_g, tree_leaves(state["vr"]),
                                tree_leaves(state["vc"])):
            _adafactor_leaf(p, g, vr, vc, cfg, lr, decay)
    return params, state, {"lr": lr, "grad_norm": gnorm}
