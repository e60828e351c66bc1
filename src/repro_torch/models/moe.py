"""Mixture-of-Experts MLP: top-k routing, shared experts, GShard grouped
dispatch.

The counterpart of ``repro.models.moe``, with its semantics.  Tokens split
into ``n_groups`` groups (1 when the token count does not divide); each group
routes its tokens into per-(group, expert) capacity slots through a sorted
run rank, so capacity and overflow drops are per (group, expert).  Expert
buffers are (G, E, C, d).  The load-balancing aux loss is Switch's,
``E * sum_e f_e * P_e`` over the true experts.

Where JAX and PyTorch could order ties differently, the port fixes the
reference's order:

* ``_top_k`` takes the k largest from a stable descending sort, so equal
  probabilities keep the lower expert index first (``jax.lax.top_k``);
* the slot order is a stable sort of the flattened (token, k) expert ids,
  so the same slots overflow.

The reference computes all of this in plain JAX (no Pallas kernel), and the
port in plain PyTorch: the expert products are batched matmuls over the
expert axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp as dense_mlp


def _run_rank(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal (sorted) ids, along the
    last dim."""
    n = sorted_ids.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=sorted_ids.device).expand_as(sorted_ids)
    new_run = torch.ones_like(sorted_ids, dtype=torch.bool)
    new_run[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    run_start = torch.where(new_run, idx, 0)
    return idx - torch.cummax(run_start, dim=-1).values


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last dim and their int32 indices, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _route(gate_idx: torch.Tensor, e_pad: int, capacity: int):
    """Slot assignment of every group at once: gate_idx (g, tg, k) ->
    (token_of_slot (g, E, C), pos (g, tg, k), keep (g, tg, k), slot_e
    (g, tg * k)).  Empty slots read token ``tg`` (the zero row); dropped
    (token, k) pairs go to expert row ``e_pad``, which is cut."""
    g, tg, k = gate_idx.shape
    dev = gate_idx.device
    flat_e = gate_idx.reshape(g, tg * k)
    flat_tok = torch.arange(tg * k, dtype=torch.int32, device=dev) // k
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    rank_sorted = _run_rank(torch.gather(flat_e, 1, order))
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < capacity
    pos = torch.clamp(rank, max=capacity - 1)
    slot_e = torch.where(keep, flat_e, e_pad)
    token_of_slot = torch.full((g, (e_pad + 1) * capacity), tg, dtype=torch.int32, device=dev)
    token_of_slot.scatter_(1, (slot_e * capacity + pos).long(),
                           flat_tok.expand(g, -1).contiguous())
    token_of_slot = token_of_slot.view(g, e_pad + 1, capacity)[:, :e_pad]
    return token_of_slot, pos.view(g, tg, k), keep.view(g, tg, k), slot_e


def moe_mlp(
    x: torch.Tensor,  # (b, s, d)
    params: dict,
    n_experts: int,  # true expert count (router width)
    top_k: int,
    capacity_factor: float,
    mlp_kind: str,
    n_groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (b, s, d) in x's dtype, aux loss float32 scalar).
    Expert weights in params:

    we_i : (E_pad, d, 2, f) swiglu  |  (E_pad, d, f) otherwise
    we_o : (E_pad, f, d)
    router: (d, E_pad) float32
    [shared_wi / shared_wo: always-on shared-expert MLP (qwen2-moe)]
    """
    b, s, d = x.shape
    e_pad = params["we_o"].shape[0]
    n_tok = b * s
    if n_tok % n_groups:
        n_groups = 1
    g, tg = n_groups, n_tok // n_groups
    xg = x.reshape(g, tg, d)

    logits = xg.float() @ params["router"]  # (g, tg, E) float32
    if e_pad > n_experts:
        logits[..., n_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)

    gate_vals, gate_idx = _top_k(probs, top_k)  # (g, tg, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    capacity = max(int(capacity_factor * top_k * tg / e_pad), 1)
    token_of_slot, pos, keep, slot_e = _route(gate_idx, e_pad, capacity)

    # group-local gather into expert buffers (empty slot -> the zero row)
    xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    rows = token_of_slot.reshape(g, e_pad * capacity, 1).long().expand(-1, -1, d)
    expert_in = torch.gather(xg_pad, 1, rows).view(g, e_pad, capacity, d)
    expert_in = expert_in.transpose(0, 1).reshape(e_pad, g * capacity, d)

    we_i = params["we_i"]
    if mlp_kind == "swiglu":
        f = we_i.shape[-1]
        gate_up = (expert_in @ we_i.reshape(e_pad, d, 2 * f)).unflatten(-1, (2, f))
        h = F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :]
    else:
        h = F.gelu(expert_in @ we_i, approximate="tanh")
    expert_out = (h @ params["we_o"]).view(e_pad, g, capacity, d).transpose(0, 1)

    # combine: group-local gather of each (token, k) slot's output; the gate
    # multiply stays in the compute dtype, one product accumulated over k
    gi = torch.arange(g, device=x.device)[:, None, None]
    out_k = expert_out[gi, gate_idx.long(), pos.long()]  # (g, tg, k, d)
    w = (gate_vals * keep).to(out_k.dtype)
    out = (w.unsqueeze(-2) @ out_k).squeeze(-2).to(x.dtype).reshape(n_tok, d)

    if "shared_wi" in params:
        out = out + dense_mlp(x.reshape(n_tok, d),
                              {"wi": params["shared_wi"], "wo": params["shared_wo"]},
                              mlp_kind)

    # Switch aux loss over the true experts (dropped pairs count in row e_pad)
    counts = torch.zeros(e_pad + 1, dtype=torch.float32, device=x.device)
    counts.index_add_(0, slot_e.reshape(-1).long(),
                      torch.ones(slot_e.numel(), dtype=torch.float32, device=x.device))
    f_e = counts[:e_pad] / n_tok
    p_e = probs.mean(dim=(0, 1))
    aux = n_experts * torch.sum(f_e[:n_experts] * p_e[:n_experts])
    return out.reshape(b, s, d), aux
