"""Transformer layer pieces: RMSNorm, RoPE, SwiGLU FFN, sort-based MoE.

PyTorch twin of ``repro.lm.layers``, with the reference's dtype points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import top_k as ranked_top_k


def rms_norm(x, w, eps=1e-6):
    # as the reference: square in x's dtype, take the mean in fp32, scale in
    # x's dtype
    var = (x * x).to(torch.float32).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def rope(x, positions, theta: float):
    """Rotary embedding. x: [B, S, H, dh], positions: [S] or [B, S]. The
    angle and the rotation run in fp32; the result is cast back to x's
    dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[:, None].to(torch.float32) * freqs[None, :]  # [S, half]
        ang = ang[None, :, None, :]
    else:
        ang = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
        ang = ang[:, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w1, w3, w2):
    """x @ w1 -> silu, gate x @ w3, down w2. Shapes: [.., D]x[D,F]."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert takes: the reference's ``max(1, int(N * top_k / E *
    capacity_factor))``, a floor (its docstring says ceil; its code floors)."""
    return max(1, int(n_tokens * top_k / n_experts * capacity_factor))


def moe_route(x, router_w, top_k: int):
    """The router: fp32 softmax over ``x @ router_w`` (the product in x's
    dtype), the ``top_k`` experts of each token in ``jax.lax.top_k``'s order
    (the lower expert first among equal probabilities), their gates
    renormalised by ``max(sum, 1e-9)``. Returns (probs [N, E] fp32, gate
    [N, k] fp32, expert [N, k] int64)."""
    probs = torch.softmax((x @ router_w).to(torch.float32), dim=-1)
    gate, expert = ranked_top_k(probs, top_k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, expert


def moe_dispatch(expert, n_experts: int, capacity: int):
    """The reference's static-shape dispatch of the routed (token, k)
    pairs, flattened token-major: a stable sort by expert, each pair's rank
    in its expert's group from a ``searchsorted`` of the sorted experts,
    and slot ``e * C + rank`` for the pairs whose rank is below C.
    Returns (order [N*k], the pairs' sorted positions; slot [N*k], ``E*C``
    for a dropped pair; keep [N*k] bool), all in sorted order."""
    flat = expert.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    se = flat[order]
    offsets = torch.searchsorted(se, torch.arange(n_experts, device=se.device), side="left")
    rank = torch.arange(se.shape[0], device=se.device) - offsets[se]
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, n_experts * capacity)
    return order, slot, keep


def moe_experts(xe, we1, we3, we2):
    """Every expert's SwiGLU over its slots: xe [E, C, D] -> [E, C, D]; the
    reference's three batched ``einsum``s, plain batched GEMMs here."""
    h = F.silu(torch.bmm(xe, we1))
    h = h * torch.bmm(xe, we3)
    return torch.bmm(h, we2)


def moe_ffn(x, router_w, we1, we3, we2, *, top_k: int, capacity_factor: float):
    """Token-choice top-k MoE with sort-based dispatch and capacity drop.

    x: [N, D] tokens; router_w: [D, E]; we*: [E, D, F] / [E, F, D].
    Returns ([N, D] in x's dtype, the load-balancing aux loss fp32): the
    router (``moe_route``), then ``moe_apply`` at the capacity
    ``moe_capacity`` gives."""
    E = router_w.shape[-1]
    probs, gate, expert = moe_route(x, router_w, top_k)
    C = moe_capacity(x.shape[0], top_k, E, capacity_factor)
    return moe_apply(x, gate, expert, we1, we3, we2, C), _load_balance_loss(probs, expert, E)


def moe_apply(x, gate, expert, we1, we3, we2, capacity: int):
    """The experts over x [N, D] for a given routing (gate [N, k], expert
    [N, k]), as the reference: pairs past an expert's C slots are dropped;
    the dispatch buffer has a trash slot ``E*C`` that is sliced off
    (``mode="drop"``); each kept pair's expert output is weighted by its
    gate in fp32, cast to x's dtype and added to its token. A token's pairs
    are added in the reference's scatter order (ascending expert), one after
    another in x's dtype, with no atomics, so a bf16 sum rounds where the
    reference's does and two calls are equal."""
    N, D = x.shape
    E, top_k, C = we1.shape[0], expert.shape[1], capacity
    order, slot, keep = moe_dispatch(expert, E, C)
    stok = torch.div(order, top_k, rounding_mode="floor")
    # dispatch: xe[e, c] = x[the token in that slot], zero where unused
    slot_token = torch.zeros(E * C + 1, dtype=torch.int64, device=x.device)
    slot_token[slot] = stok
    slot_used = torch.zeros(E * C + 1, dtype=torch.bool, device=x.device)
    slot_used[slot] = keep
    slot_token, slot_used = slot_token[:E * C], slot_used[:E * C]
    xe = (x[slot_token] * slot_used[:, None].to(x.dtype)).reshape(E, C, D)
    ye = moe_experts(xe, we1, we3, we2).reshape(E * C, D)
    # combine: each pair's output (zero if dropped) x its gate, in x's
    # dtype, back in token-major pair order
    y_pair = torch.where(keep[:, None], ye[slot.clamp(max=E * C - 1)], 0.0)
    contrib = (y_pair * gate.reshape(-1)[order][:, None]).to(x.dtype)
    pairs = torch.empty_like(contrib)
    pairs[order] = contrib
    pairs = pairs.reshape(N, top_k, D)
    by_expert = torch.sort(expert, dim=-1, stable=True).indices
    out = torch.zeros((N, D), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + pairs.gather(1, by_expert[:, j, None, None].expand(N, 1, D))[:, 0]
    return out


def _load_balance_loss(probs, expert, E):
    """Switch-style auxiliary load-balancing loss: E x the dot of the mean
    router probability and the routed share of each expert."""
    N, k = expert.shape
    me = probs.mean(0)
    flat = expert.reshape(-1)
    routed = torch.zeros(E, dtype=torch.int64, device=flat.device)
    routed.scatter_add_(0, flat, torch.ones_like(flat))  # bincount, with a static shape
    ce = routed.to(torch.float32) / (N * k)
    return E * torch.sum(me * ce)
