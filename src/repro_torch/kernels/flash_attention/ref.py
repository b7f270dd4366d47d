"""Plain PyTorch version of the flash_attention kernel (the CPU path and the
yardstick the CUDA kernel is held to)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def band_mask(sq: int, sk: int, *, causal: bool, window, q_offset: int, device):
    """allowed [Sq, Sk]: query row i sits at position ``q_offset + i``; key j
    is allowed where ``j <= position`` (causal) and ``j > position -
    window`` (``window`` > 0; None or <= 0 is none)."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    allowed = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        allowed &= kpos <= qpos
    if window is not None and window > 0:
        allowed &= kpos > qpos - window
    return allowed


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """q [B, Sq, H, dh]; k, v [B, Sk, KV, dh] -> [B, Sq, H, dh] in q's dtype.

    The function ``repro.lm.attention.flash_attention`` computes, with its
    dtype points: ``q * dh**-0.5`` rounded to q's dtype, fp32 scores,
    disallowed scores -1e30 (a row with no allowed key gets the mean of v),
    probabilities rounded to v's dtype before the product with v, the sum
    over keys in fp32. A plain softmax over all keys at once, one sequence
    at a time so that the scores of one sequence ([H, Sq, Sk] fp32) are the
    largest temporary.
    """
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qs = q * dh**-0.5
    allowed = band_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                        device=q.device)
    out = torch.empty_like(q)
    for b in range(B):
        qb = qs[b].to(torch.float32).reshape(Sq, KV, G, dh).permute(1, 2, 0, 3)
        kb = k[b].to(torch.float32).permute(1, 0, 2)  # [KV, Sk, dh]
        vb = v[b].to(torch.float32).permute(1, 0, 2)
        s = torch.einsum("kgqd,kcd->kgqc", qb, kb)
        s = torch.where(allowed, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        p = p.to(v.dtype).to(torch.float32)
        o = torch.einsum("kgqc,kcd->kgqd", p, vb) / l.clamp(min=1e-30)
        out[b] = o.permute(2, 0, 1, 3).reshape(Sq, H, dh).to(q.dtype)
    return out
