"""Plain PyTorch versions of the flash_attention kernels, forward and
backward (the CPU path and the yardsticks the CUDA kernels are held to)."""

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


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0, with_lse=False):
    """q [B, Sq, H, dh]; k, v [B, Sk, KV, dh] -> [B, Sq, H, dh] in q's dtype
    (and, with ``with_lse``, the row log-sum-exp [B, H, Sq] fp32 of the
    scaled scores, -1e30 where a row has no allowed key, as the kernels
    write it).

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
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for b in range(B):
        qb = qs[b].to(torch.float32).reshape(Sq, KV, G, dh).permute(1, 2, 0, 3)
        kb = k[b].to(torch.float32).permute(1, 0, 2)  # [KV, Sk, dh]
        vb = v[b].to(torch.float32).permute(1, 0, 2)
        s = torch.einsum("kgqd,kcd->kgqc", qb, kb)
        s = torch.where(allowed, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if with_lse:
            lse[b] = (m + torch.log(l)).reshape(H, Sq)
        p = p.to(v.dtype).to(torch.float32)
        o = torch.einsum("kgqc,kcd->kgqd", p, vb) / l.clamp(min=1e-30)
        out[b] = o.permute(2, 0, 1, 3).reshape(Sq, H, dh).to(q.dtype)
    return (out, lse) if with_lse else out


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=None, q_offset=0):
    """``(dq, dk, dv)`` in the inputs' dtype: the plain version of the
    backward kernels (``csrc/flash_attention_bwd.cu``), with their math.

    ``qs = q * dh**-0.5`` rounded to q's dtype, ``s = qs . k``, ``p =
    exp(s - lse)`` on the allowed keys and 0 elsewhere, ``D = rowsum(do *
    o)``; ``dv = p^T do``, ``dp = do v^T``, ``ds = p * (dp - D)``, ``dk =
    ds^T qs``, ``dq = scale * ds k``, all in fp32. A row with no allowed key
    (``lse`` at or below -5e29) had the mean of v over all Sk keys: its
    ``p`` is ``1 / Sk`` on every key and its ``ds`` 0, as the reference's
    gradient through its -1e30 scores is. Summed over a GQA group's query
    heads, one sequence at a time.
    """
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh**-0.5
    qs = q * scale
    allowed = band_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                        device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = torch.float32
    for b in range(B):
        heads = lambda t: t[b].to(f32).reshape(Sq, KV, G, dh).permute(1, 2, 0, 3)
        qb, ob, dob = heads(qs), heads(o), heads(do)  # [KV, G, Sq, dh]
        kb = k[b].to(f32).permute(1, 0, 2)  # [KV, Sk, dh]
        vb = v[b].to(f32).permute(1, 0, 2)
        lb = lse[b].reshape(KV, G, Sq, 1)
        empty = lb <= 0.5 * NEG_INF
        s = torch.einsum("kgqd,kcd->kgqc", qb, kb)
        p = torch.where(allowed, torch.exp(torch.where(allowed, s - lb, 0.0)), 0.0)
        p = torch.where(empty, 1.0 / max(Sk, 1), p)
        dp = torch.einsum("kgqd,kcd->kgqc", dob, vb)
        delta = (dob * ob).sum(-1, keepdim=True)
        ds = torch.where(allowed & ~empty, p * (dp - delta), 0.0)
        dv[b] = torch.einsum("kgqc,kgqd->kcd", p, dob).permute(1, 0, 2).to(v.dtype)
        dk[b] = torch.einsum("kgqc,kgqd->kcd", ds, qb).permute(1, 0, 2).to(k.dtype)
        dqb = torch.einsum("kgqc,kcd->kgqd", ds, kb) * scale
        dq[b] = dqb.permute(2, 0, 1, 3).reshape(Sq, H, dh).to(q.dtype)
    return dq, dk, dv
