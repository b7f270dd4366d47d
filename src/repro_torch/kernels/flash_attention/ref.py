"""Plain PyTorch versions of the flash_attention kernels, forward and
backward (the CPU path and the yardsticks the CUDA kernels are held to)."""

from __future__ import annotations

import torch

from repro_torch.kernels import plain_slices

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
    for sl in _sequences(q):
        nb = len(range(B)[sl])
        qb = qs[sl].to(torch.float32).reshape(nb, Sq, KV, G, dh).permute(0, 2, 3, 1, 4)
        kb = k[sl].to(torch.float32).permute(0, 2, 1, 3)  # [nb, KV, Sk, dh]
        vb = v[sl].to(torch.float32).permute(0, 2, 1, 3)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kb)
        s = torch.where(allowed, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if with_lse:
            lse[sl] = (m + torch.log(l)).reshape(nb, H, Sq)
        p = p.to(v.dtype).to(torch.float32)
        o = torch.einsum("bkgqc,bkcd->bkgqd", p, vb) / l.clamp(min=1e-30)
        out[sl] = o.permute(0, 3, 1, 2, 4).reshape(nb, Sq, H, dh).to(q.dtype)
    return (out, lse) if with_lse else out


def _sequences(q):
    """The batch slices the plain versions take at a time: one sequence, so
    that its scores are the largest temporary."""
    return plain_slices(q.shape[0], 1, q.device)


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
    for sl in _sequences(q):
        nb = len(range(B)[sl])
        heads = lambda t: t[sl].to(f32).reshape(nb, Sq, KV, G, dh).permute(0, 2, 3, 1, 4)
        qb, ob, dob = heads(qs), heads(o), heads(do)  # [nb, KV, G, Sq, dh]
        kb = k[sl].to(f32).permute(0, 2, 1, 3)  # [nb, KV, Sk, dh]
        vb = v[sl].to(f32).permute(0, 2, 1, 3)
        lb = lse[sl].reshape(nb, KV, G, Sq, 1)
        empty = lb <= 0.5 * NEG_INF
        s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kb)
        p = torch.where(allowed, torch.exp(torch.where(allowed, s - lb, 0.0)), 0.0)
        p = torch.where(empty, 1.0 / max(Sk, 1), p)
        dp = torch.einsum("bkgqd,bkcd->bkgqc", dob, vb)
        delta = (dob * ob).sum(-1, keepdim=True)
        ds = torch.where(allowed & ~empty, p * (dp - delta), 0.0)
        dv[sl] = torch.einsum("bkgqc,bkgqd->bkcd", p, dob).permute(0, 2, 1, 3).to(v.dtype)
        dk[sl] = torch.einsum("bkgqc,bkgqd->bkcd", ds, qb).permute(0, 2, 1, 3).to(k.dtype)
        dqb = torch.einsum("bkgqc,bkcd->bkgqd", ds, kb) * scale
        dq[sl] = dqb.permute(0, 3, 1, 2, 4).reshape(nb, Sq, H, dh).to(q.dtype)
    return dq, dk, dv
