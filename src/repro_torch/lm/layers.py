"""Transformer layer pieces: RMSNorm, RoPE, SwiGLU FFN.

PyTorch twin of ``repro.lm.layers``, with the reference's dtype points.
``moe_ffn`` is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def moe_ffn(x, router_w, we1, we3, we2, *, top_k: int, capacity_factor: float):
    raise NotImplementedError(
        "moe_ffn is not ported yet: it waits for MoE, with the Grok and Kimi configs "
        "(ROADMAP queue 1, the rest of the model families)"
    )
