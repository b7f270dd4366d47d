"""Attention: flash attention (prefill and training) and KV-cache decode
attention.

PyTorch twin of ``repro.lm.attention``. ``flash_attention`` is the
``flash_attention`` kernel's wrapper, in the reference's layout (q
[B, Sq, H, dh], k / v [B, Sk, KV, dh]): the hand-written kernel on CUDA, its
plain version on the CPU. Where q, k or v requires a gradient it goes
through the wrapper's ``autograd.Function``, whose backward is the
hand-written backward kernels (the reference differentiates its scans). The kernel tiles by its own constants, so the
reference's ``q_chunk`` / ``k_chunk`` are gone. ``decode_attention`` is
plain torch, as it is plain ``jnp`` in the reference. GQA reads KV head
``h // G`` for query head ``h`` (``G = H // KV``): K/V never materialise
repeated heads.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF

__all__ = ["flash_attention", "decode_attention"]


def decode_attention(q, k_cache, v_cache, pos: int, *, window=None):
    """Single-token attention against the KV cache: q [B, 1, H, dh], caches
    [B, S, KV, dh], ``pos`` the number of valid cache positions (the current
    one included). Returns [B, 1, H, dh] in q's dtype."""
    B, _, H, dh = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    qg = (q[:, 0] * dh**-0.5).reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32), k_cache.to(torch.float32))
    kpos = torch.arange(S, device=q.device)
    ok = kpos < pos
    if window is not None and window > 0:
        ok &= kpos > pos - 1 - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, H, dh).to(q.dtype)
