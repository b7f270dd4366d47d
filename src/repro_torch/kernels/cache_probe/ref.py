"""Plain PyTorch version of the cache_probe kernel (the CPU path and the
yardstick the CUDA kernel is held to, bit for bit)."""

from __future__ import annotations

import torch


def cache_probe_ref(c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp, *, probes=8):
    """Cache arrays [C]; keys [B] (``h``/``fp``/``c_fp`` int32 holding the
    uint32 bits; only the low bits of ``h`` are used).

    Returns (hit bool [B], first matching slot int32 [B] or -1).
    """
    C = c_tpl.shape[0]
    base = h & (C - 1)
    offs = torch.arange(probes, dtype=torch.int64, device=h.device)
    slots = (base[:, None] + offs[None, :]) & (C - 1)
    ok = (
        c_valid[slots]
        & (c_tpl[slots] == tpl[:, None])
        & (c_root[slots] == root[:, None])
        & (c_fp[slots] == fp[:, None])
    )
    hit = ok.any(dim=1)
    first = ok.to(torch.uint8).argmax(dim=1)  # first True (0 when none)
    slot = torch.where(hit, slots.gather(1, first[:, None])[:, 0], -1)
    return hit, slot.to(torch.int32)
