"""Plain PyTorch version of the embedding_bag kernel (the CPU path and the
yardstick the CUDA kernel is held to)."""

from __future__ import annotations

import torch


# bags per step: one step's [bags, K, D] fp32 gather is 1 GiB at K 16, D 256
CHUNK = 1 << 16


def embedding_bag_ref(table, ids, mask, *, mode="sum"):
    """table [V, D]; ids int [B, K]; mask bool [B, K] -> [B, D] in
    ``table.dtype``.

    ``recsys.embedding.embedding_bag`` without weights: ids clipped to
    ``[0, V-1]``, masked positions add nothing, ``mode="mean"`` divides by
    ``max(count, 1)``. Sums and the division run in fp32, rounded once. The
    bags go CHUNK at a time, so the gathered rows of one step are the
    largest temporary.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got {mode!r}")
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    for s in range(0, ids.shape[0], CHUNK):
        i, m = ids[s:s + CHUNK], mask[s:s + CHUNK]
        rows = table[i.long().clamp(0, table.shape[0] - 1)].to(torch.float32)
        acc = torch.where(m[..., None], rows, 0.0).sum(-2)
        if mode == "mean":
            acc = acc / m.sum(-1, keepdim=True).to(torch.float32).clamp(min=1.0)
        out[s:s + CHUNK] = acc
    return out
