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


def scaled_rows(dout, mask, mode):
    """Each bag's term of the table gradient, fp32 [B, D]: ``dout[b]``,
    divided by ``max(count_b, 1)`` in mean mode, once a bag. The plain
    version and the kernel both sum these, so their sums can be equal bit
    for bit."""
    g = dout.to(torch.float32)
    if mode == "mean":
        g = g / mask.sum(-1, keepdim=True).to(torch.float32).clamp(min=1.0)
    return g.contiguous()


def embedding_bag_backward_ref(dout, ids, mask, n_rows: int, *, mode="sum"):
    """The gradient of ``embedding_bag_ref`` with respect to its table:
    dout [B, D]; ids int [B, K]; mask bool [B, K] -> dtable [n_rows, D] in
    ``dout.dtype``, dense, as ``jax.grad`` of the reference's ``clip`` +
    ``take`` gives it.

    ``dtable[clip(ids[b, j])] += dout[b] / max(count_b, 1)`` (``mode="mean"``;
    ``dout[b]`` for ``"sum"``) over the unmasked ``(b, j)``: a clipped id
    sends its gradient to row 0 or ``n_rows - 1``; masked entries and
    all-masked bags add nothing. Summed in fp32 (``index_add_`` into a zero
    table), rounded once."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got {mode!r}")
    B, K = ids.shape
    g = scaled_rows(dout, mask, mode)
    keep = mask.reshape(-1)
    rows = ids.reshape(-1).long().clamp(0, n_rows - 1)[keep]
    bags = torch.arange(B, device=ids.device).repeat_interleave(K)[keep]
    out = torch.zeros((n_rows, dout.shape[1]), dtype=torch.float32, device=dout.device)
    out.index_add_(0, rows, g[bags])
    return out.to(dout.dtype)
