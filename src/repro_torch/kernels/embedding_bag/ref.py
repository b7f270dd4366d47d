"""Plain PyTorch version of the embedding_bag kernel (the CPU path and the
yardstick the CUDA kernel is held to)."""

from __future__ import annotations

import torch


# bags per step: one step's [bags, K, D] fp32 gather is 1 GiB at K 16, D 256
CHUNK = 1 << 16
# entries per partial sum in the table gradient: a row's sorted run is cut
# into chunks of RUN_CHUNK, each summed alone, then the partials in order
# (the backward kernels take the same value as an argument). 64, 128 and
# 256 timed equal within noise at the two-tower item table (PERF.md); 128
# was picked among them.
RUN_CHUNK = 128


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


def row_bounds_ref(key_sorted, n_rows: int):
    """Each row's run in ``key_sorted`` (sorted clipped ids, ``n_rows``
    where masked), int32 [n_rows, 2]: ``(lo, hi)`` with
    ``key_sorted[lo:hi] == v``, ``(0, 0)`` where no entry reads row v."""
    bounds = torch.arange(n_rows + 1, dtype=key_sorted.dtype, device=key_sorted.device)
    offsets = torch.searchsorted(key_sorted, bounds, side="left", out_int32=True)
    runs = torch.stack([offsets[:-1], offsets[1:]], -1)
    return torch.where(runs[:, 1:] > runs[:, :1], runs, 0)


def embedding_bag_backward_ref(dout, ids, mask, n_rows: int, *, mode="sum", chunk=RUN_CHUNK):
    """The gradient of ``embedding_bag_ref`` with respect to its table:
    dout [B, D]; ids int [B, K]; mask bool [B, K] -> dtable [n_rows, D] in
    ``dout.dtype``, dense, as ``jax.grad`` of the reference's ``clip`` +
    ``take`` gives it.

    ``dtable[clip(ids[b, j])] += dout[b] / max(count_b, 1)`` (``mode="mean"``;
    ``dout[b]`` for ``"sum"``) over the unmasked ``(b, j)``: a clipped id
    sends its gradient to row 0 or ``n_rows - 1``; masked entries and
    all-masked bags add nothing. Summed in fp32, rounded once, in this
    order: a row's entries in flat (bag, slot) order are cut into chunks
    of ``chunk``; each chunk's partial adds its terms one after another
    from 0 (``index_add_`` into a zero table), and the row adds its
    partials in chunk order from 0."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got {mode!r}")
    B, K = ids.shape
    g = scaled_rows(dout, mask, mode)
    keep = mask.reshape(-1)
    rows = ids.reshape(-1).long().clamp(0, n_rows - 1)[keep]
    bags = torch.arange(B, device=ids.device).repeat_interleave(K)[keep]
    rows, perm = torch.sort(rows, stable=True)  # each row's run in flat order
    bags = bags[perm]
    rank = torch.arange(rows.numel(), device=ids.device) - torch.searchsorted(rows, rows)
    first = rank % chunk == 0  # the first entry of each chunk
    partials = torch.zeros((int(first.sum()), dout.shape[1]), dtype=torch.float32,
                           device=dout.device)
    partials.index_add_(0, torch.cumsum(first, 0) - 1, g[bags])
    out = torch.zeros((n_rows, dout.shape[1]), dtype=torch.float32, device=dout.device)
    out.index_add_(0, rows[first], partials)
    return out.to(dout.dtype)
