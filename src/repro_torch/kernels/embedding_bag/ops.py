"""Public embedding_bag wrappers: the bag forward and, where the table
takes a gradient, its backward.

CPU tensors take the plain PyTorch versions (``ref.py``); CUDA tensors
launch the hand-written kernels or raise. There is no fallback between the
two.

Where the table requires a gradient (and autograd is on), the bags go
through ``EmbeddingBagFn``, whose backward is ``embedding_bag_backward``:
the dense table gradient, ``dtable[clip(id)] += dout[bag] / max(cnt, 1)``
over the unmasked entries. The reference takes that gradient by autodiff
through ``jnp.take``; the port's is a kernel of its own over the entries
sorted by row once (``prepare_rows``), with no atomics, so two calls are
equal bit for bit.

``launches`` counts kernel launches (never the plain versions' calls), so
a run can show that its towers went through the kernels;
``launches_backward`` counts those made by backward passes (included in
``launches``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_bwd_cuda, embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_backward_ref, embedding_bag_ref,
                                                  scaled_rows)

launches = 0
launches_backward = 0

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_LIMIT = 2**31


def embedding_bag(table, ids, mask, *, mode="sum"):
    """table [V, D] fp32 or bf16; ids int32 [B, K]; mask bool [B, K].
    Returns [B, D] in ``table.dtype``: the sum (``mode="sum"``) or mean
    (``"mean"``, over the unmasked count, at least 1) of the rows of the
    unmasked ids, each clipped to ``[0, V-1]``, summed in fp32 in bag order.
    Differentiable in ``table`` (``EmbeddingBagFn``)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBagFn.apply(table, ids, mask, mode)
    return _bags(table, ids, mask, mode)


def _bags(table, ids, mask, mode):
    global launches
    dev = table.device
    if dev.type == "cpu":
        return embedding_bag_ref(table, ids, mask, mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {dev}")
    check_args(table, ids, mask, mode)
    (V, D), (B, K) = table.shape, ids.shape
    if B == 0 or D == 0:
        return torch.zeros((B, D), dtype=table.dtype, device=dev)
    out = embedding_bag_cuda(table, ids, mask, mean=mode == "mean")
    launches += 1
    return out


class EmbeddingBagFn(torch.autograd.Function):
    """``embedding_bag`` with its table gradient (``embedding_bag_backward``);
    ids and mask take none."""

    @staticmethod
    def forward(ctx, table, ids, mask, mode):
        ctx.save_for_backward(ids, mask)
        ctx.n_rows, ctx.mode = table.shape[0], mode
        return _bags(table.detach(), ids, mask, mode)

    @staticmethod
    def backward(ctx, dout):
        ids, mask = ctx.saved_tensors
        grad = embedding_bag_backward(dout.contiguous(), ids, mask, ctx.n_rows, mode=ctx.mode)
        return grad, None, None, None


def prepare_rows(ids, mask, n_rows: int):
    """The entries sorted by the table row they read, for the backward
    kernel: (order int32 [B*K], the flat positions ``b*K + j`` in a stable
    sort by clipped id; offsets int32 [n_rows + 1], row v's entries at
    ``order[offsets[v]:offsets[v + 1]]``). Masked entries get the key
    ``n_rows``: they sort past ``offsets[n_rows]`` and add nothing. On the
    device, with no host read, as ``segment_spmm.prepare_edges``."""
    flat = ids.reshape(-1).clamp(0, n_rows - 1).to(torch.int32)
    key = torch.where(mask.reshape(-1), flat, n_rows)
    key_sorted, order = torch.sort(key, stable=True)
    bounds = torch.arange(n_rows + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(key_sorted, bounds, side="left").to(torch.int32)
    return order.to(torch.int32), offsets


def embedding_bag_backward(dout, ids, mask, n_rows: int, *, mode="sum"):
    """The gradient of ``embedding_bag`` with respect to its [n_rows, D]
    table: dout [B, D] fp32 or bf16 (the table's dtype); ids int32 [B, K];
    mask bool [B, K]. Returns the dense [n_rows, D] gradient in
    ``dout.dtype``: each row sums, in fp32 and in sorted (bag, slot) order,
    ``dout[b] / max(count_b, 1)`` (mean) or ``dout[b]`` (sum) over the
    unmasked entries that read it, clipped ids included; a row no entry
    reads is zero."""
    global launches, launches_backward
    dev = dout.device
    if dev.type == "cpu":
        return embedding_bag_backward_ref(dout, ids, mask, n_rows, mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag backward: unsupported device {dev}")
    B, K = ids.shape
    if dout.dim() != 2 or dout.shape[0] != B or dout.dtype not in _DTYPES \
            or not dout.is_contiguous():
        raise ValueError(f"embedding_bag backward: dout must be a contiguous float32 or "
                         f"bfloat16 [{B}, D], got {dout.dtype} {tuple(dout.shape)}")
    _check_bags(ids, mask, mode, dev)
    _check_sizes(n_rows, dout.shape[1], B, K)
    if B * K >= _INDEX_LIMIT:
        raise ValueError(f"embedding_bag backward: B*K={B * K} must be below 2^31")
    if dout.shape[1] == 0:
        return torch.zeros((n_rows, 0), dtype=dout.dtype, device=dev)
    order, offsets = prepare_rows(ids, mask, n_rows)
    out = embedding_bag_bwd_cuda(scaled_rows(dout, mask, mode), order, offsets, K, dout.dtype)
    launches += 1
    launches_backward += 1
    return out


def check_args(table, ids, mask, mode):
    """Raises ValueError on what the kernels do not take: another mode, a
    table that is not a contiguous 2-d fp32 / bf16 tensor, ids or a mask
    that are not contiguous int32 / bool [B, K] on the table's device, or a
    size past the kernels' int32 arguments (V must be at least 1)."""
    if table.dim() != 2 or table.dtype not in _DTYPES or not table.is_contiguous():
        raise ValueError(f"embedding_bag: table must be a contiguous 2-d float32 or bfloat16 "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    _check_bags(ids, mask, mode, table.device)
    _check_sizes(*table.shape, *ids.shape)


def _check_bags(ids, mask, mode, dev):
    """The mode, and ids and a mask that are contiguous int32 / bool [B, K]
    on ``dev``."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got {mode!r}")
    if ids.dim() != 2 or ids.dtype != torch.int32 or ids.device != dev or not ids.is_contiguous():
        raise ValueError(f"embedding_bag: ids must be a contiguous int32 [B, K] on {dev}, "
                         f"got {ids.dtype} {tuple(ids.shape)} on {ids.device}")
    if (mask.shape != ids.shape or mask.dtype != torch.bool or mask.device != dev
            or not mask.is_contiguous()):
        raise ValueError(f"embedding_bag: mask must be a contiguous bool {tuple(ids.shape)} "
                         f"on {dev}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")


def _check_sizes(V, D, B, K):
    if max(V, D, B, K) >= _INDEX_LIMIT or V == 0:
        raise ValueError(f"embedding_bag: V={V}, D={D}, B={B}, K={K} must each be in "
                         "[1, 2^31) (V) or [0, 2^31)")
