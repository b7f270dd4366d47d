"""Public embedding_bag wrappers: the bag forward and, where the table
takes a gradient, its backward.

CPU tensors take the plain PyTorch versions (``ref.py``); CUDA tensors
launch the hand-written kernels or raise. There is no fallback between the
two.

Where the table requires a gradient (and autograd is on), the bags go
through ``EmbeddingBagFn``, whose backward is ``embedding_bag_backward``:
the dense table gradient, ``dtable[clip(id)] += dout[bag] / max(cnt, 1)``
over the unmasked entries. The reference takes that gradient by autodiff
through ``jnp.take``; the port's is three kernels over the entries sorted
by row once (``prepare_rows``): each row's run found in one pass over the
sorted keys, then the runs cut into chunks of ``RUN_CHUNK`` entries. One
warp a chunk of a long run sums it into a partial; then one warp a group
of 32 rows adds each short run, or each long run's partials in chunk
order, so a Zipf head's run no longer rests on one warp. No atomics: two
calls are equal bit for bit, and to the plain version, which adds in the
same chunked order.

``launches`` counts the wrappers' kernel calls (never the plain versions'
calls), so a run can show that its towers went through the kernels;
``launches_backward`` counts those made by backward passes (included in
``launches``), each of which launches ``BWD_KERNELS`` kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import plain_device, shape_run
from repro_torch.kernels.embedding_bag.kernel import (embedding_bag_bwd_cuda, embedding_bag_cuda,
                                                     row_bounds_cuda)
from repro_torch.kernels.embedding_bag.ref import (RUN_CHUNK, embedding_bag_backward_ref,
                                                  embedding_bag_ref, row_bounds_ref, scaled_rows)

launches = 0
launches_backward = 0

BWD_KERNELS = 3  # the row bounds, the chunk pass and the row pass
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
    if plain_device(dev):
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


class RowPlan(NamedTuple):
    """The entries of a batch sorted by the table row they read, and the
    chunks of the runs longer than the chunk size C (``prepare_rows``).

    order int32 [N]: the flat positions ``b*K + j`` (N = B*K) in a stable
    sort by clipped id, masked entries last. bounds int32 [n_rows, 2]: row
    v's entries at ``order[lo:hi]``, ``(lo, hi) = bounds[v]``, ``(0, 0)``
    for a row no entry reads. A run longer than C is cut into chunks of C
    consecutive entries (the last may be shorter); the chunks of all such
    runs, in sorted order, take the slots 0, 1, ...: slot_start int32 [S]
    is a chunk's first sorted position and slot_row int32 [S] its row; the
    idle slots past the used ones hold N and ``n_rows`` (S = ``n_slots(N,
    C)``, an upper bound). chunk_rank int32 [N]: the chunks that start at
    or before each sorted position, so a long run starting at ``lo`` has its
    first chunk in slot ``chunk_rank[lo] - 1``."""
    order: torch.Tensor
    bounds: torch.Tensor
    chunk_rank: torch.Tensor
    slot_row: torch.Tensor
    slot_start: torch.Tensor


def n_slots(n_entries: int, chunk: int) -> int:
    """Chunk slots for n entries: a run longer than C has ceil(len / C) <
    len / C + 1 < 2 len / C chunks, so all long runs together have fewer
    than 2 n / C."""
    return 2 * -(-n_entries // chunk)


def sorted_keys(ids, mask, n_rows: int):
    """(the sorted keys, order): each entry's clipped id, ``n_rows`` where
    masked, in a stable sort."""
    flat = ids.reshape(-1).clamp(0, n_rows - 1).to(torch.int32)
    key = torch.where(mask.reshape(-1), flat, n_rows)
    key_sorted, order = torch.sort(key, stable=True)
    return key_sorted, order.to(torch.int32)


def row_bounds(key_sorted, n_rows: int):
    """``RowPlan.bounds`` from the sorted keys: on the card one pass over
    them (``row_bounds_cuda``), on the CPU the plain version."""
    if plain_device(key_sorted.device):
        return row_bounds_ref(key_sorted, n_rows)
    return row_bounds_cuda(key_sorted, n_rows)


def chunk_table(key_sorted, bounds, n_rows: int, chunk: int):
    """(chunk_rank, slot_row, slot_start) of ``RowPlan``, from one pass over
    the sorted entries: a position starts a chunk where its run is longer
    than ``chunk`` and its rank in the run is a multiple of ``chunk``."""
    n, dev = key_sorted.numel(), key_sorted.device
    lo, hi = bounds[key_sorted.clamp(max=n_rows - 1)].unbind(-1)
    rank = torch.arange(n, dtype=torch.int32, device=dev) - lo
    starts = (key_sorted < n_rows) & (hi - lo > chunk) & (rank % chunk == 0)
    chunk_rank = torch.cumsum(starts, 0, dtype=torch.int32)
    slots = torch.arange(1, n_slots(n, chunk) + 1, dtype=torch.int32, device=dev)
    slot_start = torch.searchsorted(chunk_rank, slots, side="left", out_int32=True)  # N: idle
    slot_row = torch.where(slot_start < n, key_sorted[slot_start.clamp(max=max(n - 1, 0))],
                           n_rows)
    return chunk_rank, slot_row, slot_start


def prepare_rows(ids, mask, n_rows: int, *, chunk=RUN_CHUNK) -> RowPlan:
    """The ``RowPlan`` of a batch for the backward kernels, chunks of
    ``chunk`` entries. On the device, fixed shapes, no host read, as
    ``segment_spmm.prepare_edges``."""
    key_sorted, order = sorted_keys(ids, mask, n_rows)
    bounds = row_bounds(key_sorted, n_rows)
    return RowPlan(order, bounds, *chunk_table(key_sorted, bounds, n_rows, chunk))


def embedding_bag_backward(dout, ids, mask, n_rows: int, *, mode="sum"):
    """The gradient of ``embedding_bag`` with respect to its [n_rows, D]
    table: dout [B, D] fp32 or bf16 (the table's dtype); ids int32 [B, K];
    mask bool [B, K]. Returns the dense [n_rows, D] gradient in
    ``dout.dtype``: each row sums, in fp32, ``dout[b] / max(count_b, 1)``
    (mean) or ``dout[b]`` (sum) over the unmasked entries that read it,
    clipped ids included, in the plain version's order (chunks of
    ``RUN_CHUNK`` entries in sorted (bag, slot) order, then their partials
    in order); a row no entry reads is zero. On the card three launches on
    the current stream (the row bounds, the chunk pass, the row pass), no
    host read."""
    global launches, launches_backward
    dev = dout.device
    if shape_run(dev):
        return dout.new_empty((n_rows, dout.shape[1]))
    if plain_device(dev):
        return embedding_bag_backward_ref(dout, ids, mask, n_rows, mode=mode, chunk=RUN_CHUNK)
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
    plan = prepare_rows(ids, mask, n_rows, chunk=RUN_CHUNK)
    out = embedding_bag_bwd_cuda(scaled_rows(dout, mask, mode), plan, K, dout.dtype,
                                 chunk=RUN_CHUNK)
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
