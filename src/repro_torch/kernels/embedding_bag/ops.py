"""Public embedding_bag wrapper.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the hand-written kernel or raise. There is no fallback between the two.
``launches`` counts kernel launches (never the plain version's calls), so a
run can show that its towers went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_LIMIT = 2**31


def embedding_bag(table, ids, mask, *, mode="sum"):
    """table [V, D] fp32 or bf16; ids int32 [B, K]; mask bool [B, K].
    Returns [B, D] in ``table.dtype``: the sum (``mode="sum"``) or mean
    (``"mean"``, over the unmasked count, at least 1) of the rows of the
    unmasked ids, each clipped to ``[0, V-1]``, summed in fp32 in bag order."""
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


def check_args(table, ids, mask, mode):
    """Raises ValueError on what the kernel does not take: another mode, a
    table that is not a contiguous 2-d fp32 / bf16 tensor, ids or a mask
    that are not contiguous int32 / bool [B, K] on the table's device, or a
    size past the kernel's int32 arguments (V must be at least 1)."""
    dev = table.device
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got {mode!r}")
    if table.dim() != 2 or table.dtype not in _DTYPES or not table.is_contiguous():
        raise ValueError(f"embedding_bag: table must be a contiguous 2-d float32 or bfloat16 "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    if ids.dim() != 2 or ids.dtype != torch.int32 or ids.device != dev or not ids.is_contiguous():
        raise ValueError(f"embedding_bag: ids must be a contiguous int32 [B, K] on {dev}, "
                         f"got {ids.dtype} {tuple(ids.shape)} on {ids.device}")
    if (mask.shape != ids.shape or mask.dtype != torch.bool or mask.device != dev
            or not mask.is_contiguous()):
        raise ValueError(f"embedding_bag: mask must be a contiguous bool {tuple(ids.shape)} "
                         f"on {dev}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    (V, D), (B, K) = table.shape, ids.shape
    if max(V, D, B, K) >= _INDEX_LIMIT or V == 0:
        raise ValueError(f"embedding_bag: V={V}, D={D}, B={B}, K={K} must each be in "
                         "[1, 2^31) (V) or [0, 2^31)")
