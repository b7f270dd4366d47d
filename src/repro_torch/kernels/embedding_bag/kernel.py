"""ctypes bindings of the CUDA embedding_bag kernels: the forward
(``csrc/embedding_bag.cu``) and the table gradient
(``csrc/embedding_bag_bwd.cu``).

The sources' headers say what each replaces and what bounds it. Each
launches on PyTorch's current stream and allocates only its output (the
backward also its fp32 partials, one row a chunk slot).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def embedding_bag_cuda(table, ids, mask, *, mean: bool):
    """[B, D] in ``table.dtype``: the masked sum (or mean) of the clipped
    rows ``table[ids[b, j]]``. ``ids`` int32 [B, K], ``mask`` bool [B, K]."""
    (V, D), (B, K) = table.shape, ids.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    fn = _build.bind("embedding_bag", "embedding_bag_launch", 4, 6)
    err = fn(
        table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
        V, B, K, D, int(mean), int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check("embedding_bag", err)
    return out


def embedding_bag_bwd_cuda(g, plan, k: int, dtype, *, chunk: int):
    """The dense table gradient [V, D] in ``dtype`` (fp32 or bf16), V =
    ``plan.bounds.shape[0]``: row v sums ``g[plan.order[e] // k]`` over e
    in ``[lo, hi) = bounds[v]`` in fp32, a run longer than
    ``chunk`` as the partials of its chunks (``plan``'s slots, from
    ``prepare_rows`` with the same ``chunk``) added in order. ``g`` fp32
    [B, D] (dout scaled by each bag's denominator)."""
    V, D = plan.bounds.shape[0], g.shape[1]
    S = plan.slot_row.shape[0]
    out = torch.empty((V, D), dtype=dtype, device=g.device)
    partials = torch.empty((S, D), dtype=torch.float32, device=g.device)
    fn = _build.bind("embedding_bag_bwd", "embedding_bag_bwd_launch", 8, 6)
    err = fn(
        g.data_ptr(), plan.order.data_ptr(), plan.bounds.data_ptr(),
        plan.chunk_rank.data_ptr(), plan.slot_row.data_ptr(), plan.slot_start.data_ptr(),
        partials.data_ptr(), out.data_ptr(),
        V, S, k, D, chunk, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check("embedding_bag_bwd", err)
    return out


def row_bounds_cuda(key_sorted, n_rows: int):
    """int32 [n_rows, 2]: each row's run ``(lo, hi)`` in ``key_sorted``
    (int32, sorted clipped ids, ``n_rows`` where masked), ``(0, 0)`` where
    empty, from one pass over the keys."""
    bounds = torch.zeros((n_rows, 2), dtype=torch.int32, device=key_sorted.device)
    fn = _build.bind("embedding_bag_bwd", "embedding_bag_bwd_bounds_launch", 2, 2)
    err = fn(key_sorted.data_ptr(), bounds.data_ptr(), key_sorted.numel(), n_rows,
             torch.cuda.current_stream(key_sorted.device).cuda_stream)
    _build.check("embedding_bag_bwd", err)
    return bounds
