"""ctypes bindings of the CUDA embedding_bag kernels: the forward
(``csrc/embedding_bag.cu``) and the table gradient
(``csrc/embedding_bag_bwd.cu``).

The sources' headers say what each replaces and what bounds it. Each
launches on PyTorch's current stream and allocates only its output.
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


def embedding_bag_bwd_cuda(g, order, offsets, k: int, dtype):
    """The dense table gradient [V, D] in ``dtype`` (fp32 or bf16), V =
    ``offsets.numel() - 1``: row v sums ``g[order[e] // k]`` over e in
    ``[offsets[v], offsets[v + 1])`` in that order, in fp32. ``g`` fp32 [B, D]
    (dout scaled by each bag's denominator), ``order`` int32 [B*k] (flat
    (bag, slot) positions sorted by row), ``offsets`` int32 [V + 1]."""
    V, D = offsets.shape[0] - 1, g.shape[1]
    out = torch.empty((V, D), dtype=dtype, device=g.device)
    fn = _build.bind("embedding_bag_bwd", "embedding_bag_bwd_launch", 4, 4)
    err = fn(
        g.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        V, k, D, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check("embedding_bag_bwd", err)
    return out
