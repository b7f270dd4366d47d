"""ctypes binding of the CUDA embedding_bag kernel (``csrc/embedding_bag.cu``).

The source's header says which TPU kernel it replaces and what bounds it.
Launches on PyTorch's current stream and allocates only its output.
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
