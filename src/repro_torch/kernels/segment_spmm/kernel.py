"""ctypes binding of the CUDA segment_spmm kernel (``csrc/segment_spmm.cu``).

The source's header says which TPU kernel it replaces and what bounds it.
Launches on PyTorch's current stream and allocates only its output.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def segment_spmm_cuda(x, src_sorted, offsets):
    """``out[v] = sum of x[src_sorted[e]]`` over ``e`` in
    ``[offsets[v], offsets[v + 1])``, for the ``len(offsets) - 1`` rows."""
    n, d = offsets.shape[0] - 1, x.shape[1]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    fn = _build.bind("segment_spmm", "segment_spmm_launch", 4, 3)
    err = fn(
        x.data_ptr(), src_sorted.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        n, d, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("segment_spmm", err)
    return out
