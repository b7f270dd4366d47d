"""ctypes binding of the CUDA onehop_gather kernel (``csrc/onehop_gather.cu``).

The source's header says which TPU kernel it replaces and what bounds it.
Launches on PyTorch's current stream and allocates only its outputs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def onehop_gather_cuda(start, deg, dst, eprop, vprop, roots, *, max_deg,
                       edge_val, leaf_val):
    B, V, E = roots.shape[0], start.shape[0], dst.shape[0]
    leaves = torch.empty((B, max_deg), dtype=torch.int32, device=roots.device)
    mask = torch.empty((B, max_deg), dtype=torch.bool, device=roots.device)
    fn = _build.bind("onehop_gather", "onehop_gather_launch", 8, 6)
    err = fn(
        start.data_ptr(), deg.data_ptr(), dst.data_ptr(), eprop.data_ptr(),
        vprop.data_ptr(), roots.data_ptr(), leaves.data_ptr(), mask.data_ptr(),
        B, V, E, max_deg, edge_val, leaf_val,
        torch.cuda.current_stream(roots.device).cuda_stream,
    )
    _build.check("onehop_gather", err)
    return leaves, mask
