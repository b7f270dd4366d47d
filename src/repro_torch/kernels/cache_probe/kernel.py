"""ctypes binding of the CUDA cache_probe kernel (``csrc/cache_probe.cu``).

The source's header says which TPU kernel it replaces and what bounds it.
Launches on PyTorch's current stream and allocates only its outputs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def cache_probe_cuda(c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp, *, probes):
    B, C = tpl.shape[0], c_tpl.shape[0]
    hit = torch.empty(B, dtype=torch.bool, device=tpl.device)
    slot = torch.empty(B, dtype=torch.int32, device=tpl.device)
    fn = _build.bind("cache_probe", "cache_probe_launch", 10, 3)
    err = fn(
        c_tpl.data_ptr(), c_root.data_ptr(), c_fp.data_ptr(), c_valid.data_ptr(),
        tpl.data_ptr(), root.data_ptr(), h.data_ptr(), fp.data_ptr(),
        hit.data_ptr(), slot.data_ptr(), B, C, probes,
        torch.cuda.current_stream(tpl.device).cuda_stream,
    )
    _build.check("cache_probe", err)
    return hit, slot
