"""ctypes binding of the CUDA flash_attention kernels
(``csrc/flash_attention.cu``): one entry point, which launches the bf16
tensor-core kernel for bf16 tensors and the fp32 SIMT kernel for fp32.

The source's header says which TPU kernel they replace and what bounds
them. Launches on PyTorch's current stream and allocates only its output.
"""

from __future__ import annotations

import struct

import torch

from repro_torch.kernels import _build


def flash_attention_cuda(q, k, v, *, causal: bool, window: int, q_offset: int):
    """[B, Sq, H, dh] attention of q [B, Sq, H, dh] over k, v [B, Sk, KV,
    dh]; ``window`` <= 0 is none."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    # the softmax scale as the fp32 that torch's ``q * dh**-0.5`` multiplies by
    scale_bits = struct.unpack("<i", struct.pack("<f", dh**-0.5))[0]
    fn = _build.bind("flash_attention", "flash_attention_launch", 4, 11)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, dh, int(causal), int(window), int(q_offset), scale_bits,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", err)
    return out
