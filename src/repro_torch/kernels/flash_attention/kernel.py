"""ctypes bindings of the CUDA flash_attention kernels.

``csrc/flash_attention.cu``, the forward: one entry point, which launches
the bf16 tensor-core kernel for bf16 tensors and the fp32 SIMT kernel for
fp32, and writes the row log-sum-exp too when given a buffer for it.
``csrc/flash_attention_bwd.cu``, the backward: one entry point, which
launches its dq kernel and then its dk / dv kernel, on the tensor cores for
bf16 tensors and as SIMT kernels for fp32.

The sources' headers say what they replace and what bounds them. Each
launches on PyTorch's current stream and allocates only its outputs (and
the backward's [B, H, Sq] scratch).
"""

from __future__ import annotations

import struct

import torch

from repro_torch.kernels import _build


def _scale_bits(dh: int) -> int:
    """The softmax scale as the fp32 that torch's ``q * dh**-0.5``
    multiplies by, as the int of its bits."""
    return struct.unpack("<i", struct.pack("<f", dh**-0.5))[0]


def flash_attention_cuda(q, k, v, *, causal: bool, window: int, q_offset: int,
                         with_lse: bool = False):
    """[B, Sq, H, dh] attention of q [B, Sq, H, dh] over k, v [B, Sk, KV,
    dh]; ``window`` <= 0 is none. With ``with_lse``, returns ``(out,
    lse)``, lse [B, H, Sq] fp32 the row log-sum-exp of the scaled scores."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    fn = _build.bind("flash_attention", "flash_attention_launch", 5, 11)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Sk, H, KV, dh, int(causal), int(window), int(q_offset), _scale_bits(dh),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", err)
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool, window: int, q_offset: int):
    """``(dq, dk, dv)`` of the attention ``o`` of q, k, v (shapes as the
    forward's; ``do`` like ``o``; ``lse`` [B, H, Sq] fp32 the forward's),
    in the inputs' dtype."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attention_bwd", "flash_attention_bwd_launch", 10, 11)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B, Sq, Sk, H, KV, dh, int(causal), int(window), int(q_offset), _scale_bits(dh),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention_bwd", err)
    return dq, dk, dv
