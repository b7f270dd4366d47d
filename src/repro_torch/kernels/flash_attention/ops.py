"""Public flash_attention wrapper, in the LM layout.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
a hand-written kernel or raise. The dtype picks the kernel: bf16 runs on the
tensor cores (wgmma, TMA-staged tiles), fp32 on the SIMT kernel (tensor
cores would be TF32). There is no fallback between the three.
``launches`` counts kernel launches (never the plain version's calls), so a
run can show that its prefill went through the kernel; ``launches_bf16_tc``
and ``launches_f32_simt`` split it by route. The kernels' tiles are their own
constants: the reference's ``q_chunk`` / ``k_chunk`` have no counterpart
here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

launches = 0
launches_bf16_tc = 0
launches_f32_simt = 0

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_LIMIT = 2**31
_GRID_LIMIT = 65535  # heads and batch ride the grid's y and z


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q [B, Sq, H, dh]; k, v [B, Sk, KV, dh] with H a multiple of KV
    (query head h reads KV head h // (H // KV)); fp32 or bf16, one dtype;
    dh <= 256, a multiple of 8. Query row i sits at position ``q_offset +
    i``; ``window`` None or <= 0 is none. Returns [B, Sq, H, dh] in q's
    dtype."""
    global launches, launches_bf16_tc, launches_f32_simt
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype != q.dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous 4-d {q.dtype} "
                             f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype must be float32 or bfloat16, got {q.dtype}")
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be [B={B}, Sk, KV, dh={dh}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads over {KV} KV heads")
    if dh > 256 or dh % 8:
        raise ValueError(f"flash_attention: head dim {dh} must be a multiple of 8, at most 256")
    if max(q.numel(), k.numel()) >= _INDEX_LIMIT or max(H, B) > _GRID_LIMIT:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} / k {tuple(k.shape)} exceed "
                         "the kernel's index range")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        # TMA reads from 16-byte aligned bases only; a contiguous view can
        # start mid-row
        raise ValueError("flash_attention: bf16 q, k and v must start on 16-byte boundaries")
    w = 0 if window is None else int(window)
    q_offset = int(q_offset)
    if B == 0 or Sq == 0:
        return torch.empty_like(q)
    out = flash_attention_cuda(q, k, v, causal=bool(causal), window=max(w, 0),
                               q_offset=q_offset)
    launches += 1
    if q.dtype == torch.bfloat16:
        launches_bf16_tc += 1
    else:
        launches_f32_simt += 1
    return out
