"""Public flash_attention wrapper, in the LM layout, with its gradient.

CPU tensors take the plain PyTorch versions (``ref.py``); CUDA tensors
launch a hand-written kernel or raise. The dtype picks the kernels, forward
and backward: bf16 runs on the tensor cores (wgmma, TMA-staged tiles),
fp32 on the SIMT kernels (tensor cores would be TF32). There is no
fallback between them.

Where q, k or v requires a gradient (and autograd is on), the call goes
through ``FlashAttentionFn``: its forward also writes the row log-sum-exp,
and its backward launches the backward kernels (``csrc/flash_attention_bwd.cu``;
on the CPU, ``flash_attention_bwd_ref``). Otherwise, as in prefill, the
forward writes no lse.

Launch counters (kernel launches only, never the plain versions' calls),
so a run can show that its attention went through the kernels:
``launches`` every forward launch, split by route into ``launches_bf16_tc``
and ``launches_f32_simt`` and by purpose into ``launches_fwd_lse`` (the
autograd path's, remat recomputations included); ``launches_bwd`` one per
backward call, which launches the dq kernel and then the dk / dv kernel.
The kernels' tiles are their own constants: the reference's ``q_chunk`` /
``k_chunk`` have no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

launches = 0
launches_bf16_tc = 0
launches_f32_simt = 0
launches_fwd_lse = 0
launches_bwd = 0

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_LIMIT = 2**31
_GRID_LIMIT = 65535  # heads and batch ride the grid's y and z


def _check(q, k, v):
    """Raises on what the kernels do not take."""
    dev = q.device
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
    if q.dtype == torch.bfloat16 and not all(map(_aligned, (q, k, v))):
        # TMA reads from 16-byte aligned bases only; a contiguous view can
        # start mid-row
        raise ValueError("flash_attention: bf16 q, k and v must start on 16-byte boundaries")


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def _check_grads(q, o, do, lse):
    """Raises on an ``o``, ``do`` or ``lse`` the backward kernels do not
    take: ``o`` and ``do`` as q (the bf16 kernels read both by TMA or
    16-byte loads, so they must start on 16-byte boundaries too)."""
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be a contiguous "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
        if q.dtype == torch.bfloat16 and not _aligned(t):
            raise ValueError(f"flash_attention backward: bf16 {name} must start on a 16-byte "
                             "boundary")
    B, Sq, H, _ = q.shape
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention backward: lse must be a contiguous float32 "
                         f"[{B}, {H}, {Sq}] on {q.device}")


def _forward(q, k, v, causal, window, q_offset, with_lse):
    """The forward on q's device: the plain version on the CPU, else a
    kernel launch (counted). ``(out, lse or None)``."""
    global launches, launches_bf16_tc, launches_f32_simt, launches_fwd_lse
    dev = q.device
    if dev.type == "cpu":
        res = flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                  with_lse=with_lse)
        return res if with_lse else (res, None)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    if B == 0 or Sq == 0:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) if with_lse else None
        return torch.empty_like(q), lse
    w = 0 if window is None else max(int(window), 0)
    res = flash_attention_cuda(q, k, v, causal=bool(causal), window=w, q_offset=int(q_offset),
                               with_lse=with_lse)
    out, lse = res if with_lse else (res, None)
    launches += 1
    if q.dtype == torch.bfloat16:
        launches_bf16_tc += 1
    else:
        launches_f32_simt += 1
    if with_lse:
        launches_fwd_lse += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=None, q_offset=0):
    """``(dq, dk, dv)`` of ``o = flash_attention(q, k, v, ...)`` for the
    upstream gradient ``do`` (like ``o``), from the forward's ``lse``
    [B, H, Sq] fp32; in the inputs' dtype. The plain version on the CPU,
    the backward kernels on CUDA (one counted launch of the pair)."""
    global launches_bwd
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window,
                                       q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    _check_grads(q, o, do, lse)
    B, Sq = q.shape[:2]
    if B == 0 or Sq == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    w = 0 if window is None else max(int(window), 0)
    out = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=bool(causal), window=w,
                                   q_offset=int(q_offset))
    launches_bwd += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient: the forward saves q, k, v, the output
    and its lse; the backward runs ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _forward(q, k, v, causal, window, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dout = dout.contiguous()
        if not _aligned(dout):  # a contiguous view autograd hands over may start mid-row
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                         window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q [B, Sq, H, dh]; k, v [B, Sk, KV, dh] with H a multiple of KV
    (query head h reads KV head h // (H // KV)); fp32 or bf16, one dtype;
    dh <= 256, a multiple of 8. Query row i sits at position ``q_offset +
    i``; ``window`` None or <= 0 is none. Returns [B, Sq, H, dh] in q's
    dtype; differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset, with_lse=False)[0]
