"""Int8 gradient compression with error feedback.

PyTorch twin of ``repro.optim.compression``: each gradient, plus its
residual, is cut into blocks of ``BLOCK`` values, quantized to int8 with
the block's abs-max / 127 as its scale, and dequantized; what the
roundtrip lost is the next step's residual, so the optimizer sees every
part of the gradient in the long run. On one card there is no collective
to shrink: the roundtrip is the whole of it, as the reference's is outside
``shard_map``.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten

BLOCK = 256


def _quant_one(g, r):
    g32 = g.to(torch.float32) + (r.to(torch.float32) if r is not None else 0.0)
    flat = g32.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale).reshape(-1)[: g32.numel()].reshape(g32.shape)
    return deq.to(g.dtype), (g32 - deq).to(torch.float32)


def int8_compress_grads(grads, residuals=None):
    """Per-block int8 quantization roundtrip + error-feedback residuals:
    ``(dequantized grads in their dtypes, fp32 residuals)``."""
    flat_g = tree_leaves(grads)
    flat_r = [None] * len(flat_g) if residuals is None else tree_leaves(residuals)
    out = [_quant_one(g, r) for g, r in zip(flat_g, flat_r)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
