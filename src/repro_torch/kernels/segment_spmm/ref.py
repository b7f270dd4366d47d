"""Plain PyTorch version of the segment_spmm kernel (the CPU path and the
yardstick the CUDA kernel is held to)."""

from __future__ import annotations

import torch

from repro_torch.utils import jax_index


def segment_spmm_ref(x, src, dst, n_nodes=None, edge_mask=None):
    """``out[v] = sum over e with dst[e] == v of x[src[e]]``, [n_nodes, D].

    Follows ``jax.ops.segment_sum(x[src], dst, num_segments=n_nodes)``: a
    segment id outside ``[0, n_nodes)`` is dropped (``index_add_`` would
    raise), and ``src`` reads as ``jnp`` gathers (a negative index wraps
    once, then clamps). Edges where ``edge_mask`` is False are dropped too.
    Accumulates in fp32 and returns ``x.dtype``.
    """
    n = x.shape[0] if n_nodes is None else n_nodes
    keep = (dst >= 0) & (dst < n)
    if edge_mask is not None:
        keep &= edge_mask
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    rows = x[jax_index(src[keep], x.shape[0])].to(torch.float32)
    out.index_add_(0, dst[keep].to(torch.int64), rows)
    return out.to(x.dtype)
