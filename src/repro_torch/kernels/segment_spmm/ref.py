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


def segment_spmm_csr_ref(x, src_sorted, offsets):
    """``out[v] = sum of x[src_sorted[e]]`` over ``e`` in ``[offsets[v],
    offsets[v + 1])``, [len(offsets) - 1, D]: the function the kernel
    computes over a CSR that ``prepare_edges`` built. Edges past
    ``offsets[-1]`` are dropped. Accumulates in fp32 and returns
    ``x.dtype``."""
    n = offsets.shape[0] - 1
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), counts)
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, x[src_sorted[: rows.shape[0]].to(torch.int64)].to(torch.float32))
    return out.to(x.dtype)
