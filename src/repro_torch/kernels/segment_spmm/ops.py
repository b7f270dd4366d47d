"""Public segment_spmm wrapper: sorts the edges by destination into a CSR,
then launches the kernel over it.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the hand-written kernel or raise. There is no fallback between the two.
``launches`` counts kernel launches (never the plain version's calls), so a
run can show that its message passing went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
from repro_torch.utils import jax_index

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_LIMIT = 2**31


def prepare_edges(src, dst, n_nodes: int, n_src: int, edge_mask=None):
    """The CSR by destination the kernel walks: ``(src_sorted int32 [E],
    offsets int32 [n_nodes + 1])``.

    A stable sort by ``dst`` (as ``jnp.argsort``), so each row keeps its
    edges in their original order. Masked edges and destinations outside
    ``[0, n_nodes)`` get the key ``n_nodes`` first: they sort past
    ``offsets[n_nodes]`` and are dropped, as ``jax.ops.segment_sum`` drops
    them. ``src`` is mapped as ``jnp`` gathers rows of an ``n_src``-row
    ``x``. Everything stays on the device: no value is read on the host.
    """
    drop = (dst < 0) | (dst >= n_nodes)
    if edge_mask is not None:
        drop |= ~edge_mask
    key = torch.where(drop, n_nodes, dst.to(torch.int32))
    key_sorted, order = torch.sort(key, stable=True)
    src_sorted = jax_index(src, n_src)[order].to(torch.int32)
    bounds = torch.arange(n_nodes + 1, dtype=torch.int32, device=dst.device)
    offsets = torch.searchsorted(key_sorted, bounds, side="left").to(torch.int32)
    return src_sorted, offsets


def segment_spmm(x, src, dst, n_nodes=None, edge_mask=None):
    """``out[v] = sum over e with dst[e] == v (and edge_mask[e]) of
    x[src[e]]``: x [N_x, D] fp32 or bf16, src/dst [E] int, edge_mask [E]
    bool or None. Returns [n_nodes, D] (``n_nodes`` defaults to N_x) in
    ``x.dtype``, summed in fp32. Exact for any degree."""
    global launches
    dev = x.device
    if dev.type == "cpu":
        return segment_spmm_ref(x, src, dst, n_nodes, edge_mask)
    if dev.type != "cuda":
        raise ValueError(f"segment_spmm: unsupported device {dev}")
    n = x.shape[0] if n_nodes is None else int(n_nodes)
    E = src.shape[0]
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"segment_spmm: x must be a 2-d float32 or bfloat16 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if src.shape != (E,) or dst.shape != (E,) or src.device != dev or dst.device != dev:
        raise ValueError(f"segment_spmm: src and dst must be [E] on {dev}, got "
                         f"{tuple(src.shape)} on {src.device} and {tuple(dst.shape)} on {dst.device}")
    if edge_mask is not None and (edge_mask.shape != (E,) or edge_mask.dtype != torch.bool
                                  or edge_mask.device != dev):
        raise ValueError(f"segment_spmm: edge_mask must be a bool [E] on {dev}")
    if E >= _INDEX_LIMIT or n >= _INDEX_LIMIT or x.shape[0] >= _INDEX_LIMIT:
        raise ValueError(f"segment_spmm: E={E}, n_nodes={n} and N_x={x.shape[0]} "
                         "must each be below 2^31 (int32 indices)")
    if n < 0 or (E and x.shape[0] == 0):
        raise ValueError(f"segment_spmm: n_nodes={n} with x of {x.shape[0]} rows")
    if n == 0 or x.shape[1] == 0:
        return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=dev)
    src_sorted, offsets = prepare_edges(src, dst, n, x.shape[0], edge_mask)
    out = segment_spmm_cuda(x.contiguous(), src_sorted, offsets)
    launches += 1
    return out
