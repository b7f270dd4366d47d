"""Public segment_spmm wrapper: sorts the edges by destination into a CSR
(``prepare_edges``), then launches the kernel over it.

A caller that sums over the same edges many times builds the CSR once and
passes it (``segment_spmm(x, csr=csr)``): the PNA forward does so for all
of its segment sums. The ``(x, src, dst, n_nodes, edge_mask)`` form builds
one CSR per call.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the hand-written kernel or raise. There is no fallback between the two.

Where x requires a gradient (and autograd is on), the sum goes through
``SegmentSpmmFn``, whose backward is ``segment_spmm`` of the upstream
gradient over the transposed edge list: ``dx[u]`` sums ``dout[v]`` over
the kept edges that read row u into row v. That is the same kernel over
another CSR (``transpose_csr``), built with the first
(``prepare_edges(..., transpose=True)``): ``segment_spmm`` does so when it
builds the CSR itself, and a caller that passes one under grad must have
built it so.

``launches`` counts kernel launches (never the plain version's calls), so a
run can show that its message passing went through the kernel;
``launches_backward`` counts those made by backward passes (included in
``launches``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda
from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref, segment_spmm_ref
from repro_torch.utils import jax_index

launches = 0
launches_backward = 0

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_LIMIT = 2**31


@dataclass(frozen=True)
class SegmentCSR:
    """Edges sorted by destination: row ``v`` sums ``x[src_sorted[e]]`` over
    ``e`` in ``[offsets[v], offsets[v + 1])``; edges past ``offsets[n_nodes]``
    are dropped. ``src_sorted`` indexes the rows of an ``n_src``-row x."""

    src_sorted: torch.Tensor  # int32 [E]
    offsets: torch.Tensor  # int32 [n_nodes + 1]
    n_nodes: int
    n_src: int
    # the CSR of the transposed kept edges (``transpose_csr``), for the gradient
    transpose: Optional["SegmentCSR"] = None


def transpose_csr(csr: SegmentCSR) -> SegmentCSR:
    """The CSR of ``csr``'s kept edges reversed: its row u sums, over the
    edges that read row u of x, the rows they were summed into, of an
    ``n_nodes``-row tensor (``n_src`` rows). A stable sort again, so each
    row keeps its edges in ``csr``'s order. On the device, as
    ``prepare_edges``. An edge whose source was past the end of x read row
    ``n_src - 1`` (jnp's clamp) and sends its gradient there, where jax's
    scatter would drop it; no caller passes one."""
    E = csr.src_sorted.shape[0]
    pos = torch.arange(E, dtype=torch.int32, device=csr.offsets.device)
    # each sorted edge's row; the dropped edges past offsets[n_nodes] get n_nodes
    row = torch.searchsorted(csr.offsets, pos, right=True).to(torch.int32) - 1
    keep = pos < csr.offsets[-1]
    return prepare_edges(row, csr.src_sorted, csr.n_src, csr.n_nodes, keep)


def prepare_edges(src, dst, n_nodes: int, n_src: int, edge_mask=None, *,
                  transpose: bool = False) -> SegmentCSR:
    """The CSR by destination the kernel walks.

    A stable sort by ``dst`` (as ``jnp.argsort``), so each row keeps its
    edges in their original order. Masked edges and destinations outside
    ``[0, n_nodes)`` get the key ``n_nodes`` first: they sort past
    ``offsets[n_nodes]`` and are dropped, as ``jax.ops.segment_sum`` drops
    them. ``src`` is mapped as ``jnp`` gathers rows of an ``n_src``-row
    ``x``. Everything stays on the device: no value is read on the host.
    With ``transpose``, the CSR carries its transpose for the gradient.
    """
    drop = (dst < 0) | (dst >= n_nodes)
    if edge_mask is not None:
        drop |= ~edge_mask
    key = torch.where(drop, n_nodes, dst.to(torch.int32))
    key_sorted, order = torch.sort(key, stable=True)
    src_sorted = jax_index(src, n_src)[order].to(torch.int32)
    bounds = torch.arange(n_nodes + 1, dtype=torch.int32, device=dst.device)
    offsets = torch.searchsorted(key_sorted, bounds, side="left").to(torch.int32)
    csr = SegmentCSR(src_sorted, offsets, int(n_nodes), int(n_src))
    return dataclasses.replace(csr, transpose=transpose_csr(csr)) if transpose else csr


def csr_sum(x, csr: SegmentCSR, backward: bool = False):
    """``segment_spmm`` of x over ``csr``, checked by the caller: the plain
    version for a CPU tensor, else one counted kernel launch (``backward``
    marks a backward pass's)."""
    global launches, launches_backward
    if x.device.type == "cpu":
        return segment_spmm_csr_ref(x, csr.src_sorted, csr.offsets)
    if csr.n_nodes == 0 or x.shape[1] == 0:
        return torch.zeros((csr.n_nodes, x.shape[1]), dtype=x.dtype, device=x.device)
    out = segment_spmm_cuda(x.contiguous(), csr.src_sorted, csr.offsets)
    launches += 1
    launches_backward += int(backward)
    return out


class SegmentSpmmFn(torch.autograd.Function):
    """``segment_spmm`` over a CSR, with its gradient: ``dx`` is the sum of
    the upstream gradient over the transposed CSR (the same kernel)."""

    @staticmethod
    def forward(ctx, x, csr):
        ctx.csr = csr
        return csr_sum(x, csr)

    @staticmethod
    def backward(ctx, dout):
        return csr_sum(dout.contiguous(), ctx.csr.transpose, backward=True), None


def segment_spmm(x, src=None, dst=None, n_nodes=None, edge_mask=None, *, csr=None):
    """``out[v] = sum over e with dst[e] == v (and edge_mask[e]) of
    x[src[e]]``: x [N_x, D] fp32 or bf16, src/dst [E] int, edge_mask [E]
    bool or None. Returns [n_nodes, D] (``n_nodes`` defaults to N_x) in
    ``x.dtype``, summed in fp32. Exact for any degree.

    With ``csr`` (a ``SegmentCSR`` that ``prepare_edges`` built for x's
    rows) in place of ``src`` .. ``edge_mask``, the sums run over it and
    nothing is sorted."""
    if csr is not None:
        if src is not None or dst is not None or n_nodes is not None or edge_mask is not None:
            raise ValueError("segment_spmm: pass either csr or src/dst/n_nodes/edge_mask")
        if x.shape[0] != csr.n_src:
            raise ValueError(f"segment_spmm: the csr indexes {csr.n_src} rows of x, got "
                             f"{x.shape[0]}")
    elif src is None or dst is None:
        raise ValueError("segment_spmm: src and dst are required without a csr")
    dev = x.device
    grad = torch.is_grad_enabled() and x.requires_grad
    if csr is not None and grad and csr.transpose is None:
        raise ValueError("segment_spmm: a gradient walks the csr's transpose; build it with "
                         "prepare_edges(..., transpose=True)")
    n = x.shape[0] if n_nodes is None else int(n_nodes)
    if dev.type == "cpu":
        if csr is None and not grad:
            return segment_spmm_ref(x, src, dst, n_nodes, edge_mask)
    elif dev.type != "cuda":
        raise ValueError(f"segment_spmm: unsupported device {dev}")
    else:
        if x.dim() != 2 or x.dtype not in _DTYPES:
            raise ValueError(f"segment_spmm: x must be a 2-d float32 or bfloat16 tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if csr is None:
            E = src.shape[0]
            if (src.shape != (E,) or dst.shape != (E,) or src.device != dev
                    or dst.device != dev):
                raise ValueError(f"segment_spmm: src and dst must be [E] on {dev}, got "
                                 f"{tuple(src.shape)} on {src.device} and {tuple(dst.shape)} "
                                 f"on {dst.device}")
            if edge_mask is not None and (edge_mask.shape != (E,)
                                          or edge_mask.dtype != torch.bool
                                          or edge_mask.device != dev):
                raise ValueError(f"segment_spmm: edge_mask must be a bool [E] on {dev}")
        else:
            n, E = csr.n_nodes, csr.src_sorted.shape[0]
            if (csr.offsets.shape != (n + 1,) or csr.src_sorted.dim() != 1
                    or any(t.dtype != torch.int32 or t.device != dev or not t.is_contiguous()
                           for t in (csr.src_sorted, csr.offsets))):
                raise ValueError(f"segment_spmm: csr must hold contiguous int32 src_sorted "
                                 f"[E] and offsets [{n + 1}] on {dev}")
        if E >= _INDEX_LIMIT or n >= _INDEX_LIMIT or x.shape[0] >= _INDEX_LIMIT:
            raise ValueError(f"segment_spmm: E={E}, n_nodes={n} and N_x={x.shape[0]} "
                             "must each be below 2^31 (int32 indices)")
        if n < 0 or (E and x.shape[0] == 0):
            raise ValueError(f"segment_spmm: n_nodes={n} with x of {x.shape[0]} rows")
        if n == 0 or x.shape[1] == 0:
            return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=dev)
    if csr is None:
        csr = prepare_edges(src, dst, n, x.shape[0], edge_mask, transpose=grad)
    return SegmentSpmmFn.apply(x, csr) if grad else csr_sum(x, csr)
