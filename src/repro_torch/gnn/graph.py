"""Padded graph batches + segment-op primitives.

PyTorch twin of ``repro.gnn.graph``. Message passing runs directly over an
edge-index list; this IS the SpMM/SDDMM layer of the system. Every segment
*sum* (``scatter_sum``, the sums and counts of ``scatter_mean``,
``degrees``) goes through the ``segment_spmm`` op, which launches the
hand-written kernel on the card, forward and, in training, backward (over
the transposed edge list). Each takes an optional ``csr``, the edges
sorted by destination once (``edge_csr``), so that a forward sorts its
edges once instead of once a sum. Segment max / min and the edge softmax
stay plain torch (``scatter_reduce``), as the reference leaves them to
``jax.ops.segment_max``, and take autograd's gradient (a tie splits it
evenly, as jax's does). All shapes are static (padded with masks).

The reference's ``_npin`` / ``constrain`` are sharding hints for a device
mesh; on one card they have nothing to do and are left out.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.segment_spmm.ops import SegmentCSR, prepare_edges, segment_spmm
from repro_torch.utils import jax_index, resolve_device


@dataclass(frozen=True)
class GraphBatch:
    node_feat: torch.Tensor  # [N, F] float
    edge_src: torch.Tensor  # [E] int32
    edge_dst: torch.Tensor  # [E] int32
    node_mask: torch.Tensor  # [N] bool
    edge_mask: torch.Tensor  # [E] bool
    labels: torch.Tensor  # [N] int32 (node classification) or graph targets
    positions: Optional[torch.Tensor] = None  # [N, 3] for equivariant models
    graph_ids: Optional[torch.Tensor] = None  # [N] int32 for batched small graphs
    n_graphs: int = 1  # segment count for graph pooling

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GraphBatch":
        return self._replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def random_graph_batch(
    generator: torch.Generator, n_nodes, n_edges, d_feat, n_classes=16,
    positions=False, n_graphs=1, device=None,
) -> GraphBatch:
    """A random batch drawn from ``generator`` (in place of the reference's
    key), on ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    g = dict(generator=generator, device=generator.device)
    i32 = torch.int32
    src = torch.randint(0, n_nodes, (n_edges,), dtype=i32, **g)
    dst = torch.randint(0, n_nodes, (n_edges,), dtype=i32, **g)
    feat = torch.randn((n_nodes, d_feat), **g)
    labels = torch.randint(0, n_classes, (n_nodes,), dtype=i32, **g)
    pos = torch.randn((n_nodes, 3), **g) if positions else None
    return GraphBatch(
        node_feat=feat,
        edge_src=src,
        edge_dst=dst,
        node_mask=torch.ones(n_nodes, dtype=torch.bool),
        edge_mask=torch.ones(n_edges, dtype=torch.bool),
        labels=labels,
        positions=pos,
        graph_ids=(torch.arange(n_nodes, dtype=i32) % n_graphs) if n_graphs > 1 else None,
        n_graphs=n_graphs,
    ).to(dev)


def _edge_ids(messages):
    return torch.arange(messages.shape[0], dtype=torch.int32, device=messages.device)


def _segment_ids(dst, n_nodes, edge_mask):
    """``dst`` as int64 row ids, with masked edges and ids outside
    ``[0, n_nodes)`` sent to the trash row ``n_nodes``."""
    keep = edge_mask & (dst >= 0) & (dst < n_nodes)
    return torch.where(keep, dst.to(torch.int64), n_nodes)


def edge_csr(dst, n_nodes, edge_mask, transpose: bool = False) -> SegmentCSR:
    """The CSR of per-edge rows (row ``e`` of a [E, D] message tensor) by
    destination, for the segment sums below: built once, used by all. With
    ``transpose`` (training), it carries the transposed CSR too, which
    every sum's backward walks: one edge a row, the row of its
    destination."""
    return prepare_edges(_edge_ids(dst), dst, n_nodes, dst.shape[0], edge_mask,
                         transpose=transpose)


def scatter_sum(messages, dst, n_nodes, edge_mask, csr: Optional[SegmentCSR] = None):
    if csr is not None:
        return segment_spmm(messages, csr=csr)
    return segment_spmm(messages, _edge_ids(messages), dst, n_nodes, edge_mask)


def degrees(dst, n_nodes, edge_mask, csr: Optional[SegmentCSR] = None):
    ones = torch.ones((dst.shape[0], 1), dtype=torch.float32, device=dst.device)
    return scatter_sum(ones, dst, n_nodes, edge_mask, csr)[:, 0]


def scatter_mean(messages, dst, n_nodes, edge_mask, csr: Optional[SegmentCSR] = None):
    s = scatter_sum(messages, dst, n_nodes, edge_mask, csr)
    cnt = degrees(dst, n_nodes, edge_mask, csr).to(messages.dtype)
    return s / cnt.clamp(min=1)[:, None], cnt


def _segment_max(values, dst, n_nodes, edge_mask):
    """``jax.ops.segment_max`` of ``values`` [E, D] over the kept edges:
    ``-inf`` where a segment has none."""
    ids = _segment_ids(dst, n_nodes, edge_mask)[:, None].expand(values.shape)
    out = torch.full((n_nodes + 1, values.shape[1]), -torch.inf, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, ids, values, "amax", include_self=True)[:n_nodes]


def scatter_max(messages, dst, n_nodes, edge_mask):
    out = _segment_max(messages, dst, n_nodes, edge_mask)
    return torch.where(torch.isfinite(out), out, 0)


def scatter_min(messages, dst, n_nodes, edge_mask):
    return -scatter_max(-messages, dst, n_nodes, edge_mask)


def segment_softmax(scores, dst, n_nodes, edge_mask, csr: Optional[SegmentCSR] = None):
    """Edge-softmax normalized over incoming edges of each dst node.

    scores: [E, H]. Returns [E, H] weights (masked edges -> 0).
    """
    em = edge_mask[:, None]
    s = torch.where(em, scores, -torch.inf)
    mx = _segment_max(s, dst, n_nodes, edge_mask)
    mx = torch.where(torch.isfinite(mx), mx, 0)
    at_dst = jax_index(dst, n_nodes)  # jnp's gather rule for mx[dst]
    ex = torch.where(em, torch.exp(s - mx[at_dst]), 0)
    den = scatter_sum(ex, dst, n_nodes, edge_mask, csr)
    return ex / den[at_dst].clamp(min=1e-16)
