"""GNN substrate of the port: segment-op message passing (SpMM regime)
with PNA, GAT, EGNN and NequIP-lite, their training steps, plus the fanout
neighbor sampler and its one-hop-cache-backed variant (the paper's
technique applied to GNN data loading). PyTorch twin of ``repro.gnn``."""

from repro_torch.gnn.config import GNNConfig
from repro_torch.gnn.graph import GraphBatch, random_graph_batch, segment_softmax
from repro_torch.gnn.models import forward as gnn_forward, loss_fn as gnn_loss, init_params as gnn_init
from repro_torch.gnn.models import train_step as gnn_train_step
from repro_torch.gnn.sampler import CachedNeighborSampler, CSRGraph, FanoutSampler

__all__ = [
    "GNNConfig",
    "GraphBatch",
    "random_graph_batch",
    "segment_softmax",
    "gnn_forward",
    "gnn_loss",
    "gnn_init",
    "gnn_train_step",
    "CSRGraph",
    "FanoutSampler",
    "CachedNeighborSampler",
]
