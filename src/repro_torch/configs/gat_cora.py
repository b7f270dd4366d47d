"""gat-cora: 2L d_hidden=8 n_heads=8 attention aggregator.
[arXiv:1710.10903]"""

from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.gnn.config import GNNConfig

FAMILY = "gnn"

FULL = GNNConfig(
    name="gat-cora", kind="gat", n_layers=2, d_hidden=8, n_heads=8,
    d_in=1433, n_classes=7,
)

SMOKE = GNNConfig(
    name="gat-smoke", kind="gat", n_layers=2, d_hidden=4, n_heads=2,
    d_in=16, n_classes=4,
)

SHAPES = GNN_SHAPES
SKIPS = {}
