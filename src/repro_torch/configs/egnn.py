"""egnn: 4L d_hidden=64, E(n)-equivariant. [arXiv:2102.09844]"""

from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.gnn.config import GNNConfig

FAMILY = "gnn"

FULL = GNNConfig(
    name="egnn", kind="egnn", n_layers=4, d_hidden=64, d_in=32, n_classes=1,
)

SMOKE = GNNConfig(
    name="egnn-smoke", kind="egnn", n_layers=2, d_hidden=8, d_in=16, n_classes=1,
)

SHAPES = GNN_SHAPES
SKIPS = {}
