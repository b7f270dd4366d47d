"""nequip: 5L d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3)-equivariant
interatomic potentials. [arXiv:2101.03164]

DESIGN.md §2 records the tensor-product restriction: l=2 features are kept
as traceless symmetric 3x3 matrices with a fixed path set instead of the
full Clebsch-Gordan product."""

from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.gnn.config import GNNConfig

FAMILY = "gnn"

FULL = GNNConfig(
    name="nequip", kind="nequip", n_layers=5, d_hidden=32, d_in=32,
    n_classes=1, l_max=2, n_rbf=8, cutoff=5.0,
)

SMOKE = GNNConfig(
    name="nequip-smoke", kind="nequip", n_layers=2, d_hidden=8, d_in=16,
    n_classes=1, l_max=2, n_rbf=4, cutoff=5.0,
)

SHAPES = GNN_SHAPES
SKIPS = {}
