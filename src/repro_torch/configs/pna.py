"""pna: 4L d_hidden=75 aggregators=mean-max-min-std scalers=id-amp-atten.
[arXiv:2004.05718] (a copy of ``repro.configs.pna``)"""

from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.gnn.config import GNNConfig

FAMILY = "gnn"

FULL = GNNConfig(
    name="pna", kind="pna", n_layers=4, d_hidden=75, d_in=128, n_classes=47,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
)

SMOKE = GNNConfig(
    name="pna-smoke", kind="pna", n_layers=2, d_hidden=8, d_in=16, n_classes=4,
)

SHAPES = GNN_SHAPES
SKIPS = {}
