"""GNN architecture configuration (a copy of ``repro.gnn.config``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # "pna" | "gat" | "egnn" | "nequip"
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int = 16
    # gat
    n_heads: int = 1
    # pna
    aggregators: Tuple[str, ...] = ("mean", "max", "min", "std")
    scalers: Tuple[str, ...] = ("identity", "amplification", "attenuation")
    mean_log_degree: float = 2.0  # PNA's delta, precomputed on train graphs
    # nequip
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    # equivariant models consume positions
    @property
    def needs_positions(self) -> bool:
        return self.kind in ("egnn", "nequip")

    dtype: str = "float32"
