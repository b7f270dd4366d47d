"""Architecture registry of the port: the JAX package's ten assigned
architectures and the paper's own graph engine, one module each at the
path of its twin in ``repro.configs``, each holding the same data:

  FAMILY: "lm" | "gnn" | "recsys" | "graph"
  FULL:   the exact published configuration
  SMOKE:  a reduced same-family config for CPU smoke tests
  SHAPES: {shape_name: dict(kind=..., **dims)}
  SKIPS:  {shape_name: reason}

A config is data: one whose model the port does not run yet (MoE, GAT,
EGNN, NequIP) imports and lists here, and raises only when that model is
run. The LM configs leave out the reference's attention chunk sizes (the
kernel tiles by its own constants).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "glm4-9b",
    "yi-6b",
    "gemma3-4b",
    "kimi-k2-1t-a32b",
    "grok-1-314b",
    "pna",
    "nequip",
    "gat-cora",
    "egnn",
    "two-tower-retrieval",
    "ecommerce-graph",  # the paper's own architecture
]


def get_arch(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")


def all_cells(include_paper_arch: bool = True):
    """Every (arch, shape) cell incl. skip annotations."""
    cells = []
    for a in ARCH_IDS:
        if a == "ecommerce-graph" and not include_paper_arch:
            continue
        mod = get_arch(a)
        for shape, info in mod.SHAPES.items():
            cells.append(dict(arch=a, shape=shape, kind=info["kind"], skip=mod.SKIPS.get(shape)))
    return cells
