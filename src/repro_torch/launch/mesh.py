"""Production mesh shapes, for the dry-run's capacity planning.

PyTorch twin of ``repro.launch.mesh``. The reference builds a device mesh;
the port runs on one card, so its mesh is a shape alone: the axis names
and sizes that ``distributed.sharding.maybe_spec`` validates specs
against and that the dry-run divides each argument by. Single pod: 16 x 16
= 256 chips; multi-pod: 2 pods = 512 chips with a leading ``pod`` axis.
"""

from __future__ import annotations

import math


class ShapeMesh:
    """A mesh's axis names and sizes, and nothing else: ``shape`` maps each
    axis name to its size, in order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, sizes, names):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for the axes {tuple(names)}")
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> ShapeMesh:
    """The reference's tiny mesh for single-host tests, as a shape."""
    return ShapeMesh((n_data, n_model), ("data", "model"))
