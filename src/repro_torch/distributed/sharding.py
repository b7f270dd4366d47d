"""A mesh of ``n`` ranks held in one process, driven in lockstep.

The reference runs the sharded runtime under ``shard_map``: one program per
rank, with collectives between them. The port writes that per-rank program
as a Python generator that ``yield``s each collective it needs, as a
``(kind, tensor)`` request, and receives its part of the result back from
the ``yield``:

- ``(ALL_TO_ALL, send)`` with ``send`` of shape ``[n, ...]``: row ``d`` goes
  to rank ``d``; every rank receives ``recv[s] = send_from_rank_s[d]``
  (the reference's tiled ``all_to_all`` with split and concat axis 0);
- ``(ALL_REDUCE_SUM, x)``: every rank receives the sum of all ranks' ``x``;
- ``(ALL_REDUCE_MAX, x)``: every rank receives the elementwise maximum
  (the reference's ``pmax``);
- ``(ALL_GATHER, x)``: every rank receives the concatenation of all ranks'
  ``x`` along axis 0, in rank order (the tiled ``all_gather`` on axis 0).

``LocalMesh.run`` advances every rank to its next request, checks that all
of them asked for the same collective on tensors of one shape, performs it
exactly (a permutation, a concatenation, a sum or a maximum), and resumes each rank with its part. Unlike
threads at a barrier, this cannot deadlock: a rank that raises stops the
run at once, and a rank that finishes or asks for another collective than
its peers raises ``MeshError``. Running one rank per card replaces only
this driver with ``torch.distributed`` calls; the per-rank programs stay.
"""

from __future__ import annotations

import numpy as np
import torch

ALL_TO_ALL = "all_to_all"
ALL_REDUCE_SUM = "all_reduce_sum"
ALL_REDUCE_MAX = "all_reduce_max"
ALL_GATHER = "all_gather"


class MeshError(RuntimeError):
    """The ranks of a mesh disagree on the collective they are at."""


class LocalMesh:
    """``n`` ranks in one process. ``counts`` tallies the collectives run
    (one per exchange, whatever the number of ranks)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a mesh needs at least one rank, got {n}")
        self.n = n
        self.counts = {ALL_TO_ALL: 0, ALL_REDUCE_SUM: 0, ALL_REDUCE_MAX: 0, ALL_GATHER: 0}

    def run(self, programs):
        """Drive one generator per rank to its end; returns their return
        values in rank order."""
        n = self.n
        if len(programs) != n:
            raise MeshError(f"{len(programs)} programs for a mesh of {n} ranks")
        replies = [None] * n
        while True:
            asks, outs = [], []
            for g, reply in zip(programs, replies):
                try:
                    asks.append(g.send(reply))
                except StopIteration as stop:
                    asks.append(None)
                    outs.append(stop.value)
            if len(outs) == n:
                return outs
            if outs:
                waiting = [r for r, a in enumerate(asks) if a is not None]
                raise MeshError(f"ranks {waiting} wait at a collective the others never reach")
            replies = self._collective(asks)

    def _collective(self, asks):
        n = self.n
        kinds = {kind for kind, _ in asks}
        if len(kinds) != 1:
            raise MeshError(f"ranks ask for different collectives: {[k for k, _ in asks]}")
        kind = kinds.pop()
        xs = [x for _, x in asks]
        shapes = {(tuple(x.shape), x.dtype) for x in xs}
        if len(shapes) != 1:
            raise MeshError(f"{kind} over tensors of different shapes: {sorted(map(str, shapes))}")
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if kind == ALL_TO_ALL:
            if xs[0].dim() == 0 or xs[0].shape[0] != n:
                raise MeshError(f"all_to_all needs a leading axis of {n}, got {tuple(xs[0].shape)}")
            sent = torch.stack(xs)  # [src, dst, ...]
            return [sent[:, d] for d in range(n)]
        if kind == ALL_REDUCE_SUM:
            total = torch.stack(xs).sum(dim=0, dtype=xs[0].dtype)
            return [total] * n
        if kind == ALL_REDUCE_MAX:
            return [torch.stack(xs).amax(dim=0)] * n
        if kind == ALL_GATHER:
            if xs[0].dim() == 0:
                raise MeshError("all_gather needs a leading axis to concatenate on")
            return [torch.cat(xs)] * n
        raise MeshError(f"unknown collective {kind!r}")


def flat_mesh(n: int) -> LocalMesh:
    """A process-local mesh of ``n`` ranks: the layout of the sharded
    transaction runtime, whose vertex ownership, owner-local edge blocks and
    cache blocks all partition over one flat axis."""
    return LocalMesh(n)


# ------------------------------------------------------------------ specs
# The reference's shape-only sharding helpers. A spec is a plain tuple with
# one entry a dimension: None (replicated), an axis name, or a tuple of
# axis names. A mesh is anything with a ``.shape`` mapping of axis name to
# size (``launch.mesh.ShapeMesh``); nothing here places a tensor.

_MESH = None


def set_mesh(mesh):
    """Install the process-wide mesh used by ``maybe_spec`` /
    ``add_data_axis`` / ``tree_shardings`` when none is given. Nothing in
    the port installs one: ``launch.steps`` passes its mesh to every call."""
    global _MESH
    _MESH = mesh


def active_mesh():
    return _MESH


def _axis_size(mesh, axes) -> int:
    size = 1
    for a in axes:
        size *= int(mesh.shape[a])
    return size


def maybe_spec(shape, spec, mesh=None) -> tuple:
    """Validate a spec against a shape: drop axes that are absent from the
    mesh or do not divide the dimension (or are of size 1). Returns one
    entry a dimension; ``()`` without a mesh."""
    mesh = mesh or _MESH
    if mesh is None:
        return ()
    out = []
    spec = tuple(spec)[: len(shape)]  # rank-0 leaves (e.g. step counters)
    for d, axis in enumerate(spec + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        axes = tuple(a for a in axes if a in mesh.shape)
        if not axes:
            out.append(None)
            continue
        size = _axis_size(mesh, axes)
        if size <= 1 or shape[d] % size != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def constrain(x, *spec):
    """The reference's ``with_sharding_constraint``: a no-op here. One card
    holds the whole tensor, so there is nothing to lay out; the dry-run
    reads a spec from ``maybe_spec`` instead."""
    return x


def add_data_axis(spec, shape, mesh=None, axes=("data",)) -> tuple:
    """ZeRO-1: extend a param spec with the data axis on the largest
    still-replicated, divisible dimension (optimizer-state sharding)."""
    mesh = mesh or _MESH
    if mesh is None:
        return tuple(spec)
    size = _axis_size(mesh, [a for a in axes if a in mesh.shape])
    if size <= 1:
        return tuple(spec)
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    order = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in order:
        if entries[d] is None and shape[d] % size == 0:
            entries[d] = axes if len(axes) > 1 else axes[0]
            return tuple(entries)
    return tuple(entries)


def tree_shardings(tree, rule, mesh=None):
    """A tree like ``tree`` holding one validated spec tuple a leaf:
    ``rule(path, leaf) -> spec``, ``path`` the string ``jax.tree_util.keystr``
    gives (``"['layers']['wq']"``, ``".m['embed']"``, ``"[0]"``)."""
    mesh = mesh or _MESH
    return tree_map_with_path(
        lambda path, leaf: maybe_spec(tuple(leaf.shape), rule(path, leaf), mesh), tree)


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the arrays (tensors and numpy arrays) of a
    tree of dicts, NamedTuples, tuples and lists, as
    ``jax.tree_util.tree_map_with_path`` with its ``keystr`` paths; ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, x, f"{path}[{i}]") for i, x in enumerate(tree))
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")
