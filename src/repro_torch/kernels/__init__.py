"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

A wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor; any other device raises. Inside ``shapes_only()`` a
``meta`` tensor takes the plain version too, which then computes shapes
and dtypes alone: the dry-run runs a step so (``launch.dryrun``). A plain
version whose temporaries are sized by the values (``segment_spmm`` over a
CSR, the ``embedding_bag`` backward) is not run there: its wrapper returns
an empty output of the known shape (neither does a matmul, so the FLOPs
counted over the step are the same). A plain version that bounds its
temporaries by walking a batch or a leaf in slices takes them from
``plain_slices``, which gives one slice in a shape-only run.
"""

from __future__ import annotations

import contextlib

_SHAPES_ONLY = False


@contextlib.contextmanager
def shapes_only():
    """While open, the wrappers take their plain versions on ``meta``
    tensors (a shape-only run of a step); no kernel is launched."""
    global _SHAPES_ONLY
    prev, _SHAPES_ONLY = _SHAPES_ONLY, True
    try:
        yield
    finally:
        _SHAPES_ONLY = prev


def plain_device(dev) -> bool:
    """Whether a wrapper given tensors on ``dev`` takes its plain version:
    the CPU, or ``meta`` inside ``shapes_only()``."""
    return dev.type == "cpu" or shape_run(dev)


def shape_run(dev) -> bool:
    """Whether tensors on ``dev`` hold shapes alone: ``meta`` inside
    ``shapes_only()``."""
    return dev.type == "meta" and _SHAPES_ONLY


def plain_slices(n: int, step: int, dev) -> list:
    """``[0, n)`` as slices of ``step``: how a plain version walks a batch
    or a leaf to bound its temporaries. A shape-only run holds none, and
    takes the whole of ``[0, n)`` as one slice."""
    step = max(n, 1) if shape_run(dev) else max(step, 1)
    return [slice(i, i + step) for i in range(0, n, step)]
