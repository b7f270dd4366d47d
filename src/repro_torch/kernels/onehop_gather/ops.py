"""Public onehop_gather wrapper.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the hand-written kernel or raise. There is no fallback between the two.
``launches`` counts kernel launches. As in the JAX package, the engine's
miss path does not call this kernel (it runs ``store._gather`` with the
recent-region scan and liveness chain this narrower contract lacks).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import plain_device
from repro_torch.kernels.onehop_gather.kernel import onehop_gather_cuda
from repro_torch.kernels.onehop_gather.ref import onehop_gather_ref

launches = 0

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def onehop_gather(start, deg, dst, eprop, vprop, roots, *, max_deg, edge_val,
                  leaf_val):
    """start/deg/vprop int32 [V]; dst/eprop int32 [E]; roots int32 [B].

    Returns (leaves int32 [B, max_deg], -1 padded; mask bool [B, max_deg]).
    """
    global launches
    args = (start, deg, dst, eprop, vprop, roots)
    kw = dict(max_deg=max_deg, edge_val=edge_val, leaf_val=leaf_val)
    dev = roots.device
    if plain_device(dev):
        return onehop_gather_ref(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"onehop_gather: unsupported device {dev}")
    V, E, B = start.shape[0], dst.shape[0], roots.shape[0]
    shapes = ((V,), (V,), (E,), (E,), (V,), (B,))
    names = ("start", "deg", "dst", "eprop", "vprop", "roots")
    for a, shape, name in zip(args, shapes, names):
        if (a.device != dev or a.dtype != torch.int32 or tuple(a.shape) != shape
                or not a.is_contiguous()):
            raise ValueError(
                f"onehop_gather: {name} must be a contiguous int32 {list(shape)} "
                f"on {dev}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    if V == 0 or E == 0 or max_deg < 0:
        raise ValueError("onehop_gather: needs V > 0, E > 0 and max_deg >= 0")
    for name, v in (("edge_val", edge_val), ("leaf_val", leaf_val)):
        if not _INT32_MIN <= int(v) <= _INT32_MAX:
            raise ValueError(f"onehop_gather: {name}={v} is not an int32")
    if B * max_deg == 0:
        return (torch.full((B, max_deg), -1, dtype=torch.int32, device=dev),
                torch.zeros((B, max_deg), dtype=torch.bool, device=dev))
    out = onehop_gather_cuda(*args, max_deg=max_deg, edge_val=int(edge_val),
                             leaf_val=int(leaf_val))
    launches += 1
    return out
