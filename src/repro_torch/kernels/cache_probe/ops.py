"""Public cache_probe wrapper.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the hand-written kernel or raise. There is no fallback between the two.
``launches`` counts kernel launches (never the plain version's calls), so a
run can show that its read path went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cache_probe.kernel import cache_probe_cuda
from repro_torch.kernels.cache_probe.ref import cache_probe_ref

launches = 0

_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool,
           torch.int32, torch.int32, torch.int32, torch.int32)
_NAMES = ("c_tpl", "c_root", "c_fp", "c_valid", "tpl", "root", "h", "fp")


def cache_probe(c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp, *, probes=8):
    """Probe B keys against a C-slot cache. Cache arrays [C] with C a power
    of two; keys [B]; ``h``/``fp``/``c_fp`` int32 holding the uint32 bits.

    Returns (hit bool [B], slot int32 [B], -1 where no slot matched).
    """
    global launches
    args = (c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp)
    dev = tpl.device
    if dev.type == "cpu":
        return cache_probe_ref(*args, probes=probes)
    if dev.type != "cuda":
        raise ValueError(f"cache_probe: unsupported device {dev}")
    C, B = c_tpl.shape[0], tpl.shape[0]
    if C & (C - 1) or C == 0:
        raise ValueError(f"cache_probe: capacity {C} is not a power of two")
    for a, dt, name in zip(args, _DTYPES, _NAMES):
        n = C if name.startswith("c_") else B
        if a.device != dev or a.dtype != dt or a.shape != (n,) or not a.is_contiguous():
            raise ValueError(
                f"cache_probe: {name} must be a contiguous {dt} [{n}] on {dev}, "
                f"got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    if B == 0:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    out = cache_probe_cuda(*args, probes=probes)
    launches += 1
    return out
