"""ctypes binding of the CUDA block_gather kernel (``csrc/block_gather.cu``).

The source's header says which TPU kernel it replaces and what bounds it.
Launches on PyTorch's current stream and allocates only its outputs.
"""

from __future__ import annotations

import torch

from repro_torch.core.templates import MAX_CONDS
from repro_torch.kernels import _build

_N_POINTERS = 24  # 19 operands + 5 outputs
_N_INTS = 9 + 2 * (2 + 5 * MAX_CONDS)
LAUNCH = "block_gather_launch"
# the per-lane design before it, launched only as the yardstick of
# chip_smoke.py's diagnosis
LANE_LAUNCH = "block_gather_lane_launch"


def pred_ints(stat: tuple) -> list:
    """A ``pred_static`` tuple as the kernel's ints: label, number of
    conditions, then MAX_CONDS x (lane, prop id, op, value, wildcard)."""
    label, conds = stat
    out = [label, len(conds)]
    for c in range(MAX_CONDS):
        out += list(conds[c][:4]) + [int(conds[c][4])] if c < len(conds) else [0] * 5
    return out


def block_gather_cuda(operands, rows, *, max_deg, recent_cap, e_blk_cap, edge_label, pe, pl,
                      symbol=LAUNCH):
    """``operands``: the 11 block tensors; ``rows``: the 8 per-row tensors."""
    roots = rows[0]
    B, dev = roots.shape[0], roots.device
    W = max_deg + recent_cap
    leaf = torch.empty((B, W), dtype=torch.int32, device=dev)
    scan, emask, qual = (torch.empty((B, W), dtype=torch.bool, device=dev) for _ in range(3))
    trunc = torch.empty(B, dtype=torch.bool, device=dev)
    indptr, vprops, props, valive = operands[0], operands[8], operands[5], operands[7]
    ints = [B, indptr.shape[0], e_blk_cap, valive.shape[0], props.shape[1], vprops.shape[1],
            max_deg, recent_cap, edge_label] + pred_ints(pe) + pred_ints(pl)
    fn = _build.bind("block_gather", symbol, _N_POINTERS, _N_INTS)
    err = fn(*(t.data_ptr() for t in (*operands, *rows, leaf, scan, emask, qual, trunc)),
             *ints, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("block_gather", err)
    return leaf, scan, emask, qual, trunc
