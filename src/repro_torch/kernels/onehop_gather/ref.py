"""Plain PyTorch version of the onehop_gather kernel (the CPU path and the
yardstick the CUDA kernel is held to, bit for bit)."""

from __future__ import annotations

import torch

from repro_torch.utils import NULL_ID, jax_index


def onehop_gather_ref(start, deg, dst, eprop, vprop, roots, *, max_deg,
                      edge_val, leaf_val):
    """start/deg/vprop [V]; dst/eprop [E]; roots [B] -> (leaves, mask)
    [B, max_deg]. Index rules follow ``jnp``'s gather (``jax_index``)."""
    V, E = start.shape[0], dst.shape[0]
    rc = jax_index(roots, V)
    lanes = torch.arange(max_deg, dtype=torch.int32, device=roots.device)
    pos = start[rc][:, None] + lanes[None, :]
    within = lanes[None, :] < deg[rc][:, None]
    pos = pos.clamp(0, E - 1).long()
    leaf = dst[pos]
    ok = within & (eprop[pos] == edge_val) & (vprop[jax_index(leaf, V)] == leaf_val)
    ok &= roots[:, None] >= 0
    return torch.where(ok, leaf, NULL_ID), ok
