"""EmbeddingBag: gather + bag reduce.

PyTorch twin of ``repro.recsys.embedding``. Two forms:

- ``embedding_bag``: padded bags [..., K] + mask, the model-facing form.
  Without weights (the only form the towers use) it runs the hand-written
  ``embedding_bag`` kernel on CUDA and its plain version on the CPU, and a
  table that requires a gradient gets it from the backward kernel (its
  plain version on the CPU); with weights it is plain torch, as in the
  reference.
- ``embedding_bag_flat``: the ragged (ids [NNZ], segment_ids [NNZ]) form,
  plain torch (``index_add_``), as it is plain ``jnp`` in the reference and
  on no serving path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.ops import embedding_bag as bag_op


def embedding_bag(table, ids, mask=None, *, mode: str = "sum", weights=None):
    """table [V, D]; ids [..., K] padded; mask [..., K] bool. Returns
    [..., D] in ``table.dtype``."""
    if weights is None:
        lead, K = ids.shape[:-1], ids.shape[-1]
        flat = ids.reshape(-1, K).to(torch.int32).contiguous()
        m = (torch.ones_like(flat, dtype=torch.bool) if mask is None
             else mask.reshape(-1, K).contiguous())
        return bag_op(table, flat, m, mode=mode).reshape(*lead, table.shape[1])
    # the reference's arithmetic, step for step, in the table's dtype
    emb = table[ids.long().clamp(0, table.shape[0] - 1)]
    emb = emb * weights[..., None].to(emb.dtype)
    if mask is not None:
        emb = torch.where(mask[..., None], emb, torch.zeros((), dtype=emb.dtype))
    out = emb.sum(-2)
    if mode == "mean":
        cnt = (mask.sum(-1, keepdim=True).to(out.dtype) if mask is not None
               else torch.full(out.shape[:-1] + (1,), ids.shape[-1], dtype=out.dtype))
        out = out / cnt.clamp(min=1)
    return out


def embedding_bag_flat(table, ids, segment_ids, n_bags: int, *, mode: str = "sum",
                       weights=None):
    """Ragged form: ids / segment_ids [NNZ]. Returns [n_bags, D]. Segment
    ids outside ``[0, n_bags)`` are dropped, as ``jax.ops.segment_sum``
    drops them."""
    emb = table[ids.long().clamp(0, table.shape[0] - 1)]
    if weights is not None:
        emb = emb * weights[:, None].to(emb.dtype)
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < n_bags)
    out = torch.zeros((n_bags, table.shape[1]), dtype=emb.dtype, device=emb.device)
    out.index_add_(0, seg[keep], emb[keep])
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=emb.dtype, device=emb.device)
        cnt.index_add_(0, seg[keep], torch.ones_like(seg[keep], dtype=emb.dtype))
        out = out / cnt.clamp(min=1)[:, None]
    return out
