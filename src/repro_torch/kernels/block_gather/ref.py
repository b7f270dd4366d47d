"""Plain PyTorch version of the block_gather kernel (the CPU path and the
yardstick the CUDA kernel is held to, bit for bit).

One orientation of the partitioned store's owner-local miss execution:
CSR-window scan + recent-region scan + liveness chain + edge-label /
edge-predicate / leaf-predicate filter over one ``BlockGatherOperands``
bundle, vectorized over the whole batch. The hop's predicates arrive frozen
by ``pred_static`` into plain ints, which is also how the CUDA kernel
receives them.

Per-row inputs (shared by both orientations): ``roots`` int32 [B] global
root ids; ``lroot`` int32 [B] local CSR row; ``rvalid`` bool [B] ownership
and range gate of the recent-region scan; ``cvalid`` bool [B] gate of the
CSR window (``rvalid`` restricted to native roots under a routing table);
``rmask`` bool [B] rows this call executes; ``r_ok`` bool [B] root
predicate & rmask; ``pe_bound`` / ``pl_bound`` int32 [B, MAX_CONDS] bound
wildcard values.

Outputs, [B, W] with ``W = max_deg + recent_cap``: ``leaf`` global leaf id
per lane, ``scan`` the observed-edge mask (liveness & rmask), ``emask``
after the edge filters, ``qual`` the qualifying mask; and ``trunc`` [B],
the CSR degree exceeded ``max_deg`` (not masked: the caller ands it).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.templates import MAX_CONDS, OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, OP_NEQ
from repro_torch.utils import PROP_MISSING, jax_index


def pred_static(pred) -> tuple:
    """Freeze a ``PredSpec`` into ``(label, ((lane, prop_id, op, val, wild),
    ...))``, unused conditions (prop_id < 0) dropped; ``lane`` is the
    condition's MAX_CONDS index, where a wildcard reads its bound value."""
    pid, ops, vals, wild = (np.asarray(getattr(pred, f)) for f in ("prop_ids", "ops", "vals", "wild"))
    conds = tuple(
        (c, int(pid[c]), int(ops[c]), int(vals[c]), bool(wild[c]))
        for c in range(MAX_CONDS) if int(pid[c]) >= 0
    )
    return (int(np.asarray(pred.label)), conds)


def _cmp_static(op: int, a, b):
    if op == OP_EQ:
        return a == b
    if op == OP_NEQ:
        return a != b
    if op == OP_LT:
        return a < b
    if op == OP_LE:
        return a <= b
    if op == OP_GT:
        return a > b
    if op == OP_GE:
        return a >= b
    return torch.zeros_like(a, dtype=torch.bool)


def eval_pred_static(stat: tuple, labels, props, bound):
    """``templates.evaluate_pred`` with the spec frozen and wildcards bound:
    a wildcard condition compares OP_EQ against its bound lane, a literal
    one its constant, and both require presence."""
    label, conds = stat
    ok = torch.ones(labels.shape, dtype=torch.bool, device=labels.device) if label < 0 \
        else labels == label
    for lane, pid, op, val, wild in conds:
        pv = props[..., min(pid, props.shape[-1] - 1)]
        present = pv != PROP_MISSING
        cond = _cmp_static(OP_EQ, pv, bound[..., lane]) if wild else _cmp_static(op, pv, val)
        ok = ok & present & cond
    return ok


def block_gather_filter_ref(
    indptr, key, other, label, alive, props, vlabel, valive, vprops,
    csr_len, blk_len, roots, lroot, rvalid, cvalid, rmask, r_ok,
    pe_bound, pl_bound,
    *, max_deg: int, recent_cap: int, e_blk_cap: int, edge_label: int,
    pe: tuple, pl: tuple,
):
    """The fused scan + filter over the whole batch. Index rules are the
    reference's: ``indptr`` reads wrap a negative index once, then clamp;
    every other read is clamped explicitly."""
    B, dev = roots.shape[0], roots.device
    EB, R = e_blk_cap, recent_cap
    Vp, v_cap = indptr.shape[0], valive.shape[0]

    # ---- CSR window (the physically sorted block region) ----
    start = indptr[jax_index(lroot, Vp)]
    deg = indptr[jax_index(lroot + 1, Vp)] - start
    trunc = deg > max_deg
    lane = torch.arange(max_deg, dtype=torch.int32, device=dev)[None, :]
    pos = start[:, None] + lane
    csr_mask = (lane < deg[:, None]) & cvalid[:, None]
    slot_csr = pos.clamp(0, EB - 1)

    # ---- recent region: [csr_len, blk_len) within a bounded window ----
    sid = csr_len.clamp(0, EB - R) + torch.arange(R, dtype=torch.int32, device=dev)
    key_r = key[sid.long()]
    in_region = (sid >= csr_len) & (sid < blk_len)
    rec_mask = (key_r[None, :] == roots[:, None]) & in_region[None, :] & rvalid[:, None]
    slot_rec = sid[None, :].expand(B, R)

    slots = torch.cat([slot_csr, slot_rec], dim=1).long()  # [B, W]
    mask = torch.cat([csr_mask, rec_mask], dim=1)
    mask = mask & alive[slots]
    leaf = other[slots]
    leaf_c = leaf.clamp(0, v_cap - 1).long()
    mask = mask & valive[leaf_c]
    root_c = roots.clamp(0, v_cap - 1).long()
    mask = mask & valive[root_c][:, None]

    # ---- filter chain, statically specialized ----
    scan = mask & rmask[:, None]
    elab = label[slots]
    e_ok = torch.ones_like(scan) if edge_label < 0 else elab == edge_label
    e_ok = e_ok & eval_pred_static(pe, elab, props[slots], pe_bound[:, None, :])
    emask = scan & e_ok
    l_ok = eval_pred_static(pl, vlabel[leaf_c], vprops[leaf_c], pl_bound[:, None, :])
    qual = emask & l_ok & r_ok[:, None]
    return leaf, scan, emask, qual, trunc
