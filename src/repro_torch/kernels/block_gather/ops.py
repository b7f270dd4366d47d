"""Public wrappers for block_gather: the fused scan + filter, and the
owner-local miss executor of the partitioned serve tier.

``block_gather``: CPU tensors take the plain PyTorch version (``ref.py``);
CUDA tensors launch the hand-written kernel or raise. There is no fallback
between the two. ``launches`` counts kernel launches (never the plain
version's calls), so a run can show that its miss path went through the
kernel.

``block_onehop_exec`` replaces ``runtime.onehop_exec_view`` over a
``partition.BlockStoreView``: the same (leaves, lmask, n_true, truncated,
stats) contract and the same outputs, with each orientation's scan and
filter in one ``block_gather`` call and the Definition 2.1 set-dedup done by
the sort-based ``first_occurrence_mask``. The two dedups agree wherever no
qualifying lane carries NULL_ID, which liveness guarantees.
"""

from __future__ import annotations

import torch

from repro_torch.core.templates import DIR_BOTH, DIR_IN, DIR_OUT, MAX_CONDS, evaluate_pred
from repro_torch.distributed.routing import storage_owner_of
from repro_torch.graphstore.partition import local_of, owner_of
from repro_torch.kernels.block_gather.kernel import block_gather_cuda
from repro_torch.kernels.block_gather.ref import block_gather_filter_ref, pred_static
from repro_torch.utils import INT32_MAX, compact_masked, first_occurrence, take_along0

launches = 0

_OPERANDS = (("indptr", torch.int32, 1), ("key", torch.int32, 1), ("other", torch.int32, 1),
             ("label", torch.int32, 1), ("alive", torch.bool, 1), ("props", torch.int32, 2),
             ("vlabel", torch.int32, 1), ("valive", torch.bool, 1), ("vprops", torch.int32, 2),
             ("csr_len", torch.int32, 0), ("blk_len", torch.int32, 0))
_ROWS = (("roots", torch.int32), ("lroot", torch.int32), ("rvalid", torch.bool),
         ("cvalid", torch.bool), ("rmask", torch.bool), ("r_ok", torch.bool),
         ("pe_bound", torch.int32), ("pl_bound", torch.int32))


def _check(name, t, dtype, ndim, dev):
    if t.device != dev or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"block_gather: {name} must be a contiguous {dtype} of rank {ndim} "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def block_gather(
    indptr, key, other, label, alive, props, vlabel, valive, vprops,
    csr_len, blk_len, roots, lroot, rvalid, cvalid, rmask, r_ok,
    pe_bound, pl_bound,
    *, max_deg, recent_cap, e_blk_cap, edge_label, pe, pl,
):
    """One orientation's fused scan + filter (see ``ref`` for the operand
    and output contract). On the card the kernel's grid covers any B: no
    row is padded."""
    global launches
    operands = (indptr, key, other, label, alive, props, vlabel, valive, vprops, csr_len, blk_len)
    rows = (roots, lroot, rvalid, cvalid, rmask, r_ok, pe_bound, pl_bound)
    statics = dict(max_deg=max_deg, recent_cap=recent_cap, e_blk_cap=e_blk_cap,
                   edge_label=edge_label, pe=pe, pl=pl)
    dev = roots.device
    if dev.type == "cpu":
        return block_gather_filter_ref(*operands, *rows, **statics)
    if dev.type != "cuda":
        raise ValueError(f"block_gather: unsupported device {dev}")
    for t, (name, dtype, ndim) in zip(operands, _OPERANDS):
        _check(name, t, dtype, ndim, dev)
    B = roots.shape[0]
    for t, (name, dtype) in zip(rows, _ROWS):
        _check(name, t, dtype, 2 if name.endswith("bound") else 1, dev)
        if t.shape[0] != B or (name.endswith("bound") and t.shape[1] != MAX_CONDS):
            raise ValueError(f"block_gather: {name} has shape {tuple(t.shape)} for B={B}")
    EB, v_cap = key.shape[0], valive.shape[0]
    if (EB != e_blk_cap or not 0 < recent_cap <= EB or max_deg < 0 or v_cap == 0
            or indptr.shape[0] == 0 or any(t.shape[0] != EB for t in (other, label, alive, props))
            or vlabel.shape[0] != v_cap or vprops.shape[0] != v_cap):
        raise ValueError("block_gather: inconsistent block shapes")
    W = max_deg + recent_cap
    if B == 0:
        empty = lambda dt: torch.zeros((0, W), dtype=dt, device=dev)
        return (empty(torch.int32), empty(torch.bool), empty(torch.bool), empty(torch.bool),
                torch.zeros(0, dtype=torch.bool, device=dev))
    out = block_gather_cuda(operands, rows, **statics)
    launches += 1
    return out


def first_occurrence_mask(vals, mask):
    """Per-row first-occurrence keep over masked lanes: stable sort, an
    adjacent compare and the inverse permutation, O(W log W) per row."""
    keyed = torch.where(mask, vals, torch.full_like(vals, INT32_MAX))
    return first_occurrence(keyed) & (keyed != INT32_MAX)


def row_gates(view, pr, roots, rmask):
    """The per-row inputs both orientations share: ``(roots, lroot, rvalid,
    cvalid, native, r_ok)``. ``native`` is None without a routing table."""
    pspec = view.pspec
    n, v_cap = pspec.n_shards, pspec.base.v_cap
    roots = roots.to(torch.int32).contiguous()
    r_ok = evaluate_pred(pr, take_along0(view.vlabel, roots), take_along0(view.vprops, roots)) & rmask
    rvalid = (storage_owner_of(view.rtable, roots, n) == view.me) & (roots >= 0) & (roots < v_cap)
    if view.rtable is None:
        native, cvalid = None, rvalid
    else:
        # a migrated-in root's local index v // n aliases a native vertex's
        # CSR rows: only native roots open the CSR window
        native = owner_of(roots, n) == view.me
        cvalid = rvalid & native
    lroot = local_of(roots, n).clamp(0, pspec.v_loc - 1).contiguous()
    return roots, lroot, rvalid, cvalid, native, r_ok


def block_onehop_exec(espec, view, direction: int, edge_label: int, pr, pe, pl,
                      roots, params, rmask):
    """Fused owner-local miss executor over a ``BlockStoreView``, the
    partitioned tier's ``exec_fn``. Same contract as
    ``runtime.onehop_exec_view``: (leaves [B, RW], lmask, n_true, truncated,
    stats), identical outputs."""
    pspec = view.pspec
    params = params.contiguous()
    pe_bound = params[:, :MAX_CONDS].contiguous()
    pl_bound = params[:, MAX_CONDS:].contiguous()
    roots, lroot, rvalid, cvalid, native, r_ok = row_gates(view, pr, roots, rmask)
    rows = (roots, lroot, rvalid, cvalid, rmask.contiguous(), r_ok, pe_bound, pl_bound)

    pe_s, pl_s = pred_static(pe), pred_static(pl)
    sides = {DIR_OUT: (False,), DIR_IN: (True,), DIR_BOTH: (False, True)}[direction]
    leaf_p, scan_p, em_p, qual_p = [], [], [], []
    trunc = torch.zeros_like(rmask)
    for incoming in sides:
        leaf, scan, emask, qual, t = block_gather(
            *view.kernel_operands(incoming=incoming), *rows,
            max_deg=espec.max_deg, recent_cap=pspec.recent_blk_cap,
            e_blk_cap=pspec.e_blk_cap, edge_label=edge_label, pe=pe_s, pl=pl_s,
        )
        leaf_p.append(leaf)
        scan_p.append(scan)
        em_p.append(emask)
        qual_p.append(qual)
        # a foreign root's CSR degree is an aliased native vertex's
        trunc |= t if native is None else t & native

    leaf = torch.cat(leaf_p, dim=1)
    scanned_mask = torch.cat(scan_p, dim=1)
    keep = first_occurrence_mask(leaf, torch.cat(qual_p, dim=1))  # Definition 2.1
    n_true = keep.sum(dim=1, dtype=torch.int32)
    leaves, lmask = compact_masked(leaf, keep, espec.result_width)
    stats = {
        "edges_scanned": scanned_mask.sum(dtype=torch.int32),
        "leaf_fetches": torch.cat(em_p, dim=1).sum(dtype=torch.int32),  # the paper's "n"
        # the full read-conflict set for OCC population commits
        "scanned": leaf,
        "scanned_mask": scanned_mask,
    }
    return leaves, lmask, n_true, trunc & rmask, stats
