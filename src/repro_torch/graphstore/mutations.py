"""Batched graph mutations (the write half of gRW-Txs).

PyTorch twin of ``repro.graphstore.mutations``. A ``MutationBatch`` is a
structure-of-arrays with one fixed-capacity section per change type of §3.2.
``apply_mutations`` applies the whole batch as one commit: it snapshots the
old state the mutation listener needs, writes copies of the changed fields
(the caller's store is left intact; the gRW step needs both states at once),
and bumps per-vertex versions, the conflict ranges of CP population commits.
``shard_mutation_rows`` slices an applied batch round-robin over the ranks
of the replicated tier's commit.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.graphstore.store import GraphStore, StoreSpec
from repro_torch.utils import (
    PROP_MISSING,
    keep_last_occurrence,
    resolve_device,
    scatter_drop,
    take_along0,
)


class MutationBatch(NamedTuple):
    """Padded change sections. ``*_n`` is the live count per section."""

    # add vertices
    nv_label: torch.Tensor  # int32 [KNV]
    nv_props: torch.Tensor  # int32 [KNV, n_vprops]
    nv_n: torch.Tensor
    # add edges
    ne_src: torch.Tensor  # int32 [KNE]
    ne_dst: torch.Tensor
    ne_label: torch.Tensor
    ne_props: torch.Tensor  # int32 [KNE, n_eprops]
    ne_n: torch.Tensor
    # delete edges
    de_eid: torch.Tensor  # int32 [KDE]
    de_n: torch.Tensor
    # delete vertices
    dv_vid: torch.Tensor  # int32 [KDV]
    dv_n: torch.Tensor
    # set/del vertex property (val == PROP_MISSING deletes the property)
    sv_vid: torch.Tensor  # int32 [KSV]
    sv_pid: torch.Tensor
    sv_val: torch.Tensor
    sv_n: torch.Tensor
    # set/del edge property
    se_eid: torch.Tensor  # int32 [KSE]
    se_pid: torch.Tensor
    se_val: torch.Tensor
    se_n: torch.Tensor


class AppliedMutations(NamedTuple):
    """Old-state snapshots captured at apply time, consumed by invalidation."""

    batch: MutationBatch
    ne_eid: torch.Tensor  # assigned edge slots [KNE]
    nv_vid: torch.Tensor  # assigned vertex slots [KNV]
    # deleted-edge pre-images
    de_src: torch.Tensor
    de_dst: torch.Tensor
    de_label: torch.Tensor
    de_props: torch.Tensor  # [KDE, n_eprops]
    # vertex-prop pre-images
    sv_old: torch.Tensor  # [KSV]
    # edge-prop pre-images and the (immutable) edge identity
    se_old: torch.Tensor  # [KSE]
    se_src: torch.Tensor
    se_dst: torch.Tensor
    se_label: torch.Tensor
    se_props: torch.Tensor  # [KSE, n_eprops] post-change props (for key calc)
    commit_version: torch.Tensor  # int32 scalar


def make_mutation_batch(
    spec: StoreSpec,
    *,
    new_vertices: Sequence = (),  # (label, props[n_vprops])
    new_edges: Sequence = (),  # (src, dst, label, props[n_eprops])
    del_edges: Sequence = (),  # eid
    del_vertices: Sequence = (),  # vid
    set_vprops: Sequence = (),  # (vid, pid, val)
    set_eprops: Sequence = (),  # (eid, pid, val)
    caps: tuple = (8, 32, 32, 8, 32, 32),
    device=None,
) -> MutationBatch:
    """Host-side builder: pads python change lists into a MutationBatch."""
    dev = resolve_device(device)
    knv, kne, kde, kdv, ksv, kse = caps
    assert len(new_vertices) <= knv and len(new_edges) <= kne
    assert len(del_edges) <= kde and len(del_vertices) <= kdv
    assert len(set_vprops) <= ksv and len(set_eprops) <= kse

    def pad(arr, cap, fill=0, width=None):
        a = np.asarray(arr, dtype=np.int64)
        shape = (cap,) if width is None else (cap, width)
        out = np.full(shape, fill, np.int32)
        out[: len(a)] = a.reshape((len(a),) + shape[1:])
        return torch.as_tensor(out, device=dev)

    n = lambda k: torch.tensor(k, dtype=torch.int32, device=dev)
    ne, sv, se = list(new_edges), list(set_vprops), list(set_eprops)
    return MutationBatch(
        nv_label=pad([v[0] for v in new_vertices], knv, -1),
        nv_props=pad([v[1] for v in new_vertices], knv, PROP_MISSING, spec.n_vprops),
        nv_n=n(len(new_vertices)),
        ne_src=pad([e[0] for e in ne], kne, -1),
        ne_dst=pad([e[1] for e in ne], kne, -1),
        ne_label=pad([e[2] for e in ne], kne, -1),
        ne_props=pad([e[3] for e in ne], kne, PROP_MISSING, spec.n_eprops),
        ne_n=n(len(ne)),
        de_eid=pad(list(del_edges), kde, -1),
        de_n=n(len(del_edges)),
        dv_vid=pad(list(del_vertices), kdv, -1),
        dv_n=n(len(del_vertices)),
        sv_vid=pad([x[0] for x in sv], ksv, -1),
        sv_pid=pad([x[1] for x in sv], ksv, 0),
        sv_val=pad([x[2] for x in sv], ksv, PROP_MISSING),
        sv_n=n(len(sv)),
        se_eid=pad([x[0] for x in se], kse, -1),
        se_pid=pad([x[1] for x in se], kse, 0),
        se_val=pad([x[2] for x in se], kse, PROP_MISSING),
        se_n=n(len(se)),
    )


def _sec_mask(ids, n):
    return torch.arange(ids.shape[0], device=ids.device) < n


def _set_cells(table, rows, cols, vals, keep):
    """``table.at[where(keep, rows, OOB), cols].set(vals, mode="drop")`` on a
    copy, with duplicate cells resolved last-writer-wins like the reference."""
    R, C = table.shape
    rows = rows.long()
    rows = torch.where(rows < 0, rows + R, rows)
    keep = keep & (rows >= 0) & (rows < R)
    flat = rows * C + cols.long()
    keep = keep_last_occurrence(flat, keep)
    return scatter_drop(table.reshape(-1), flat, vals, keep).reshape(R, C)


def shard_mutation_rows(applied: AppliedMutations, n: int, me: int) -> AppliedMutations:
    """Round-robin slice of every change section for rank ``me`` of ``n``:
    rows ``me, me + n, me + 2n, ...`` of both the batch arrays and the
    listener's pre-image snapshots, each section's live count recomputed
    for the slice (the replicated tier's gRW listener splits its work over
    the ranks this way). Local row ``j`` of rank ``me`` is global row
    ``me + n * j``: ``derive_cache_ops``' ``row_offset`` / ``row_stride``
    turn it back into the global order key. Every section keeps
    ``ceil(K / n)`` rows, gathered with the index clipped, so the shapes
    depend on ``n`` alone, as in the reference."""

    def sl(count, *arrs):
        K = arrs[0].shape[0]
        idx = me + n * torch.arange(-(-K // n), dtype=torch.int32, device=arrs[0].device)
        return [(idx < count).sum(dtype=torch.int32)] + [take_along0(a, idx) for a in arrs]

    b = applied.batch
    nv_n, nv_label, nv_props, nv_vid = sl(b.nv_n, b.nv_label, b.nv_props, applied.nv_vid)
    ne_n, ne_src, ne_dst, ne_label, ne_props, ne_eid = sl(
        b.ne_n, b.ne_src, b.ne_dst, b.ne_label, b.ne_props, applied.ne_eid)
    de_n, de_eid, de_src, de_dst, de_label, de_props = sl(
        b.de_n, b.de_eid, applied.de_src, applied.de_dst, applied.de_label, applied.de_props)
    dv_n, dv_vid = sl(b.dv_n, b.dv_vid)
    sv_n, sv_vid, sv_pid, sv_val, sv_old = sl(b.sv_n, b.sv_vid, b.sv_pid, b.sv_val,
                                              applied.sv_old)
    se_n, se_eid, se_pid, se_val, se_old, se_src, se_dst, se_label, se_props = sl(
        b.se_n, b.se_eid, b.se_pid, b.se_val, applied.se_old, applied.se_src, applied.se_dst,
        applied.se_label, applied.se_props)
    batch = MutationBatch(
        nv_label=nv_label, nv_props=nv_props, nv_n=nv_n,
        ne_src=ne_src, ne_dst=ne_dst, ne_label=ne_label, ne_props=ne_props, ne_n=ne_n,
        de_eid=de_eid, de_n=de_n, dv_vid=dv_vid, dv_n=dv_n,
        sv_vid=sv_vid, sv_pid=sv_pid, sv_val=sv_val, sv_n=sv_n,
        se_eid=se_eid, se_pid=se_pid, se_val=se_val, se_n=se_n,
    )
    return AppliedMutations(
        batch=batch, ne_eid=ne_eid, nv_vid=nv_vid,
        de_src=de_src, de_dst=de_dst, de_label=de_label, de_props=de_props,
        sv_old=sv_old, se_old=se_old, se_src=se_src, se_dst=se_dst, se_label=se_label,
        se_props=se_props, commit_version=applied.commit_version,
    )


def apply_mutations(spec: StoreSpec, store: GraphStore, batch: MutationBatch):
    """Apply one commit. Returns ``(new store, AppliedMutations)``."""
    new_version = store.version + 1
    where = torch.where

    # ---- pre-images (captured against the pre-state) -----------------------
    de_mask = _sec_mask(batch.de_eid, batch.de_n)
    de_src = where(de_mask, take_along0(store.esrc, batch.de_eid), -1)
    de_dst = where(de_mask, take_along0(store.edst, batch.de_eid), -1)
    de_label = where(de_mask, take_along0(store.elabel, batch.de_eid), -1)
    de_props = where(de_mask[:, None], take_along0(store.eprops, batch.de_eid),
                     PROP_MISSING)
    sv_mask = _sec_mask(batch.sv_vid, batch.sv_n)
    sv_pcol = batch.sv_pid.clamp(0, spec.n_vprops - 1).long()
    sv_rows = take_along0(store.vprops, batch.sv_vid)
    sv_old = where(sv_mask, sv_rows.gather(1, sv_pcol[:, None])[:, 0], PROP_MISSING)
    se_mask = _sec_mask(batch.se_eid, batch.se_n)
    se_pcol = batch.se_pid.clamp(0, spec.n_eprops - 1).long()
    se_rows = take_along0(store.eprops, batch.se_eid)
    se_old = where(se_mask, se_rows.gather(1, se_pcol[:, None])[:, 0], PROP_MISSING)
    se_src = where(se_mask, take_along0(store.esrc, batch.se_eid), -1)
    se_dst = where(se_mask, take_along0(store.edst, batch.se_eid), -1)
    se_label = where(se_mask, take_along0(store.elabel, batch.se_eid), -1)

    # ---- allocate new vertex / edge slots ----------------------------------
    dev = store.vlabel.device
    knv = batch.nv_label.shape[0]
    kne = batch.ne_src.shape[0]
    nv_mask = _sec_mask(batch.nv_label, batch.nv_n)
    ne_mask = _sec_mask(batch.ne_src, batch.ne_n)
    nv_vid = where(nv_mask, store.v_len + torch.arange(knv, dtype=torch.int32, device=dev), -1)
    ne_eid = where(ne_mask, store.e_len + torch.arange(kne, dtype=torch.int32, device=dev), -1)

    vlabel = scatter_drop(store.vlabel, nv_vid, batch.nv_label, nv_mask)
    valive = scatter_drop(store.valive, nv_vid, True, nv_mask)
    vprops = scatter_drop(store.vprops, nv_vid, batch.nv_props, nv_mask)
    esrc = scatter_drop(store.esrc, ne_eid, batch.ne_src, ne_mask)
    edst = scatter_drop(store.edst, ne_eid, batch.ne_dst, ne_mask)
    elabel = scatter_drop(store.elabel, ne_eid, batch.ne_label, ne_mask)
    ealive = scatter_drop(store.ealive, ne_eid, True, ne_mask)
    eprops = scatter_drop(store.eprops, ne_eid, batch.ne_props, ne_mask)

    # ---- property writes ----------------------------------------------------
    vprops = _set_cells(vprops, batch.sv_vid, sv_pcol, batch.sv_val, sv_mask)
    eprops = _set_cells(eprops, batch.se_eid, se_pcol, batch.se_val, se_mask)
    se_props_new = where(se_mask[:, None], take_along0(eprops, batch.se_eid),
                         PROP_MISSING)

    # ---- deletes -------------------------------------------------------------
    ealive = scatter_drop(ealive, batch.de_eid, False, de_mask)
    dv_mask = _sec_mask(batch.dv_vid, batch.dv_n)
    valive = scatter_drop(valive, batch.dv_vid, False, dv_mask)

    # ---- version bumps (write-conflict ranges at vertex granularity) -------
    vids = torch.cat([batch.ne_src, batch.ne_dst, de_src, de_dst, batch.sv_vid,
                      se_src, se_dst, batch.dv_vid, nv_vid])
    vmask = torch.cat([ne_mask, ne_mask, de_mask, de_mask, sv_mask, se_mask,
                       se_mask, dv_mask, nv_mask])
    vversion = scatter_drop(store.vversion, vids, new_version, vmask)

    new_store = store._replace(
        vlabel=vlabel,
        valive=valive,
        vprops=vprops,
        vversion=vversion,
        esrc=esrc,
        edst=edst,
        elabel=elabel,
        ealive=ealive,
        eprops=eprops,
        v_len=store.v_len + batch.nv_n,
        e_len=store.e_len + batch.ne_n,
        version=new_version,
    )
    applied = AppliedMutations(
        batch=batch,
        ne_eid=ne_eid,
        nv_vid=nv_vid,
        de_src=de_src,
        de_dst=de_dst,
        de_label=de_label,
        de_props=de_props,
        sv_old=sv_old,
        se_old=se_old,
        se_src=se_src,
        se_dst=se_dst,
        se_label=se_label,
        se_props=se_props_new,
        commit_version=new_version,
    )
    return new_store, applied
