"""The tensor property-graph store.

PyTorch twin of ``repro.graphstore.store``. Vertices and edges live in
fixed-capacity slot arrays (the slot index is the immutable id). Out-/in-edge
adjacency is served by CSR permutation indexes built at compaction time over
slots ``[0, csr_len)``; edges appended after the last compaction sit in the
*recent region* ``[csr_len, e_len)`` and are found by a bounded linear scan
of ``recent_cap`` slots. All reads are masked by liveness, so deletes are
O(1) writes and never need index maintenance.

State is functional: every function returns new tensors for the fields it
changes and never writes into a tensor the caller holds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils import INT32_MAX, PROP_MISSING, resolve_device, take_along0


class StoreSpec(NamedTuple):
    """Static shape/capacity configuration."""

    v_cap: int = 1024
    e_cap: int = 8192
    n_vprops: int = 4
    n_eprops: int = 2
    recent_cap: int = 256


class GraphStore(NamedTuple):
    """Device tensors. See the module docstring for the layout."""

    # vertex slots
    vlabel: torch.Tensor  # int32 [v_cap]
    valive: torch.Tensor  # bool  [v_cap]
    vprops: torch.Tensor  # int32 [v_cap, n_vprops]
    vversion: torch.Tensor  # int32 [v_cap]  (FDB-style conflict ranges)
    # edge slots
    esrc: torch.Tensor  # int32 [e_cap]
    edst: torch.Tensor  # int32 [e_cap]
    elabel: torch.Tensor  # int32 [e_cap]
    ealive: torch.Tensor  # bool  [e_cap]
    eprops: torch.Tensor  # int32 [e_cap, n_eprops]
    # CSR indexes over [0, csr_len)
    out_indptr: torch.Tensor  # int32 [v_cap + 1]
    out_perm: torch.Tensor  # int32 [e_cap]  (CSR position -> edge slot)
    in_indptr: torch.Tensor  # int32 [v_cap + 1]
    in_perm: torch.Tensor  # int32 [e_cap]
    # scalars (0-d int32 tensors)
    v_len: torch.Tensor
    e_len: torch.Tensor
    csr_len: torch.Tensor
    version: torch.Tensor  # global commit version


def empty_store(spec: StoreSpec, device=None) -> GraphStore:
    dev = resolve_device(device)
    i32 = torch.int32
    full = lambda shape, v, dt=i32: torch.full(shape, v, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    return GraphStore(
        vlabel=full((spec.v_cap,), -1),
        valive=full((spec.v_cap,), False, torch.bool),
        vprops=full((spec.v_cap, spec.n_vprops), PROP_MISSING),
        vversion=full((spec.v_cap,), 0),
        esrc=full((spec.e_cap,), INT32_MAX),
        edst=full((spec.e_cap,), -1),
        elabel=full((spec.e_cap,), -1),
        ealive=full((spec.e_cap,), False, torch.bool),
        eprops=full((spec.e_cap, spec.n_eprops), PROP_MISSING),
        out_indptr=full((spec.v_cap + 1,), 0),
        out_perm=full((spec.e_cap,), 0),
        in_indptr=full((spec.v_cap + 1,), 0),
        in_perm=full((spec.e_cap,), 0),
        v_len=zero,
        e_len=zero,
        csr_len=zero,
        version=zero,
    )


def ingest(
    spec: StoreSpec,
    vlabels: np.ndarray,
    vprops: np.ndarray,
    esrc: np.ndarray,
    edst: np.ndarray,
    elabels: np.ndarray,
    eprops: np.ndarray,
    device=None,
) -> GraphStore:
    """Bulk-load a graph from host arrays and compact."""
    store = empty_store(spec, device)
    dev = store.vlabel.device
    nv, ne = len(vlabels), len(esrc)
    assert nv <= spec.v_cap and ne <= spec.e_cap
    t = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
    vlabel, valive, vp = store.vlabel.clone(), store.valive.clone(), store.vprops.clone()
    es, ed, el = store.esrc.clone(), store.edst.clone(), store.elabel.clone()
    ea, ep = store.ealive.clone(), store.eprops.clone()
    vlabel[:nv] = t(vlabels)
    valive[:nv] = True
    vp[:nv] = t(vprops).reshape(nv, spec.n_vprops)
    es[:ne] = t(esrc)
    ed[:ne] = t(edst)
    el[:ne] = t(elabels)
    ea[:ne] = True
    ep[:ne] = t(eprops).reshape(ne, spec.n_eprops)
    store = store._replace(
        vlabel=vlabel, valive=valive, vprops=vp, esrc=es, edst=ed, elabel=el,
        ealive=ea, eprops=ep,
        v_len=torch.tensor(nv, dtype=torch.int32, device=dev),
        e_len=torch.tensor(ne, dtype=torch.int32, device=dev),
    )
    return compact(spec, store)


def _csr(spec: StoreSpec, key, allocated):
    k = torch.where(allocated, key, torch.full_like(key, INT32_MAX))
    ks, perm = torch.sort(k, stable=True)
    bounds = torch.arange(spec.v_cap + 1, dtype=torch.int32, device=key.device)
    indptr = torch.searchsorted(ks, bounds, right=False).to(torch.int32)
    return indptr, perm.to(torch.int32)


def compact(spec: StoreSpec, store: GraphStore) -> GraphStore:
    """Rebuild both CSR indexes over all allocated edge slots.

    Sort-based; dead edges keep their slots but are masked at read time.
    Afterwards the recent region is empty and every edge is range-readable.
    """
    idx = torch.arange(spec.e_cap, dtype=torch.int32, device=store.esrc.device)
    allocated = idx < store.e_len
    out_indptr, operm = _csr(spec, store.esrc, allocated)
    in_indptr, iperm = _csr(spec, store.edst, allocated)
    return store._replace(
        out_indptr=out_indptr,
        out_perm=operm,
        in_indptr=in_indptr,
        in_perm=iperm,
        csr_len=store.e_len.clone(),
    )


def _gather(spec: StoreSpec, store: GraphStore, roots, max_deg: int, *,
            incoming: bool):
    """Padded adjacency gather: CSR rows + recent-region scan.

    Returns (eids [B, W], other [B, W], mask [B, W], truncated [B]) where
    W = max_deg + recent_cap and ``other`` is the opposite endpoint.
    ``truncated`` flags supernode rows whose CSR degree exceeded max_deg.
    """
    indptr = store.in_indptr if incoming else store.out_indptr
    perm = store.in_perm if incoming else store.out_perm
    key_side = store.edst if incoming else store.esrc
    other_side = store.esrc if incoming else store.edst
    dev = roots.device

    roots = roots.to(torch.int32)
    rvalid = (roots >= 0) & (roots < spec.v_cap)
    rc = roots.clamp(0, spec.v_cap - 1).long()
    start = indptr[rc]
    deg = indptr[rc + 1] - start
    truncated = deg > max_deg
    lanes = torch.arange(max_deg, dtype=torch.int32, device=dev)
    pos = start[:, None] + lanes[None, :]
    csr_mask = (lanes[None, :] < deg[:, None]) & rvalid[:, None]
    eid_csr = take_along0(perm, pos)

    # recent region [csr_len, csr_len + recent_cap), read at a device offset
    # (index arithmetic instead of a slice, so no host read of csr_len)
    roff = store.csr_len.clamp(0, spec.e_cap - spec.recent_cap)
    eid_r = roff + torch.arange(spec.recent_cap, dtype=torch.int32, device=dev)
    key_r = key_side[eid_r.long()]
    in_region = (eid_r >= store.csr_len) & (eid_r < store.e_len)
    rec_mask = (key_r[None, :] == roots[:, None]) & in_region[None, :]
    rec_mask &= rvalid[:, None]
    eid_rec = eid_r[None, :].expand(roots.shape[0], spec.recent_cap)

    eids = torch.cat([eid_csr, eid_rec], dim=1)
    mask = torch.cat([csr_mask, rec_mask], dim=1)
    # liveness: edge alive, both endpoints alive
    mask &= take_along0(store.ealive, eids)
    other = take_along0(other_side, eids)
    mask &= take_along0(store.valive, other)
    mask &= take_along0(store.valive, roots[:, None].expand(eids.shape))
    return eids, other, mask, truncated


def gather_out(spec: StoreSpec, store: GraphStore, roots, max_deg: int):
    """Outgoing edges of each root. See ``_gather``."""
    return _gather(spec, store, roots, max_deg, incoming=False)


def gather_in(spec: StoreSpec, store: GraphStore, roots, max_deg: int):
    """Incoming edges of each root. See ``_gather``."""
    return _gather(spec, store, roots, max_deg, incoming=True)


class GlobalStoreView:
    """Storage view of a full single-host ``GraphStore``: vertex attribute
    tensors plus a padded adjacency gather that also resolves each scanned
    edge's label/properties. ``own`` is ``None``: one host owns every vertex.
    """

    own = None

    def __init__(self, spec: StoreSpec, store: GraphStore):
        self.spec = spec
        self.store = store

    @property
    def vlabel(self):
        return self.store.vlabel

    @property
    def vprops(self):
        return self.store.vprops

    @property
    def valive(self):
        return self.store.valive

    def adjacency(self, roots, max_deg: int, *, incoming: bool):
        """Returns ``(other [B, W], mask, truncated [B], elabel, eprops)``."""
        eids, other, mask, trunc = _gather(
            self.spec, self.store, roots, max_deg, incoming=incoming
        )
        elab = take_along0(self.store.elabel, eids)
        ep = take_along0(self.store.eprops, eids)
        return other, mask, trunc, elab, ep
