"""The partitioned dual-CSR storage tier: owner-local edge blocks.

PyTorch twin of ``repro.graphstore.partition``: the read side, the geid
index, the gRW commit (``apply_mutations_partitioned``) and the recovery
splice (``splice_owner_blocks``); block maintenance is in
``graphstore.maintenance``. ``PartitionedGraphStore`` splits edge
storage into owner-local blocks, so a one-hop scan reads only tensors of
the shard that owns the hop's root:

- the **out block** of shard ``s`` holds every edge whose *src* vertex
  ``s`` owns, CSR-ordered by src;
- the **in block** of shard ``s`` holds every edge whose *dst* vertex ``s``
  owns, CSR-ordered by dst.

Each block's CSR region ``[0, csr_len)`` is physically sorted by (key,
global edge id) and appends sit in its recent region ``[csr_len, blk_len)``,
so a block gather returns the single-host gather's lanes in the same order.
Ownership is interleaved (``owner_of(v) = v mod n``, local index ``v // n``).
The vertex attribute tier (labels, liveness, properties, versions) and the
scalars stay replicated: the partitioned store shares those tensors with the
single-host store it was built from.

Arrays carry the global layout ``[n * e_blk_cap, ...]``, shard ``s`` at rows
``[s * e_blk_cap, (s + 1) * e_blk_cap)``; ``local_shard`` returns views of
those rows, never copies. So the commit is functional: it writes copies of
what it changes and never a view the caller holds.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed.routing import storage_owner_of
from repro_torch.distributed.sharding import ALL_REDUCE_SUM
from repro_torch.graphstore.mutations import AppliedMutations, _sec_mask, _set_cells
from repro_torch.graphstore.store import GraphStore, StoreSpec, empty_store
from repro_torch.utils import INT32_MAX, PROP_MISSING, scatter_drop, take_along0


class PartitionedStoreSpec(NamedTuple):
    """Static layout of a partitioned store.

    ``e_blk_cap`` bounds edges per block (per orientation, per shard);
    ``recent_blk_cap`` is the per-block append-scan window.
    """

    base: StoreSpec
    n_shards: int
    e_blk_cap: int
    recent_blk_cap: int

    @property
    def v_loc(self) -> int:
        return self.base.v_cap // self.n_shards


def owner_of(vids, n: int):
    """Interleaved ownership: shard ``v mod n`` owns vertex ``v``. Any int
    maps to exactly one shard; callers mask negatives where they mean
    padding."""
    return torch.remainder(torch.as_tensor(vids).to(torch.int32), n)


def local_of(vids, n: int):
    """Owner-local vertex index under interleaved ownership (floor division,
    as ``jnp``'s ``//``)."""
    return torch.div(torch.as_tensor(vids).to(torch.int32), n, rounding_mode="floor")


def default_pspec(spec: StoreSpec, n_shards: int, *, slack: float = 2.0,
                  recent_blk_cap: int | None = None) -> PartitionedStoreSpec:
    """Block capacities for a given shard count: ``slack`` times the uniform
    share (ownership skew headroom); the recent window defaults to the base
    store's."""
    if spec.v_cap // n_shards * n_shards != spec.v_cap:
        raise ValueError(f"v_cap {spec.v_cap} does not divide over {n_shards} shards")
    eb = int(math.ceil(spec.e_cap * slack / n_shards))
    rb = min(spec.recent_cap if recent_blk_cap is None else recent_blk_cap, eb)
    return PartitionedStoreSpec(spec, n_shards, eb, rb)


class BlockCapacityError(ValueError):
    """A shard's owner-local block cannot hold the edges it owns; ``needed``
    carries the largest per-shard edge count of the failing orientation."""

    def __init__(self, msg: str, needed: int):
        super().__init__(msg)
        self.needed = needed


class EdgeBlock(NamedTuple):
    """One orientation's owner-local edge copies, all shards stacked.

    ``key`` is the owner-side endpoint, ``other`` the opposite one, ``geid``
    the global edge id. ``gperm`` is the sorted geid -> slot index: allocated
    slots by ascending geid, then the unallocated tail in slot order.
    """

    key: torch.Tensor  # int32 [n*EB]
    other: torch.Tensor  # int32 [n*EB]
    label: torch.Tensor  # int32 [n*EB]
    alive: torch.Tensor  # bool  [n*EB]
    props: torch.Tensor  # int32 [n*EB, n_eprops]
    geid: torch.Tensor  # int32 [n*EB]
    gperm: torch.Tensor  # int32 [n*EB]
    indptr: torch.Tensor  # int32 [n*(v_loc+1)] CSR row offsets (local vertex)
    blk_len: torch.Tensor  # int32 [n] edges in the block
    csr_len: torch.Tensor  # int32 [n] CSR region length


class PartitionedGraphStore(NamedTuple):
    """The sharded storage tier. See the module docstring."""

    vlabel: torch.Tensor  # int32 [v_cap]  (replicated)
    valive: torch.Tensor  # bool  [v_cap]
    vprops: torch.Tensor  # int32 [v_cap, n_vprops]
    vversion: torch.Tensor  # int32 [v_cap]
    out: EdgeBlock
    inc: EdgeBlock
    v_len: torch.Tensor
    e_len: torch.Tensor
    version: torch.Tensor


# ------------------------------------------------------------------ build
def _build_block(pspec: PartitionedStoreSpec, keyside, otherside, elabel, ealive,
                 eprops, e_len: int, csr_len: int) -> EdgeBlock:
    """One orientation's blocks, built with sorts on the tensors' device."""
    n, EB, Vloc = pspec.n_shards, pspec.e_blk_cap, pspec.v_loc
    dev = keyside.device
    i32 = dict(dtype=torch.int32, device=dev)
    key = torch.full((n * EB,), INT32_MAX, **i32)
    other = torch.full((n * EB,), -1, **i32)
    label = torch.full((n * EB,), -1, **i32)
    alive = torch.zeros((n * EB,), dtype=torch.bool, device=dev)
    props = torch.full((n * EB, eprops.shape[1]), PROP_MISSING, **i32)
    geid = torch.full((n * EB,), -1, **i32)
    gperm = torch.zeros((n * EB,), **i32)
    indptr = torch.zeros((n * (Vloc + 1),), **i32)
    blk_len = torch.zeros((n,), **i32)
    csr_blk = torch.zeros((n,), **i32)

    slots = torch.arange(e_len, dtype=torch.int64, device=dev)
    keys = keyside[:e_len]
    owner = owner_of(keys, n).long()
    counts = torch.bincount(owner, minlength=n).cpu()
    if e_len and int(counts.max()) > EB:
        worst = int(counts.argmax())
        raise BlockCapacityError(
            f"shard {worst} owns {int(counts.max())} edges of this orientation > "
            f"e_blk_cap={EB}. Raise e_blk_cap / blk_slack.",
            needed=int(counts.max()),
        )
    lanes = torch.arange(EB, dtype=torch.int64, device=dev)
    bounds = torch.arange(Vloc + 1, dtype=torch.int32, device=dev)
    for s in range(n):
        mine = slots[owner == s]
        csr_mine = mine[mine < csr_len]
        rec_mine = mine[mine >= csr_len]
        # CSR region: stable sort by owner-side key; ties keep global-slot
        # order, the single-host stable argsort's lane order
        order = torch.sort(keyside[csr_mine], stable=True).indices
        csr_sorted = csr_mine[order]
        local = torch.cat([csr_sorted, rec_mine])
        m = local.shape[0]
        rows = slice(s * EB, s * EB + m)
        key[rows] = keyside[local]
        other[rows] = otherside[local]
        label[rows] = elabel[local]
        alive[rows] = ealive[local]
        props[rows] = eprops[local]
        geid[rows] = local.to(torch.int32)
        blk_len[s] = m
        csr_blk[s] = csr_sorted.shape[0]
        # sorted geid -> slot index: allocated slots by ascending geid, then
        # the unallocated tail in slot order (stable ties on the sentinel)
        masked = torch.where(lanes < m, geid[s * EB:(s + 1) * EB].long(), INT32_MAX)
        gperm[s * EB:(s + 1) * EB] = torch.sort(masked, stable=True).indices.to(torch.int32)
        lk = local_of(keyside[csr_sorted], n).contiguous()
        indptr[s * (Vloc + 1):(s + 1) * (Vloc + 1)] = torch.searchsorted(
            lk, bounds, right=False).to(torch.int32)
    return EdgeBlock(key=key, other=other, label=label, alive=alive, props=props,
                     geid=geid, gperm=gperm, indptr=indptr, blk_len=blk_len,
                     csr_len=csr_blk)


def partition_store(pspec: PartitionedStoreSpec, store: GraphStore) -> PartitionedGraphStore:
    """Partition a ``GraphStore`` into owner-local blocks on its device.

    A pure layout change: the partitioned store serves identical reads.
    Dead-but-allocated edges keep their CSR lanes (masked at read time), so
    per-root CSR degrees, truncation flags and scan metrics match the
    source store.
    """
    e_len, csr_len = int(store.e_len), int(store.csr_len)
    args = (store.elabel, store.ealive, store.eprops, e_len, csr_len)
    out = _build_block(pspec, store.esrc, store.edst, *args)
    inc = _build_block(pspec, store.edst, store.esrc, *args)
    return PartitionedGraphStore(
        vlabel=store.vlabel, valive=store.valive, vprops=store.vprops,
        vversion=store.vversion, out=out, inc=inc,
        v_len=store.v_len, e_len=store.e_len, version=store.version,
    )


def abstract_partitioned_store(pspec: PartitionedStoreSpec) -> PartitionedGraphStore:
    """The shapes and dtypes of a partitioned store, as tensors on the
    ``meta`` device (no storage): the template a checkpoint restores into."""
    spec, n = pspec.base, pspec.n_shards
    EB, Vloc = pspec.e_blk_cap, pspec.v_loc
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    b8 = lambda *shape: torch.empty(shape, dtype=torch.bool, device="meta")

    def blk():
        return EdgeBlock(
            key=i32(n * EB), other=i32(n * EB), label=i32(n * EB), alive=b8(n * EB),
            props=i32(n * EB, spec.n_eprops), geid=i32(n * EB), gperm=i32(n * EB),
            indptr=i32(n * (Vloc + 1)), blk_len=i32(n), csr_len=i32(n),
        )

    return PartitionedGraphStore(
        vlabel=i32(spec.v_cap), valive=b8(spec.v_cap), vprops=i32(spec.v_cap, spec.n_vprops),
        vversion=i32(spec.v_cap), out=blk(), inc=blk(), v_len=i32(), e_len=i32(), version=i32(),
    )


# ------------------------------------------------------------------ bytes
def tree_nbytes(tree) -> int:
    """Total tensor bytes of a (nested) tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(tree_nbytes(t) for t in tree)


def store_bytes_report(pspec: PartitionedStoreSpec, pstore: PartitionedGraphStore) -> dict:
    """Per-shard bytes of the partitioned tier vs the replicated snapshot.

    ``per_shard_bytes`` counts one shard's edge blocks plus its copy of the
    replicated vertex / scalar tier; ``replicated_per_shard_bytes`` is the
    full single-host ``GraphStore`` each shard would otherwise carry.
    """
    n = pspec.n_shards
    blocks = tree_nbytes((pstore.out, pstore.inc))
    repl = tree_nbytes((pstore.vlabel, pstore.valive, pstore.vprops, pstore.vversion,
                        pstore.v_len, pstore.e_len, pstore.version))
    per_shard = blocks // n + repl
    baseline = tree_nbytes(empty_store(pspec.base, device="meta"))
    return dict(
        n_shards=n,
        per_shard_bytes=per_shard,
        per_shard_block_bytes=blocks // n,
        per_shard_replicated_bytes=repl,
        replicated_per_shard_bytes=baseline,
        ratio=per_shard / baseline,
        ideal_ratio=1.0 / n,
    )


# ------------------------------------------------------------------ reads
def gather_block(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore, roots,
                 max_deg: int, *, incoming: bool, me, rtable=None):
    """Owner-local padded adjacency gather (one shard's view, ``ps`` holding
    that shard's block slices).

    Mirror of ``store._gather``: CSR lanes from the sorted block region plus
    a bounded recent-region scan. Returns ``(slots [B, W], other [B, W],
    mask [B, W], truncated [B])`` with ``W = max_deg + recent_blk_cap``;
    ``slots`` index the local block. Roots this shard does not own come back
    fully masked. With a routing table the CSR window opens only for native
    roots (a migrated-in root's local index would alias a native vertex's
    rows), and so does the truncation flag.
    """
    spec, n = pspec.base, pspec.n_shards
    EB, Vloc, R = pspec.e_blk_cap, pspec.v_loc, pspec.recent_blk_cap
    blk = ps.inc if incoming else ps.out
    dev = roots.device

    roots = roots.to(torch.int32)
    local = local_of(roots, n)
    rvalid = (storage_owner_of(rtable, roots, n) == me) & (roots >= 0) & (roots < spec.v_cap)
    if rtable is None:
        cvalid = rvalid
    else:
        native = owner_of(roots, n) == me
        cvalid = rvalid & native
    lc = local.clamp(0, Vloc - 1).long()
    start = blk.indptr[lc]
    deg = blk.indptr[lc + 1] - start
    truncated = deg > max_deg
    if rtable is not None:
        truncated &= native
    lane = torch.arange(max_deg, dtype=torch.int32, device=dev)
    pos = start[:, None] + lane[None, :]
    csr_mask = (lane[None, :] < deg[:, None]) & cvalid[:, None]
    slot_csr = pos.clamp(0, EB - 1)

    # recent region of this block: [csr_len, blk_len) within a bounded
    # window, read at a device offset (no host read of csr_len)
    clb, lb = blk.csr_len[0], blk.blk_len[0]
    sid = clb.clamp(0, EB - R) + torch.arange(R, dtype=torch.int32, device=dev)
    key_r = blk.key[sid.long()]
    in_region = (sid >= clb) & (sid < lb)
    rec_mask = (key_r[None, :] == roots[:, None]) & in_region[None, :] & rvalid[:, None]
    slot_rec = sid[None, :].expand(roots.shape[0], R)

    slots = torch.cat([slot_csr, slot_rec], dim=1)
    mask = torch.cat([csr_mask, rec_mask], dim=1)
    # liveness chain of the single-host gather: edge alive, both endpoints
    # alive (leaf via the replicated vertex tier)
    mask &= take_along0(blk.alive, slots)
    other = take_along0(blk.other, slots)
    mask &= take_along0(ps.valive, other)
    mask &= take_along0(ps.valive, roots[:, None].expand(slots.shape))
    return slots, other, mask, truncated


class BlockGatherOperands(NamedTuple):
    """One orientation's owner-local block as the ``block_gather`` kernel's
    positional operands (see ``kernels/block_gather`` for the contract)."""

    indptr: torch.Tensor  # int32 [v_loc + 1] CSR row index (local vertex ids)
    key: torch.Tensor  # int32 [e_blk_cap] owner-side key per edge record
    other: torch.Tensor  # int32 [e_blk_cap] global leaf id per edge record
    label: torch.Tensor  # int32 [e_blk_cap] edge label
    alive: torch.Tensor  # bool  [e_blk_cap] edge liveness
    props: torch.Tensor  # int32 [e_blk_cap, NEP] edge properties
    vlabel: torch.Tensor  # int32 [v_cap] replicated vertex labels
    valive: torch.Tensor  # bool  [v_cap] replicated vertex liveness
    vprops: torch.Tensor  # int32 [v_cap, NVP] replicated vertex properties
    csr_len: torch.Tensor  # int32 [] sorted-region length of this block
    blk_len: torch.Tensor  # int32 [] allocated length (recent = [csr, blk))


class BlockStoreView:
    """One shard's storage view over its owner-local blocks: the interface
    of ``store.GlobalStoreView``, with vertex attributes from the replicated
    tier and adjacency from the local dual-CSR blocks. ``ps`` holds the
    shard's block slices (``local_shard``); ``rtable`` makes ownership
    table-driven (``None`` = the base rule)."""

    def __init__(self, pspec: PartitionedStoreSpec, ps: PartitionedGraphStore, me: int,
                 rtable=None):
        self.pspec = pspec
        self.ps = ps
        self.me = int(me)
        self.rtable = rtable

    @property
    def vlabel(self):
        return self.ps.vlabel

    @property
    def vprops(self):
        return self.ps.vprops

    @property
    def valive(self):
        return self.ps.valive

    def own(self, vids):
        """Which of ``vids`` this shard owns (their storage owner under the
        routing table); the listener gates its emissions by it."""
        return storage_owner_of(self.rtable, vids, self.pspec.n_shards) == self.me

    def adjacency(self, roots, max_deg: int, *, incoming: bool):
        """Returns ``(other [B, W], mask, truncated [B], elabel, eprops)``."""
        slots, other, mask, trunc = gather_block(
            self.pspec, self.ps, roots, max_deg, incoming=incoming, me=self.me,
            rtable=self.rtable,
        )
        blk = self.ps.inc if incoming else self.ps.out
        return other, mask, trunc, take_along0(blk.label, slots), take_along0(blk.props, slots)

    def kernel_operands(self, *, incoming: bool) -> BlockGatherOperands:
        """The tensors the ``block_gather`` kernel streams, in its argument
        order; the fill scalars stay on the device."""
        blk = self.ps.inc if incoming else self.ps.out
        return BlockGatherOperands(
            indptr=blk.indptr, key=blk.key, other=blk.other, label=blk.label,
            alive=blk.alive, props=blk.props, vlabel=self.ps.vlabel,
            valive=self.ps.valive, vprops=self.ps.vprops,
            csr_len=blk.csr_len[0], blk_len=blk.blk_len[0],
        )


# ------------------------------------------------------------- geid index
def rebuild_geid_index(blk_len, geid):
    """One block's sorted geid -> slot permutation from scratch: allocated
    slots (``< blk_len``) by ascending geid, then the unallocated tail in
    slot order, as ``partition_store`` builds it."""
    lanes = torch.arange(geid.shape[0], dtype=torch.int32, device=geid.device)
    masked = torch.where(lanes < blk_len, geid, INT32_MAX)
    return torch.sort(masked, stable=True).indices.to(torch.int32)


def sorted_geid_view(EB: int, geid, gperm, blk_len):
    """The index's ascending geid view (one gather), shareable by every
    lookup against the same block state."""
    lanes = torch.arange(EB, dtype=torch.int32, device=geid.device)
    return torch.where(lanes < blk_len, take_along0(geid, gperm), INT32_MAX)


def geid_slot_lookup(EB: int, geid, gperm, blk_len, eids, skey=None):
    """Locate global edge ids in one block through the sorted geid index:
    a binary search of the ascending view (pass ``skey`` to share it).
    Returns ``(slot [K], found [K])``; ``slot`` means something only where
    ``found``."""
    if skey is None:
        skey = sorted_geid_view(EB, geid, gperm, blk_len)
    eids = torch.as_tensor(eids).to(device=geid.device, dtype=torch.int32)
    pos = torch.searchsorted(skey, eids.contiguous(), side="left").to(torch.int32)
    posc = pos.clamp(0, EB - 1)
    slot = take_along0(gperm, posc)
    found = (pos < blk_len) & (take_along0(skey, posc) == eids) & (eids >= 0)
    return slot, found


# ----------------------------------------------------------------- writes
def _psum(x):
    """One all-reduce sum of the mesh (a per-rank program's request)."""
    return (yield (ALL_REDUCE_SUM, x))


def _lookup_block(pspec: PartitionedStoreSpec, blk: EdgeBlock, eids, skey=None):
    """Locate global edge ids in one shard's block and replicate their
    records over the mesh: exactly one shard holds an edge's copy per
    orientation, so the sum over ranks is that owner's record. A per-rank
    program; returns ``(found, key, other, label, props)``."""
    sl, found_l = geid_slot_lookup(pspec.e_blk_cap, blk.geid, blk.gperm, blk.blk_len[0],
                                   eids, skey=skey)
    contrib = lambda a: torch.where(found_l, take_along0(a, sl), 0)
    found = (yield from _psum(found_l.to(torch.int32))) > 0
    key = yield from _psum(contrib(blk.key))
    other = yield from _psum(contrib(blk.other))
    label = yield from _psum(contrib(blk.label))
    props = yield from _psum(torch.where(found_l[:, None], take_along0(blk.props, sl), 0))
    return found, key, other, label, props


def _pick(rows, col):
    """``rows[i, col[i]]`` for each row."""
    return rows.gather(1, col.long()[:, None])[:, 0]


def apply_mutations_partitioned(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore,
                                batch, me: int, rtable=None):
    """One gRW commit on shard ``me``: a per-rank program (a generator that
    yields its all-reduces; see ``distributed.sharding``) over the shard's
    ``local_shard`` view.

    New, deleted and re-propertied edges land at their src-owner's out
    block and dst-owner's in block (located by global edge id; new edges
    append to the recent region at ``blk_len + rank`` and enter the geid
    index at once); vertex sections apply to the replicated attribute tier
    on every rank alike. The pre-images the single host reads from its
    edge arrays are all-reduced from the src-owners, so the returned
    ``AppliedMutations`` equals the single host's on every rank.

    Returns ``(store', applied, append_overflow)``: ``store'`` holds the
    shard's new blocks, written as copies (``ps`` is left as it was); a
    nonzero overflow counts new edges a full block dropped, over the mesh.
    """
    spec, n = pspec.base, pspec.n_shards
    EB = pspec.e_blk_cap
    nvp, nep = spec.n_vprops, spec.n_eprops
    b = batch
    dev = ps.vlabel.device
    where = torch.where
    new_version = ps.version + 1

    nv_mask = _sec_mask(b.nv_label, b.nv_n)
    ne_mask = _sec_mask(b.ne_src, b.ne_n)
    de_mask = _sec_mask(b.de_eid, b.de_n)
    dv_mask = _sec_mask(b.dv_vid, b.dv_n)
    sv_mask = _sec_mask(b.sv_vid, b.sv_n)
    se_mask = _sec_mask(b.se_eid, b.se_n)
    se_pcol = b.se_pid.clamp(0, nep - 1)
    sv_pcol = b.sv_pid.clamp(0, nvp - 1)

    # ---- pre-images from the pre-state out blocks (one shared sorted view);
    # the defaults are what an empty slot holds
    skey_pre = sorted_geid_view(EB, ps.out.geid, ps.out.gperm, ps.out.blk_len[0])
    f_de, de_src_g, de_dst_g, de_lab_g, de_props_g = yield from _lookup_block(
        pspec, ps.out, b.de_eid, skey=skey_pre)
    de_src = where(de_mask, where(f_de, de_src_g, INT32_MAX), -1)
    de_dst = where(de_mask, where(f_de, de_dst_g, -1), -1)
    de_label = where(de_mask, where(f_de, de_lab_g, -1), -1)
    de_props = where(de_mask[:, None], where(f_de[:, None], de_props_g, PROP_MISSING),
                     PROP_MISSING)
    f_se, se_src_g, se_dst_g, se_lab_g, se_props_g = yield from _lookup_block(
        pspec, ps.out, b.se_eid, skey=skey_pre)
    se_src = where(se_mask, where(f_se, se_src_g, INT32_MAX), -1)
    se_dst = where(se_mask, where(f_se, se_dst_g, -1), -1)
    se_label = where(se_mask, where(f_se, se_lab_g, -1), -1)
    se_pre_rows = where(f_se[:, None], se_props_g, PROP_MISSING)
    se_old = where(se_mask, _pick(se_pre_rows, se_pcol), PROP_MISSING)
    sv_old = where(sv_mask, _pick(take_along0(ps.vprops, b.sv_vid), sv_pcol), PROP_MISSING)

    # ---- ids from the replicated scalars (no coordination)
    knv, kne = b.nv_label.shape[0], b.ne_src.shape[0]
    nv_vid = where(nv_mask, ps.v_len + torch.arange(knv, dtype=torch.int32, device=dev), -1)
    ne_eid = where(ne_mask, ps.e_len + torch.arange(kne, dtype=torch.int32, device=dev), -1)

    # ---- the replicated vertex-attribute tier, alike on every rank
    vlabel = scatter_drop(ps.vlabel, nv_vid, b.nv_label, nv_mask)
    valive = scatter_drop(ps.valive, nv_vid, True, nv_mask)
    vprops = scatter_drop(ps.vprops, nv_vid, b.nv_props, nv_mask)
    vprops = _set_cells(vprops, b.sv_vid, sv_pcol, b.sv_val, sv_mask)
    valive = scatter_drop(valive, b.dv_vid, False, dv_mask)
    vids = torch.cat([b.ne_src, b.ne_dst, de_src, de_dst, b.sv_vid, se_src, se_dst,
                      b.dv_vid, nv_vid])
    vmask = torch.cat([ne_mask, ne_mask, de_mask, de_mask, sv_mask, se_mask, se_mask,
                       dv_mask, nv_mask])
    vversion = scatter_drop(ps.vversion, vids, new_version, vmask)

    # ---- the shard's owner-local edge blocks
    def apply_block(blk: EdgeBlock, keysel, othersel):
        own_ne = ne_mask & (storage_owner_of(rtable, keysel, n) == me)
        rank = torch.cumsum(own_ne.to(torch.int32), 0, dtype=torch.int32) - 1
        pos = where(own_ne, blk.blk_len[0] + rank, EB)
        fits = own_ne & (pos < EB)
        ovf = (own_ne & ~fits).sum(dtype=torch.int32)
        put = lambda a, v: scatter_drop(a, pos, v, fits)
        # appended geids exceed every geid in the block (e_len only grows),
        # so an appended slot's sorted rank is its own index
        gperm = put(blk.gperm, pos.to(torch.int32))
        geid = put(blk.geid, ne_eid)
        new_len = blk.blk_len[0] + fits.sum(dtype=torch.int32)
        # prop edits and deletes find their copy after the append, so this
        # batch's new edges are editable; both share one sorted view
        skey = sorted_geid_view(EB, geid, gperm, new_len)
        sl_se, f_se_l = geid_slot_lookup(EB, geid, gperm, new_len, b.se_eid, skey=skey)
        sl_de, f_de_l = geid_slot_lookup(EB, geid, gperm, new_len, b.de_eid, skey=skey)
        props = _set_cells(put(blk.props, b.ne_props), sl_se, se_pcol, b.se_val,
                           f_se_l & se_mask)
        alive = scatter_drop(put(blk.alive, True), sl_de, False, f_de_l & de_mask)
        return blk._replace(
            key=put(blk.key, keysel), other=put(blk.other, othersel),
            label=put(blk.label, b.ne_label), alive=alive, props=props, geid=geid,
            gperm=gperm, blk_len=new_len.reshape(1),
        ), ovf

    out2, ovf_o = apply_block(ps.out, b.ne_src, b.ne_dst)
    inc2, ovf_i = apply_block(ps.inc, b.ne_dst, b.ne_src)
    ps2 = ps._replace(
        vlabel=vlabel, valive=valive, vprops=vprops, vversion=vversion, out=out2, inc=inc2,
        v_len=ps.v_len + b.nv_n, e_len=ps.e_len + b.ne_n, version=new_version,
    )
    # post-change edge-prop rows (the listener's key calc), from the new blocks
    f_sp, _, _, _, se_post_rows = yield from _lookup_block(pspec, ps2.out, b.se_eid)
    se_props_new = where(se_mask[:, None], where(f_sp[:, None], se_post_rows, PROP_MISSING),
                         PROP_MISSING)
    applied = AppliedMutations(
        batch=batch, ne_eid=ne_eid, nv_vid=nv_vid,
        de_src=de_src, de_dst=de_dst, de_label=de_label, de_props=de_props,
        sv_old=sv_old, se_old=se_old, se_src=se_src, se_dst=se_dst,
        se_label=se_label, se_props=se_props_new, commit_version=new_version,
    )
    overflow = yield from _psum(ovf_o + ovf_i)
    return ps2, applied, overflow


def local_shard(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore, s: int):
    """Shard ``s``'s local view of a global partitioned store: views of its
    block rows; the replicated tier passes through."""
    EB, Vloc = pspec.e_blk_cap, pspec.v_loc

    def blk(b: EdgeBlock) -> EdgeBlock:
        rows = slice(s * EB, (s + 1) * EB)
        return EdgeBlock(
            key=b.key[rows], other=b.other[rows], label=b.label[rows],
            alive=b.alive[rows], props=b.props[rows], geid=b.geid[rows],
            gperm=b.gperm[rows], indptr=b.indptr[s * (Vloc + 1):(s + 1) * (Vloc + 1)],
            blk_len=b.blk_len[s:s + 1], csr_len=b.csr_len[s:s + 1],
        )

    return ps._replace(out=blk(ps.out), inc=blk(ps.inc))


def join_shards(stores) -> PartitionedGraphStore:
    """The inverse of ``local_shard`` over all ranks: one store whose blocks
    are the ranks' blocks in rank order; the replicated tier, alike on every
    rank, is rank 0's."""
    join = lambda blocks: EdgeBlock(*(torch.cat(f) for f in zip(*blocks)))
    return stores[0]._replace(out=join([s.out for s in stores]),
                              inc=join([s.inc for s in stores]))



def splice_owner_blocks(pspec: PartitionedStoreSpec, dst: PartitionedGraphStore,
                        src: PartitionedGraphStore, owner: int) -> PartitionedGraphStore:
    """Graft owner ``owner``'s out / inc block rows from ``src`` into a store
    that holds ``dst``'s rows for every other owner: the transport of
    recovery as migration. ``src`` is the dead owner's rebuilt store
    (checkpoint chain + journal replay), ``dst`` the live store that kept
    serving degraded. The replicated vertex tier and the scalars come from
    ``src``: during the outage every commit queued unapplied, so the replayed
    store is the durable global state, and the live copy equals it. The geid
    index (``gperm``) lives inside the rows and travels with them, so the
    result serves at once.

    The result equals the reference's numpy function field for field. It is
    written into ``src``'s block tensors in place (the other owners' row
    ranges copied over from ``dst``), so the splice allocates nothing; a
    caller that needs ``src`` afterwards passes a clone."""
    EB, W, s = pspec.e_blk_cap, pspec.v_loc + 1, int(owner)

    def graft(d: torch.Tensor, r: torch.Tensor, rows: int):
        # every row range but the owner's: two slice copies, no temporary
        r[:s * rows].copy_(d[:s * rows])
        r[(s + 1) * rows:].copy_(d[(s + 1) * rows:])

    for d, r in ((dst.out, src.out), (dst.inc, src.inc)):
        for f in ("key", "other", "label", "alive", "props", "geid", "gperm"):
            graft(getattr(d, f), getattr(r, f), EB)
        graft(d.indptr, r.indptr, W)
        graft(d.blk_len, r.blk_len, 1)
        graft(d.csr_len, r.csr_len, 1)
    return src
