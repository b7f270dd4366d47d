"""Owner-local block maintenance: compaction, index rebuilds and capacity
growth for the partitioned dual-CSR storage tier.

PyTorch package twin of ``repro.graphstore.maintenance``. The partitioned
tier keeps each block's body physically CSR-sorted and lands appends in a
per-block recent region; without compaction that region only fills,
reads fall off its bounded scan window and appends overflow. This module
is the write path's background half:

- ``compact_block`` merges one block's recent region into its sorted body:
  a stable (tier, key, geid) sort, the indptr through ``searchsorted``, the
  geid -> slot index rebuilt. Read results are unchanged (CSR lanes ascend
  by geid within a root and recent geids exceed every CSR geid). With
  ``purge=False`` the result equals ``partition_store`` of the host-compacted
  store; ``purge=True`` also reclaims dead lanes, after which a mutation
  naming a purged geid resolves to "not found" (an opt-in for write streams
  that never name a deleted edge again).
- ``grow_store`` re-pads blocks to a larger ``e_blk_cap``, equal to
  ``partition_store`` under the grown spec. The reference's per-shard
  ``grow_block_local`` (its shard_map pad) has no twin: the pad runs in
  eager torch.
- ``MaintenancePolicy`` / ``decide_maintenance`` say when to do either, from
  the ``block_occupancy`` report.

All of it is owner-local: no collectives. ``ShardedTxnRuntime`` runs it
between batches (``maintenance_tick``) or inside a gated commit
(``run_grw_tx(gate=DeviceGate(...))``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.graphstore.partition import (
    EdgeBlock,
    PartitionedGraphStore,
    PartitionedStoreSpec,
    join_shards,
    local_of,
    local_shard,
    rebuild_geid_index,
)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.utils import INT32_MAX, PROP_MISSING


# ------------------------------------------------------------- compaction
class DeviceGate(NamedTuple):
    """The maintenance gate of a gRW commit
    (``ShardedTxnRuntime.run_grw_tx(gate=...)``): after the commit's apply
    and listener, each shard compacts every block of its whose recent fill
    reaches ``ceil(recent_fill_frac * recent_blk_cap)`` lanes. The decision
    is a function of (store, batch, gate) alone, so replaying the same
    commits through the same gate reproduces the block layout. ``purge``
    also reclaims tombstone lanes (enable it only when
    ``journal.EpochRegistry.safe_to_purge`` says so)."""

    recent_fill_frac: float = 0.5
    purge: bool = False


def compact_block(pspec: PartitionedStoreSpec, blk: EdgeBlock, *, purge: bool = False,
                  me=None) -> EdgeBlock:
    """Merge one shard's recent region into its sorted CSR body.

    ``blk`` is a local block view (``[e_blk_cap]`` lanes, as ``local_shard``
    gives it). The merged body is the stable (key, geid) order of every
    allocated edge, so every gather observable is unchanged; afterwards the
    recent region is empty (``csr_len == blk_len``). With ``purge=True``
    dead edges are dropped and their slots reclaimed.

    ``me`` (this shard's index) keeps rows a shard does not natively own
    (``key mod n != me``, migrated in) out of the CSR body, as a sorted
    prefix of the recent region where the key-compare scan serves them. On
    a block with no such rows the result equals ``me=None``.

    The reference's three stable sorts (geid, then key, then tier) are two
    here: geid, then one int64 key ``tier * 2^32 + (key + 2^31)``, the same
    order for every int32 key.
    """
    EB, Vloc, n = pspec.e_blk_cap, pspec.v_loc, pspec.n_shards
    dev = blk.key.device
    lanes = torch.arange(EB, dtype=torch.int32, device=dev)
    keep = lanes < blk.blk_len[0]
    if purge:
        keep &= blk.alive
    native = keep if me is None else keep & (torch.remainder(blk.key, n) == me)
    # native live rows form the CSR body (tier 0), foreign live rows the
    # recent region (1), dropped lanes sink to the end in slot order (2)
    tier = torch.where(native, 0, torch.where(keep, 1, 2)).to(torch.int64)
    skey = torch.where(keep, blk.key, INT32_MAX).to(torch.int64)
    sgeid = torch.where(keep, blk.geid, INT32_MAX)
    perm = torch.sort(sgeid, stable=True).indices
    tk = (tier << 32) + (skey + 2**31)
    perm = perm[torch.sort(tk[perm], stable=True).indices]
    new_len = keep.sum(dtype=torch.int32)
    csr_len = native.sum(dtype=torch.int32)
    live = lanes < new_len

    def take(a, fill):
        g = a[perm]
        m = live if g.dim() == 1 else live[:, None]
        return torch.where(m, g, torch.tensor(fill, dtype=a.dtype, device=dev))

    key = take(blk.key, INT32_MAX)
    geid = take(blk.geid, -1)
    # CSR row offsets over the native prefix (local = key // n); lanes past
    # csr_len sort past every local index
    lkey = torch.where(lanes < csr_len, local_of(key, n), INT32_MAX)
    indptr = torch.searchsorted(
        lkey, torch.arange(Vloc + 1, dtype=torch.int32, device=dev), right=False
    ).to(torch.int32)
    return EdgeBlock(
        key=key, other=take(blk.other, -1), label=take(blk.label, -1),
        alive=take(blk.alive, False), props=take(blk.props, PROP_MISSING), geid=geid,
        gperm=rebuild_geid_index(new_len, geid), indptr=indptr,
        blk_len=new_len.reshape(1), csr_len=csr_len.reshape(1),
    )


def compact_store(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore, *,
                  purge: bool = False, tracer=None) -> PartitionedGraphStore:
    """Compact both blocks of every shard of a global-layout store and join
    them in shard order; the replicated tier passes through. Owner-local: no
    collectives. ``tracer`` (an ``obs.trace.Tracer``) times the pass in a
    ``compact_store`` span. The reference's ``native_only`` (``me`` per
    shard, so migrated-in rows stay in the recent region) has no twin:
    neither package has a caller that sets it."""
    with (tracer if tracer is not None else NULL_TRACER).span("compact_store"):
        shards = [local_shard(pspec, ps, s) for s in range(pspec.n_shards)]
        return join_shards([p._replace(out=compact_block(pspec, p.out, purge=purge),
                                       inc=compact_block(pspec, p.inc, purge=purge))
                            for p in shards])


# ------------------------------------------------------------- elasticity
def _pad_blocks(blk: EdgeBlock, n: int, EB: int, NE: int) -> EdgeBlock:
    """Re-pad ``n`` stacked blocks from ``EB`` to ``NE`` lanes each: rows
    keep their slots, the tail lanes carry ``partition_store``'s empty-lane
    fills and the geid -> slot index extends with the ascending new slots
    (allocated slots are a block prefix)."""
    if NE < EB:
        raise ValueError(f"cannot shrink blocks from {EB} to {NE} lanes")
    ext = NE - EB

    def pad(a, fill):
        x = a.reshape((n, EB) + a.shape[1:])
        tail = torch.full((n, ext) + a.shape[1:], fill, dtype=a.dtype, device=a.device)
        return torch.cat([x, tail], dim=1).reshape((n * NE,) + a.shape[1:])

    gtail = torch.arange(EB, NE, dtype=torch.int32, device=blk.gperm.device)
    gperm = torch.cat([blk.gperm.reshape(n, EB), gtail.expand(n, ext)], dim=1).reshape(-1)
    return blk._replace(
        key=pad(blk.key, INT32_MAX), other=pad(blk.other, -1), label=pad(blk.label, -1),
        alive=pad(blk.alive, False), props=pad(blk.props, PROP_MISSING),
        geid=pad(blk.geid, -1), gperm=gperm,
    )


def grow_store(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore, e_blk_cap: int, *,
               recent_blk_cap: int | None = None):
    """Re-pad every block to a larger ``e_blk_cap`` (the recent window stays
    within the block). Returns ``(new_pspec, new_store)``, equal to
    ``partition_store`` under the grown spec. ``indptr`` / ``blk_len`` /
    ``csr_len`` are unchanged."""
    if e_blk_cap < pspec.e_blk_cap:
        raise ValueError(f"e_blk_cap {e_blk_cap} < {pspec.e_blk_cap}: blocks only grow")
    rb = pspec.recent_blk_cap if recent_blk_cap is None else int(recent_blk_cap)
    new = pspec._replace(e_blk_cap=int(e_blk_cap), recent_blk_cap=min(rb, int(e_blk_cap)))
    pad = lambda b: _pad_blocks(b, pspec.n_shards, pspec.e_blk_cap, new.e_blk_cap)
    return new, ps._replace(out=pad(ps.out), inc=pad(ps.inc))


# ---------------------------------------------------------------- metrics
def block_occupancy(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore) -> dict:
    """Per-shard / per-orientation occupancy and recent fill, from one host
    read of the ``[n]`` block-length scalars. ``occupancy`` is ``blk_len /
    e_blk_cap`` (the growth signal), ``recent_fill`` is ``blk_len - csr_len``
    in rows (the compaction signal)."""
    EB, R = pspec.e_blk_cap, pspec.recent_blk_cap
    lens = torch.stack([ps.out.blk_len, ps.out.csr_len, ps.inc.blk_len, ps.inc.csr_len])
    lens = lens.cpu().tolist()
    out = dict(e_blk_cap=EB, recent_blk_cap=R)
    max_occ, max_rec = 0.0, 0
    for name, ln, cs in (("out", lens[0], lens[1]), ("inc", lens[2], lens[3])):
        rec = [a - b for a, b in zip(ln, cs)]
        occ = [a / EB for a in ln]
        out[name] = dict(blk_len=ln, recent_fill=rec, occupancy=[round(x, 4) for x in occ])
        max_occ = max([max_occ] + occ)
        max_rec = max([max_rec] + rec)
    out["max_occupancy"] = round(max_occ, 4)
    out["max_recent_fill"] = max_rec
    out["recent_fill_frac"] = round(max_rec / R, 4) if R else 0.0
    return out


# ----------------------------------------------------------------- policy
class MaintenancePolicy(NamedTuple):
    """When shards compact and when blocks grow.

    ``recent_fill_frac``: compact once any block's recent fill reaches this
    fraction of ``recent_blk_cap`` (1.0 is the edge past which reads miss
    appended edges). ``mutation_rows``: also compact after this many applied
    mutation rows since the last compaction. ``grow_occupancy_frac`` /
    ``growth_factor``: grow ``e_blk_cap`` by the factor once any block's
    occupancy reaches the high-water fraction. ``purge``: reclaim tombstone
    slots at compaction.
    """

    recent_fill_frac: float = 0.5
    mutation_rows: int = 4096
    grow_occupancy_frac: float = 0.85
    growth_factor: float = 2.0
    purge: bool = False


class MaintenanceDecision(NamedTuple):
    compact: bool
    grow_to: int | None
    reason: str


def decide_maintenance(pspec: PartitionedStoreSpec, occ: dict, policy: MaintenancePolicy,
                       mutation_rows: int = 0) -> MaintenanceDecision:
    """The scheduling decision from an occupancy report (host-side)."""
    reasons = []
    grow_to = None
    if occ["max_occupancy"] >= policy.grow_occupancy_frac:
        grow_to = max(int(math.ceil(pspec.e_blk_cap * policy.growth_factor)),
                      pspec.e_blk_cap + 1)
        reasons.append(f"occupancy {occ['max_occupancy']:.2f} >= "
                       f"{policy.grow_occupancy_frac:.2f}: grow to {grow_to}")
    compact = occ["max_recent_fill"] >= policy.recent_fill_frac * pspec.recent_blk_cap
    if compact:
        reasons.append(f"recent fill {occ['max_recent_fill']} >= "
                       f"{policy.recent_fill_frac:.2f} x {pspec.recent_blk_cap}")
    elif mutation_rows >= policy.mutation_rows:
        compact = True
        reasons.append(f"{mutation_rows} mutation rows >= budget {policy.mutation_rows}")
    return MaintenanceDecision(compact, grow_to, "; ".join(reasons))
