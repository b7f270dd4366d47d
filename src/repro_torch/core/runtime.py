"""The shared transaction-runtime substrate.

PyTorch twin of ``repro.core.runtime``. Both entry points run on it: the
single-host ``GraphEngine`` (core/engine.py) and the sharded serve tier
(distributed/graph_serve.py).

- ``onehop_exec``          — one one-hop sub-query instance per root (the
                             cache-miss path; Definition 2.1 semantics).
- ``make_hop_kernel``      — one hop of the pipeline: cache probe through the
                             ``cache_probe`` kernel, then masked miss
                             execution behind the all-hit short circuit,
                             through a storage hook (``exec_fn``).
- ``make_plan_fn``         — the whole-plan pipeline: all hops, on-device
                             frontier merges, final clause, device metrics,
                             over a tier of route / storage hooks. It is a
                             per-rank program: a generator that yields each
                             collective it needs (see
                             ``repro_torch.distributed.sharding``); the
                             single-host tier never yields, and
                             ``make_fused_plan_fn`` runs it to its end.
- wire format / routing    — ``pack_``/``unpack_query_frame``,
                             ``pack_``/``unpack_result_frame``, and the
                             routing primitives ``route_plan`` /
                             ``route_scatter`` / ``bucketize``, which count
                             the valid rows a full peer bucket dropped.
- bucketing / padding      — ``BUCKETS`` / ``bucket_for`` / ``pad_roots``.
- ``get_grw_step``         — the gRW-Tx commit (apply mutations + cache
                             maintenance in one functional state transition),
                             write-around or write-through.

**Host syncs.** The reference's ``lax.cond`` / ``lax.while_loop`` have no
eager twin, so the port decides on the host: each hop reads its miss count
once (the all-hit short circuit stays a real branch, so an all-hit hop does
no storage work, which is the cache's whole benefit) and each frontier merge
reads its round condition once per round; a write-through commit reads its
op-stream round count once. Every such read is counted in the
``SyncCount`` the caller passes, and the engines report the total in
``metrics["host_syncs"]``, the one metric the port's parity tests skip. On
a mesh each rank reads its own miss count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cache import cache_lookup_lean
from repro_torch.core.keys import PARAM_LEN
from repro_torch.core.templates import DIR_BOTH, DIR_IN, DIR_OUT, MAX_CONDS, evaluate_pred
from repro_torch.graphstore.store import GlobalStoreView
from repro_torch.utils import (
    NULL_ID,
    SyncCount,
    compact_masked,
    dedup_masked,
    scatter_drop,
    segmented_dedup_merge,
    take_along0,
)

# final-clause codes of a QueryPlan
FINAL_IDS, FINAL_COUNT, FINAL_VALUES = 0, 1, 2

# ------------------------------------------------------- packed wire format
# One hop exchange each direction moves ONE contiguous int32 buffer.
#
# Query frame (querier -> owner), int32 lanes per routed row:
#     [0]              root vertex id (>= 0 for delivered rows)
#     [1]              flags — bit 0 (WIRE_FLAG_VALID) marks a live row;
#                      bucket padding is zero-filled, so its flags are 0
#     [2 : 2+PARAM_LEN] the hop's bound predicate params (wildcard values)
#
# Result frame (owner -> querier), int32 lanes per row:
#     [0 : RW]         left-packed leaf ids (cache hit or miss exec)
#     [RW]             count lane: >= 0 is the leaf count, -1 marks a row
#                      deferred at a down owner (see ``make_hop_kernel``)
WIRE_FLAG_VALID = 1
WIRE_QUERY_LANES = 2 + PARAM_LEN


def pack_query_frame(roots, flags, params):
    """``roots`` int32 [M], ``flags`` int32 [M], ``params`` int32
    [M, PARAM_LEN] -> int32 [M, WIRE_QUERY_LANES]."""
    return torch.cat([roots[:, None].to(torch.int32), flags[:, None].to(torch.int32),
                      params.to(torch.int32)], dim=1)


def unpack_query_frame(frame):
    """Inverse of ``pack_query_frame``: (roots, flags, params)."""
    return frame[..., 0], frame[..., 1], frame[..., 2:]


def pack_result_frame(vals, cnt):
    """Per-row results + count lane: [M, RW] + [M] -> [M, RW + 1]."""
    return torch.cat([vals, cnt[..., None].to(vals.dtype)], dim=-1)


def unpack_result_frame(frame):
    """Inverse of ``pack_result_frame``: (vals [M, RW], cnt [M])."""
    return frame[..., :-1], frame[..., -1]


# batch buckets: gR-Tx batches are padded to the next bucket so the set of
# batch shapes stays small. ``CachePopulator`` uses the prefix ``BUCKETS[:4]``.
BUCKETS = (8, 32, 128, 512, 2048, 8192)

# a gRW-Tx's caps on the real maintenance ops and sweeps it derives (the
# partitioned tier routes up to ``OPS_CAP`` ops to each peer)
OPS_CAP, SWEEP_CAP = 4096, 512


def bucket_for(k: int, buckets=BUCKETS, clamp: bool = False) -> int:
    """Smallest bucket >= k; next power of two (or, clamped, the largest
    bucket — the caller then chunks) beyond the table."""
    for b in buckets:
        if b >= k:
            return b
    if clamp:
        return buckets[-1]
    return 1 << int(np.ceil(np.log2(max(k, 1))))


def pad_roots(roots: np.ndarray, bucket: int):
    """Pad a host root batch to ``bucket``: (roots [bucket], valid [bucket])."""
    B = len(roots)
    proots = np.zeros(bucket, np.int32)
    proots[:B] = roots
    bvalid = np.zeros(bucket, bool)
    bvalid[:B] = True
    return proots, bvalid


# ------------------------------------------------------------------ routing
def route_plan(dest, n: int, cap: int):
    """Slot assignment for routing M items into [n, cap] peer buckets.

    Returns (slot [M] — each input's ``peer * cap + rank``, or ``n * cap``
    when dropped, kept [M], overflow — the count of *valid* (0 <= dest < n)
    items dropped because their peer bucket overflowed ``cap``). Items with
    a dest outside [0, n) are padding: dropped, not counted. Ranks follow
    input order within a peer (a stable sort, as the reference's).
    """
    dev = dest.device
    M = dest.shape[0]
    sd, order = torch.sort(dest.to(torch.int32), stable=True)
    offs = torch.searchsorted(sd, torch.arange(n, dtype=torch.int32, device=dev))
    rank = torch.arange(M, device=dev) - offs[sd.clamp(0, n - 1).long()]
    keep_sorted = (rank < cap) & (sd >= 0) & (sd < n)
    slot_sorted = torch.where(keep_sorted, sd.long() * cap + rank, n * cap)
    slot = torch.full((M,), n * cap, dtype=torch.int32, device=dev)
    slot[order] = slot_sorted.to(torch.int32)
    kept = slot < n * cap
    overflow = ((dest >= 0) & (dest < n) & ~kept).sum(dtype=torch.int32)
    return slot, kept, overflow


def route_scatter(vals, slot, n: int, cap: int, fill=NULL_ID):
    """Place ``vals`` into the [n, cap] send buckets of a ``route_plan``."""
    buckets = torch.full((n * cap,) + tuple(vals.shape[1:]), fill, dtype=vals.dtype,
                         device=vals.device)
    out = scatter_drop(buckets, slot, vals, slot < n * cap)
    return out.reshape((n, cap) + tuple(vals.shape[1:]))


def bucketize(vals, dest, n: int, cap: int, fill=NULL_ID):
    """Route ``vals`` into [n, cap] peer buckets (MoE-dispatch style).

    Returns (buckets [n, cap, ...], slot, kept, overflow); see ``route_plan``.
    """
    slot, kept, overflow = route_plan(dest, n, cap)
    return route_scatter(vals, slot, n, cap, fill), slot, kept, overflow


def compact_rows(mask, cap: int, arrays, fills):
    """Order-preserving row compaction of parallel tensors to ``cap`` rows.

    Returns (compacted tensors, n kept, overflow — masked rows dropped past
    ``cap``). One index scatter builds a gather map, so each column costs a
    ``cap``-row gather.
    """
    mask = mask.to(torch.bool)
    dev = mask.device
    M = mask.shape[0]
    total = mask.sum(dtype=torch.int32)
    n = total.clamp(max=cap)
    if M == 0:
        outs = [torch.full((cap,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=dev)
                for a, fill in zip(arrays, fills)]
        return outs, n, total - n
    idx = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    dest = torch.where(mask, idx, cap).clamp(max=cap)
    sel = torch.full((cap + 1,), M, dtype=torch.int64, device=dev)
    sel[dest] = torch.arange(M, device=dev)
    sel = sel[:cap]
    live = sel < M
    selc = sel.clamp(0, M - 1)
    outs = []
    for a, fill in zip(arrays, fills):
        m = live.reshape((cap,) + (1,) * (a.ndim - 1))
        outs.append(torch.where(m, a[selc], torch.as_tensor(fill, dtype=a.dtype, device=dev)))
    return outs, n, total - n


# --------------------------------------------------------------- miss exec
def onehop_exec_view(espec, view, direction: int, edge_label: int, pr, pe, pl,
                     roots, params, rmask):
    """Execute one one-hop sub-query instance per root (the cache-miss path)
    against a storage ``view``.

    Returns (leaves [B, RW], lmask, n_true [B], truncated [B], stats) where
    RW = espec.result_width. ``n_true`` is the un-truncated cardinality and
    ``truncated`` flags supernode rows whose adjacency exceeded the gather
    window — neither is cacheable when truncated.
    """
    pe_bound = params[:, :MAX_CONDS]
    pl_bound = params[:, MAX_CONDS:]

    rlab = take_along0(view.vlabel, roots)
    rprops = take_along0(view.vprops, roots)
    r_ok = evaluate_pred(pr, rlab, rprops) & rmask

    leaf_parts, mask_parts, el_parts, ep_parts = [], [], [], []
    trunc = torch.zeros_like(r_ok)
    sides = []
    if direction in (DIR_OUT, DIR_BOTH):
        sides.append(False)
    if direction in (DIR_IN, DIR_BOTH):
        sides.append(True)
    for incoming in sides:
        o, m, t, el, epr = view.adjacency(roots, espec.max_deg, incoming=incoming)
        leaf_parts.append(o)
        mask_parts.append(m)
        el_parts.append(el)
        ep_parts.append(epr)
        trunc |= t
    leaf = torch.cat(leaf_parts, dim=1)
    # gate by rmask so per-row stats only count rows this call executes
    scanned_mask = torch.cat(mask_parts, dim=1) & rmask[:, None]
    mask = scanned_mask
    n_edges_scanned = mask.sum(dtype=torch.int32)

    elab = torch.cat(el_parts, dim=1)
    ep = torch.cat(ep_parts, dim=1)
    if edge_label >= 0:
        mask = mask & (elab == edge_label)
    mask = mask & evaluate_pred(pe, elab, ep, bound_vals=pe_bound[:, None, :])
    n_leaf_fetches = mask.sum(dtype=torch.int32)  # the paper's "n"

    llab = take_along0(view.vlabel, leaf)
    lp = take_along0(view.vprops, leaf)
    l_ok = evaluate_pred(pl, llab, lp, bound_vals=pl_bound[:, None, :])
    mask = mask & l_ok & r_ok[:, None]

    mask = dedup_masked(leaf, mask)  # set semantics (Definition 2.1)
    n_true = mask.sum(dim=1, dtype=torch.int32)
    leaves, lmask = compact_masked(leaf, mask, espec.result_width)
    stats = {
        "edges_scanned": n_edges_scanned,
        "leaf_fetches": n_leaf_fetches,
        # full read-conflict set for OCC population commits: every vertex
        # this execution observed, including filtered-out leaves
        "scanned": leaf,
        "scanned_mask": scanned_mask,
    }
    return leaves, lmask, n_true, trunc & rmask, stats


def onehop_exec(espec, store, direction: int, edge_label: int, pr, pe, pl,
                roots, params, rmask):
    """``onehop_exec_view`` against a full ``GraphStore`` (single-host)."""
    return onehop_exec_view(
        espec, GlobalStoreView(espec.store, store), direction, edge_label,
        pr, pe, pl, roots, params, rmask,
    )


class MissRecord(NamedTuple):
    """Host-side record of one cache miss awaiting async population."""

    tpl_idx: int
    root: int
    params: np.ndarray  # int32 [PARAM_LEN]
    read_version: int


def _hop_params(hop, n: int, device):
    p = torch.as_tensor(np.asarray(hop.params, np.int32), device=device)
    return p.expand(n, PARAM_LEN)


# ----------------------------------------------------------- hop pipeline
def make_hop_kernel(espec, hop, use_cache: bool, exec_fn=None, defer_fn=None):
    """One hop of the pipeline over a flat root frontier.

    Returns ``kernel(store, cache, ttable, roots_flat, rmask_flat,
    params_flat=None, syncs=None) -> (vals [BF, RW], cnt [BF], miss_roots
    [BF], n_miss_records, stats)``. ``params_flat`` holds the per-row bound
    predicate params ([BF, PARAM_LEN]); the sharded tier unpacks them from
    the routed query frame, the single host leaves them None and the hop's
    own params broadcast. The probe runs through the ``cache_probe``
    kernel; the miss path (storage gathers, hit/miss select, miss-record
    compaction) runs only when some row missed, decided by one host read of
    the miss count ``k`` (counted in ``syncs``), so an all-hit frontier pays
    none of it. ``stats["k"]`` is that host int; the other stats are device
    scalars.

    ``exec_fn(store, roots, params, rmask)`` is the storage hook of the miss
    path (default: ``onehop_exec`` over a full ``GraphStore``; the
    partitioned tier supplies an owner-local block executor).

    ``defer_fn(roots_flat) -> bool[BF]`` is the degraded-mode hook: True
    where this shard cannot execute the row's miss (its storage is down).
    Such a miss *defers*: it leaves the miss mask, so no storage
    gather runs for it and it emits no miss record (CP must not populate
    from a lost block), and its count lane comes home as ``cnt = -1``.
    Hits still serve. With the hook absent the kernel does no deferral work.
    """
    RW = espec.result_width
    cacheable = hop.tpl_idx >= 0 and use_cache
    if exec_fn is None:
        def exec_fn(store, roots_f, params, miss_m):
            return onehop_exec(espec, store, hop.direction, hop.edge_label, hop.pr,
                               hop.pe, hop.pl, roots_f, params, miss_m)

    def kernel(store, cache, ttable, roots_flat, rmask_flat, params_flat=None, syncs=None):
        syncs = syncs if syncs is not None else SyncCount()
        dev = roots_flat.device
        BF = roots_flat.shape[0]
        params = _hop_params(hop, BF, dev) if params_flat is None else params_flat
        z = torch.zeros((), dtype=torch.int32, device=dev)
        if cacheable:
            hit, leaves_c, cnt_c, _ = cache_lookup_lean(
                espec.cache, cache, hop.tpl_idx, roots_flat, params
            )
            hit = hit & rmask_flat & bool(ttable.read_enabled[hop.tpl_idx])
            cnt_c = torch.where(hit, cnt_c, 0)
            n_read = rmask_flat.sum(dtype=torch.int32)
            n_hit = hit.sum(dtype=torch.int32)
        else:
            hit = torch.zeros(BF, dtype=torch.bool, device=dev)
            n_read = n_hit = z
        miss_mask = rmask_flat & ~hit
        deferred = None
        if defer_fn is not None:
            deferred = miss_mask & defer_fn(roots_flat)
            miss_mask = miss_mask & ~deferred
        k = syncs.read(miss_mask.sum())
        null_roots = torch.full((BF,), NULL_ID, dtype=torch.int32, device=dev)
        if k > 0:
            leaves_e, _lmask, n_true, trunc, stats = exec_fn(store, roots_flat, params, miss_mask)
            cnt_e = torch.where(miss_mask, n_true.clamp(max=RW), 0)
            if cacheable:
                vals = torch.where(hit[:, None], leaves_c, leaves_e)
                cnt = torch.where(hit, cnt_c, cnt_e)
                rec = miss_mask & ~trunc & (n_true <= RW)
                mr, _ = compact_masked(roots_flat.to(torch.int32), rec, BF)
                nrec = rec.sum(dtype=torch.int32)
            else:
                vals, cnt, mr, nrec = leaves_e, cnt_e, null_roots, z
            trunc_n = trunc.sum(dtype=torch.int32)
            es, lf = stats["edges_scanned"], stats["leaf_fetches"]
        else:
            # the all-hit short circuit: no storage gathers at all
            if cacheable:
                vals, cnt = leaves_c, cnt_c
            else:
                vals = torch.full((BF, RW), NULL_ID, dtype=torch.int32, device=dev)
                cnt = torch.zeros(BF, dtype=torch.int32, device=dev)
            mr, nrec, trunc_n, es, lf = null_roots, z, z, z, z
        if deferred is not None:
            # deferred rows ride the count lane home as -1 (their count is 0
            # on both branches, so the encoding is unambiguous)
            cnt = torch.where(deferred, -1, cnt)
        stats = {
            "k": k, "n_read": n_read, "hits": n_hit,
            "trunc": trunc_n, "edges": es, "leaves": lf,
        }
        return vals, cnt, mr, nrec, stats

    return kernel


def finalize_frontier(plan, store, q_roots, leaves, lmask):
    """Apply a plan's post filter + final clause to the final frontier."""
    if plan.post_filter is not None:
        kind = plan.post_filter[0]
        if kind == "id_neq":
            lmask = lmask & (leaves != q_roots[:, None])
        elif kind == "prop_neq_root":
            pid = plan.post_filter[1]
            lp = take_along0(store.vprops, leaves)[..., pid]
            rp = take_along0(store.vprops, q_roots)[..., pid]
            lmask = lmask & (lp != rp[:, None])
    if plan.final == FINAL_COUNT:
        return lmask.sum(dim=1, dtype=torch.int32)
    if plan.final == FINAL_VALUES:
        vals = take_along0(store.vprops, leaves)[..., plan.final_prop]
        return torch.where(lmask, vals, NULL_ID)
    return torch.where(lmask, leaves, NULL_ID)


class LocalPlanTier:
    """The single-host instantiation of the hop driver's hooks: no routing,
    no collectives, storage is the full ``GraphStore``. ``route``,
    ``unroute``, ``psum`` and ``reduce_metrics`` are generators, as on a
    mesh, that return at once without yielding."""

    routed = False

    def exec_fn(self, hop):
        return None  # default: onehop_exec over the full store

    def defer_fn(self):
        return None  # one host has no owner to lose: nothing defers

    def route(self, hop_idx, A, roots_flat, rmask_flat, params_row):
        # rows stay home; per-row params stay implicit (None -> the hop
        # kernel broadcasts its own)
        return roots_flat, rmask_flat, None, None, 0
        yield  # a generator that never yields: one host has no collective

    def unroute(self, ctx, vals, cnt):
        return vals, cnt
        yield

    def psum(self, x):
        return x
        yield

    def pack_count(self, nrec):
        return nrec

    def reduce_metrics(self, m):
        return m
        yield


def make_plan_fn(espec, plan, use_cache: bool, tier, *, overlap: bool = False):
    """The whole-plan per-rank program: every hop's route, probe + masked
    miss-exec, unroute and frontier merge, the final clause, per-hop compact
    miss arrays and the metrics, over the ``tier``'s hooks.

    Tier hooks: ``exec_fn(hop)`` supplies the miss-path storage executor
    (None -> full-store ``onehop_exec``); ``defer_fn()`` the degraded-mode
    hook of the hop kernels (None: nothing defers); ``route`` / ``unroute`` move
    frontier rows to their owners and results home (identity on a single
    host, one all_to_all each on a mesh); ``pack_count`` shapes per-hop miss
    counts (one segment per rank on a mesh); ``reduce_metrics`` globalizes
    the additive metrics and the per-hop miss counts in one reduction,
    after which each hop's edge-read + leaf-fetch phases are gated on the
    *global* count, as in the reference. A tier whose ``stage_rows`` is
    true also gets ``metrics["_frontier_rows"]``, the live routed rows this
    rank probed and executed over the hops, to pop in ``reduce_metrics``.

    Deferred rows come home with ``cnt = -1`` in any of their slots: the
    whole query row is then flagged deferred (bounded-stale), its slots
    merge as empty (so a row deferred at hop 1 reaches later hops with no
    leaves), and ``metrics["deferred"]`` counts the flagged rows on the one
    reduction that exists.

    Returns ``steps(store, cache, ttable, roots, bvalid, syncs=None)``, a
    generator function: it yields the tier's collective requests and
    returns ``(result, deferred, miss_roots, miss_counts, metrics,
    version)``; ``deferred`` is the bool per-row flag, or None when the
    tier defers nothing; metric values are host ints or device scalars.
    ``overlap=True`` is not ported yet.
    """
    if overlap:
        raise NotImplementedError("the double-buffered schedule is not ported yet")
    F, RW = espec.frontier, espec.result_width
    defer_fn = tier.defer_fn()
    kernels = [make_hop_kernel(espec, hop, use_cache, tier.exec_fn(hop), defer_fn)
               for hop in plan.hops]
    cached_hops = [hop.tpl_idx >= 0 and use_cache for hop in plan.hops]

    def steps(store, cache, ttable, roots, bvalid, syncs=None):
        syncs = syncs if syncs is not None else SyncCount()
        dev = roots.device
        Bb = roots.shape[0]
        z = torch.zeros((), dtype=torch.int32, device=dev)
        m = {
            "phases": 1,  # root index lookup (request 1)
            "requests": bvalid.sum(dtype=torch.int32),
            "hits": z, "misses": 0, "truncated": z,
            "leaf_fetches": z, "edges_scanned": z, "cache_reads": z,
            "deferred": 0,
        }
        if tier.routed:
            m["route_overflow"] = z
        # the telemetry tier: owner-side frontier occupancy (live routed rows
        # this rank probes and executes, summed over hops), a device scalar
        # until ``reduce_metrics`` folds it into the owner-stage block and
        # pops it, so the host metrics are unchanged
        stage_rows = getattr(tier, "stage_rows", False)
        if stage_rows:
            m["_frontier_rows"] = z
        frontier = torch.full((Bb, F), NULL_ID, dtype=torch.int32, device=dev)
        frontier[:, 0] = roots
        fmask = torch.zeros((Bb, F), dtype=torch.bool, device=dev)
        fmask[:, 0] = bvalid
        A = 1  # occupied frontier prefix: 1 for the root hop, then min(F, A*RW)
        row_def = None if defer_fn is None else torch.zeros(Bb, dtype=torch.bool, device=dev)
        miss_roots, miss_counts, hop_k = [], [], []
        for h, kernel in enumerate(kernels):
            q, qmask, qparams, ctx, ovf = yield from tier.route(
                h, A, frontier[:, :A].reshape(-1), fmask[:, :A].reshape(-1),
                plan.hops[h].params,
            )
            if tier.routed:
                m["route_overflow"] = m["route_overflow"] + ovf
            if stage_rows:
                m["_frontier_rows"] = m["_frontier_rows"] + qmask.sum(dtype=torch.int32)
            vals, cnt, mr, nrec, hs = kernel(store, cache, ttable, q, qmask, qparams, syncs)
            if cached_hops[h]:
                m["requests"] = m["requests"] + hs["n_read"]
                m["cache_reads"] = m["cache_reads"] + hs["n_read"]
                m["hits"] = m["hits"] + hs["hits"]
                m["phases"] += 1  # one cache get round-trip
                miss_roots.append(mr)
                miss_counts.append(tier.pack_count(nrec))
            hop_k.append(hs["k"])
            m["requests"] = m["requests"] + hs["k"] + hs["leaves"]
            m["leaf_fetches"] = m["leaf_fetches"] + hs["leaves"]
            m["edges_scanned"] = m["edges_scanned"] + hs["edges"]
            m["misses"] += hs["k"]
            m["truncated"] = m["truncated"] + hs["trunc"]
            vals, cnt = yield from tier.unroute(ctx, vals, cnt)
            cnt = cnt.reshape(Bb, A)
            if row_def is not None:
                # the deferred channel: any slot at -1 flags its query row
                row_def = row_def | (cnt < 0).any(dim=1)
                cnt = cnt.clamp(min=0)
            frontier, fmask = segmented_dedup_merge(vals.reshape(Bb, A, RW), cnt, F, syncs=syncs)
            A = min(F, A * RW)

        result = finalize_frontier(plan, store, roots, frontier, fmask)
        if plan.post_filter is not None and plan.post_filter[0] != "id_neq":
            m["phases"] += 1  # un-rewritten property fetch
            m["requests"] = m["requests"] + fmask.sum(dtype=torch.int32)
        if plan.final == FINAL_VALUES:
            m["phases"] += 1  # valueMap fetch
            m["requests"] = m["requests"] + fmask.sum(dtype=torch.int32)
        m["phases"] += plan.extra_phases
        if row_def is not None:
            m["deferred"] = row_def.sum(dtype=torch.int32)
        # one deferred reduction: the per-hop miss counts ride the metrics
        # through ``reduce_metrics``, then gate each hop's edge-read +
        # leaf-fetch phases on the global count
        m["_hop_k"] = hop_k
        m = yield from tier.reduce_metrics(m)
        for k in m.pop("_hop_k"):
            m["phases"] = m["phases"] + 2 * (k > 0)
        return result, row_def, tuple(miss_roots), tuple(miss_counts), m, store.version

    return steps


def run_local(program):
    """Run a per-rank program whose tier never asks for a collective."""
    try:
        ask = next(program)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError(f"a single-host program asked for a collective: {ask[0]}")


def make_fused_plan_fn(espec, plan, use_cache: bool):
    """The single-host whole-plan pipeline: ``make_plan_fn`` with identity
    hooks, run to its end. ``fused(store, cache, ttable, roots, bvalid,
    syncs=None) -> (result, deferred, miss_roots, miss_counts, metrics,
    version)``; ``deferred`` is None (one host defers nothing)."""
    steps = make_plan_fn(espec, plan, use_cache, LocalPlanTier())

    def fused(*args, **kwargs):
        return run_local(steps(*args, **kwargs))

    return fused


def decode_miss_records(plan, use_cache, miss_roots, miss_counts, read_version):
    """Turn per-hop compact miss arrays (host numpy) into ``MissRecord``s.

    Each hop entry may hold several independently counted segments:
    ``miss_roots[i]`` reshapes to [segments, L] with ``miss_counts[i]`` of
    shape [segments].
    """
    misses: list[MissRecord] = []
    ci = 0
    for hop in plan.hops:
        if hop.tpl_idx >= 0 and use_cache:
            counts = np.asarray(miss_counts[ci]).reshape(-1)
            segs = np.asarray(miss_roots[ci]).reshape(len(counts), -1)
            ci += 1
            params = np.asarray(hop.params, np.int32)
            for seg, cnt in zip(segs, counts):
                for r in seg[: int(cnt)]:
                    misses.append(MissRecord(hop.tpl_idx, int(r), params, read_version))
    return misses


def host_compact_dedup(vals: np.ndarray, mask: np.ndarray, width: int):
    """Host-side per-row dedup + compaction (frontier merge between hops)."""
    B = vals.shape[0]
    out = np.full((B, width), NULL_ID, np.int32)
    omask = np.zeros((B, width), bool)
    for b in range(B):
        row = vals[b][mask[b]]
        if row.size:
            _, first = np.unique(row, return_index=True)
            row = row[np.sort(first)][:width]
            out[b, : len(row)] = row
            omask[b, : len(row)] = True
    return out, omask


# ---------------------------------------------------------------- gRW step
def get_grw_step(espec, policy: str = "write-around", *, ops_cap: int = OPS_CAP,
                 sweep_cap: int = SWEEP_CAP):
    """The gRW-Tx commit: apply mutations + maintain the cache in one
    functional state transition (graph writes and cache maintenance land in
    one commit, as FDB buffers both in one transaction).

    The maintenance phase derives the impacted keys as tensor streams,
    compacts the mostly-masked stream to ``ops_cap`` real ops (and sweeps to
    ``sweep_cap``), and applies sweeps first, then the exact-key ops:
    write-around's deletes in one batch, write-through's value edits with
    ``apply_op_stream_segmented`` (one round per op of the busiest key).

    Returns ``step(store, cache, ttable, batch, syncs=None) -> (store',
    cache', impacted, op_overflow)``; ``impacted`` counts distinct logical
    entries removed (chunk-0 occupancy delta); a nonzero ``op_overflow``
    means real maintenance ops were dropped by the caps. Write-through reads
    its round count on the host, counted in ``syncs``.
    """
    if policy not in ("write-around", "write-through"):
        raise ValueError(f"unknown gRW policy {policy!r}")
    from repro_torch.core.invalidation import (
        CacheOpStream,
        SweepStream,
        apply_op_stream_batched,
        apply_op_stream_segmented,
        apply_sweeps,
        derive_cache_ops,
    )
    from repro_torch.graphstore.mutations import apply_mutations

    through = policy == "write-through"
    cspec = espec.cache

    def step(store, cache, ttable, batch, syncs=None):
        store2, applied = apply_mutations(espec.store, store, batch)
        ops, sweeps = derive_cache_ops(espec, store, store2, ttable, applied, through=through)
        dev = store.vlabel.device
        (okind, otpl, oroot, oparams, ovid, oorder), n_ops, ovf_o = compact_rows(
            ops.ok, ops_cap,
            (ops.kind, ops.tpl, ops.root, ops.params, ops.vid, ops.order),
            (0, -1, NULL_ID, 0, NULL_ID, 0),
        )
        cops = CacheOpStream(
            kind=okind, tpl=otpl, root=oroot, params=oparams, vid=ovid, order=oorder,
            ok=torch.arange(ops_cap, device=dev) < n_ops,
        )
        (stpl, sroot), n_sw, ovf_s = compact_rows(
            sweeps.ok, sweep_cap, (sweeps.tpl, sweeps.root), (-1, NULL_ID)
        )
        gsw = SweepStream(tpl=stpl, root=sroot, ok=torch.arange(sweep_cap, device=dev) < n_sw)
        head = lambda c: (c.valid & (c.chunk == 0)).sum(dtype=torch.int32)
        occ0 = head(cache)
        cache2 = apply_sweeps(cspec, cache, gsw)
        if through:
            # value edits are order-sensitive per key; distinct keys commute
            cache2 = apply_op_stream_segmented(cspec, cache2, cops, syncs)
        else:
            cache2 = apply_op_stream_batched(cspec, cache2, cops)
        impacted = occ0 - head(cache2)
        cache2 = cache2._replace(n_delete=cache.n_delete + impacted)
        return store2, cache2, impacted, ovf_o + ovf_s

    return step
