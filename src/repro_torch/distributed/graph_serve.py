"""The sharded gR-Tx serving tier: owner shards over a mesh.

PyTorch twin of ``repro.distributed.graph_serve`` on both storage tiers:
the read path, CP population, the gRW-Tx commit under both policies, and, on the
partitioned tier, its maintenance gate and write-behind journal, block
maintenance between batches (compaction, capacity growth), the degraded
mode the failover tier drives and the routing overlays the migration
tier sets; the owner-stage telemetry with its tracer spans on both.
Vertex ownership is interleaved
(shard ``v mod n`` owns ``v``) unless the routing table says otherwise,
and the one-hop result cache is co-partitioned with it: the global cache
of ``C`` slots is ``n`` blocks of ``C // n`` slots, and a key's block is
its root's cache owner, so a probe is always local to that owner.

A gR-Tx batch runs one per-rank program (``runtime.make_plan_fn`` over a
``_MeshTier``) on every rank of a ``LocalMesh``; rank ``r`` holds rows
``[r * B/n, (r+1) * B/n)`` of the padded batch. Per hop:

- **route** — each frontier root ships as a query frame ``[root | flags |
  params]`` into per-peer buckets of ``cap`` rows (``route_cap_factor``
  sizes them; valid rows a full bucket drops are counted in
  ``route_overflow``), then one all_to_all delivers every bucket to its
  owner;
- **exec** — the owner probes its cache block through the ``cache_probe``
  kernel and runs its misses through the ``block_gather`` kernel over its
  owner-local blocks (``kernels.block_gather.ops.block_onehop_exec``);
- **unroute** — results return as ``[vals x RW | cnt]`` frames in the
  mirror all_to_all, and the querying rank merges them into its frontier.

After the hops, one all-reduce globalizes the additive metrics and the
per-hop miss counts, so every metric equals the single-host engine's except
``route_overflow`` and ``locality_routed`` (sharded-only, both 0 with
no-drop caps and the identity routing table) and ``host_syncs``.

Routing overlays
----------------

``attach_routing(RoutingTableHost)`` makes placement data: every step then
reads the host's device table (cached per epoch). A migrated vertex's rows
live at its storage owner, which gR, commits and CP use; a cache exception
sends a vertex's reads to another cache home. There a hit serves; a miss
*defers* (the row is stored elsewhere) and the **locality retry** runs the
deferred rows once more through the table's storage view, merging results,
flags, misses and the additive metrics. CP queues each miss at its cache
owner (``ShardedMissDrain``); a step whose rows execute or insert at
another shard runs the **CP split** (``population.populate_program`` on
every rank: execute at the storage owner, sum the bundle, insert at the
cache owner). A table with no exception costs nothing: the same kernel
calls, host reads and collectives as the identity table.

Storage tiers
-------------

``store_tier="partitioned"`` (the default) keeps each owner's dual-CSR
blocks (``graphstore.partition``): a miss executes through the
``block_gather`` kernel over the owner-local blocks after routing.
``store_tier="replicated"`` is the reference's baseline, a full read
snapshot per rank: every rank executes any miss over the whole single-host
``GraphStore`` (the full-store ``onehop_exec``), so nothing defers and
there are no blocks to maintain. The ranks of a ``LocalMesh`` share one
process and one card, so the tier keeps ONE store that every rank's program
reads and applies each commit to it once; four copies would give the same
results for four times the bytes and four applies. Routing, the probe on
the owner's cache block, unroute and merge are those of the partitioned
tier; an attached ``RoutingTableHost`` routes rows and CP inserts to their
cache owner, and nothing splits or retries. A commit applies the batch
once, then each rank runs the listener over a round-robin slice of it
(``mutations.shard_mutation_rows``, global rows restored by
``row_offset`` / ``row_stride``) and the ops route as on the partitioned
tier. CP runs each row whole at its cache owner over the full store. The
partitioned tier's own entry points (``partition_store``, ``store_bytes``,
``store_occupancy``, ``compact_step``, ``grow_blocks``,
``set_block_capacity``, ``maintenance_tick``, a commit's ``gate``) raise
``ValueError`` on it, where the reference asserts.

A gRW-Tx commit is one per-rank program too (``grw_step``): each rank
applies the batch to its own blocks (``apply_mutations_partitioned``), runs
the ownership-gated listener over its pre- and post-state blocks, compacts
the derived ops, routes each to its root's cache owner in one all_to_all,
all-gathers the sweeps, and applies both to its cache block. Its post-store
equals ``partition_store`` of the single host's post-store, and its cache
the single host's entries.

With a ``DeviceGate`` the commit also compacts, on each rank, every block
of its whose recent fill reached the gate's threshold, after the listener
(so the layout change cannot perturb the commit's ops). Eager torch decides
on the host: the ranks all-gather their flags and the mesh reads them once
a commit (``host_syncs``); the decision is a function of (store, batch,
gate) alone, which journal replay relies on. ``maintenance_tick`` runs the
same maintenance between batches under a ``MaintenancePolicy``.

Observability
-------------

With ``telemetry=True`` (the default) each gR-Tx batch also assembles the
per-owner stage block (``repro_torch.obs.metrics.OWNER_STAGE_FIELDS``:
frontier rows, probe hits, miss rows, edges scanned, leaf fetches, route
overflow, deferred rows) on the same one metrics all-reduce: each rank
writes its local counters at its own row of an ``[n, 7]`` block, the
block rides the reduced vector, and the sum assembles the matrix on every
rank. Hits, misses, edges, leaves and frontier rows are counted at the
owner (after routing), overflow and deferred rows at the origin. The block
rides the batch's one result copy too, and ``run_gr_tx_batch`` pops it
into ``last_owner_stage`` before it builds the metrics dict, so the
collectives, the host reads and the metrics are those of
``telemetry=False``. Host phases run in ``tracer`` spans
(``repro_torch.obs.trace``; the no-op ``NULL_TRACER`` unless one is
given): ``gr_dispatch`` (every rank's program, with its per-hop reads),
``gr_sync`` (the one result copy), ``gr_unpack`` (the decode),
``grw_step``, ``compaction_tick`` and ``hot_swap_pause`` (``grow_blocks``).
A span adds no device synchronization.

Degraded mode
-------------

``run_gr_tx_batch(down=...)`` masks the miss segments of the owners marked
down: a miss whose storage owner is down *defers* (no gather, no miss
record; its row comes back flagged in ``deferred``), while hits, the dead
owner's cached entries among them, and the other owners' misses serve as
usual. A healthy batch (no owner down) does no deferral work: the same
kernels and host reads as before.

``racer()`` / ``adopt()`` serve the hedged read of a straggling owner: each
racer is a copy of the runtime with observations, mesh counts and spans of
its own, and the winner's are adopted. The kernels' launch counts and the
CUDA stream stay shared: a losing racer that is still running queues its
kernels behind the next batch's.
"""

from __future__ import annotations

import copy
import functools
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.cache import _SLOT_FIELDS, CacheState, cache_shard, empty_cache
from repro_torch.core.keys import PARAM_LEN
from repro_torch.core.invalidation import (
    CacheOpStream,
    SweepStream,
    apply_op_stream_batched,
    apply_op_stream_segmented,
    apply_sweeps,
    derive_cache_ops,
    derive_cache_ops_views,
)
from repro_torch.core.runtime import (
    OPS_CAP,
    SWEEP_CAP,
    WIRE_FLAG_VALID,
    bucket_for,
    bucketize,
    compact_rows,
    decode_miss_records,
    make_plan_fn,
    pack_query_frame,
    pack_result_frame,
    pad_roots,
    unpack_query_frame,
    unpack_result_frame,
)
from repro_torch.distributed.routing import (
    RoutingTableHost,
    base_owner,
    cache_owner_of,
    identity_table,
    storage_owner_of,
)
from repro_torch.distributed.sharding import (
    ALL_GATHER,
    ALL_REDUCE_MAX,
    ALL_REDUCE_SUM,
    ALL_TO_ALL,
    LocalMesh,
    tree_map_with_path,
)
from repro_torch.graphstore.maintenance import (
    DeviceGate,
    MaintenancePolicy,
    block_occupancy,
    compact_block,
    compact_store,
    decide_maintenance,
    grow_store,
)
from repro_torch.graphstore.mutations import apply_mutations, shard_mutation_rows
from repro_torch.graphstore.partition import (
    BlockCapacityError,
    BlockStoreView,
    apply_mutations_partitioned,
    default_pspec,
    join_shards,
    local_shard,
    owner_of,
    partition_store,
    store_bytes_report,
)
from repro_torch.kernels.block_gather.ops import block_onehop_exec
from repro_torch.obs.metrics import OWNER_STAGE_FIELDS, attribute_step_seconds
from repro_torch.obs.trace import NULL_TRACER, _Span
from repro_torch.utils import NULL_ID, SyncCount, resolve_device

_STAT_FIELDS = ("n_hit", "n_miss", "n_insert", "n_evict", "n_delete", "n_oversize")
_ADDITIVE_METRICS = (
    "requests", "hits", "misses", "truncated", "leaf_fetches",
    "edges_scanned", "cache_reads", "route_overflow", "deferred",
    "locality_routed",
)

# The reference's measured per-hop routing capacity multipliers (Zipf 1.3
# eCommerce roots on an 8-shard mesh): hop 1 routes query roots with 4x
# headroom over the uniform share, later hops leaf-derived frontiers at 3x.
DEFAULT_ROUTE_CAP_FACTOR = (4, 3)


def _replicate_stats(before: CacheState, shards) -> CacheState:
    """Reassemble a global cache from its ``n`` shards after a step that
    wrote them: slot blocks in owner order, and each 0-d stats counter the
    global value plus the sum of every shard's delta (the reference's psum
    of local deltas)."""
    slots = {f: torch.cat([getattr(s, f) for s in shards]) for f in _SLOT_FIELDS}
    stats = {f: getattr(before, f) + sum(getattr(s, f) - getattr(before, f) for s in shards)
             for f in _STAT_FIELDS}
    return before._replace(**slots, **stats)


class _MeshRead:
    """A host read of a value every rank receives alike from a collective
    (the all-gathered gate flags): the first rank to ask reads it, counted
    in ``syncs``; the others reuse that read. One rank per process would
    read its own copy instead, once a commit per process."""

    def __init__(self, syncs: SyncCount):
        self.syncs, self.value = syncs, None

    def read(self, x) -> list:
        if self.value is None:
            self.value = self.syncs.read_list(x)
        return self.value


# what a gR batch records on its runtime: a hedged read's racers keep these
# apart, and the winner's are adopted (``ShardedTxnRuntime.racer``)
_OBSERVED = ("last_step_seconds", "last_owner_stage", "last_step_owner_seconds",
             "locality_retries")


class _SpanLog:
    """A tracer that keeps its spans as they close, for ``adopt`` to record
    into the runtime's own tracer."""

    enabled = True

    def __init__(self):
        self.spans = []

    def span(self, name: str, **attrs):
        return _Span(self, name, attrs or None)

    def record(self, name: str, seconds: float, attrs: dict | None = None):
        self.spans.append((name, seconds, attrs))


class _MeshTier:
    """One rank's hooks of the hop driver under one routing table
    ``rtable``: owner routing over all_to_all, the one metrics all-reduce,
    owner-local block execution and, when ``down`` (the host bool mask of
    owners marked down) is given or ``split`` (the table may hold cache
    exceptions), the deferral hook."""

    routed = True

    def __init__(self, rt: "ShardedTxnRuntime", caps, me: int, rtable, down=None,
                 split: bool = False):
        self.rt, self.caps, self.me = rt, caps, me
        self.n, self.pspec, self.rtable = rt.n, rt.pspec, rtable
        self.down, self.split = down, split
        self._locality = 0  # rows the table routed away from their base owner
        # telemetry: the plan program counts owner-side frontier rows
        # (stage_rows) and reduce_metrics folds the owner-stage block into
        # its one all-reduce
        self.telemetry = self.stage_rows = rt.telemetry

    def defer_fn(self):
        if self.pspec is None or (self.down is None and not self.split):
            # the replicated store: every rank executes any miss over its
            # full snapshot, so nothing defers (the reference's pspec None)
            return None
        dead = self.down is not None and bool(self.down[self.me])
        if not self.split:
            # every miss routed to a down owner defers, a live owner's never
            # (with no cache exception a row routed here is stored here)
            return lambda roots_flat: torch.full_like(roots_flat, dead, dtype=torch.bool)
        # a miss also defers where it was routed here for its cache home
        # while its rows live at another shard: the locality retry runs it
        # there through the table's storage view. Hits serve either way.
        return lambda roots_flat: (storage_owner_of(self.rtable, roots_flat, self.n)
                                   != self.me) | dead

    def exec_fn(self, hop):
        pspec, espec = self.pspec, self.rt.lspec
        if pspec is None:
            return None  # the replicated store: the full-store onehop_exec

        def exec_fn(store, roots_f, params, miss_m):
            view = BlockStoreView(pspec, store, self.me, rtable=self.rtable)
            return block_onehop_exec(espec, view, hop.direction, hop.edge_label,
                                     hop.pr, hop.pe, hop.pl, roots_f, params, miss_m)

        return exec_fn

    def route(self, hop_idx, A, roots_flat, rmask_flat, params_row):
        # one exchange: root id + valid flag + bound params in one frame.
        # Bucket padding is zero-filled, so padded rows decode flags = 0.
        n, cap = self.n, self.caps[hop_idx]
        M, dev = roots_flat.shape[0], roots_flat.device
        rvals = torch.where(rmask_flat, roots_flat, NULL_ID)
        ok = rmask_flat & (roots_flat >= 0)
        # gR routes by the *cache* owner; the identity table makes this the
        # base owner exactly
        dest = cache_owner_of(self.rtable, roots_flat, n)
        owner = torch.where(ok, dest, -1)
        self._locality = self._locality + (ok & (dest != owner_of(roots_flat, n))).sum(
            dtype=torch.int32)
        flags = rmask_flat.to(torch.int32) * WIRE_FLAG_VALID
        params = torch.as_tensor(np.asarray(params_row, np.int32), device=dev).expand(M, PARAM_LEN)
        frame = pack_query_frame(rvals, flags, params)
        send, slot, kept, ovf = bucketize(frame, owner, n, cap, fill=0)
        recv = yield (ALL_TO_ALL, send)
        q, qflags, qparams = unpack_query_frame(recv.reshape(n * cap, -1))
        qmask = (qflags & WIRE_FLAG_VALID) == WIRE_FLAG_VALID
        return q.contiguous(), qmask, qparams.contiguous(), (slot, kept, cap), ovf

    def unroute(self, ctx, vals, cnt):
        # one exchange home: the RW leaf lanes and the count lane
        slot, kept, cap = ctx
        n, RW = self.n, vals.shape[-1]
        frame = pack_result_frame(vals, cnt).reshape(n, cap, RW + 1)
        back = (yield (ALL_TO_ALL, frame)).reshape(n * cap, RW + 1)
        back_v, back_c = unpack_result_frame(back)
        sl = slot.clamp(0, n * cap - 1).long()
        return (torch.where(kept[:, None], back_v[sl], NULL_ID),
                torch.where(kept, back_c[sl], 0))

    def psum(self, x):
        return (yield (ALL_REDUCE_SUM, x))

    def pack_count(self, nrec):
        return nrec.reshape(1)  # one independently counted miss segment per rank

    def reduce_metrics(self, m):
        # ONE all-reduce for the whole plan: the additive metrics and the
        # per-hop miss counts (the deferred phase gate) in one vector
        m["locality_routed"] = self._locality
        keys = [k for k in _ADDITIVE_METRICS if k in m]
        hop_k = m["_hop_k"]
        dev = self.rt.device
        as64 = lambda vs: torch.stack([torch.as_tensor(v, dtype=torch.int64, device=dev)
                                       for v in vs])
        vec = as64([m[k] for k in keys] + list(hop_k))
        S = len(OWNER_STAGE_FIELDS)
        if self.telemetry:
            # the owner-stage block rides the same sum: every value is still
            # this rank's local count, so writing the locals at row ``me`` of
            # an [n, S] block and summing over the ranks assembles the matrix
            # on every rank. Field order is the OWNER_STAGE_FIELDS contract;
            # route_overflow and deferred are the origin's, the rest the
            # owner's (counted after routing)
            local = {
                "frontier_rows": m.pop("_frontier_rows"), "probe_hits": m["hits"],
                "miss_rows": m["misses"], "edges_scanned": m["edges_scanned"],
                "leaf_fetches": m["leaf_fetches"], "route_overflow": m["route_overflow"],
                "deferred_rows": m["deferred"],
            }
            block = torch.zeros((self.n, S), dtype=torch.int64, device=dev)
            block[self.me] = as64([local[f] for f in OWNER_STAGE_FIELDS])
            vec = torch.cat([vec, block.reshape(-1)])
        g = yield from self.psum(vec)
        nk, nh = len(keys), len(hop_k)
        for i, k in enumerate(keys):
            m[k] = g[i]
        m["_hop_k"] = list(g[nk:nk + nh])
        if self.telemetry:
            m["owner_stage"] = g[nk + nh:].reshape(self.n, S)
        return m


class ShardedTxnRuntime:
    """One transaction runtime spread over the ``n`` ranks of a mesh, on the
    partitioned storage tier (``store_tier="partitioned"``, the default) or
    the replicated one (``"replicated"``: one single-host ``GraphStore``
    that every rank reads whole; see the module docstring).

    ``espec`` is the *global* spec: ``espec.cache.capacity`` is the fleet
    cache capacity, split into ``n`` co-partitioned blocks of
    ``capacity // n`` slots (each a power of two). Block capacities are
    ``blk_slack`` times the uniform share, twice by default
    (``partition.default_pspec``); ``maintenance_tick`` and ``grow_blocks``
    change them. With ``use_cache=False`` a read never probes the cache:
    every frontier root runs against storage (the ``serve_nocache`` cell).

    ``route_cap_factor`` bounds the per-peer routing buckets: the default is
    the reference's measured production caps, a tuple gives per-hop factors
    (hop ``i`` uses entry ``min(i, last)``), and ``None`` sizes them for the
    worst case, so nothing can drop (the parity tests' configuration).

    The maintenance ops and sweeps each rank derives per commit, and the
    ops it routes to each peer, are bounded by the single host's caps
    (``OPS_CAP`` / ``SWEEP_CAP``) on both tiers; ops they drop count in
    ``op_overflow``.

    ``telemetry`` (default on) assembles the owner-stage block of every gR
    batch into ``last_owner_stage``; ``last_step_seconds`` is the batch's
    wall clock from the first rank's program to the end of the result
    copy, and ``last_step_owner_seconds`` that wall clock attributed to
    the owners by their work (``obs.metrics.attribute_step_seconds``), the
    failure detector's per-owner heartbeat. ``tracer`` (an
    ``obs.trace.Tracer``) times the host phases; the default records
    nothing.

    Entry points run on CUDA unless ``device`` names another device, and
    raise if it is absent. The identity routing table is threaded through
    every step, as the reference does by default.
    """

    def __init__(self, espec, mesh: LocalMesh, *, use_cache: bool = True,
                 store_tier: str = "partitioned",
                 route_cap_factor=DEFAULT_ROUTE_CAP_FACTOR, blk_slack: float = 2.0,
                 device=None, telemetry: bool = True, tracer=None):
        if store_tier not in ("partitioned", "replicated"):
            raise ValueError(f"unknown store tier {store_tier!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        n = self.n = mesh.n
        if n & (n - 1):
            raise ValueError(f"shard count {n} is not a power of two")
        C = espec.cache.capacity
        Cloc = C // n
        if Cloc * n != C or Cloc & (Cloc - 1):
            raise ValueError(f"cache capacity {C} does not shard into power-of-two blocks")
        self.espec = espec
        self.lspec = espec._replace(cache=espec.cache._replace(capacity=Cloc))
        self.use_cache = bool(use_cache)
        self.store_tier = store_tier
        # the block layout; None on the replicated tier, which has no blocks
        self.pspec = (default_pspec(espec.store, n, slack=blk_slack)
                      if store_tier == "partitioned" else None)
        if isinstance(route_cap_factor, (list, tuple)):
            route_cap_factor = tuple(route_cap_factor)
            if not route_cap_factor or not all(isinstance(f, int) for f in route_cap_factor):
                raise ValueError("per-hop route_cap_factor entries must be ints")
        self.route_cap_factor = route_cap_factor
        # the identity table, threaded through every step while no
        # RoutingTableHost is attached (``attach_routing``)
        self.identity = identity_table(n, device=self.device)
        self.rhost = None
        self.locality_retries = 0  # batches whose split rows were retried
        self.cp_splits = 0  # CP steps that executed a row away from its insert
        # applied mutation rows since the last compaction (the policy's
        # latency-amortization input)
        self.mutation_rows_since_compact = 0
        self.telemetry = bool(telemetry)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the latest gR batch: its wall clock and its [n, S] owner-stage
        # block (int64, OWNER_STAGE_FIELDS order; None unless telemetry is on)
        self.last_step_seconds = 0.0
        self.last_owner_stage = None
        self.last_step_owner_seconds = None
        self.swap_events = 0  # capacity growths (``grow_blocks``)

    # ------------------------------------------------------------ state
    def _require_blocks(self, what: str):
        """``what`` reads or writes owner blocks: the partitioned tier's."""
        if self.pspec is None:
            raise ValueError(f"{what} needs the partitioned store tier; this runtime serves "
                             f"the replicated one")

    def partition_store(self, store, *, elastic: bool = False):
        """Partition a single-host ``GraphStore`` (on this runtime's device)
        into the owner-local blocks of every rank.

        With ``elastic=True`` an orientation that overflows its blocks grows
        ``e_blk_cap`` (25 % over the reported need) and retries, where it
        would raise ``BlockCapacityError``: the ingest-time half of capacity
        growth (``maintenance_tick`` is the online half)."""
        self._require_blocks("partition_store")
        if store.esrc.device.type != self.device.type:
            raise ValueError(f"the store lies on {store.esrc.device}, the runtime on {self.device}")
        while True:
            try:
                return partition_store(self.pspec, store)
            except BlockCapacityError as e:
                if not elastic:
                    raise
                self._set_pspec(self.pspec._replace(
                    e_blk_cap=max(int(math.ceil(e.needed * 1.25)), self.pspec.e_blk_cap + 1)))

    def store_bytes(self, pstore) -> dict:
        """Per-shard bytes vs the replicated snapshot."""
        self._require_blocks("store_bytes")
        return store_bytes_report(self.pspec, pstore)

    def empty_cache(self) -> CacheState:
        """Global-capacity empty cache: block ``s`` of every slot tensor is
        shard ``s``'s cache."""
        return empty_cache(self.espec.cache, device=self.device)

    # ---------------------------------------------------- block maintenance
    def _set_pspec(self, pspec):
        """Swap the block layout spec. Eager torch keeps no compiled steps
        closed over a spec, so nothing else changes."""
        self.pspec = pspec

    def set_block_capacity(self, e_blk_cap: int, *, recent_blk_cap: int | None = None):
        """Adopt a block layout without a store in hand: recovery restores a
        checkpoint taken under a recorded capacity."""
        self._require_blocks("set_block_capacity")
        rb = self.pspec.recent_blk_cap if recent_blk_cap is None else int(recent_blk_cap)
        self._set_pspec(self.pspec._replace(e_blk_cap=int(e_blk_cap),
                                            recent_blk_cap=min(rb, int(e_blk_cap))))

    def store_occupancy(self, pstore) -> dict:
        """Per-shard / per-block occupancy and recent fill."""
        self._require_blocks("store_occupancy")
        return block_occupancy(self.pspec, pstore)

    def compact_step(self, purge: bool = False):
        """The owner-local compaction pass under the current block layout,
        ``step(pstore) -> pstore'``: each shard merges its blocks' recent
        regions into their sorted bodies and rebuilds its geid indexes, with
        no collectives. The pass runs in a ``compact_store`` span."""
        self._require_blocks("compact_step")
        pspec, tracer = self.pspec, self.tracer
        return lambda ps: compact_store(pspec, ps, purge=purge, tracer=tracer)

    def grow_blocks(self, pstore, e_blk_cap: int, *, recent_blk_cap: int | None = None):
        """Grow every block to ``e_blk_cap`` and adopt the grown spec: the
        one capacity-growth path (``maintenance_tick`` and replay call it).
        The reference also prepares the next tier's compiled steps ahead of
        the swap (``precompile_next_tier`` / ``swap_to_next_tier``); eager
        torch compiles nothing, so the swap is this pad alone, counted in
        ``swap_events`` and timed in a ``hot_swap_pause`` span."""
        self._require_blocks("grow_blocks")
        with self.tracer.span("hot_swap_pause"):
            new, grown = grow_store(self.pspec, pstore, e_blk_cap, recent_blk_cap=recent_blk_cap)
            self._set_pspec(new)
        self.swap_events += 1
        return grown

    def maintenance_tick(self, pstore, policy: MaintenancePolicy | None = None, *,
                         journal=None):
        """Run due maintenance between transaction batches, in a
        ``compaction_tick`` span: read the block lengths, then grow and / or
        compact as ``policy`` decides, journaling each event (GROW / COMPACT)
        so replay repeats it at the same point. Returns ``(pstore', info)``.
        (The reference's ``occupancy=``, a report the caller holds already,
        waits for a caller: its serve loop does not tick.)"""
        self._require_blocks("maintenance_tick")
        with self.tracer.span("compaction_tick"):
            policy = MaintenancePolicy() if policy is None else policy
            occ = self.store_occupancy(pstore)
            dec = decide_maintenance(self.pspec, occ, policy, self.mutation_rows_since_compact)
            info = dict(compacted=False, grown_to=None, reason=dec.reason,
                        max_occupancy=occ["max_occupancy"],
                        max_recent_fill=occ["max_recent_fill"])
            if dec.grow_to is not None:
                pstore = self.grow_blocks(pstore, dec.grow_to)
                if journal is not None:
                    journal.append_grow(self.pspec.e_blk_cap, self.pspec.recent_blk_cap)
                info["grown_to"] = dec.grow_to
            if dec.compact:
                pstore = self.compact_step(policy.purge)(pstore)
                if journal is not None:
                    journal.append_compact(purge=policy.purge)
                self.mutation_rows_since_compact = 0
                info["compacted"] = True
        return pstore, info

    # ------------------------------------------------------------- hedging
    def racer(self):
        """A copy of this runtime for one call of a hedged read: it serves
        the same state, but its observations (``last_step_seconds``,
        ``last_owner_stage``, ``last_step_owner_seconds``), its mesh counts
        and its spans are its own. ``adopt`` takes the winner's."""
        r = copy.copy(self)
        r.mesh = LocalMesh(self.n)
        r.tracer = _SpanLog()
        return r

    def adopt(self, racer):
        """Take a winning ``racer``'s observations, mesh counts and spans."""
        for f in _OBSERVED:
            setattr(self, f, getattr(racer, f))
        for k, v in racer.mesh.counts.items():
            self.mesh.counts[k] = self.mesh.counts.get(k, 0) + v
        for name, seconds, attrs in racer.tracer.spans:
            self.tracer.record(name, seconds, attrs)

    # ---------------------------------------------------------- routing
    def attach_routing(self, rhost: RoutingTableHost | None):
        """Attach the host routing table: every serving, commit and CP step
        then reads ``rhost.device_table()`` at dispatch (cached per epoch,
        so an unchanged table costs a dict hit), and ``ShardedMissDrain``
        queues misses at each root's cache owner. ``None`` detaches."""
        if rhost is not None:
            if rhost.n != self.n:
                raise ValueError(f"a table of {rhost.n} owners on a runtime of {self.n}")
            if rhost.device != self.device:
                raise ValueError(f"the table stamps on {rhost.device}, the runtime runs on "
                                 f"{self.device}")
        self.rhost = rhost
        return rhost

    def _resolve_rtable(self, rhost: RoutingTableHost | None):
        """A step's table and its host: a given ``RoutingTableHost``, else
        the attached one, its current table; with neither, the identity
        table. Returns ``(table, rhost)``."""
        rhost = rhost if rhost is not None else self.rhost
        if rhost is not None:
            return rhost.device_table(), rhost
        return self.identity, None

    # --------------------------------------------------------- gR-Tx path
    def _hop_route_caps(self, plan, Bloc: int):
        """Per-hop per-peer routing capacity: ``ceil(factor * rows / n)`` for
        the ``rows = Bloc * A`` a rank routes at a hop, or ``rows`` (no
        drop) when the factor is None."""
        caps, A = [], 1
        F, RW = self.espec.frontier, self.espec.result_width
        rcf = self.route_cap_factor
        for i, _ in enumerate(plan.hops):
            rows = Bloc * A
            f = rcf[min(i, len(rcf) - 1)] if isinstance(rcf, tuple) else rcf
            caps.append(max(1, rows) if f is None else max(1, -(-f * rows // self.n)))
            A = min(F, A * RW)
        return caps

    def run_gr_tx_batch(self, store, cache, ttable, plan, roots, *, down=None, rtable=None,
                        return_deferred: bool = False):
        """Pad, run every rank's program on the mesh, decode the misses.
        Same contract as ``GraphEngine.run``: (result, misses, metrics), and
        the per-row ``deferred`` flags fourth with ``return_deferred``.

        ``down`` (bool[n]) masks the named owners' miss segments: their
        misses defer. ``rtable`` is the routing table (a
        ``RoutingTableHost``, or None: the attached host, else the identity
        table). Under a table with cache exceptions, rows
        routed to a split vertex's cache home that miss there defer, and
        the **locality retry** runs them once more through the table's
        storage view (``storage_table()``), merging results, deferred
        flags, misses and the additive metrics (``locality_retry_rows``
        counts the rows, ``locality_retries`` the batches). With no owner
        down and no cache exception the batch does no deferral work.

        ``metrics["host_syncs"]`` counts each rank's miss-count read per hop,
        each rank's merge rounds and the one result copy. With telemetry on,
        the owner-stage block rides that copy and lands in
        ``last_owner_stage``, not in the metrics; ``last_step_owner_seconds``
        attributes ``last_step_seconds`` to the owners by their work."""
        table, rhost = self._resolve_rtable(rtable)
        split = rhost is not None and bool(rhost.cache_exceptions)
        result, misses, metrics, deferred = self._gr_batch(store, cache, ttable, plan, roots,
                                                           down, table, split)
        metrics["locality_retry_rows"] = 0
        if split and deferred.any():
            roots = np.asarray(roots, np.int32)
            idx = np.flatnonzero(deferred & rhost.is_split(roots))
            if idx.size:
                r2, mis2, m2, d2 = self._gr_batch(store, cache, ttable, plan, roots[idx], down,
                                                  rhost.storage_table(), False)
                result, deferred = result.copy(), deferred.copy()
                result[idx] = r2
                deferred[idx] = d2
                misses = list(misses) + list(mis2)
                for k, v in m2.items():
                    if k in metrics:
                        metrics[k] += int(v)
                metrics["locality_retry_rows"] = int(idx.size)
                self.locality_retries += 1
        if return_deferred:
            return result, misses, metrics, deferred
        return result, misses, metrics

    def _gr_batch(self, store, cache, ttable, plan, roots, down, rtable, split: bool):
        """One gR batch under the routing table ``rtable`` (``split``: it
        may hold cache exceptions, so rows routed to a split vertex's cache
        home defer). Returns ``(result, misses, metrics, deferred)``, each
        cut to the batch."""
        from repro_torch.core.engine import _to_host

        n, tr = self.n, self.tracer
        B = len(roots)
        bucket = max(bucket_for(B), n)
        if bucket // n * n != bucket:
            raise ValueError(f"batch bucket {bucket} does not divide over {n} shards")
        proots, bvalid = pad_roots(roots, bucket)
        proots = torch.as_tensor(proots, device=self.device)
        bvalid = torch.as_tensor(bvalid, device=self.device)
        down = None if down is None else np.asarray(down, dtype=bool).reshape(-1)
        if down is not None and not down.any():
            down = None
        syncs = SyncCount()
        t0 = time.perf_counter()
        with tr.span("gr_dispatch"):
            result, row_def, mroots, mcounts, m = self._gr_programs(
                store, cache, ttable, plan, proots, bvalid, down, rtable, split, syncs)
        n_seg = len(mroots)
        # the owner-stage block leaves the metrics before the copy, so the
        # metrics dict is the one telemetry=False builds
        stage = m.pop("owner_stage", None)
        extra = ([row_def] if row_def is not None else []) + ([stage] if stage is not None else [])
        with tr.span("gr_sync"):
            metrics, (result, *host) = _to_host(m, [result, *mroots, *mcounts, *extra])
        self.last_step_seconds = time.perf_counter() - t0
        with tr.span("gr_unpack"):
            stage = host.pop() if stage is not None else None
            deferred = host.pop() if row_def is not None else np.zeros(len(result), bool)
            version = metrics.pop("_version")
            metrics["host_syncs"] = syncs.n + 1
            metrics["route_cap_retries"] = 0  # the "auto" caps are not ported
            misses = decode_miss_records(plan, self.use_cache, host[:n_seg], host[n_seg:],
                                          version)
        if stage is not None:
            self.last_owner_stage = stage.astype(np.int64)
            self.last_step_owner_seconds = attribute_step_seconds(self.last_step_seconds,
                                                                  self.last_owner_stage)
        else:
            self.last_owner_stage = self.last_step_owner_seconds = None
        return result[:B], misses, metrics, deferred[:B]

    def _gr_programs(self, store, cache, ttable, plan, proots, bvalid, down, rtable,
                     split: bool, syncs):
        """Every rank's gR program over the padded batch ``proots`` /
        ``bvalid`` (rank ``r`` takes rows ``[r * B/n, (r + 1) * B/n)``), on
        the device: ``(result, row deferred or None, miss roots by segment,
        miss counts by segment, metrics with "_version")``, the metrics'
        values still tensors. ``down`` is the host mask of owners down, or
        None."""
        n, pspec = self.n, self.pspec
        Bloc = proots.shape[0] // n
        caps = self._hop_route_caps(plan, Bloc)
        programs = []
        for me in range(n):
            tier = _MeshTier(self, caps, me, rtable, down, split)
            steps = make_plan_fn(self.lspec, plan, self.use_cache, tier)
            rows = slice(me * Bloc, (me + 1) * Bloc)
            # the replicated tier's ranks all read the one full store
            shard = store if pspec is None else local_shard(pspec, store, me)
            programs.append(steps(shard, cache_shard(cache, n, me), ttable, proots[rows],
                                  bvalid[rows], syncs))
        outs = self.mesh.run(programs)
        result = torch.cat([o[0] for o in outs])
        row_def = torch.cat([o[1] for o in outs]) if outs[0][1] is not None else None
        n_seg = len(outs[0][2])
        mroots = [torch.cat([o[2][i] for o in outs]) for i in range(n_seg)]
        mcounts = [torch.cat([o[3][i] for o in outs]) for i in range(n_seg)]
        return result, row_def, mroots, mcounts, dict(outs[0][4], _version=outs[0][5])

    def gr_step(self, plan):
        """The serving step of one plan over a padded global batch, as the
        reference's ``_gr_fn`` program: ``step(store, cache, ttable, roots,
        bvalid, down, rtable) -> (result, miss roots by segment, miss counts
        by segment, metrics)``, all on the device; ``down`` is a bool [n]
        tensor, ``rtable`` a ``RoutingTable``. It reads ``down`` on the host
        (an owner down defers its misses), then each rank's miss count at
        every hop and its merge rounds, as ``run_gr_tx_batch`` does. The
        step carries this runtime as ``step.runtime``."""

        def step(store, cache, ttable, roots, bvalid, down, rtable):
            mask = np.asarray(down.cpu(), dtype=bool).reshape(-1)
            result, _, mroots, mcounts, m = self._gr_programs(
                store, cache, ttable, plan, roots, bvalid, mask if mask.any() else None,
                rtable, False, SyncCount())
            m.pop("owner_stage", None)
            return result, mroots, mcounts, m

        step.runtime = self
        return step

    # -------------------------------------------------------- gRW-Tx path
    def _route_and_apply_ops(self, cache, ops, sweeps, through: bool, syncs, rtable):
        """One rank's maintenance apply, a per-rank program: compact the
        derived ops to ``OPS_CAP`` rows and route each, as one frame
        ``[flags | kind | tpl | root | params | vid | order]``, to the shard
        holding its root's cache entries (``cache_owner_of`` under
        ``rtable``) in one
        all_to_all; all-gather the sweeps, which every rank applies whole (a
        sweep of another shard's root matches nothing here); then apply
        sweeps, then ops, to the rank's cache block. Returns (cache',
        occupancy delta, overflow)."""
        n, cap, lcspec = self.n, OPS_CAP, self.lspec.cache
        (okind, otpl, oroot, oparams, ovid, oorder), _, ovf_c = compact_rows(
            ops.ok, OPS_CAP, (ops.kind, ops.tpl, ops.root, ops.params, ops.vid, ops.order),
            (0, -1, NULL_ID, 0, NULL_ID, 0),
        )
        dest = torch.where(oroot != NULL_ID, cache_owner_of(rtable, oroot, n), -1)
        flags = torch.full_like(oroot, WIRE_FLAG_VALID)
        col = lambda x: x[:, None]
        frame = torch.cat([col(flags), col(okind), col(otpl), col(oroot), oparams, col(ovid),
                           col(oorder)], dim=1)
        send, _, _, ovf_r = bucketize(frame, dest, n, cap, fill=0)  # padding: flags 0
        recv = (yield (ALL_TO_ALL, send)).reshape(n * cap, -1)
        P = PARAM_LEN
        rops = CacheOpStream(
            kind=recv[:, 1], tpl=recv[:, 2], root=recv[:, 3], params=recv[:, 4:4 + P],
            vid=recv[:, 4 + P], order=recv[:, 5 + P],
            ok=(recv[:, 0] & WIRE_FLAG_VALID) == WIRE_FLAG_VALID,
        )
        (stpl, sroot), _, ovf_s = compact_rows(sweeps.ok, SWEEP_CAP,
                                               (sweeps.tpl, sweeps.root), (-1, NULL_ID))
        g = yield (ALL_GATHER, torch.stack([stpl, sroot], dim=1))
        gsw = SweepStream(tpl=g[:, 0], root=g[:, 1], ok=g[:, 1] != NULL_ID)
        # impacted = distinct logical keys removed: the chunk-0 occupancy
        # delta (raw ops would count a key hit by several ops more than once)
        head = lambda c: (c.valid & (c.chunk == 0)).sum(dtype=torch.int32)
        occ0 = head(cache)
        cache2 = apply_sweeps(lcspec, cache, gsw)
        if through:
            cache2 = apply_op_stream_segmented(lcspec, cache2, rops, syncs)
        else:
            cache2 = apply_op_stream_batched(lcspec, cache2, rops)
        occ = occ0 - head(cache2)
        return cache2._replace(n_delete=cache.n_delete + occ), occ, ovf_c + ovf_r + ovf_s

    def _grw_replicated_fn(self, through: bool, store, store2, applied, cache, ttable, me: int,
                           syncs, rtable):
        """Rank ``me``'s share of a replicated-tier commit, a per-rank
        program: the listener over its round-robin slice of the applied
        batch (its rows' global indices restored for the op-order keys)
        against the full pre and post store, then the ops routed and
        applied as on the partitioned tier, and one all-reduce sum of
        (impacted, overflow). Returns (its cache block, impacted,
        op_overflow)."""
        n = self.n
        ops, sweeps = derive_cache_ops(self.espec, store, store2, ttable,
                                       shard_mutation_rows(applied, n, me), through=through,
                                       row_offset=me, row_stride=n)
        cache2, occ, ovf = yield from self._route_and_apply_ops(
            cache_shard(cache, n, me), ops, sweeps, through, syncs, rtable)
        sums = yield (ALL_REDUCE_SUM, torch.stack([occ, ovf]))
        return cache2, sums[0], sums[1]

    def _grw_fn(self, through: bool, gate, store, cache, ttable, batch, me: int, syncs,
                flags_read: _MeshRead, rtable):
        """Rank ``me``'s gRW-Tx commit, a per-rank program: apply the batch to
        its blocks, derive the ops its storage owns; with a ``gate``,
        all-gather every rank's (out, inc) gate flags (read once for the
        mesh through ``flags_read``) and compact its own flagged blocks;
        route and apply the ops, then one all-reduce sum of (impacted,
        overflow) and one all-reduce max of (largest block, largest recent
        fill) over the maintained blocks. Returns (the rank's store, its
        cache block, impacted, op_overflow, store_overflow, blk_max,
        rec_max, the blocks the gate compacted over the mesh)."""
        pspec = self.pspec
        local = local_shard(pspec, store, me)
        store2, applied, store_ovf = yield from apply_mutations_partitioned(
            pspec, local, batch, me, rtable)
        ops, sweeps = derive_cache_ops_views(
            self.lspec, BlockStoreView(pspec, local, me, rtable),
            BlockStoreView(pspec, store2, me, rtable), ttable, applied, through=through)
        ncomp = 0
        if gate is not None:
            # the ops are derived already, so the layout change cannot
            # perturb this commit's invalidation; a block compacts at
            # ceil(recent_fill_frac * recent_blk_cap) recent lanes
            thresh = max(int(math.ceil(gate.recent_fill_frac * pspec.recent_blk_cap)), 0)
            rec = torch.stack([b.blk_len[0] - b.csr_len[0] for b in (store2.out, store2.inc)])
            flags = flags_read.read((yield (ALL_GATHER, (rec >= thresh)[None])))
            maintain = lambda b, hit: compact_block(pspec, b, purge=gate.purge, me=me) if hit else b
            store2 = store2._replace(out=maintain(store2.out, flags[me][0]),
                                     inc=maintain(store2.inc, flags[me][1]))
            ncomp = sum(map(sum, flags))
        cache2, occ, ovf = yield from self._route_and_apply_ops(
            cache_shard(cache, self.n, me), ops, sweeps, through, syncs, rtable)
        sums = yield (ALL_REDUCE_SUM, torch.stack([occ, ovf]))
        out, inc = store2.out, store2.inc
        fill = torch.stack([torch.maximum(out.blk_len[0], inc.blk_len[0]),
                            torch.maximum(out.blk_len[0] - out.csr_len[0],
                                          inc.blk_len[0] - inc.csr_len[0])])
        maxes = yield (ALL_REDUCE_MAX, fill)
        return store2, cache2, sums[0], sums[1], store_ovf, maxes[0], maxes[1], ncomp

    def grw_step(self, policy: str = "write-around", gate: DeviceGate | None = None):
        """The partitioned gRW-Tx commit under ``policy`` (write-around or
        write-through) and ``gate`` (a ``DeviceGate`` or None):
        ``step(store, cache, ttable, batch, syncs=None, rtable=None) ->
        (store', cache', impacted, op_overflow, store_append_overflow,
        max_blk_len, max_recent_fill, device_compactions)``, device scalars
        but the last, a host int. Runs every rank's ``_grw_fn`` on the mesh
        under the routing table (resolved as ``run_gr_tx_batch``'s) and
        joins their blocks in rank order; write-through's round reads and
        the gate's one flag read are counted in ``syncs``.

        On the replicated tier the step applies the batch to the one store
        once, then runs every rank's ``_grw_replicated_fn``; its store
        overflow, block maxima and compactions are 0, and a ``gate`` raises
        (the gate compacts blocks)."""
        if policy not in ("write-around", "write-through"):
            raise ValueError(f"unknown gRW policy {policy!r}")
        through = policy == "write-through"
        if gate is not None:
            self._require_blocks("the maintenance gate")

        def step(store, cache, ttable, batch, syncs=None, rtable=None):
            syncs = syncs if syncs is not None else SyncCount()
            flags_read = _MeshRead(syncs)
            table, _ = self._resolve_rtable(rtable)
            if self.pspec is None:
                store2, applied = apply_mutations(self.espec.store, store, batch)
                outs = self.mesh.run([
                    self._grw_replicated_fn(through, store, store2, applied, cache, ttable, me,
                                            syncs, table) for me in range(self.n)])
                z = torch.zeros((), dtype=torch.int32, device=self.device)
                return (store2, _replicate_stats(cache, [o[0] for o in outs]), outs[0][1],
                        outs[0][2], z, z, z, 0)
            outs = self.mesh.run([self._grw_fn(through, gate, store, cache, ttable, batch, me,
                                               syncs, flags_read, table)
                                  for me in range(self.n)])
            store2 = join_shards([o[0] for o in outs])
            cache2 = _replicate_stats(cache, [o[1] for o in outs])
            return (store2, cache2) + tuple(outs[0][2:])

        return step

    def run_grw_tx(self, store, cache, ttable, batch, policy: str = "write-around", *,
                   gate: DeviceGate | None = None, occupancy_metrics: bool = True,
                   journal=None, rtable=None):
        """One gRW-Tx on the partitioned tier, mirroring
        ``core.engine.run_grw_tx``: (store', cache', metrics). Metrics:
        ``impacted_keys``, ``op_overflow``, ``store_append_overflow``;
        with a ``gate``, ``device_compactions`` (the blocks it compacted);
        with ``occupancy_metrics``, ``store_occupancy_max`` (largest block
        fill over ``e_blk_cap``) and ``store_recent_fill_max`` (largest
        ``blk_len - csr_len``), both after the gate; ``host_syncs``:
        write-through's round reads, the gate's one flag read, the one copy
        of the metrics (the commit version and the batch's section counts
        ride it) and, with a ``journal``, its one copy of the batch.

        On the replicated tier the store is the single-host ``GraphStore``,
        ``store_append_overflow`` and the occupancy metrics read 0 and a
        ``gate`` raises.

        ``journal`` (a ``WriteBehindJournal``) makes the commit durable
        write-behind: the batch is appended with its policy and gate, and
        the journal's metrics join the returned ones. ``rtable`` routes the
        commit (resolved as ``run_gr_tx_batch``'s); a host table also routes
        the journal's dirty owners. The commit and its metrics copy run in a
        ``grw_step`` span."""
        syncs = SyncCount()
        _, rhost = self._resolve_rtable(rtable)
        with self.tracer.span("grw_step"):
            store2, cache2, *scalars, ncomp = self.grw_step(policy, gate)(
                store, cache, ttable, batch, syncs, rtable)
            b = batch
            counts = [b.nv_n, b.ne_n, b.de_n, b.dv_n, b.sv_n, b.se_n]
            impacted, ovf, store_ovf, blk_max, rec_max, version, *rows = torch.stack(
                [x.to(torch.int64) for x in scalars + [store2.version] + counts]).tolist()
        metrics = {"impacted_keys": impacted, "op_overflow": ovf,
                   "store_append_overflow": store_ovf}
        if self.pspec is not None:
            self.mutation_rows_since_compact += sum(rows)
        if gate is not None:
            metrics["device_compactions"] = ncomp
            if ncomp:
                self.mutation_rows_since_compact = 0
        if occupancy_metrics:
            # the replicated tier has no blocks: both read 0
            metrics["store_occupancy_max"] = (0.0 if self.pspec is None
                                              else round(blk_max / self.pspec.e_blk_cap, 4))
            metrics["store_recent_fill_max"] = rec_max
        metrics["host_syncs"] = syncs.n + 1 + (journal is not None)
        if journal is not None:
            journal.append_commit(batch, policy=policy, gate=gate, commit_version=version,
                                  device_compactions=ncomp,
                                  route=rhost.storage_owner if rhost is not None else None)
            metrics.update(journal.metrics())
        return store2, cache2, metrics

    # ------------------------------------------------------ CP population
    def populator(self, templates_meta, owner: int, max_retries: int = 3):
        """A ``CachePopulator`` for the misses queued at one owner shard
        (their cache owner). Its CP transactions execute each row against
        its storage owner's blocks and insert it into its cache owner's
        block, under the table of the moment; on the replicated tier each
        row executes and inserts whole at its cache owner, over the full
        store."""
        from repro_torch.core.population import CachePopulator

        return CachePopulator(self.espec, templates_meta, max_retries=max_retries,
                              device=self.device,
                              step_builder=functools.partial(self._pop, templates_meta, owner))

    def _pop(self, templates_meta, me: int, tpl_idx: int, bucket: int):
        from repro_torch.core.population import populate_program, populate_step

        del bucket  # eager torch compiles nothing per batch shape
        n, lspec = self.n, self.lspec
        direction, edge_label = templates_meta[tpl_idx]

        def step(store_exec, store_commit, cache, ttable, roots, params, mask, read_versions):
            # the table and the block layout at CALL time: a populator keeps
            # this step across moves and capacity swaps
            rtable, rhost = self._resolve_rtable(None)
            pspec = self.pspec
            valid = mask & (roots >= 0)
            if pspec is None:
                # the replicated store: a row executes where it inserts, at
                # its cache owner, over the full store (no split)
                c2, ok, ab = populate_step(
                    lspec, store_exec, store_commit, cache_shard(cache, n, me), ttable,
                    tpl_idx, direction, edge_label, roots, params,
                    valid & (cache_owner_of(rtable, roots, n) == me), read_versions)
                shards = [c2 if s == me else cache_shard(cache, n, s) for s in range(n)]
                return _replicate_stats(cache, shards), ok, ab
            sown = storage_owner_of(rtable, roots, n)
            view = lambda s: BlockStoreView(pspec, local_shard(pspec, store_exec, s), s, rtable)
            cown = None
            if rhost is not None and rhost.has_exceptions():
                # one read decides: does a row execute or insert at another
                # shard (a split vertex, or a vertex moved since it queued)?
                cown = cache_owner_of(rtable, roots, n)
                if not bool((valid & ((sown != me) | (cown != me))).any()):
                    cown = None
            if cown is None:
                # every row executes and inserts here
                c2, ok, ab = populate_step(
                    lspec, store_exec, store_commit, cache_shard(cache, n, me), ttable,
                    tpl_idx, direction, edge_label, roots, params, valid & (sown == me),
                    read_versions, exec_view=view(me))
                shards = [c2 if s == me else cache_shard(cache, n, s) for s in range(n)]
                return _replicate_stats(cache, shards), ok, ab
            # the CP split: each row executes at its storage owner and
            # inserts at its cache owner, the bundle summed over the mesh
            self.cp_splits += 1
            outs = self.mesh.run([populate_program(
                lspec, store_exec, store_commit, cache_shard(cache, n, s), ttable, tpl_idx,
                direction, edge_label, roots, params, valid & (sown == s), read_versions,
                exec_view=view(s), commit_mask=valid & (cown == s)) for s in range(n)])
            ok = torch.stack([o[1] for o in outs]).any(dim=0)
            ab = torch.stack([o[2] for o in outs]).any(dim=0)
            return _replicate_stats(cache, [o[0] for o in outs]), ok, ab

        return step


class ShardedMissDrain:
    """Per-shard CP drain loops over the runtime's per-shard miss records.

    Each miss record lands in the queue of its root's cache owner (under
    the attached routing table; its owner by the base rule without one),
    drained by that owner's populator; ``drain`` walks the shards in order,
    so every CP batch runs one owner's step (the CP-per-shard layout of
    §4's population threads). A row whose rows live elsewhere executes at
    its storage owner inside that step (the CP split).
    """

    def __init__(self, rt: ShardedTxnRuntime, templates_meta, max_retries: int = 3):
        self.n = rt.n
        self.rt = rt
        self.pops = [rt.populator(templates_meta, s, max_retries) for s in range(rt.n)]

    def push(self, misses):
        rhost = self.rt.rhost
        roots = np.array([m.root for m in misses], np.int64)
        owners = rhost.cache_owner(roots) if rhost is not None else base_owner(roots, self.n)
        for m, owner in zip(misses, owners.tolist()):
            self.pops[owner].queue.push([m])

    def drain(self, store_exec, store_commit, cache, ttable, k: int = 128):
        """Drain up to ``k`` misses per shard queue; returns the new cache."""
        for pop in self.pops:
            cache = pop.drain(store_exec, store_commit, cache, ttable, k)
        return cache

    @property
    def committed(self) -> int:
        return sum(p.committed for p in self.pops)

    @property
    def aborted(self) -> int:
        return sum(p.aborted for p in self.pops)

    def pending(self) -> int:
        return sum(len(p.queue) for p in self.pops)


# ======================================================================
# The capacity-planning description of a deployment, lowered to the
# runtime's spec and its served template, and the dry-run's serving cell
# (``config_cell``). The reference's ``config_grw_cell`` lowers the gRW
# commit at capacity for an XLA check and has no twin: the port's commit
# reads the host, so a meta run of it would stop at its first read.


@dataclass(frozen=True)
class GraphServeConfig:
    v_total: int  # vertices
    e_per_vertex: int  # average degree for capacity planning
    max_deg: int  # per-hop gather window
    max_leaves: int  # cache value width
    cache_slots_total: int  # cache capacity across the fleet
    route_cap_factor: int | tuple | None = DEFAULT_ROUTE_CAP_FACTOR
    recent_cap: int = 1024  # append-region scan window
    n_vprops: int = 2
    n_eprops: int = 1
    # the served template instance (Figure 1): edge prop0 == 1, leaf prop0 == 0
    edge_prop: int = 0
    edge_val: int = 1
    leaf_prop: int = 0
    leaf_val: int = 0

    def e_total(self) -> int:
        return self.v_total * self.e_per_vertex


def config_espec(cfg: GraphServeConfig):
    """Lower a capacity config to an ``EngineSpec`` for the runtime."""
    from repro_torch.core.cache import CacheSpec
    from repro_torch.core.engine import EngineSpec
    from repro_torch.graphstore.store import StoreSpec

    spec = StoreSpec(v_cap=cfg.v_total, e_cap=cfg.e_total(), n_vprops=cfg.n_vprops,
                     n_eprops=cfg.n_eprops, recent_cap=cfg.recent_cap)
    cspec = CacheSpec(capacity=cfg.cache_slots_total, probes=8, max_leaves=cfg.max_leaves,
                      max_chunks=1)
    return EngineSpec(store=spec, cache=cspec, max_deg=cfg.max_deg, frontier=cfg.max_leaves)


def config_plan_and_ttable(cfg: GraphServeConfig):
    """The served SQ1-shape template instance (Figure 1) as a runtime
    ``QueryPlan`` plus its enabled ``TemplateTable``."""
    from repro_torch.core.engine import Hop, QueryPlan
    from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator
    from repro_torch.core.templates import (
        ANY_LABEL, DIR_OUT, MAX_CONDS, OP_EQ, WILDCARD, Template, make_pred,
        make_template_table,
    )
    from repro_torch.utils import PROP_MISSING

    econd = [(cfg.edge_prop, OP_EQ, WILDCARD)]
    lcond = [(cfg.leaf_prop, OP_EQ, WILDCARD)]
    tpl = Template("SQ1", DIR_OUT, (ANY_LABEL, []), (ANY_LABEL, econd), (ANY_LABEL, lcond))
    ttable = make_template_table([tpl])
    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    sc.register(0)
    sc.enable(0)
    ttable = qp.ttable_masks(ttable, 1)
    params = np.full(PARAM_LEN, int(PROP_MISSING), np.int32)
    params[0] = cfg.edge_val
    params[MAX_CONDS] = cfg.leaf_val
    hop = Hop(DIR_OUT, ANY_LABEL, make_pred(ANY_LABEL, []), make_pred(ANY_LABEL, econd),
              make_pred(ANY_LABEL, lcond), 0, params)
    return QueryPlan(hops=(hop,)), ttable


def random_config_store(cfg: GraphServeConfig, generator: torch.Generator, device=None):
    """A seeded random graph at ``cfg``'s capacity, built on ``device``:
    every vertex has ``e_per_vertex`` out-edges to uniform destinations
    (edge slot ``v * e_per_vertex + j`` is vertex v's j-th), every vertex
    label and edge label 0, vertex and edge property 0 drawn from {0, 1}
    (the other properties missing). The edge slots fill ``e_cap`` exactly;
    the CSR indexes are built (``compact``)."""
    from repro_torch.graphstore.store import compact, empty_store
    from repro_torch.utils import PROP_MISSING

    espec = config_espec(cfg)
    spec = espec.store
    dev = resolve_device(device)
    V, E = cfg.v_total, cfg.e_total()
    g = dict(generator=generator, device=dev)
    store = empty_store(spec, device=dev)
    vprops = torch.full((V, spec.n_vprops), PROP_MISSING, dtype=torch.int32, device=dev)
    vprops[:, 0] = torch.randint(0, 2, (V,), dtype=torch.int32, **g)
    eprops = torch.full((E, spec.n_eprops), PROP_MISSING, dtype=torch.int32, device=dev)
    eprops[:, 0] = torch.randint(0, 2, (E,), dtype=torch.int32, **g)
    store = store._replace(
        vlabel=torch.zeros(V, dtype=torch.int32, device=dev),
        valive=torch.ones(V, dtype=torch.bool, device=dev),
        vprops=vprops,
        esrc=torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(cfg.e_per_vertex),
        edst=torch.randint(0, V, (E,), dtype=torch.int32, **g),
        elabel=torch.zeros(E, dtype=torch.int32, device=dev),
        ealive=torch.ones(E, dtype=torch.bool, device=dev),
        eprops=eprops,
        v_len=torch.tensor(V, dtype=torch.int32, device=dev),
        e_len=torch.tensor(E, dtype=torch.int32, device=dev),
    )
    return compact(spec, store)


def config_cell(cfg: GraphServeConfig, mesh, *, use_cache: bool = True,
                global_batch: int = 8192, blk_slack: float = 1.0, device="meta",
                generator: torch.Generator | None = None, pstore=None):
    """The dry-run's serving cell of a capacity config on the partitioned
    runtime: ``(step, arg_specs, args, runtime)``, built as the reference's
    ``config_cell``. ``mesh`` is a shape mesh (``launch.mesh``); the
    runtime serves its ``mesh.size`` ranks on a ``LocalMesh``. ``step`` is
    ``runtime.gr_step(plan)`` and ``args`` are ``(pstore, cache, ttable,
    roots, bvalid, down, rtable)``; ``arg_specs`` gives each tensor leaf its
    spec: the edge blocks, the cache slots, ``roots`` and ``bvalid`` over
    every mesh axis, the vertex tier, scalars, ``down`` and the routing
    table replicated.

    On ``meta`` the store is ``abstract_partitioned_store`` and nothing is
    allocated. On a real device the store is ``pstore`` where given (a
    partitioned store of this layout, shared), else ``random_config_store``
    drawn from ``generator`` and partitioned (the single-host copy is
    dropped); the cache starts empty, ``roots`` are uniform vertices from
    ``generator``, every row valid and no owner down."""
    from repro_torch.graphstore.partition import abstract_partitioned_store

    espec = config_espec(cfg)
    plan, ttable = config_plan_and_ttable(cfg)
    rt = ShardedTxnRuntime(espec, LocalMesh(mesh.size), use_cache=use_cache,
                           route_cap_factor=cfg.route_cap_factor, blk_slack=blk_slack,
                           device=device)
    dev, n, B = rt.device, rt.n, global_batch
    if dev.type == "meta":
        pstore = abstract_partitioned_store(rt.pspec)
        roots = torch.empty(B, dtype=torch.int32, device=dev)
    else:
        if pstore is None:
            pstore = rt.partition_store(random_config_store(cfg, generator, dev))
        roots = torch.randint(0, cfg.v_total, (B,), dtype=torch.int32, generator=generator,
                              device=dev)
    cache = empty_cache(espec.cache, device=dev)
    bvalid = torch.ones(B, dtype=torch.bool, device=dev)
    down = torch.zeros(n, dtype=torch.bool, device=dev)
    rtable = rt.identity  # the table every step threads while none is attached
    axes = tuple(mesh.axis_names)
    ax = axes[0] if len(axes) == 1 else axes
    blk = lambda b: type(b)(**{f: (ax,) for f in b._fields})
    store_specs = pstore._replace(
        **{f: () for f in ("vlabel", "valive", "vprops", "vversion", "v_len", "e_len",
                           "version")},
        out=blk(pstore.out), inc=blk(pstore.inc))
    cache_specs = cache._replace(**{f: (ax,) if f in _SLOT_FIELDS else () for f in cache._fields})
    repl = lambda tree: tree_map_with_path(lambda *_: (), tree)
    arg_specs = (store_specs, cache_specs, repl(ttable), (ax,), (ax,), (), repl(rtable))
    args = (pstore, cache, ttable, roots, bvalid, down, rtable)
    return rt.gr_step(plan), arg_specs, args, rt
