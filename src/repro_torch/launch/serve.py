"""The serving entry point of the PyTorch port: the sharded transaction runtime —
owner-routed gR-Txs over the partitioned dual-CSR storage tier (or, with
``--store-tier replicated``, a full store every rank reads) with the
co-partitioned cache — on a process-local mesh, with real data, reporting
hit / overflow statistics, the storage tier's bytes, durability and
telemetry. Twin of ``repro.launch.serve``: the same flags and the same
``total`` dict, plus ``--device`` (CUDA unless it names another)::

  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --batches 10
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --trace t.jsonl
  PYTHONPATH=src python -m repro_torch.launch.serve --store-tier replicated

The loop (``serve_loop``) runs the serving life-cycle:

- gR-Tx batches through ``ShardedTxnRuntime.run_gr_tx_batch``, each under
  a pin of its read epoch in the journal's ``EpochRegistry`` (the fence
  that makes tombstone purge safe);
- the per-owner CP drain: each batch's miss records land in their owner's
  queue (``ShardedMissDrain``) and drain there, in a ``cp_drain`` span;
- a gRW-Tx commit of a mutation batch every ``--write-every`` batches,
  through the maintenance gate (``DeviceGate(0.5)``), with purge only when
  ``EpochRegistry.safe_to_purge`` allows it (``--purge``);
- write-behind durability: every commit is appended to the
  ``WriteBehindJournal`` (its flusher thread behind the loop), and the
  store is checkpointed every ``--checkpoint-every`` commits (incremental
  unless ``--full-checkpoints``);
- capacity growth: once a commit's ``store_occupancy_max`` crosses the
  policy's high-water, the blocks grow by its factor at the next batch
  boundary and a GROW record follows. The reference compiles the next
  tier's programs on a thread and swaps at a later boundary; eager torch
  compiles nothing, so the growth is the pad alone;
- telemetry (``obs.ServeTelemetry``): latency histograms per traffic
  class, the owner-stage block of every batch, periodic snapshots and the
  end-of-run report, as JSONL under ``--trace``;
- chaos (``--inject-crash SHARD:BATCH``, which needs the journal): the
  shard's storage is lost from that batch on. A ``FailoverController``
  probes every owner each batch; a batch that needs the dead owner before
  the detector marks it down raises ``NodeFailure`` and counts unavailable
  (it skips its CP and its commit); then reads serve degraded, their dead
  owner's misses deferred, and commits queue in the journal unapplied;
  ``--recover-after`` batches after the crash the owner is rebuilt by
  replay and splice and the queued commits drain. A straggling owner's
  reads are hedged after ``--hedge-after`` seconds. The ``failover:`` line
  and ``total`` report it;
- hot-vertex migration (``--migrate``): a ``RoutingTableHost`` is attached
  and a ``MigrationEngine`` (its tracker, the journal, the failure
  detector) runs at each batch boundary: it observes the batch's roots and
  may run one round on the owner-stage block's ``frontier_rows``, whose
  spliced store and bumped table the loop installs together; while an
  owner is down the round waits. The ``routing:`` line and ``total``
  report it.

On the replicated tier (``--store-tier replicated``, the reference's
baseline) the loop serves the gR batches and their CP drains only, as the
reference's does: no maintenance, no journal, no commits and no store-tier
bytes line; ``--migrate`` and ``--inject-crash`` (which needs the journal)
are argument errors there.

``main`` plugs in the reference's traffic: the ``config_plan_and_ttable``
plan over a random graph, uniform (or ``--hot-frac`` hot) roots and eight
upserts a commit, all from ``--seed``. Another caller plugs in its own
batches and commits through ``serve_loop``.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np

CP_DRAIN_K = 512  # misses each owner's queue drains after a batch


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags and ``--device``. As in the reference,
    ``--inject-crash`` without the journal (``--no-journal``, or the
    replicated tier, which keeps none) and ``--migrate`` on the replicated
    tier are argument errors."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--vertices", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; raises without it)")
    ap.add_argument("--store-tier", default="partitioned", choices=("partitioned", "replicated"),
                    help="storage tier (replicated: reads and CP only, the baseline)")
    ap.add_argument("--write-every", type=int, default=2,
                    help="apply a small gRW commit every N batches (0 disables writes)")
    ap.add_argument("--no-maintenance", action="store_true",
                    help="disable the maintenance gate and capacity growth")
    ap.add_argument("--journal-dir", default=None,
                    help="write-behind journal root (default: a temporary directory, "
                         "removed at the end)")
    ap.add_argument("--no-journal", action="store_true", help="disable write-behind durability")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    help="checkpoint the store every N commits")
    ap.add_argument("--purge", action="store_true",
                    help="reclaim tombstones at gated compactions when the liveness epoch "
                         "allows")
    ap.add_argument("--inject-crash", default=None, metavar="SHARD:BATCH",
                    help="chaos: lose shard SHARD's storage from batch BATCH (serving "
                         "degrades, writes queue, recovery replays; needs the journal)")
    ap.add_argument("--recover-after", type=int, default=4,
                    help="batches of degraded serving before the crashed shard recovers")
    ap.add_argument("--hedge-after", type=float, default=0.05,
                    help="straggler hedge deadline in seconds for the gR read path")
    ap.add_argument("--io-timeout", type=float, default=None,
                    help="wall-clock bound per journal flush / checkpoint write attempt")
    ap.add_argument("--full-checkpoints", action="store_true",
                    help="periodic checkpoints snapshot the whole store (default: "
                         "incremental, the dirty owners only)")
    ap.add_argument("--migrate", action="store_true",
                    help="attach the routing table and run the hot-vertex migration policy "
                         "at batch boundaries")
    ap.add_argument("--hot-frac", type=float, default=0.0,
                    help="fraction of each batch's roots drawn from a hot set on one owner "
                         "(0 = uniform)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write telemetry (span / snapshot / report events) as JSONL to PATH; "
                         "validate with `python -m repro_torch.obs.validate PATH`")
    ap.add_argument("--snapshot-every", type=int, default=5,
                    help="emit a telemetry snapshot every N batches (0: none; the end-of-run "
                         "report is always emitted)")
    args = ap.parse_args(argv)
    replicated = args.store_tier == "replicated"
    if args.inject_crash is not None and (args.no_journal or replicated):
        ap.error("--inject-crash requires the journal (degraded-mode writes queue there)")
    if args.migrate and replicated:
        ap.error("--migrate requires the partitioned store tier")
    return args


class ServeOutcome(NamedTuple):
    total: dict  # the reference's run totals
    pstore: object  # the store after the run (the single-host one on the replicated tier)
    cache: object  # the cache after the run
    drain: object  # the ShardedMissDrain (populated / aborted / pending)
    report: dict  # the telemetry report event
    result: np.ndarray  # the last batch's result
    journal_metrics: dict | None  # the journal's metrics after its final flush
    maint: dict  # commits, device compactions, purges, growths, appends dropped


def serve_loop(args, rt, pstore, ttable, tpl_meta,
               next_batch: Callable[[int], tuple], next_commit: Callable[[int], object],
               telemetry, *, log=print) -> ServeOutcome:
    """The reference serve loop over ``args.batches`` batches on ``rt``, a
    ``ShardedTxnRuntime`` whose tracer is ``telemetry.tracer``, from the
    partitioned store ``pstore`` (on the replicated tier, the single-host
    store: reads and CP drains only, as the reference's loop there).

    ``next_batch(b)`` gives batch ``b``'s ``(plan, roots)`` and
    ``next_commit(b)`` the mutation batch committed after it (every
    ``args.write_every`` batches); ``tpl_meta`` maps each cached template to
    its (direction, edge label) for CP. The journal (unless
    ``args.no_journal``) lives at ``args.journal_dir``. With
    ``args.inject_crash`` a ``FailoverController`` serves the batches and
    commits, and with ``args.migrate`` a ``MigrationEngine`` runs at each
    batch boundary (see the module docstring). Prints the reference's lines
    through ``log``, closes ``telemetry`` and returns a ``ServeOutcome``."""
    from repro_torch.distributed.failover import FailoverController
    from repro_torch.distributed.fault import HedgedCalls, NodeFailure, ShardFaultPlan
    from repro_torch.distributed.graph_serve import ShardedMissDrain
    from repro_torch.distributed.routing import RoutingTableHost
    from repro_torch.graphstore import DeviceGate, MaintenancePolicy, WriteBehindJournal
    from repro_torch.graphstore.migration import HotSetTracker, MigrationEngine
    from repro_torch.obs.metrics import OWNER_STAGE_FIELDS
    from repro_torch.obs.schema import LATENCY_CLASSES

    cache = rt.empty_cache()
    drain = ShardedMissDrain(rt, tpl_meta)
    policy = MaintenancePolicy(recent_fill_frac=0.5, grow_occupancy_frac=0.85)
    # the replicated tier has no blocks to maintain, keeps no journal and
    # takes no commits, as in the reference
    partitioned = rt.pspec is not None
    maintain = partitioned and not args.no_maintenance
    gate_base = DeviceGate(recent_fill_frac=policy.recent_fill_frac)

    journal = None
    if partitioned and not args.no_journal:
        if args.journal_dir is None:
            raise ValueError("the journal needs args.journal_dir")
        journal = WriteBehindJournal(args.journal_dir, rt.n, io_timeout=args.io_timeout,
                                     tracer=telemetry.tracer)
        journal.checkpoint(pstore, e_blk_cap=rt.pspec.e_blk_cap,
                           recent_blk_cap=rt.pspec.recent_blk_cap,
                           store_version=int(pstore.version))
        journal.start()  # the coalescing flusher, behind the loop
        log(f"journal: {args.journal_dir} (checkpoint every {args.checkpoint_every} commits)")

    failover = None
    crash_shard = crash_batch = None
    if args.inject_crash is not None:
        if journal is None:
            raise ValueError("--inject-crash requires the journal (degraded-mode writes queue "
                             "there)")
        crash_shard, crash_batch = (int(x) for x in args.inject_crash.split(":"))
        failover = FailoverController(rt, journal, ttable,
                                      plan=ShardFaultPlan(crash={crash_shard: crash_batch}),
                                      hedge=HedgedCalls(), hedge_after=args.hedge_after)
        log(f"chaos: shard {crash_shard} crashes at batch {crash_batch}, recovery after "
            f"{args.recover_after} degraded batches")

    engine = None
    if args.migrate:
        # the table is an input of every step: attaching it, and each later
        # epoch, changes no program
        rhost = rt.attach_routing(RoutingTableHost(rt.n, device=rt.device))
        engine = MigrationEngine(rt.pspec, rhost, tracker=HotSetTracker(), journal=journal,
                                 detector=failover.detector if failover is not None else None)
        log("routing: table attached (epoch 0), migration policy loop on")
    FR = OWNER_STAGE_FIELDS.index("frontier_rows")

    total = dict(requests=0, hits=0, misses=0, route_overflow=0, deferred=0,
                 locality_routed=0, locality_retry_rows=0)
    avail = dict(unavailable_batches=0, degraded_batches=0, deferred_rows=0, queued_commits=0,
                 recovery_seconds=0.0)
    maint = dict(device_compactions=0, growths=0, commits=0, append_overflow=0, purges=0)
    grow_to = None  # a growth due at the next batch boundary
    res = jm = None
    t0 = time.time()
    for b in range(args.batches):
        if grow_to is not None:
            # the batch boundary after the high-water: grow, then journal it
            pstore = rt.grow_blocks(pstore, grow_to)
            if journal is not None:
                journal.append_grow(rt.pspec.e_blk_cap, rt.pspec.recent_blk_cap)
            maint["growths"] += 1
            log(f"batch {b}: grew to e_blk_cap={rt.pspec.e_blk_cap}")
            grow_to = None
            if engine is not None:
                engine.pspec = rt.pspec
        plan, roots = next_batch(b)
        if failover is not None:
            failover.probe(b)
            try:
                res, _deferred, misses, m = failover.run_gr(pstore, cache, plan, roots, b)
            except NodeFailure:
                # the detection gap: the dead owner is needed but not yet
                # marked down; this batch is the unavailability window
                avail["unavailable_batches"] += 1
                continue
            avail["deferred_rows"] += m["deferred_rows"]
            avail["degraded_batches"] += int(bool(failover.detector.down()))
        elif journal is not None:
            # pin the batch's read epoch: purge may not reclaim under it; the
            # scope releases on every exit path
            with journal.epochs.pin_scope():
                res, misses, m = rt.run_gr_tx_batch(pstore, cache, ttable, plan, roots)
        else:
            res, misses, m = rt.run_gr_tx_batch(pstore, cache, ttable, plan, roots)
        for k in total:
            total[k] += int(m.get(k, 0))
        telemetry.record_gr(rt.last_step_seconds, m, owner_stage=rt.last_owner_stage)
        # CP per owner: misses route to their owner's queue and drain there
        tcp = time.perf_counter()
        with telemetry.tracer.span("cp_drain"):
            drain.push(misses)
            cache = drain.drain(pstore, pstore, cache, ttable, CP_DRAIN_K)
        telemetry.record_cp_drain(time.perf_counter() - tcp)
        if (failover is not None and crash_shard in failover.detector.down()
                and b >= crash_batch + args.recover_after):
            pstore, cache, rinfo = failover.recover(pstore, cache, crash_shard)
            avail["queued_commits"] = rinfo["drained_commits"]
            avail["recovery_seconds"] = round(rinfo["recovery_seconds"], 3)
            log(f"batch {b}: recovered shard {crash_shard} — replayed "
                f"{rinfo['replayed_commits']} commits to seq {rinfo['replayed_to_seq']}, "
                f"drained {rinfo['drained_commits']} queued, "
                f"{rinfo['recovery_seconds'] * 1e3:.0f} ms")
        if engine is not None:
            # the batch boundary: observe the roots' heat, maybe run one
            # journal-first round, and install the spliced store with the
            # bumped table (the moved vertices' old cache homes swept)
            engine.observe(roots)
            pstore, cache, moves = engine.step(pstore, rt.last_owner_stage[:, FR], cache=cache)
            if moves:
                log(f"batch {b}: migrated {moves} (table epoch -> {engine.rhost.epoch})")
        wm = None
        if partitioned and args.write_every and (b + 1) % args.write_every == 0:
            mb = next_commit(b)
            gate = None
            if maintain:
                # purge only behind the liveness epoch and the checkpoint
                purge_ok = args.purge and journal is not None and (
                    journal.epochs.safe_to_purge(journal.epochs.current, journal))
                gate = gate_base._replace(purge=purge_ok)
                maint["purges"] += int(purge_ok)
            tw = time.perf_counter()
            if failover is not None:
                # degraded mode queues the commit durably instead of applying
                # it (commit ids are order-dependent; see distributed.failover)
                pstore, cache, wm = failover.run_grw(pstore, cache, mb, gate=gate)
            else:
                pstore, cache, wm = rt.run_grw_tx(pstore, cache, ttable, mb, gate=gate,
                                                  journal=journal)
            telemetry.record_grw(time.perf_counter() - tw)
            # under --no-maintenance an overflow is the degradation the flag
            # shows: reported, not raised
            maint["append_overflow"] += wm.get("store_append_overflow", 0)
            maint["device_compactions"] += wm.get("device_compactions", 0)
            maint["commits"] += 1
            if (journal is not None and not wm.get("queued", 0)
                    and maint["commits"] % args.checkpoint_every == 0):
                ckpt = journal.checkpoint if args.full_checkpoints else \
                    journal.checkpoint_incremental
                ckpt(pstore, e_blk_cap=rt.pspec.e_blk_cap,
                     recent_blk_cap=rt.pspec.recent_blk_cap, store_version=int(pstore.version))
        if (maintain and wm is not None and grow_to is None
                and wm.get("store_occupancy_max", 0) >= policy.grow_occupancy_frac):
            grow_to = int(math.ceil(rt.pspec.e_blk_cap * policy.growth_factor))
            log(f"batch {b}: occupancy {wm['store_occupancy_max']:.2f} crossed high-water — "
                f"growing to e_blk_cap={grow_to} at the next batch boundary")
        if args.snapshot_every and (b + 1) % args.snapshot_every == 0:
            telemetry.snapshot(b)
    dt = time.time() - t0
    if res is not None:
        assert len(res) == len(roots), res.shape
    log(f"{args.batches} batches x {args.batch} gR-Txs on {rt.n} shards [{rt.store_tier}]: "
        f"requests={total['requests']} hits={total['hits']} misses={total['misses']} "
        f"populated={drain.committed} route_overflow={total['route_overflow']} "
        f"({dt / max(args.batches, 1) * 1e3:.1f} ms/batch)")
    if partitioned:
        occ = rt.store_occupancy(pstore)
        log(f"maintenance: {maint['commits']} gRW commits, {maint['device_compactions']} "
            f"device compactions ({maint['purges']} purge-enabled), {maint['growths']} growths, "
            f"{maint['append_overflow']} appends dropped; occupancy max "
            f"{occ['max_occupancy']:.3f}, recent fill max "
            f"{occ['max_recent_fill']}/{occ['recent_blk_cap']}")
    if journal is not None:
        journal.stop(final_flush=True)
        jm = journal.metrics()
        total.update({k: jm[k] for k in ("journal_lag_batches", "flush_queue_depth",
                                         "pinned_epoch_min", "open_pins",
                                         "leaked_pin_releases")})
        total["swap_events"] = rt.swap_events
        log(f"durability: journal_lag_batches={jm['journal_lag_batches']} "
            f"flush_queue_depth={jm['flush_queue_depth']} flushes={jm['flushes']} "
            f"flushed_records={jm['flushed_records']} checkpoint_seq={jm['checkpoint_seq']} "
            f"pinned_epoch_min={jm['pinned_epoch_min']} open_pins={jm['open_pins']} "
            f"leaked_pin_releases={jm['leaked_pin_releases']} swap_events={rt.swap_events}")
    if failover is not None:
        fm = failover.metrics()
        total.update(avail)
        total.update({k: fm[k] for k in ("detections", "recoveries", "hedge_rate") if k in fm})
        log(f"failover: unavailable_batches={avail['unavailable_batches']} "
            f"degraded_batches={avail['degraded_batches']} deferred_rows={avail['deferred_rows']} "
            f"queued_commits_drained={avail['queued_commits']} "
            f"recovery_seconds={avail['recovery_seconds']} detections={fm['detections']} "
            f"recoveries={fm['recoveries']} hedge_rate={fm.get('hedge_rate', 0.0)}")
    if engine is not None:
        mm = engine.metrics()
        total.update({k: mm[k] for k in ("migration_rounds", "migrated_vertices",
                                         "migrated_rows", "migration_deferred_rounds",
                                         "table_epoch")})
        total["route_cap_retries"] = rt.route_cap_retries
        log(f"routing: migration_rounds={mm['migration_rounds']} "
            f"migrated_vertices={mm['migrated_vertices']} migrated_rows={mm['migrated_rows']} "
            f"deferred_rounds={mm['migration_deferred_rounds']} "
            f"table_epoch={mm['table_epoch']} storage_exceptions={mm['storage_exceptions']} "
            f"cache_exceptions={mm['cache_exceptions']} "
            f"locality_routed={total['locality_routed']} "
            f"locality_retry_rows={total['locality_retry_rows']} "
            f"route_cap_retries={rt.route_cap_retries}")
    # the end-of-run report, after journal.stop so the final flush is counted
    report = telemetry.report()

    def ms(v):
        return "n/a" if v is None else f"{v * 1e3:.2f}ms"

    for cls in LATENCY_CLASSES:
        p = report["latency"][cls]
        log(f"latency[{cls}]: p50={ms(p['p50'])} p95={ms(p['p95'])} p99={ms(p['p99'])} "
            f"p99.9={ms(p['p999'])} (n={p['count']})")
    log("hit_locality per shard: " + " ".join(f"{v:.2f}" for v in report["hit_locality"]))
    total["trace_events"] = (telemetry.writer.events_written
                             if telemetry.writer is not None else 0)
    if args.trace:
        log(f"trace: {args.trace} ({total['trace_events']} events)")
    telemetry.close()
    return ServeOutcome(total, pstore, cache, drain, report, res, jm, maint)


def reference_world(args, device):
    """The reference serve loop's deployment: its ``GraphServeConfig``, the
    served plan and template table, and a random graph matching the
    capacity profile, drawn from ``rng`` exactly as the reference draws it.
    Returns ``(espec, plan, ttable, store, rng)``."""
    from repro_torch.distributed.graph_serve import (
        GraphServeConfig, config_espec, config_plan_and_ttable,
    )
    from repro_torch.graphstore.store import ingest

    cfg = GraphServeConfig(v_total=args.vertices, e_per_vertex=4,
                           max_deg=16, max_leaves=16, cache_slots_total=4096, recent_cap=64)
    espec = config_espec(cfg)
    plan, ttable = config_plan_and_ttable(cfg)
    rng = np.random.default_rng(args.seed)
    V = cfg.v_total
    es, ed, ep = [], [], []
    for v in range(V):
        for _ in range(int(rng.integers(0, cfg.max_deg // 2))):
            es.append(v)
            ed.append(int(rng.integers(0, V)))
            ep.append([int(rng.integers(0, 2))])
    vlabels = np.zeros(V, np.int32)
    vprops = rng.integers(0, 2, (V, cfg.n_vprops)).astype(np.int64)
    store = ingest(espec.store, vlabels, vprops, es, ed, [0] * len(es), np.array(ep),
                   device=device)
    return espec, plan, ttable, store, rng


def reference_traffic(args, espec, plan, rng, device):
    """The reference serve loop's traffic, drawn from ``rng``: uniform roots
    (with ``--hot-frac``, that share drawn Zipf(1.2) from 16 hot vertices of
    owner 1) and eight random upserts a commit. Returns ``(next_batch,
    next_commit)`` for ``serve_loop``."""
    from repro_torch.graphstore import make_mutation_batch

    V = args.vertices
    # hot roots all land on one owner under the modulo layout
    hot = (np.array([v for v in range(V) if v % args.shards == 1][:16], np.int64)
           if args.hot_frac > 0 else None)

    def next_batch(b):
        roots = rng.integers(0, V, args.batch).astype(np.int32)
        if hot is not None:
            pick = rng.random(args.batch) < args.hot_frac
            zipf = np.minimum(rng.zipf(1.2, args.batch) - 1, len(hot) - 1)
            roots = np.where(pick, hot[zipf], roots).astype(np.int32)
        return plan, roots

    def next_commit(b):
        # a small upsert burst that lands in the blocks' recent regions
        ne = [(int(rng.integers(0, V)), int(rng.integers(0, V)), 0, [int(rng.integers(0, 2))])
              for _ in range(8)]
        return make_mutation_batch(espec.store, new_edges=ne, device=device)

    return next_batch, next_commit


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.utils import resolve_device

    dev = resolve_device(args.device)
    from repro_torch.distributed import flat_mesh
    from repro_torch.distributed.graph_serve import ShardedTxnRuntime
    from repro_torch.obs.telemetry import ServeTelemetry

    espec, plan, ttable, store, rng = reference_world(args, dev)
    # the owner-stage block rides the runtime's one metrics all-reduce; the
    # tracer times the host phases; JSONL only under --trace
    telemetry = ServeTelemetry(args.shards, trace_path=args.trace)
    rt = ShardedTxnRuntime(espec, flat_mesh(args.shards), store_tier=args.store_tier, device=dev,
                           tracer=telemetry.tracer)
    partitioned = rt.pspec is not None
    pstore = store
    if partitioned:
        pstore = rt.partition_store(store, elastic=True)
        rep = rt.store_bytes(pstore)
        print(f"store tier: {rep['per_shard_bytes'] / 2**20:.2f} MiB/shard partitioned vs "
              f"{rep['replicated_per_shard_bytes'] / 2**20:.2f} MiB/shard replicated "
              f"(ratio {rep['ratio']:.3f}, ideal 1/n = {rep['ideal_ratio']:.3f})")
    tpl_meta = {0: (plan.hops[0].direction, plan.hops[0].edge_label)}
    next_batch, next_commit = reference_traffic(args, espec, plan, rng, dev)
    tmp = None
    if partitioned and not args.no_journal and args.journal_dir is None:
        tmp = tempfile.mkdtemp(prefix="serve-journal-")
        args.journal_dir = os.path.join(tmp, "journal")
    try:
        out = serve_loop(args, rt, pstore, ttable, tpl_meta, next_batch, next_commit, telemetry)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if out.result is not None:
        assert out.result.shape == (args.batch, espec.result_width), out.result.shape
    return out.total


if __name__ == "__main__":
    main()
