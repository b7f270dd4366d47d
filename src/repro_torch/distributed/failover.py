"""Live shard failover for the partitioned serve loop: per-batch failure
detection, degraded-mode serving, and recovery as migration.

PyTorch package twin of ``repro.distributed.failover``.
``FailoverController`` is the thin state machine between the serve loop and
the runtime. A healthy batch costs it one branch; under an injected (or
real) owner loss it degrades instead of failing:

- **detect**: each batch probes every owner (``ShardFaultPlan`` scripts the
  outcomes in chaos runs) and ``FailureDetector`` turns consecutive
  failures into a ``down`` set. Until detection trips, a gR batch that
  needs the dead owner raises ``NodeFailure``: those batches are the
  unavailability window, bounded by ``fail_threshold`` probes.
- **degrade (reads)**: with the owner marked down, gR runs with its miss
  segments masked (``run_gr_tx_batch(down=...)``). Cache hits, the dead
  owner's cached entries among them, and the surviving owners' misses
  serve; the masked rows come back flagged ``deferred`` and emit no miss
  record, so CP cannot build entries from lost blocks.
- **degrade (writes)**: every gRW commit is journaled unapplied
  (``applied=False``), not only those naming the dead owner: commit ids
  (``e_len + i``) make commits order-dependent, so applying one out of turn
  would diverge from the journal's replay order. A degraded read is
  therefore at most ``queued_commits`` commits stale, which each batch
  reports.
- **recover**: ``replay_to_owner`` rebuilds the dead owner's blocks from
  the checkpoint chain and the journal up to the applied watermark and
  splices them into the live store; ``drain_queued`` applies the outage's
  commits in journal order against the live cache; ``mark_recovered`` and
  ``revive`` close the loop.

A straggler (alive but slow) never enters degraded mode: the detector marks
it ``straggling`` and the read races the full batch against a call with the
straggler's segment masked (``HedgedCalls``). Each racer runs on a copy of
the runtime (``ShardedTxnRuntime.racer``) and the winner's observations are
adopted. When a ``ShardFaultPlan`` scripts the straggler's delay, a primary
that loses the race during its delay returns without launching anything, so
the loser changes nothing the next batch or the detector reads. Without a
plan the primary starts at once and runs on to its end after a hedge wins:
its kernels share the CUDA stream and the kernels' launch counts, and they
delay the next batch, whose step time is the detector's heartbeat.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.distributed.fault import FailureDetector, HedgedCalls, NodeFailure, ShardFaultPlan
from repro_torch.graphstore.journal import WriteBehindJournal, drain_queued, replay_to_owner


class FailoverController:
    """The per-batch failover state machine over a ``ShardedTxnRuntime``.

    ``plan`` scripts faults for chaos runs (None: probes heartbeat from the
    runtime's measured step time); ``hedge_after`` is the straggler hedge's
    deadline in seconds. The runtime's attached ``RoutingTableHost``, read
    at each call, routes every read, write and recovery, so failover
    composes with migrated placements and with a table attached after the
    controller is built. It needs the partitioned store tier (a replicated
    runtime raises ``ValueError``)."""

    def __init__(self, rt, journal: Optional[WriteBehindJournal], ttable, *,
                 plan: Optional[ShardFaultPlan] = None,
                 detector: Optional[FailureDetector] = None,
                 hedge: Optional[HedgedCalls] = None, hedge_after: float = 0.05):
        if rt.pspec is None:
            # recovery replays and splices an owner's blocks
            raise ValueError("failover needs the partitioned store tier; this runtime serves "
                             "the replicated one")
        self.rt = rt
        self.journal = journal
        self.ttable = ttable
        self.plan = plan
        self.detector = detector if detector is not None else FailureDetector(n=rt.n)
        self.hedge = hedge
        self.hedge_after = hedge_after
        self.failed_batches = 0  # raised NodeFailure before detection
        self.degraded_batches = 0
        self.deferred_rows = 0

    # ---------------------------------------------------------------- probe
    def probe(self, batch_idx: int) -> frozenset:
        """One heartbeat round: every owner's scripted (or measured) probe
        outcome goes to the detector; returns the down set after it.

        With a ``ShardFaultPlan`` the outcomes are scripted. Without one the
        heartbeat is the runtime's measured latest step: per owner
        (``rt.last_step_owner_seconds``) when the telemetry ran, so one
        straggling owner trips ``straggle_after`` alone, else the whole
        step's wall clock (``rt.last_step_seconds``) for every owner."""
        if self.plan is None:
            self.detector.observe_step(float(getattr(self.rt, "last_step_seconds", 0.0)),
                                       per_owner=getattr(self.rt, "last_step_owner_seconds",
                                                         None))
            return self.detector.down()
        crashed = self.plan.crashed_at(batch_idx)
        for s in range(self.rt.n):
            if s in crashed:
                self.detector.observe_failure(s)
            else:
                self.detector.observe_ok(s, latency_s=self.plan.hang_delay(s, batch_idx))
        return self.detector.down()

    # ----------------------------------------------------------------- read
    def run_gr(self, pstore, cache, qplan, roots, batch_idx: int):
        """Serve one gR batch under the current failure state. Returns
        ``(results, deferred, misses, metrics)``; the metrics add
        ``deferred_rows``, ``hedged`` and ``staleness_bound_commits``.
        Raises ``NodeFailure`` when a crashed owner is needed but not yet
        marked down (the detection gap: callers count it unavailable)."""
        crashed = self.plan.crashed_at(batch_idx) if self.plan is not None else frozenset()
        down = self.detector.down()
        unmasked = crashed - down
        if unmasked:
            self.failed_batches += 1
            raise NodeFailure(f"owners {sorted(unmasked)} lost storage and are not yet marked "
                              f"down (batch {batch_idx})")
        mask = self.detector.down_mask()
        straggling = self.detector.straggling() - down

        def call(rt, m):
            # each call pins its read epoch until its result is in hand
            with (self.journal.epochs.pin_scope() if self.journal is not None
                  else contextlib.nullcontext()):
                return rt.run_gr_tx_batch(pstore, cache, self.ttable, qplan, roots,
                                          down=m if m.any() else None,
                                          return_deferred=True)

        from_hedge = False
        if straggling and self.hedge is not None:
            out, from_hedge = self._hedged(call, mask, straggling, batch_idx)
        else:
            out = call(self.rt, mask)
        result, misses, metrics, deferred = out
        ndef = int(np.asarray(deferred).sum())
        self.deferred_rows += ndef
        if mask.any():
            self.degraded_batches += 1
        metrics = dict(metrics, deferred_rows=ndef, hedged=int(from_hedge),
                       staleness_bound_commits=(self.journal.metrics()["queued_commits"]
                                                if self.journal is not None else 0))
        return result, np.asarray(deferred), misses, metrics

    def _hedged(self, call, mask, straggling, batch_idx: int):
        """The primary (the full batch, after the straggler's scripted delay)
        against the hedge (the straggler's segment masked too), each on a
        racer copy of the runtime; the winner's observations are adopted.
        Only a scripted delay lets a losing primary launch nothing (the
        module docstring says what an unscripted loser does)."""
        delay = (max(self.plan.hang_delay(s, batch_idx) for s in straggling)
                 if self.plan is not None else 0.0)
        hmask = mask.copy()
        hmask[sorted(straggling)] = True
        racers = {"primary": self.rt.racer(), "hedge": self.rt.racer()}
        decided = threading.Event()

        def primary():
            if delay and decided.wait(delay):
                return None  # the hedge won during the delay: launch nothing
            return racers["primary"], call(racers["primary"], mask)

        def hedge():
            return racers["hedge"], call(racers["hedge"], hmask)

        try:
            (winner, out), from_hedge = self.hedge.call(primary, hedge, self.hedge_after)
        finally:
            decided.set()
        self.rt.adopt(winner)
        return out, from_hedge

    # ---------------------------------------------------------------- write
    def run_grw(self, pstore, cache, batch, *, policy: str = "write-around", gate=None,
                occupancy_metrics: bool = True):
        """Commit one gRW batch, or queue it durably while any owner is
        down: the journal takes it with ``applied=False`` and the store does
        not move (the module docstring says why every commit queues).
        Returns ``(pstore, cache, metrics)`` either way."""
        if self.detector.down():
            rhost = self.rt.rhost
            self.journal.append_commit(
                batch, policy=policy, gate=gate, applied=False,
                route=rhost.storage_owner if rhost is not None else None)
            return pstore, cache, {"queued": 1, **self.journal.metrics()}
        pstore, cache, metrics = self.rt.run_grw_tx(
            pstore, cache, self.ttable, batch, policy=policy, gate=gate,
            occupancy_metrics=occupancy_metrics, journal=self.journal)
        metrics["queued"] = 0
        return pstore, cache, metrics

    # -------------------------------------------------------------- recover
    def recover(self, pstore, cache, owner: int):
        """Recovery as migration for one down owner: replay and splice its
        blocks into the live store, drain the outage's queued commits, mark
        it healthy. Returns ``(pstore, cache, info)``; ``info`` carries
        ``recovery_seconds`` and its ``replay_seconds``, ``splice_seconds``
        and ``drain_seconds``."""
        t0 = time.perf_counter()
        pstore, info = replay_to_owner(self.journal, self.rt, self.ttable, live_pstore=pstore,
                                       owner=owner)
        pstore, cache, dinfo = drain_queued(self.journal, self.rt, self.ttable, pstore, cache)
        self.detector.mark_recovered(owner)
        if self.plan is not None:
            self.plan.revive(owner)
        info.update(dinfo)
        info["recovery_seconds"] = time.perf_counter() - t0
        return pstore, cache, info

    # -------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        m = {
            "failed_batches": self.failed_batches,
            "degraded_batches": self.degraded_batches,
            "deferred_rows_total": self.deferred_rows,
            "detections": self.detector.detections,
            "recoveries": self.detector.recoveries,
            "down_shards": len(self.detector.down()),
        }
        if self.hedge is not None:
            m.update(hedge_issued=self.hedge.issued, hedged_calls=self.hedge.hedged,
                     hedge_wins=self.hedge.hedge_wins,
                     hedge_rate=round(self.hedge.hedge_rate, 4))
        return m
