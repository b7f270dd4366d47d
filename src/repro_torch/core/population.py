"""Asynchronous, transactional cache population (§4's CP threads).

PyTorch twin of ``repro.core.population``. A cache miss enqueues
``(template, root, params, read_version)``. A drain step re-executes the
one-hop sub-query at the current committed version, then commits the insert
with an optimistic conflict check: if any vertex the result depends on was
written after the CP read version, the insert aborts, as FDB's OCC keeps a
CP transaction from installing a stale entry over a concurrent gRW-Tx.
Aborted entries are retried a bounded number of times, then discarded.
Population never runs on the gR-Tx path.
"""

from __future__ import annotations

import functools
from collections import deque

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core.cache import CacheState, cache_insert
from repro_torch.core.engine import EngineSpec
from repro_torch.core.keys import PARAM_LEN
from repro_torch.core.runtime import onehop_exec_view
from repro_torch.core.templates import TemplateTable, pred_row
from repro_torch.distributed.sharding import ALL_REDUCE_SUM
from repro_torch.graphstore.store import GlobalStoreView, GraphStore
from repro_torch.graphstore.txn import conflicts
from repro_torch.utils import SyncCount, resolve_device


class MissQueue:
    """Host-side FIFO of cache misses with retry accounting."""

    def __init__(self, max_retries: int = 3, maxlen: int = 100_000):
        self.q: deque = deque(maxlen=maxlen)
        self.max_retries = max_retries
        self.discarded = 0
        self.retried = 0
        self._seen_inflight: set = set()

    @staticmethod
    def _key(r):
        return (r.tpl_idx, r.root, tuple(np.asarray(r.params).tolist()))

    def push(self, records):
        for r in records:
            key = self._key(r)
            if key in self._seen_inflight:
                continue  # dedupe identical in-flight misses
            self._seen_inflight.add(key)
            self.q.append((r, 0))

    def drain(self, k: int):
        out = []
        while self.q and len(out) < k:
            out.append(self.q.popleft())
        return out

    def requeue(self, rec, attempts):
        if attempts + 1 >= self.max_retries:
            self.discarded += 1
            self.done(rec)
        else:
            self.retried += 1
            self.q.append((rec, attempts + 1))

    def done(self, rec):
        self._seen_inflight.discard(self._key(rec))

    def __len__(self):
        return len(self.q)


def populate_step(espec: EngineSpec, store_exec: GraphStore, store_commit: GraphStore,
                  cache: CacheState, ttable: TemplateTable, tpl_idx: int,
                  direction: int, edge_label: int, roots, params, mask,
                  read_versions, syncs: SyncCount | None = None, exec_view=None):
    """One CP transaction batch for one template.

    Executes against ``store_exec`` (the CP read snapshot) and commits
    against ``store_commit`` (current state at commit time): entries whose
    read set was written in between abort. Returns (cache', committed[B],
    aborted[B]).

    ``exec_view`` overrides the miss-execution storage view (the
    partitioned tier passes a ``BlockStoreView`` over one owner's blocks);
    ``store_exec`` / ``store_commit`` then supply only ``.version`` /
    ``.vversion``, which a ``PartitionedGraphStore`` has.
    """
    program = populate_program(espec, store_exec, store_commit, cache, ttable, tpl_idx,
                               direction, edge_label, roots, params, mask, read_versions,
                               syncs=syncs, exec_view=exec_view)
    try:
        next(program)
    except StopIteration as stop:
        return stop.value
    raise AssertionError("the fused CP step asks for no all-reduce")


def populate_program(espec: EngineSpec, store_exec, store_commit, cache: CacheState,
                     ttable: TemplateTable, tpl_idx: int, direction: int, edge_label: int,
                     roots, params, mask, read_versions, syncs: SyncCount | None = None,
                     exec_view=None, commit_mask=None):
    """``populate_step`` as a per-rank program (a generator; see
    ``distributed.sharding``). Returns (cache', committed[B], aborted[B]).

    ``commit_mask`` splits the transaction across shards (the CP split of
    the routing-table tier): ``mask`` then selects the rows this shard
    *executes* (its storage holds them) and ``commit_mask`` those whose
    entry it *inserts* (its cache block holds them). The executed bundle
    (leaves, counts, the commit verdict) crosses shards in three
    all-reduce sums: one shard executes each row and every other adds
    zeros. Without it the program asks for nothing and is the fused
    transaction."""
    pr, pe, pl = (pred_row(getattr(ttable, f), tpl_idx) for f in ("pr", "pe", "pl"))
    view = exec_view if exec_view is not None else GlobalStoreView(espec.store, store_exec)
    leaves, _lmask, n_true, trunc, stats = onehop_exec_view(
        espec, view, direction, edge_label, pr, pe, pl, roots, params, mask
    )
    cacheable = mask & ~trunc & (n_true <= espec.result_width)
    cp_read_version = store_exec.version

    # OCC conflict check per entry: the root plus every vertex the execution
    # observed (a write to a filtered-out neighbour can change the result)
    read_set = torch.cat([roots[:, None], stats["scanned"]], dim=1)
    read_mask = torch.cat([mask[:, None], stats["scanned_mask"]], dim=1)
    conflict = conflicts(espec.store, store_commit, cp_read_version, read_set,
                         read_mask, axis=1)
    # populating is allowed only for read-enabled templates (§4.1 Phase 2)
    ok = cacheable & ~conflict & bool(ttable.read_enabled[tpl_idx])
    insert_ok = ok
    if commit_mask is not None:
        # ship the executed bundle to the inserting shard
        leaves = yield (ALL_REDUCE_SUM, torch.where(ok[:, None], leaves, 0))
        n_true = yield (ALL_REDUCE_SUM, torch.where(ok, n_true, 0))
        insert_ok = ((yield (ALL_REDUCE_SUM, ok.to(torch.int32))) > 0) & commit_mask
    cache = cache_insert(
        espec.cache, cache, tpl_idx, roots, params, leaves, n_true,
        cp_read_version, insert_ok, syncs=syncs,
    )
    return cache, ok, cacheable & conflict


class CachePopulator:
    """Host orchestrator: drains a MissQueue and runs CP transactions.

    ``templates_meta[t] = (direction, edge_label)``, static per template.
    ``step_builder(tpl_idx, bucket)`` optionally supplies the CP step (the
    signature of ``populate_step`` without its static arguments); the
    sharded runtime uses it to run population at the owner shards while
    reusing this orchestrator unchanged.
    """

    _BUCKETS = runtime.BUCKETS[:4]

    def __init__(self, espec: EngineSpec, templates_meta, max_retries: int = 3,
                 device=None, step_builder=None):
        self.device = resolve_device(device)
        self.espec = espec
        self.meta = templates_meta
        self.queue = MissQueue(max_retries=max_retries)
        self._steps: dict = {}
        self._step_builder = step_builder
        self.committed = 0
        self.aborted = 0

    def _fn(self, tpl_idx: int, bucket: int):
        key = (tpl_idx, bucket)
        if key not in self._steps:
            if self._step_builder is not None:
                self._steps[key] = self._step_builder(tpl_idx, bucket)
            else:
                direction, edge_label = self.meta[tpl_idx]
                self._steps[key] = functools.partial(
                    populate_step, self.espec, tpl_idx=tpl_idx, direction=direction,
                    edge_label=edge_label,
                )
        return self._steps[key]

    def drain(self, store_exec, store_commit, cache, ttable, k: int = 128):
        """Process up to k queued misses. Returns the new cache.

        Batches need no dedup pass: ``MissQueue.push`` holds each in-flight
        key once, and duplicate keys within one insert resolve
        last-writer-wins in ``cache_insert``.
        """
        batch = self.queue.drain(k)
        if not batch:
            return cache
        dev = self.device
        by_tpl: dict = {}
        for rec, attempts in batch:
            by_tpl.setdefault(rec.tpl_idx, []).append((rec, attempts))
        for t, items in by_tpl.items():
            n = len(items)
            roots_all = np.fromiter((rec.root for rec, _ in items), np.int32, n)
            params_all = np.stack(
                [np.asarray(rec.params, np.int32) for rec, _ in items]
            ).reshape(n, PARAM_LEN)
            vers_all = np.fromiter((rec.read_version for rec, _ in items), np.int32, n)
            bucket = runtime.bucket_for(n, self._BUCKETS, clamp=True)
            for lo in range(0, n, bucket):
                chunk = items[lo: lo + bucket]
                nb = len(chunk)
                roots = np.zeros(bucket, np.int32)
                params = np.zeros((bucket, PARAM_LEN), np.int32)
                vers = np.zeros(bucket, np.int32)
                m = np.zeros(bucket, bool)
                roots[:nb] = roots_all[lo: lo + nb]
                params[:nb] = params_all[lo: lo + nb]
                vers[:nb] = vers_all[lo: lo + nb]
                m[:nb] = True
                cache, ok, conflicted = self._fn(t, bucket)(
                    store_exec=store_exec, store_commit=store_commit, cache=cache,
                    ttable=ttable, roots=torch.as_tensor(roots, device=dev),
                    params=torch.as_tensor(params, device=dev),
                    mask=torch.as_tensor(m, device=dev),
                    read_versions=torch.as_tensor(vers, device=dev),
                )
                ok = ok.cpu().numpy()
                conflicted = conflicted.cpu().numpy()
                for j, (rec, attempts) in enumerate(chunk):
                    if conflicted[j]:
                        self.aborted += 1
                        self.queue.requeue(rec, attempts)
                    else:
                        self.committed += int(ok[j])
                        self.queue.done(rec)
        return cache
