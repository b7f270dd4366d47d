"""gR-Tx processing with the one-hop sub-query result cache (§3.1).

PyTorch twin of ``repro.core.engine``. A ``QueryPlan`` is a chain of one-hop
hops (Definition 2.1) plus a final clause. Per hop the engine builds the
cache keys of the frontier, probes the cache (through the ``cache_probe``
kernel), executes only the misses against storage, records the misses for
asynchronous population, and feeds the union of leaf sets to the next hop.

``fused=True`` (default) runs the whole plan with the frontier on the
device (``make_fused_plan_fn``) and copies results, miss arrays and metrics
to the host once per batch; ``fused=False`` is the host-orchestrated
reference path (probe / exec / final steps glued by host-side routing and a
numpy frontier merge). Both give identical results, miss records and
metrics except ``host_syncs``, which counts the blocking device->host reads
each path paid (see ``repro_torch.core.runtime`` for the fused path's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.cache import CacheSpec, CacheState, cache_lookup
from repro_torch.core.runtime import (
    BUCKETS,
    FINAL_COUNT,
    FINAL_IDS,
    FINAL_VALUES,
    MissRecord,
    _hop_params,
    bucket_for,
    decode_miss_records,
    finalize_frontier,
    get_grw_step,
    host_compact_dedup,
    make_fused_plan_fn,
    onehop_exec,
    pad_roots,
)
from repro_torch.core.templates import PredSpec, TemplateTable
from repro_torch.graphstore.mutations import MutationBatch
from repro_torch.graphstore.store import GraphStore, StoreSpec
from repro_torch.utils import NULL_ID, SyncCount, resolve_device

__all__ = [
    "FINAL_IDS", "FINAL_COUNT", "FINAL_VALUES", "EngineSpec", "Hop",
    "QueryPlan", "MissRecord", "GraphEngine", "onehop_exec",
    "run_gr_tx_batch", "build_grw_step", "run_grw_tx",
]


class EngineSpec(NamedTuple):
    store: StoreSpec
    cache: CacheSpec
    max_deg: int = 64  # padded adjacency width per hop
    frontier: int = 64  # per-query frontier width between hops

    @property
    def result_width(self) -> int:
        # equals the cache's value capacity, so any result the engine can
        # produce is either fully cacheable or flagged oversize
        return self.cache.max_leaves * self.cache.max_chunks


class Hop(NamedTuple):
    """One one-hop sub-query instance in a plan (template + bound params)."""

    direction: int  # DIR_OUT / DIR_IN / DIR_BOTH
    edge_label: int  # ANY_LABEL = -1
    pr: PredSpec
    pe: PredSpec
    pl: PredSpec
    tpl_idx: int  # index into the TemplateTable; -1 = not cacheable
    params: np.ndarray  # int32 [PARAM_LEN] concrete wildcard values


class QueryPlan(NamedTuple):
    hops: tuple
    final: int = FINAL_IDS
    final_prop: int = -1  # for FINAL_VALUES
    # post filter over the final frontier: ("prop_neq_root", pid) costs one
    # extra storage phase; ("id_neq",) is free (§4.2 rewrite)
    post_filter: Optional[tuple] = None
    # extra non-one-hop storage phases this query performs regardless
    extra_phases: int = 0


def _to_host(m: dict, arrays: list):
    """Metric values (host ints or device scalars) as ints, and device
    integer ``arrays`` as numpy of their own dtype, in one device->host copy:
    the scalars and the flattened arrays travel packed as int64."""
    keys = [k for k, v in m.items() if isinstance(v, torch.Tensor)]
    parts = [torch.stack([m[k].to(torch.int64) for k in keys])] if keys else []
    parts += [a.reshape(-1).to(torch.int64) for a in arrays]
    flat = torch.cat(parts).cpu().numpy()
    out = {k: int(v) for k, v in m.items() if not isinstance(v, torch.Tensor)}
    out.update(zip(keys, flat[: len(keys)].tolist()))
    host, off = [], len(keys)
    for a in arrays:
        dtype = torch.empty(0, dtype=a.dtype).numpy().dtype
        host.append(flat[off: off + a.numel()].reshape(tuple(a.shape)).astype(dtype))
        off += a.numel()
    return {k: out[k] for k in m}, host


class GraphEngine:
    """One Graph-QP: the device programs for one plan.

    ``device=None`` means CUDA; the engine raises if that is absent. Inputs
    (store, cache) must live on the engine's device.
    """

    _BUCKETS = BUCKETS

    def __init__(self, espec: EngineSpec, plan: QueryPlan, use_cache: bool = True,
                 fused: bool = True, device=None):
        assert espec.result_width >= 1
        self.device = resolve_device(device)
        self.espec = espec
        self.plan = plan
        self.use_cache = use_cache
        self.fused = fused
        self._fused_fn = make_fused_plan_fn(espec, plan, use_cache)

    def _bucket_for(self, k: int) -> int:
        return bucket_for(k, self._BUCKETS)

    def run(self, store: GraphStore, cache: CacheState, ttable: TemplateTable,
            roots: np.ndarray):
        """Process a batch of gR-Txs sharing this plan.

        Returns (result, misses: list[MissRecord], metrics: dict).
        ``metrics["phases"]`` is the number of sequential storage round-trips
        (the paper's n+2 -> 2 effect); ``metrics["requests"]`` the storage
        requests issued; ``metrics["host_syncs"]`` the blocking device->host
        reads the batch paid.
        """
        if self.fused:
            return self._run_fused(store, cache, ttable, roots)
        return self._run_host(store, cache, ttable, roots)

    def _run_fused(self, store, cache, ttable, roots):
        B = len(roots)
        bucket = self._bucket_for(B)
        proots, bvalid = pad_roots(roots, bucket)
        syncs = SyncCount()
        result, _, miss_roots, miss_counts, m, version = self._fused_fn(
            store, cache, ttable,
            torch.as_tensor(proots, device=self.device),
            torch.as_tensor(bvalid, device=self.device), syncs,
        )
        # the batch's result transfer: result, miss roots, metrics, counts
        # and version in one copy, the one read host_syncs adds to syncs.n
        metrics, (result, *mroots) = _to_host(
            dict(m, _version=version, **{f"_mc{i}": c for i, c in enumerate(miss_counts)}),
            [result, *miss_roots],
        )
        version = metrics.pop("_version")
        counts = [metrics.pop(f"_mc{i}") for i in range(len(miss_counts))]
        metrics["host_syncs"] = syncs.n + 1
        misses = decode_miss_records(self.plan, self.use_cache, mroots, counts, version)
        return result[:B], misses, metrics

    def _run_host(self, store, cache, ttable, roots):
        """Host-orchestrated reference path (``fused=False``)."""
        espec = self.espec
        dev = self.device
        B = len(roots)
        F = espec.frontier
        RW = espec.result_width
        read_version = int(store.version)

        frontier = np.full((B, F), NULL_ID, np.int32)
        frontier[:, 0] = roots
        fmask = np.zeros((B, F), bool)
        fmask[:, 0] = True

        misses: list[MissRecord] = []
        metrics = {
            "phases": 1,  # index lookup of the root vertex (paper's request 1)
            "requests": B,
            "hits": 0,
            "misses": 0,
            "truncated": 0,
            "leaf_fetches": 0,
            "edges_scanned": 0,
            "cache_reads": 0,
            "deferred": 0,  # degraded-mode rows: sharded-tier-only
            "host_syncs": 1,  # the read of store.version
        }

        for hop in self.plan.hops:
            roots_flat = frontier.reshape(-1)
            rmask_flat = fmask.reshape(-1)
            BF = roots_flat.shape[0]
            leaves_all = np.full((BF, RW), NULL_ID, np.int32)
            lmask_all = np.zeros((BF, RW), bool)

            cacheable = hop.tpl_idx >= 0 and self.use_cache
            if cacheable:
                r = torch.as_tensor(roots_flat, device=dev)
                hit, leaves_c, lmask_c, _ = cache_lookup(
                    espec.cache, cache, hop.tpl_idx, r, _hop_params(hop, BF, dev)
                )
                hit = hit & torch.as_tensor(rmask_flat, device=dev)
                hit = hit & bool(ttable.read_enabled[hop.tpl_idx])
                hit = hit.cpu().numpy()
                leaves_all[hit] = leaves_c.cpu().numpy()[hit]
                lmask_all[hit] = lmask_c.cpu().numpy()[hit]
                metrics["host_syncs"] += 1  # probe results block for routing
                metrics["phases"] += 1  # one cache get round-trip
                metrics["requests"] += int(rmask_flat.sum())
                metrics["cache_reads"] += int(rmask_flat.sum())
                metrics["hits"] += int(hit.sum())
            else:
                hit = np.zeros(BF, bool)

            miss_idx = np.nonzero(rmask_flat & ~hit)[0]
            k = len(miss_idx)
            if k > 0:
                bucket = self._bucket_for(k)
                mroots = np.zeros(bucket, np.int32)
                mroots[:k] = roots_flat[miss_idx]
                mvalid = np.zeros(bucket, bool)
                mvalid[:k] = True
                leaves_e, lmask_e, n_true, trunc, stats = onehop_exec(
                    espec, store, hop.direction, hop.edge_label, hop.pr, hop.pe,
                    hop.pl, torch.as_tensor(mroots, device=dev),
                    _hop_params(hop, bucket, dev), torch.as_tensor(mvalid, device=dev),
                )
                metrics["host_syncs"] += 1  # exec results block for the merge
                leaves_all[miss_idx] = leaves_e.cpu().numpy()[:k]
                lmask_all[miss_idx] = lmask_e.cpu().numpy()[:k]
                n_true = n_true.cpu().numpy()[:k]
                trunc = trunc.cpu().numpy()[:k]
                metrics["phases"] += 2  # edge range read + n leaf fetches
                metrics["requests"] += k + int(stats["leaf_fetches"])
                metrics["leaf_fetches"] += int(stats["leaf_fetches"])
                metrics["edges_scanned"] += int(stats["edges_scanned"])
                metrics["misses"] += k
                metrics["truncated"] += int(trunc.sum())
                if cacheable:
                    params = np.asarray(hop.params, np.int32)
                    for j, row in enumerate(miss_idx):
                        if not trunc[j] and n_true[j] <= RW:
                            misses.append(
                                MissRecord(hop.tpl_idx, int(roots_flat[row]), params, read_version)
                            )

            # next frontier: union of leaf sets per original query
            frontier, fmask = host_compact_dedup(
                leaves_all.reshape(B, F * RW), lmask_all.reshape(B, F * RW), F
            )

        result = finalize_frontier(
            self.plan, store, torch.as_tensor(np.array(roots, np.int32), device=dev),
            torch.as_tensor(frontier, device=dev), torch.as_tensor(fmask, device=dev),
        )
        metrics["host_syncs"] += 1  # final result materialization
        if self.plan.post_filter is not None and self.plan.post_filter[0] != "id_neq":
            metrics["phases"] += 1  # property fetch for the un-rewritten filter
            metrics["requests"] += int(fmask.sum())
        if self.plan.final == FINAL_VALUES:
            metrics["phases"] += 1  # valueMap fetch
            metrics["requests"] += int(fmask.sum())
        metrics["phases"] += self.plan.extra_phases
        return result.cpu().numpy(), misses, metrics


def run_gr_tx_batch(espec: EngineSpec, store: GraphStore, cache: CacheState,
                    ttable: TemplateTable, plan: QueryPlan, roots: np.ndarray,
                    use_cache: bool = True, fused: bool = True, device=None):
    """One-shot convenience wrapper (tests / examples)."""
    return GraphEngine(espec, plan, use_cache, fused=fused, device=device).run(
        store, cache, ttable, roots
    )


def build_grw_step(espec: EngineSpec, policy: str = "write-around", *,
                   device=None, **caps):
    """The gRW-Tx commit: apply mutations + maintain the cache under
    ``policy`` (write-around or write-through). ``step(store, cache,
    ttable, batch, syncs=None) -> (store', cache', impacted, op_overflow)``.
    See ``repro_torch.core.runtime.get_grw_step``."""
    resolve_device(device)
    return get_grw_step(espec, policy, **caps)


def run_grw_tx(espec: EngineSpec, store: GraphStore, cache: CacheState,
               ttable: TemplateTable, batch: MutationBatch,
               policy: str = "write-around", device=None):
    """One-shot gRW-Tx (tests / examples). Returns (store', cache', metrics);
    ``metrics["host_syncs"]`` counts the write-through round read and the
    one copy of the other metrics."""
    step = build_grw_step(espec, policy, device=device)
    syncs = SyncCount()
    store2, cache2, impacted, overflow = step(store, cache, ttable, batch, syncs)
    impacted, overflow = torch.stack([impacted, overflow]).tolist()
    return store2, cache2, {"impacted_keys": impacted, "op_overflow": overflow,
                            "host_syncs": syncs.n + 1}
