"""The paper's contribution: a one-hop sub-query result cache (PyTorch).

Modules map 1:1 onto the paper and onto ``repro.core``:

- ``templates``   — Definitions 2.1/2.2: one-hop sub-query templates.
- ``keys``        — §3: cache-key construction.
- ``cache``       — §4: the cache (open-addressing tensor hash table,
                    chunked values, sweep-deletes standing in for clearRange).
- ``runtime`` / ``engine`` — §3.1: gR-Tx processing — per-hop cache probe,
                    miss execution, miss enqueue, final clause.
- ``invalidation``— §3.2 + Appendix A: write-around and write-through
                    maintenance.
- ``population``  — §4: asynchronous transactional cache population.
- ``lifecycle``   — §4.1: the Service Coordinator's two-phase workflow.
- ``rewrite``     — §4.2: query re-writing rules (Q+).
"""

from repro_torch.core.templates import (
    ANY_LABEL,
    DIR_BOTH,
    DIR_IN,
    DIR_OUT,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_LT,
    OP_NEQ,
    WILDCARD,
    PredSpec,
    Template,
    TemplateTable,
    evaluate_pred,
    extract_wildcards,
    make_pred,
    make_template_table,
)
from repro_torch.core.keys import key_fingerprint, key_slot_hash, make_param_vec
from repro_torch.core.cache import (
    CacheSpec,
    CacheState,
    cache_delete,
    cache_entries,
    cache_insert,
    cache_insert_sequential,
    cache_lookup,
    cache_lookup_lean,
    cache_shard,
    cache_stats,
    empty_cache,
    sweep_root,
    sweep_template,
)
from repro_torch.core.runtime import (
    BUCKETS,
    LocalPlanTier,
    bucket_for,
    bucketize,
    decode_miss_records,
    get_grw_step,
    make_fused_plan_fn,
    make_hop_kernel,
    make_plan_fn,
    onehop_exec_view,
    pad_roots,
)
from repro_torch.core.engine import (
    FINAL_COUNT,
    FINAL_IDS,
    FINAL_VALUES,
    EngineSpec,
    GraphEngine,
    Hop,
    MissRecord,
    QueryPlan,
    build_grw_step,
    onehop_exec,
    run_gr_tx_batch,
    run_grw_tx,
)
from repro_torch.core.invalidation import invalidate_write_around, write_through_update
from repro_torch.core.population import CachePopulator, MissQueue, populate_step
from repro_torch.core.lifecycle import ServiceCoordinator, TemplateState
from repro_torch.core.rewrite import rewrite_plan

__all__ = [k for k in dir() if not k.startswith("_")]
