"""Tensorized transactional property-graph store.

Slotted vertex/edge tensors + CSR indexes over the compacted prefix, with a
linearly-scanned recent region for post-compaction edge inserts; per-vertex
version counters give optimistic conflict detection at vertex granularity.
``partition`` splits the edges into owner-local dual-CSR blocks for the
partitioned tier, ``maintenance`` compacts and grows them, and ``journal``
makes their commits durable (write-behind log, checkpoints, replay).
"""

from repro_torch.graphstore.store import (
    GlobalStoreView,
    GraphStore,
    StoreSpec,
    compact,
    empty_store,
    gather_in,
    gather_out,
    ingest,
)
from repro_torch.graphstore.partition import (
    BlockCapacityError,
    BlockStoreView,
    EdgeBlock,
    PartitionedGraphStore,
    PartitionedStoreSpec,
    abstract_partitioned_store,
    apply_mutations_partitioned,
    default_pspec,
    geid_slot_lookup,
    join_shards,
    local_of,
    local_shard,
    owner_of,
    partition_store,
    rebuild_geid_index,
    splice_owner_blocks,
    store_bytes_report,
)
from repro_torch.graphstore.maintenance import (
    DeviceGate,
    MaintenanceDecision,
    MaintenancePolicy,
    block_occupancy,
    compact_block,
    compact_store,
    decide_maintenance,
    grow_store,
)
from repro_torch.graphstore.journal import (
    EpochRegistry,
    FlushError,
    WriteBehindJournal,
    drain_queued,
    replay,
    replay_to_owner,
    restore_chain,
)
from repro_torch.graphstore.mutations import (
    AppliedMutations,
    MutationBatch,
    apply_mutations,
    make_mutation_batch,
)
from repro_torch.graphstore.txn import TxnError, commit_with_conflict_check, conflicts

__all__ = [
    "GraphStore",
    "GlobalStoreView",
    "StoreSpec",
    "empty_store",
    "ingest",
    "gather_out",
    "gather_in",
    "compact",
    "PartitionedStoreSpec",
    "PartitionedGraphStore",
    "EdgeBlock",
    "BlockStoreView",
    "partition_store",
    "apply_mutations_partitioned",
    "default_pspec",
    "join_shards",
    "owner_of",
    "local_of",
    "local_shard",
    "store_bytes_report",
    "abstract_partitioned_store",
    "BlockCapacityError",
    "geid_slot_lookup",
    "rebuild_geid_index",
    "splice_owner_blocks",
    "MaintenancePolicy",
    "MaintenanceDecision",
    "DeviceGate",
    "block_occupancy",
    "compact_block",
    "compact_store",
    "decide_maintenance",
    "grow_store",
    "WriteBehindJournal",
    "EpochRegistry",
    "FlushError",
    "replay",
    "replay_to_owner",
    "drain_queued",
    "restore_chain",
    "MutationBatch",
    "AppliedMutations",
    "make_mutation_batch",
    "apply_mutations",
    "commit_with_conflict_check",
    "conflicts",
    "TxnError",
]
