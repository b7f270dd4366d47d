"""Tensorized transactional property-graph store.

Slotted vertex/edge tensors + CSR indexes over the compacted prefix, with a
linearly-scanned recent region for post-compaction edge inserts; per-vertex
version counters give optimistic conflict detection at vertex granularity.
``partition`` splits the edges into owner-local dual-CSR blocks for the
partitioned tier.
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
    apply_mutations_partitioned,
    default_pspec,
    join_shards,
    local_of,
    local_shard,
    owner_of,
    partition_store,
    store_bytes_report,
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
    "BlockCapacityError",
    "MutationBatch",
    "AppliedMutations",
    "make_mutation_batch",
    "apply_mutations",
    "commit_with_conflict_check",
    "conflicts",
    "TxnError",
]
