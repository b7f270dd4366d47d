"""The sharded transaction runtime (PyTorch): the process-local mesh, the
routing table of the partitioned tier, ``ShardedTxnRuntime``, the fault
model of ``distributed.fault`` and the ``FailoverController``."""

from repro_torch.distributed.sharding import (
    ALL_GATHER,
    ALL_REDUCE_MAX,
    ALL_REDUCE_SUM,
    ALL_TO_ALL,
    LocalMesh,
    MeshError,
    flat_mesh,
)
from repro_torch.distributed.fault import (
    CallTimeout,
    ElasticRunner,
    FailureDetector,
    HedgedCalls,
    NodeFailure,
    RetryPolicy,
    ShardFaultPlan,
    timed_call,
)
from repro_torch.distributed.routing import (
    RoutingTable,
    base_owner,
    cache_owner_of,
    identity_table,
    storage_owner_of,
)

__all__ = [
    "ALL_GATHER",
    "ALL_REDUCE_MAX",
    "ALL_REDUCE_SUM",
    "ALL_TO_ALL",
    "LocalMesh",
    "MeshError",
    "flat_mesh",
    "RoutingTable",
    "base_owner",
    "cache_owner_of",
    "identity_table",
    "storage_owner_of",
    "CallTimeout",
    "ElasticRunner",
    "FailureDetector",
    "HedgedCalls",
    "NodeFailure",
    "RetryPolicy",
    "ShardFaultPlan",
    "timed_call",
    "FailoverController",
    "ShardedTxnRuntime",
    "ShardedMissDrain",
    "GraphServeConfig",
    "config_espec",
    "config_plan_and_ttable",
]

_LAZY = ("ShardedTxnRuntime", "ShardedMissDrain", "GraphServeConfig", "config_espec",
         "config_plan_and_ttable")


def __getattr__(name):
    # lazy: graph_serve pulls in the whole core engine stack, failover the
    # journal
    if name in _LAZY:
        from repro_torch.distributed import graph_serve

        return getattr(graph_serve, name)
    if name == "FailoverController":
        from repro_torch.distributed import failover

        return failover.FailoverController
    raise AttributeError(name)
