"""ecommerce-graph: the paper's own architecture — production-scale
transactional graph serving with the one-hop sub-query result cache.

~1.1B vertices / ~8.6B edges (the paper's deployment is "tens of billions
of vertices and edges"), vertex-partitioned over the full mesh with the
cache co-partitioned; peak 8k concurrent one-hop gR-Txs per step."""

from repro_torch.distributed.graph_serve import GraphServeConfig

FAMILY = "graph"

FULL = GraphServeConfig(
    v_total=2**30,
    e_per_vertex=8,
    max_deg=64,
    max_leaves=64,
    cache_slots_total=2**26,
)

SMOKE = GraphServeConfig(
    v_total=256,
    e_per_vertex=4,
    max_deg=8,
    max_leaves=8,
    cache_slots_total=256,
)

SHAPES = {
    "serve_peak": dict(kind="graph_serve", batch=8192, use_cache=True),
    "serve_low": dict(kind="graph_serve", batch=1024, use_cache=True),
    "serve_nocache": dict(kind="graph_serve", batch=8192, use_cache=False),
}
SKIPS = {}
