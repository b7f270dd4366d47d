"""The reference's stale read after a move home, on its own 4-owner
runtime (JAX on the CPU with 4 host devices; about a minute).

Warm the cache with one CP drain over roots 0-15 of the common-watchlist
plan, move vertex 1 to owner 2, delete two of its out-edges (geids 7 and
8) with a gRW-Tx, then move it home. After each move the batch is held to
a fresh execution (the cache-off single-host engine on the same store).
Away, every row equals it; home, the rows that read vertex 1's orphaned
entries in its old cache home's block do not, and hits rise. The PyTorch
port drops a moved vertex's entries at its old cache home in the round
that moves it, so it reads as a fresh execution there
(``tests/test_torch_migration.py``, the away-edit-home case).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/reference_stale_home.py

It prints one line, ``STALE {"away": {"differ": [...], "hits": N},
"home": {...}}``: the roots whose rows differ from a fresh execution, and
the batch's hits.
"""
import json
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax
import numpy as np

from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable
from repro.core import CacheSpec, EngineSpec, GraphEngine, empty_cache, run_grw_tx
from repro.distributed import flat_mesh
from repro.distributed.graph_serve import ShardedMissDrain, ShardedTxnRuntime
from repro.distributed.routing import RoutingTableHost
from repro.graphstore import make_mutation_batch
from repro.graphstore.migration import migrate_vertex_rows

spec, store = build_world()
cspec = CacheSpec(capacity=1024, probes=8, max_leaves=16, max_chunks=2)
espec = EngineSpec(store=spec, cache=cspec, max_deg=32, frontier=32)
ttable, _, _ = enabled_ttable()
plan, roots = common_watchlist_plan(), np.arange(16, dtype=np.int32)
rt = ShardedTxnRuntime(espec, flat_mesh(4), route_cap_factor=None)
ps, cache = rt.partition_store(store), rt.empty_cache()
rh = RoutingTableHost(4)
rt.attach_routing(rh)
drain = ShardedMissDrain(rt, TPL_META)
drain.push(rt.run_gr_tx_batch(ps, cache, ttable, plan, roots)[1])
cache = drain.drain(ps, ps, cache, ttable)
out = {}
for tag, moves, edit in (("away", [(1, 2)], True), ("home", [(1, 1)], False)):
    ps = jax.device_put(migrate_vertex_rows(rt.pspec, ps, moves), rt.store_sharding())
    rh.apply_moves(moves)
    if edit:
        mb = make_mutation_batch(spec, del_edges=[7, 8])
        ps, cache, _ = rt.run_grw_tx(ps, cache, ttable, mb)
        store, _, _ = run_grw_tx(espec, store, empty_cache(cspec), ttable, mb)
    res, _, m = rt.run_gr_tx_batch(ps, cache, ttable, plan, roots)
    fresh, _, _ = GraphEngine(espec, plan, False, fused=True).run(store, empty_cache(cspec),
                                                                 ttable, roots)
    differ = (np.asarray(res) != np.asarray(fresh)).any(axis=1)
    out[tag] = dict(differ=roots[differ].tolist(), hits=int(m["hits"]))
print("STALE " + json.dumps(out))
