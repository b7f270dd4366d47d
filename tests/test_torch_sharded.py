"""Parity: the port's partitioned gR-Tx tier (``ShardedTxnRuntime`` on a
process-local mesh of 4 and of 1 owner shards, CPU tensors) against the JAX
single-host ``GraphEngine``, which the reference holds its own sharded tier
equal to (``tests/test_partitioned_runtime.py``).

Each plan runs cold, then both sides drain the same misses through CP, then
runs warm. Compared exactly: results, metrics (except the sharded-only
``route_overflow`` / ``locality_routed`` / ``route_cap_retries`` /
``locality_retry_rows``, and ``host_syncs``), miss multisets, CP committed /
aborted, and the logical cache entries. The store is the ``conftest`` world
after a mutation batch, so the miss path scans live recent regions.
"""

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable, fig1_plan, \
    sq1_hop, sq2_hop
from repro.core.population import CachePopulator as JPopulator
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore.mutations import apply_mutations as j_apply
import repro_torch.core as T
from repro_torch import interop
from repro_torch.distributed import (
    ALL_GATHER,
    ALL_REDUCE_MAX,
    ALL_REDUCE_SUM,
    ALL_TO_ALL,
    MeshError,
    ShardedMissDrain,
    ShardedTxnRuntime,
    flat_mesh,
)
from repro_torch.kernels.block_gather import ops as bg_ops

PLANS = {
    "in_out": common_watchlist_plan(),
    "out_in": J.QueryPlan(hops=(sq1_hop(), sq2_hop())),
    "fig1": fig1_plan(),
}
SHARDED_ONLY = ("route_overflow", "locality_routed", "route_cap_retries", "locality_retry_rows",
                "host_syncs")


def to_np(x):
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_np(v) for v in x)
    if isinstance(x, (int, float, str, bool, type(None), np.ndarray)):
        return x
    return np.asarray(x)


@pytest.fixture(scope="module")
def sw():
    spec, store = build_world()
    mb = j_batch(spec, new_edges=[(0, 11, 0, [1]), (3, 6, 0, [1]), (1, 7, 0, [1])],
                 del_edges=[2], set_vprops=[(7, 0, 0)], del_vertices=[9])
    jstore, _ = jax.jit(j_apply, static_argnums=0)(spec, store, mb)
    jspec = J.EngineSpec(store=spec, cache=J.CacheSpec(capacity=1024, probes=8, max_leaves=16,
                                                        max_chunks=2), max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    return dict(
        jspec=jspec, jstore=jstore, jttable=jttable,
        tspec=interop.engine_spec(tuple(spec), tuple(jspec.cache), 32, 32),
        tstore=interop.store_from_numpy(to_np(jstore), device="cpu"),
        tttable=interop.ttable_from_numpy(to_np(jttable)),
        engines={name: J.GraphEngine(jspec, plan, True, fused=True) for name, plan in PLANS.items()},
        jpop=JPopulator(jspec, TPL_META),  # compiles each CP step once for the module
    )


def miss_key(ms):
    return sorted((m.tpl_idx, m.root, tuple(np.asarray(m.params).tolist()), m.read_version)
                  for m in ms)


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("n", [4, 1])
def test_sharded_gr_and_cp_match_single_host(sw, n, plan_name):
    jspec, tspec, plan = sw["jspec"], sw["tspec"], PLANS[plan_name]
    tplan = interop.plan_from_numpy(to_np(plan))
    rt = ShardedTxnRuntime(tspec, flat_mesh(n), route_cap_factor=None, device="cpu")
    pstore = rt.partition_store(sw["tstore"])
    assert int(pstore.out.blk_len.sum()) > int(pstore.out.csr_len.sum())  # live recent regions
    jcache, tcache = J.empty_cache(jspec.cache), rt.empty_cache()
    roots = np.array([5, 6, 7, 8, 9, 0, 3], np.int32)

    def gr():
        jr, jm, jmet = sw["engines"][plan_name].run(sw["jstore"], jcache, sw["jttable"], roots)
        tr, tm, tmet = rt.run_gr_tx_batch(pstore, tcache, sw["tttable"], tplan, roots)
        np.testing.assert_array_equal(tr, np.asarray(jr))
        assert tmet["route_overflow"] == 0 and tmet["locality_routed"] == 0
        assert tmet["host_syncs"] >= 1
        for k in SHARDED_ONLY:
            tmet.pop(k)
        jmet.pop("host_syncs")
        assert tmet == jmet
        assert miss_key(tm) == miss_key(jm)
        return jm, tm, tmet

    before = bg_ops.launches
    jm, tm, cold = gr()
    assert cold["misses"] > 0 and bg_ops.launches == before  # CPU: the plain version ran
    jpop = sw["jpop"]
    c0, a0 = jpop.committed, jpop.aborted
    jpop.queue.push(jm)
    jcache = jpop.drain(sw["jstore"], sw["jstore"], jcache, sw["jttable"])
    drain = ShardedMissDrain(rt, TPL_META)
    drain.push(tm)
    tcache = drain.drain(pstore, pstore, tcache, sw["tttable"])
    assert (drain.committed, drain.aborted) == (jpop.committed - c0, jpop.aborted - a0)
    assert drain.committed > 0 and drain.pending() == 0
    assert int(tcache.n_evict) == int(jcache.n_evict) == 0
    assert int(tcache.n_insert) == int(jcache.n_insert)
    assert T.cache_entries(tspec.cache, tcache) == J.cache_entries(jspec.cache, jcache)
    _, _, warm = gr()
    assert warm["hits"] > 0 and warm["phases"] <= cold["phases"]


def test_mesh_is_an_exact_lockstep_permutation():
    mesh = flat_mesh(3)

    def rank(r):
        send = torch.arange(3 * 2).reshape(3, 2) + 10 * r  # row d goes to rank d
        recv = yield (ALL_TO_ALL, send)
        total = yield (ALL_REDUCE_SUM, torch.tensor(r + 1))
        return recv, int(total)

    outs = mesh.run([rank(r) for r in range(3)])
    for d, (recv, total) in enumerate(outs):
        assert total == 6
        for s in range(3):
            assert recv[s].tolist() == [10 * s + 2 * d, 10 * s + 2 * d + 1]
    assert mesh.counts == {ALL_TO_ALL: 1, ALL_REDUCE_SUM: 1, ALL_GATHER: 0, ALL_REDUCE_MAX: 0}

    def odd(r):  # rank 2 asks for another collective than its peers
        yield (ALL_REDUCE_SUM if r == 2 else ALL_TO_ALL, torch.zeros(3, 1))

    with pytest.raises(MeshError, match="different collectives"):
        mesh.run([odd(r) for r in range(3)])

    def early(r):  # rank 0 finishes while the others wait at a collective
        if r:
            yield (ALL_REDUCE_SUM, torch.zeros(1))
        return r

    with pytest.raises(MeshError, match="never reach"):
        mesh.run([early(r) for r in range(3)])
