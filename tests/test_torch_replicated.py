"""Parity: the port's replicated store tier.

At the small sizes of ``tests/test_torch_sharded.py``, on the CPU, against
the JAX package in process (its single host; no JAX mesh subprocess):

- ``shard_mutation_rows`` bit for bit against the reference's for 1 to 4
  ranks and every rank, on a batch with every section;
- the op-order keys of a round-robin slice are global: each rank's sliced
  op set equals the reference's, the sets are disjoint, and they union to
  the unsliced set (the twin of the reference's
  ``test_op_stream_order_keys_are_global``);
- ``ShardedTxnRuntime(store_tier="replicated")`` on 4 and 1 ranks with
  no-drop caps: cold, CP, warm against the JAX single-host ``GraphEngine``
  (results, metrics, miss multisets, CP outcomes, cache entries), then a
  commit under each policy against JAX ``run_grw_tx`` (store fields bit for
  bit, cache entries equal); tight caps surface ``route_overflow``; a
  cache exception routes reads and CP to its cache home; each
  partitioned-only entry point raises;
- the overlapped hop schedule stays unported: ``make_plan_fn(overlap=True)``
  raises.
"""

import numpy as np
import pytest
import torch

import repro.core as J
from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable, fig1_plan
from repro.core.invalidation import derive_cache_ops as j_derive
from repro.core.population import CachePopulator as JPopulator
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore.mutations import apply_mutations as j_apply
from repro.graphstore.mutations import shard_mutation_rows as j_shard_rows
import repro_torch.core as T
from repro_torch import interop
from repro_torch.core.invalidation import derive_cache_ops as t_derive
from repro_torch.core.runtime import LocalPlanTier, make_plan_fn
from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, flat_mesh
from repro_torch.distributed.failover import FailoverController
from repro_torch.distributed.routing import RoutingTableHost
from repro_torch.graphstore import DeviceGate, apply_mutations as t_apply
from repro_torch.graphstore import make_mutation_batch as t_batch
from repro_torch.graphstore.mutations import shard_mutation_rows as t_shard_rows
from repro_torch.kernels.block_gather import ops as bg_ops
from test_torch_sharded import SHARDED_ONLY, miss_key, to_np

PLANS = {"in_out": common_watchlist_plan(), "fig1": fig1_plan()}
# each plan's roots: listings and watch-lists for the two-hop plan from
# listings, the watch-lists for Figure 1's
ROOTS = {"in_out": np.array([5, 6, 7, 8, 9, 0, 3], np.int32),
         "fig1": np.array([0, 1, 2, 3], np.int32)}
# a batch with every section, on the world's rows and edges
_EVERY_SECTION = dict(
    new_vertices=[(1, [0, 1007]), (0, [1, 1008])],
    new_edges=[(0, 11, 0, [1]), (2, 16, 0, [0]), (3, 5, 0, [1]), (1, 7, 0, [0]), (0, 9, 0, [1])],
    del_edges=[2, 5, 7], del_vertices=[9, 13],
    set_vprops=[(6, 0, 1), (7, 0, 0), (8, 0, 1), (10, 0, 0), (12, 1, 4242)],
    set_eprops=[(1, 0, 0), (4, 0, 1), (6, 0, 0)],
)
# the reference's commit of its replicated-tier identity test
_COMMIT = dict(set_vprops=[(7, 0, 1), (8, 0, 0)], del_edges=[2], new_edges=[(0, 11, 0, [1])],
               del_vertices=[9])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rw():
    """The ``conftest`` world in both packages, and the JAX single host's
    engines and populator (each compiled once for the module)."""
    spec, store = build_world()
    jspec = J.EngineSpec(store=spec, cache=J.CacheSpec(capacity=1024, probes=8, max_leaves=16,
                                                        max_chunks=2), max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    tspec = interop.engine_spec(tuple(spec), tuple(jspec.cache), 32, 32)
    return dict(
        spec=spec, jspec=jspec, jstore=store, jttable=jttable, tspec=tspec,
        tstore=interop.store_from_numpy(to_np(store), device="cpu"),
        tttable=interop.ttable_from_numpy(to_np(jttable)),
        tplans={k: interop.plan_from_numpy(to_np(p)) for k, p in PLANS.items()},
        engines={k: J.GraphEngine(jspec, p, True, fused=True) for k, p in PLANS.items()},
        jpop=JPopulator(jspec, TPL_META), single={},
    )


def _applied(rw, **kw):
    """The same batch applied in both packages: (JAX applied, port applied,
    JAX post-store, port post-store)."""
    js2, ja = j_apply(rw["spec"], rw["jstore"], j_batch(rw["spec"], **kw))
    ts2, ta = t_apply(rw["tspec"].store, rw["tstore"],
                      t_batch(rw["tspec"].store, device="cpu", **kw))
    return ja, ta, js2, ts2


def _flat(applied):
    d = dict(applied._asdict())
    batch = d.pop("batch")._asdict()
    return {**{f"batch.{k}": np.asarray(v) for k, v in batch.items()},
            **{k: np.asarray(v) for k, v in d.items()}}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shard_mutation_rows_matches_reference(rw, n):
    ja, ta, _, _ = _applied(rw, **_EVERY_SECTION)
    for me in range(n):
        want = _flat(j_shard_rows(ja, n, me))
        got = _flat(t_shard_rows(ta, n, me))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, (n, me, k)
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{n} {me} {k}")


def _op_set(ops):
    ok = np.asarray(ops.ok)
    cols = [np.asarray(c)[ok] for c in (ops.order, ops.kind, ops.tpl, ops.root, ops.vid)]
    return set(zip(*(c.tolist() for c in cols)))


@pytest.mark.parametrize("n", [2, 4])
def test_op_stream_order_keys_are_global(rw, n):
    """Each rank's sliced op set, order keys included, equals the reference's;
    the ranks' sets are disjoint and union to the unsliced set, in both
    packages."""
    mb = dict(set_vprops=[(6, 0, 1), (7, 0, 0), (8, 0, 1), (10, 0, 0)], del_edges=[1, 3],
              new_edges=[(0, 11, 0, [1])])
    ja, ta, js2, ts2 = _applied(rw, **mb)

    def both(jap, tap, off, stride):
        jops, _ = j_derive(rw["jspec"], rw["jstore"], js2, rw["jttable"], jap, through=True,
                           row_offset=off, row_stride=stride)
        tops, _ = t_derive(rw["tspec"], rw["tstore"], ts2, rw["tttable"], tap, through=True,
                           row_offset=off, row_stride=stride)
        assert _op_set(tops) == _op_set(jops), (off, stride)
        return _op_set(tops)

    full = both(ja, ta, 0, 1)
    sharded = set()
    for me in range(n):
        part = both(j_shard_rows(ja, n, me), t_shard_rows(ta, n, me), me, n)
        assert part <= full, "a rank emitted an order key the full run lacks"
        assert not (part & sharded), "ranks emitted overlapping ops"
        sharded |= part
    assert sharded == full and len(full) > 0


def _single(rw, plan_name):
    """The JAX single host's cold run, CP and warm run of ``plan_name`` on
    the world, then each policy's commit: computed once for the module."""
    if plan_name in rw["single"]:
        return rw["single"][plan_name]
    eng, jpop = rw["engines"][plan_name], rw["jpop"]
    roots = ROOTS[plan_name]
    jcache = J.empty_cache(rw["jspec"].cache)
    cold = eng.run(rw["jstore"], jcache, rw["jttable"], roots)
    c0, a0 = jpop.committed, jpop.aborted
    jpop.queue.push(cold[1])
    jcache = jpop.drain(rw["jstore"], rw["jstore"], jcache, rw["jttable"])
    cp = (jpop.committed - c0, jpop.aborted - a0)
    warm = eng.run(rw["jstore"], jcache, rw["jttable"], roots)
    grw = {}
    for policy in ("write-around", "write-through"):
        js2, jc2, jm = J.run_grw_tx(rw["jspec"], rw["jstore"], jcache, rw["jttable"],
                                    j_batch(rw["spec"], **_COMMIT), policy=policy)
        grw[policy] = ({f: np.asarray(getattr(js2, f)) for f in js2._fields},
                       J.cache_entries(rw["jspec"].cache, jc2), jm)
    rw["single"][plan_name] = out = dict(
        roots=roots, cold=cold, warm=warm, cp=cp,
        entries=J.cache_entries(rw["jspec"].cache, jcache), grw=grw)
    return out


def _check_gr(got, want):
    (tr, tm, tmet), (jr, jm, jmet) = got, want
    np.testing.assert_array_equal(tr, np.asarray(jr))
    tmet, jmet = dict(tmet), dict(jmet)
    assert tmet["route_overflow"] == 0 and tmet["locality_routed"] == 0
    for k in SHARDED_ONLY:
        tmet.pop(k)
    jmet.pop("host_syncs")
    assert tmet == jmet
    assert miss_key(tm) == miss_key(jm)
    return tmet


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("n", [4, 1])
def test_replicated_runtime_matches_single_host(rw, n, plan_name):
    want = _single(rw, plan_name)
    rt = ShardedTxnRuntime(rw["tspec"], flat_mesh(n), store_tier="replicated",
                           route_cap_factor=None, device="cpu")
    assert rt.pspec is None and rt.store_tier == "replicated"
    store, tcache, plan = rw["tstore"], rt.empty_cache(), rw["tplans"][plan_name]
    before = bg_ops.launches
    cold = _check_gr(rt.run_gr_tx_batch(store, tcache, rw["tttable"], plan, want["roots"]),
                     want["cold"])
    assert cold["misses"] > 0 and bg_ops.launches == before  # the full-store exec: no blocks
    drain = ShardedMissDrain(rt, TPL_META)
    drain.push(rt.run_gr_tx_batch(store, tcache, rw["tttable"], plan, want["roots"])[1])
    tcache = drain.drain(store, store, tcache, rw["tttable"])
    assert (drain.committed, drain.aborted) == want["cp"] and drain.committed > 0
    assert int(tcache.n_evict) == 0
    assert T.cache_entries(rw["tspec"].cache, tcache) == want["entries"]
    warm = _check_gr(rt.run_gr_tx_batch(store, tcache, rw["tttable"], plan, want["roots"]),
                     want["warm"])
    assert warm["hits"] > 0 and warm["phases"] < cold["phases"]
    for policy, (jstore, jentries, jm) in want["grw"].items():
        ts2, tc2, m = rt.run_grw_tx(store, tcache, rw["tttable"],
                                    t_batch(rw["tspec"].store, device="cpu", **_COMMIT), policy)
        # write-through edits the entries in place: it removes none here
        assert m["impacted_keys"] == jm["impacted_keys"] and m["op_overflow"] == 0
        assert m["impacted_keys"] > 0 or policy == "write-through"
        assert (m["store_append_overflow"], m["store_occupancy_max"],
                m["store_recent_fill_max"]) == (0, 0.0, 0)
        got = interop.store_to_numpy(ts2)
        assert set(got) == set(jstore)
        for f in jstore:
            np.testing.assert_array_equal(got[f], np.asarray(jstore[f]), err_msg=f"{policy} {f}")
        assert T.cache_entries(rw["tspec"].cache, tc2) == jentries != want["entries"], policy
        assert int(tc2.n_delete) - int(tcache.n_delete) == m["impacted_keys"]


def test_route_overflow_is_surfaced(rw):
    """Buckets of one uniform share drop rows when every root lives at one
    owner, and the metrics say so."""
    rt = ShardedTxnRuntime(rw["tspec"], flat_mesh(4), store_tier="replicated",
                           route_cap_factor=1, device="cpu")
    _, _, met = rt.run_gr_tx_batch(rw["tstore"], rt.empty_cache(), rw["tttable"],
                                   rw["tplans"]["fig1"], np.full(16, 1, np.int32))
    assert met["route_overflow"] > 0, met


def test_cache_exception_serves_at_its_cache_home(rw):
    """A root whose cache home a ``RoutingTableHost`` moves to owner 3 reads
    there over the full store (nothing defers or retries), its CP entry
    lands in owner 3's block, and the warm read hits it: every batch equals
    the JAX single host."""
    want = _single(rw, "fig1")
    rt = ShardedTxnRuntime(rw["tspec"], flat_mesh(4), store_tier="replicated",
                           route_cap_factor=None, device="cpu")
    rhost = rt.attach_routing(RoutingTableHost(4, device="cpu"))
    v = 1  # a watch-list root of base owner 1
    rhost.set_cache_owner(v, 3)
    store, cache, plan = rw["tstore"], rt.empty_cache(), rw["tplans"]["fig1"]

    def read():
        res, misses, m = rt.run_gr_tx_batch(store, cache, rw["tttable"], plan, want["roots"])
        assert m["locality_routed"] > 0 and m["locality_retry_rows"] == 0
        m = dict(m, locality_routed=0)
        return res, misses, m

    _check_gr(read(), want["cold"])
    drain = ShardedMissDrain(rt, TPL_META)
    drain.push(read()[1])
    cache = drain.drain(store, store, cache, rw["tttable"])
    assert T.cache_entries(rw["tspec"].cache, cache) == want["entries"]
    Cloc = rw["tspec"].cache.capacity // 4
    homes = {s for s in range(4)
             if bool((cache.valid[s * Cloc:(s + 1) * Cloc]
                      & (cache.root[s * Cloc:(s + 1) * Cloc] == v)).any())}
    assert homes == {3}
    _check_gr(read(), want["warm"])
    assert rt.locality_retries == 0 and rt.cp_splits == 0


@pytest.mark.parametrize("entry", ["partition_store", "store_bytes", "store_occupancy",
                                   "compact_step", "grow_blocks", "set_block_capacity",
                                   "maintenance_tick", "gate", "failover"])
def test_partitioned_only_entry_points_raise(rw, entry):
    rt = ShardedTxnRuntime(rw["tspec"], flat_mesh(4), store_tier="replicated", device="cpu")
    store = rw["tstore"]
    calls = {
        "partition_store": lambda: rt.partition_store(store),
        "store_bytes": lambda: rt.store_bytes(store),
        "store_occupancy": lambda: rt.store_occupancy(store),
        "compact_step": lambda: rt.compact_step(),
        "grow_blocks": lambda: rt.grow_blocks(store, 1 << 12),
        "set_block_capacity": lambda: rt.set_block_capacity(1 << 12),
        "maintenance_tick": lambda: rt.maintenance_tick(store),
        "gate": lambda: rt.run_grw_tx(store, rt.empty_cache(), rw["tttable"],
                                      t_batch(rw["tspec"].store, device="cpu", **_COMMIT),
                                      gate=DeviceGate(0.5)),
        "failover": lambda: FailoverController(rt, None, rw["tttable"]),
    }
    with pytest.raises(ValueError, match="partitioned store tier"):
        calls[entry]()
    with pytest.raises(ValueError, match="unknown store tier"):
        ShardedTxnRuntime(rw["tspec"], flat_mesh(4), store_tier="sharded", device="cpu")



def test_overlapped_schedule_is_not_ported():
    """The two-stream hop schedule waits for ranks on streams or cards of
    their own (ROADMAP.md queue 1): ``make_plan_fn(overlap=True)`` raises
    before it builds a kernel."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        make_plan_fn(None, None, True, LocalPlanTier(), overlap=True)
