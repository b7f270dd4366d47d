"""The port's routing tier against the reference's.

- **The table**: the nine cases of ``tests/test_routing_table.py`` fed to
  both packages' ``RoutingTableHost`` with equal outcomes (device-table and
  host lookups, split flags, epochs, exceptions, metrics, errors); the
  stamped tables are equal array for array through ``interop``, and a
  host's placement crosses in both directions.
- **Locality** (the twin of ``tests/test_routing_runtime.py``'s LOCALITY
  script, on 4 owners, without its recompile pins): no table, a given
  exception-free host and an attached one give the same batch; with two split vertices (cache home away from the storage owner)
  the cold batch routes them to their cache homes, defers their misses
  and retries them through the storage view, CP executes them at the
  storage owner and inserts at the cache home, and the warm batch serves
  them there: results, misses, CP counts and entries equal the JAX
  single-host ``GraphEngine`` and ``CachePopulator``, and so do the
  metrics (but ``host_syncs`` and the sharded-only counters) of the warm
  batch; the cold batch's merge its two dispatches, as the reference's
  4-owner runtime's do (the split rows' first probes and the retry's
  phases on top of the single host's).
- **The CP split's program**: ``populate_program(commit_mask=)`` driven on
  one shard (an identity reducer) against the reference's
  ``populate_step(commit_mask=, allreduce=)``.
- **No exception, no cost**: a batch, a CP drain and a commit under an
  attached exception-free host make the same kernel calls, host reads and
  collectives as with no table.
"""

import numpy as np
import pytest
import torch

import repro.core as J
import repro.distributed.routing as JR
from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable
from repro.core.population import CachePopulator as JPopulator
import repro_torch.core as T
import repro_torch.core.cache as cache_mod
import repro_torch.distributed.routing as TR
from repro_torch import interop
from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, flat_mesh
from repro_torch.graphstore import make_mutation_batch
from repro_torch.kernels.block_gather import ops as bg_ops
from test_torch_sharded import SHARDED_ONLY, miss_key, to_np
from test_torch_fixtures import _torch_test_env  # noqa: F401

N = 8  # the table cases' owners, as the reference's


# ------------------------------------------------------------------ table
def _host(pkg, *a, **kw):
    return (TR.RoutingTableHost(*a, device="cpu", **kw) if pkg == "t"
            else JR.RoutingTableHost(*a, **kw))


def _owners(pkg, fn_name, table, vids):
    vids = np.asarray(vids, np.int32)
    if pkg == "t":
        return getattr(TR, fn_name)(table, torch.as_tensor(vids), N).numpy().tolist()
    return np.asarray(getattr(JR, fn_name)(table, vids, N)).tolist()


def _identity(pkg, **kw):
    return TR.identity_table(N, device="cpu", **kw) if pkg == "t" else JR.identity_table(N, **kw)


def _storage_view(pkg, t):
    return (TR if pkg == "t" else JR).storage_view(t)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e).split(";")[0]
    return None


def _case_identity(pkg):
    vids = np.arange(200)
    return [_owners(pkg, f, t, vids) for t in (None, _identity(pkg))
            for f in ("storage_owner_of", "cache_owner_of")]


def _case_storage_exception(pkg):
    rh = _host(pkg, N)
    rh.set_storage_owner(10, 5)
    t, vids = rh.device_table(), np.arange(64)
    return [_owners(pkg, "storage_owner_of", t, vids), _owners(pkg, "cache_owner_of", t, vids),
            rh.storage_owner(vids).tolist(), rh.storage_owner(10), rh.storage_owner(11)]


def _case_cache_exception(pkg):
    rh = _host(pkg, N)
    rh.set_storage_owner(10, 5)
    rh.set_cache_owner(10, 7)
    rh.set_cache_owner(3, 0)
    t, vids = rh.device_table(), np.arange(16)
    sv, sv2 = _storage_view(pkg, t), rh.storage_table()
    return [_owners(pkg, "storage_owner_of", t, vids), _owners(pkg, "cache_owner_of", t, vids),
            rh.is_split(np.asarray([10, 3, 4], np.int32)).tolist(),
            _owners(pkg, "cache_owner_of", sv, vids), _owners(pkg, "cache_owner_of", sv2, vids),
            rh.cache_owner(np.arange(16)).tolist(), tuple(np.asarray(sv.epoch).shape)]


def _case_moving_home(pkg):
    rh = _host(pkg, N)
    rh.set_storage_owner(10, 5)
    out = [rh.has_exceptions()]
    rh.set_storage_owner(10, int(JR.base_owner(10, N)))
    return out + [rh.has_exceptions(), rh.storage_exceptions, rh.epoch]


def _case_apply_moves(pkg):
    rh = _host(pkg, N)
    rh.set_cache_owner(9, 4)
    e0 = rh.epoch
    rh.apply_moves([(9, 6), (17, 0), (12, 4)])  # 12 -> 4 is its native owner
    return [rh.epoch - e0, rh.storage_owner(9), rh.storage_owner(17), rh.cache_exceptions,
            rh.cache_owner(9), rh.storage_exceptions]


def _case_cached_per_epoch(pkg):
    rh = _host(pkg, N)
    rh.set_storage_owner(10, 5)
    t1 = rh.device_table()
    same = rh.device_table() is t1 and rh.storage_table() is rh.storage_table()
    rh.set_storage_owner(11, 6)
    t2 = rh.device_table()
    return [same, t2 is not t1, int(np.asarray(t1.epoch)), int(np.asarray(t2.epoch)), rh.epoch]


def _case_capacity(pkg):
    rh = _host(pkg, N, cap=2)
    rh.set_storage_owner(10, 5)
    rh.set_storage_owner(11, 5)
    return [_raises(lambda: rh.set_storage_owner(12, 5)),
            _raises(lambda: rh.apply_moves([(13, 6)])),
            _raises(lambda: rh.set_storage_owner(10, 4)),  # an update, not a new one
            _identity(pkg, cap=2).cap, _identity(pkg).cap, rh.storage_exceptions]


def _case_owner_range(pkg):
    rh = _host(pkg, N)
    return [_raises(lambda: rh.set_storage_owner(1, N)),
            _raises(lambda: rh.set_cache_owner(1, -1)), rh.epoch]


def _case_metrics(pkg):
    rh = _host(pkg, N)
    rh.set_storage_owner(10, 5)
    rh.set_cache_owner(3, 0)
    rh.clear_cache_owner(3)
    rh.clear_cache_owner(3)  # nothing to clear: no bump
    rh.set_cache_owner(4, 1)
    return [rh.metrics(), rh.epoch]


TABLE_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_identity, _case_storage_exception, _case_cache_exception, _case_moving_home,
    _case_apply_moves, _case_cached_per_epoch, _case_capacity, _case_owner_range,
    _case_metrics)}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_routing_table_case_matches_reference(case):
    got, want = TABLE_CASES[case]("t"), TABLE_CASES[case]("j")
    assert got == want


def test_stamped_tables_and_placement_cross_between_packages():
    hosts = {}
    for pkg in ("t", "j"):
        rh = hosts[pkg] = _host(pkg, 4, cap=8)
        rh.apply_moves([(9, 2), (6, 3)])
        rh.set_cache_owner(5, 0)
        rh.set_cache_owner(9, 1)
    for stamp in ("device_table", "storage_table"):
        got = interop.rtable_to_numpy(getattr(hosts["t"], stamp)())
        want = to_np(getattr(hosts["j"], stamp)())
        assert got.keys() == want.keys()
        for f in got:
            np.testing.assert_array_equal(got[f], want[f])
            assert got[f].dtype == want[f].dtype, f
        back = interop.rtable_from_numpy(want, device="cpu")
        vids = torch.arange(16, dtype=torch.int32)
        assert torch.equal(TR.cache_owner_of(back, vids, 4),
                           TR.cache_owner_of(getattr(hosts["t"], stamp)(), vids, 4))
    state = interop.rhost_state(hosts["j"])
    assert state == interop.rhost_state(hosts["t"])
    h = interop.rhost_from_state(state, device="cpu")
    assert interop.rhost_state(h) == state
    assert h.cache_owner(np.arange(16)).tolist() == hosts["j"].cache_owner(np.arange(16)).tolist()


# --------------------------------------------------------------- locality
@pytest.fixture(scope="module")
def world():
    spec, store = build_world()
    cspec = J.CacheSpec(capacity=1024, probes=8, max_leaves=16, max_chunks=2)
    jespec = J.EngineSpec(store=spec, cache=cspec, max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    plan = common_watchlist_plan()
    return dict(spec=spec, store=store, jespec=jespec, jttable=jttable, jplan=plan,
                engine=J.GraphEngine(jespec, plan, True, fused=True),
                tspec=interop.store_spec(tuple(spec)),
                tespec=interop.engine_spec(tuple(spec), tuple(cspec), 32, 32),
                tstore=interop.store_from_numpy(to_np(store), device="cpu"),
                tttable=interop.ttable_from_numpy(to_np(jttable)),
                tplan=interop.plan_from_numpy(to_np(plan)))


ROOTS = np.array([0, 3, 5, 6, 7, 11], np.int32)


def _same(tmet, jmet):
    t = {k: v for k, v in tmet.items() if k not in SHARDED_ONLY}
    return t == {k: v for k, v in jmet.items() if k != "host_syncs"}


def test_locality_routing_matches_the_single_host(world):
    cspec, espec, ttable, plan = world["jespec"].cache, world["tespec"], world["tttable"], \
        world["tplan"]
    rt = ShardedTxnRuntime(espec, flat_mesh(4), route_cap_factor=None, device="cpu")
    ps = rt.partition_store(world["tstore"])
    cache_h, cache_s = J.empty_cache(cspec), rt.empty_cache()
    res_h, miss_h, met_h = world["engine"].run(world["store"], cache_h, world["jttable"], ROOTS)

    # no table, a given exception-free host and an attached one: the same
    # batch
    runs = {"none": rt.run_gr_tx_batch(ps, cache_s, ttable, plan, ROOTS),
            "given": rt.run_gr_tx_batch(ps, cache_s, ttable, plan, ROOTS,
                                        rtable=TR.RoutingTableHost(4, device="cpu"))}
    rhost = rt.attach_routing(TR.RoutingTableHost(4, device="cpu"))
    runs["attached"] = rt.run_gr_tx_batch(ps, cache_s, ttable, plan, ROOTS)
    for tag, (res, miss, met) in runs.items():
        np.testing.assert_array_equal(res, np.asarray(res_h))
        assert miss_key(miss) == miss_key(miss_h), tag
        assert _same(met, met_h), tag
        assert met["locality_routed"] == met["locality_retry_rows"] == 0, tag
    assert runs["attached"][2] == runs["none"][2]

    # split vertices: 5's rows at owner 1, its cache home at 0; 7's rows at
    # 3, its cache home at 2
    rhost.set_cache_owner(5, 0)
    rhost.set_cache_owner(7, 2)
    res_c, miss_c, met_c, def_c = rt.run_gr_tx_batch(ps, cache_s, ttable, plan, ROOTS,
                                                     return_deferred=True)
    np.testing.assert_array_equal(res_c, np.asarray(res_h))
    assert miss_key(miss_c) == miss_key(miss_h)
    # the metrics merge the two dispatches as the reference's runtime does:
    # the split rows' first probes and the retry's phases count on top
    for k in ("hits", "misses", "edges_scanned", "leaf_fetches", "truncated"):
        assert met_c[k] == met_h[k], k
    assert met_c["deferred"] == met_c["locality_retry_rows"] == 2
    assert met_c["cache_reads"] == met_h["cache_reads"] + 2
    assert met_c["phases"] == 2 * met_h["phases"] and met_c["requests"] > met_h["requests"]
    assert met_c["locality_routed"] > 0
    assert rt.locality_retries == 1 and not def_c.any()

    # CP: the split roots execute at their storage owners and insert at
    # their cache homes, the counts and entries the single host's
    pop_h = JPopulator(world["jespec"], TPL_META)
    pop_h.queue.push(miss_h)
    cache_h = pop_h.drain(world["store"], world["store"], cache_h, world["jttable"])
    drain = ShardedMissDrain(rt, TPL_META)
    drain.push(miss_c)
    assert [len(p.queue) for p in drain.pops][0] > 0
    cache_s = drain.drain(ps, ps, cache_s, ttable)
    assert (drain.committed, drain.aborted) == (pop_h.committed, pop_h.aborted)
    assert T.cache_entries(espec.cache, cache_s) == J.cache_entries(cspec, cache_h)
    Cloc = espec.cache.capacity // 4
    valid, root = cache_s.valid.numpy(), cache_s.root.numpy()
    for v, home in ((5, 0), (7, 2)):
        at = np.flatnonzero(valid & (root == v)) // Cloc
        assert at.size and set(at.tolist()) == {home}, (v, at)

    # warm: the hits serve at the cache homes, with no deferral and no retry
    res_wh, _, met_wh = world["engine"].run(world["store"], cache_h, world["jttable"], ROOTS)
    res_w, _, met_w = rt.run_gr_tx_batch(ps, cache_s, ttable, plan, ROOTS)
    np.testing.assert_array_equal(res_w, np.asarray(res_wh))
    assert met_wh["misses"] == met_w["misses"] == 0 and met_w["hits"] == met_wh["hits"] > 0
    assert _same(met_w, met_wh)
    assert met_w["locality_routed"] > 0 and met_w["locality_retry_rows"] == 0
    assert rt.locality_retries == 1


def test_an_exception_free_table_costs_nothing(world, monkeypatch):
    espec, ttable, plan = world["tespec"], world["tttable"], world["tplan"]
    calls = {"cache_probe": 0, "block_gather": 0}
    for mod, name in ((cache_mod, "cache_probe"), (bg_ops, "block_gather")):
        inner = getattr(mod, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    seen = []
    for attach in (False, True):
        rt = ShardedTxnRuntime(espec, flat_mesh(4), route_cap_factor=None, device="cpu")
        if attach:
            rhost = rt.attach_routing(TR.RoutingTableHost(4, device="cpu"))
            rhost.set_storage_owner(5, 2)
            rhost.set_storage_owner(5, 1)  # home again: the table is empty
            assert not rhost.has_exceptions() and rhost.epoch == 2
        ps, cache = rt.partition_store(world["tstore"]), rt.empty_cache()
        for k in calls:
            calls[k] = 0
        res, ms, m, d = rt.run_gr_tx_batch(ps, cache, ttable, plan, ROOTS, return_deferred=True)
        drain = ShardedMissDrain(rt, TPL_META)
        drain.push(ms)
        cache = drain.drain(ps, ps, cache, ttable)
        mb = make_mutation_batch(world["tspec"], new_edges=[(5, 9, 0, [1])], del_edges=[2],
                                 device="cpu")
        ps2, cache2, wm = rt.run_grw_tx(ps, cache, ttable, mb)
        res2, _, m2 = rt.run_gr_tx_batch(ps2, cache2, ttable, plan, ROOTS)
        assert not d.any() and m["deferred"] == 0
        seen.append((res.tolist(), miss_key(ms), m, drain.committed, wm, res2.tolist(), m2,
                     T.cache_entries(espec.cache, cache2), dict(calls), dict(rt.mesh.counts)))
    assert seen[0] == seen[1]
    assert seen[0][8]["cache_probe"] > 0 and seen[0][8]["block_gather"] > 0


def _drive(program, reduce):
    """Run a per-rank program alone, each all-reduce it asks for answered by
    ``reduce``."""
    try:
        ask = next(program)
        while True:
            ask = program.send(reduce(ask[1]))
    except StopIteration as stop:
        return stop.value


def test_populate_program_split_matches_reference(world):
    """``populate_program(commit_mask=)`` on one shard (an identity reducer)
    inserts only the committed rows, as the reference's
    ``populate_step(commit_mask=, allreduce=)`` does; without it, it is the
    fused step, as ``populate_step`` is."""
    import jax.numpy as jnp

    from repro.core.population import populate_step as j_step
    from repro_torch.core.population import populate_program, populate_step

    roots = np.array([0, 1, 2, 3, 5, 9], np.int32)
    params = np.tile(np.asarray(world["jplan"].hops[1].params, np.int32), (len(roots), 1))
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    vers = np.zeros(len(roots), np.int32)
    seen = []
    for commit in (None, np.array([1, 0, 1, 1, 0, 1], bool)):
        jc, jok, jab = j_step(
            world["jespec"], world["store"], world["store"], J.empty_cache(world["jespec"].cache),
            world["jttable"], 0, *TPL_META[0], jnp.asarray(roots), jnp.asarray(params),
            jnp.asarray(mask), jnp.asarray(vers),
            commit_mask=None if commit is None else jnp.asarray(commit),
            allreduce=None if commit is None else (lambda x: x))
        args = (world["tespec"], world["tstore"], world["tstore"],
                T.empty_cache(world["tespec"].cache, device="cpu"), world["tttable"], 0,
                *TPL_META[0], torch.as_tensor(roots), torch.as_tensor(params),
                torch.as_tensor(mask), torch.as_tensor(vers))
        tc, tok, tab = _drive(populate_program(
            *args, commit_mask=None if commit is None else torch.as_tensor(commit)),
            lambda x: x)
        if commit is None:
            fused = populate_step(*args)
            assert T.cache_entries(world["tespec"].cache, fused[0]) == \
                T.cache_entries(world["tespec"].cache, tc)
            assert fused[1].tolist() == tok.tolist() and fused[2].tolist() == tab.tolist()
        got = T.cache_entries(world["tespec"].cache, tc)
        assert got == J.cache_entries(world["jespec"].cache, jc)
        assert tok.tolist() == np.asarray(jok).tolist() and tab.tolist() == np.asarray(jab).tolist()
        seen.append({e[1] for e in got})
    assert seen[1] == seen[0] - {1, 5} and seen[1]
