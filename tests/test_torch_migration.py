"""The port's migration tier against the reference's.

- **The splice**: ``migrate_vertex_rows`` on the port's 4-shard store (live
  recent regions, tombstoned rows) equals the reference's numpy function
  applied to the same arrays through ``interop``, byte for byte, for a
  single move, a round of moves, a vertex moved twice in one round, a
  move to the shard that holds it already and a round that moves home;
  a destination too full raises ``BlockCapacityError`` with the same
  ``needed``; the caller's store is left as it was.
- **The readers**: ``infer_storage_exceptions`` and ``vertex_row_counts``
  on every migrated store, ``HotSetTracker`` over a scripted stream and
  ``select_migrations`` on the reference's cases and more (cooldown,
  headroom, table room) equal the reference's.
- **The engine**: it defers during an outage (no record, no move), then
  journals before it moves, in both packages with the same moves,
  metrics and MIGRATE payload bytes.
- **The runtime** (the twin of ``tests/test_routing_runtime.py``'s
  MIGRATION script on 4 owners, without its recompile pins): after a
  journal-first round, reads equal the JAX single-host engine; a commit
  appends the migrated vertices' edges at their table owners; replay from
  the pre-migration checkpoint rebuilds the live store byte for byte and
  reads alike.
- **A crash at each point of the protocol** (the twin of
  ``tests/test_migration_failover.py``): before the record, a torn
  record, after it with and without the splice and the table, and after
  later traffic: replay gives the pre- or the post-migration store,
  never a mix.
- **Away, edit, home**: a vertex moved away, edited, and moved home reads
  as the single-host engine and a fresh execution do (the reference
  serves stale entries there, as ``tests/reference_stale_home.py`` shows;
  the port drops the moved vertex's entries at its old cache home, so it
  misses them once more).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.distributed.routing as JR
import repro.graphstore.migration as JM
from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable
from repro.core.population import CachePopulator as JPopulator
from repro.graphstore import WriteBehindJournal as JJournal
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore.journal import REC_MIGRATE
from repro.graphstore.mutations import apply_mutations as j_apply
from repro.graphstore.partition import EdgeBlock as JEdgeBlock
from repro.graphstore.partition import PartitionedGraphStore as JPStore
import repro_torch.core as T
import repro_torch.graphstore.migration as TM
from repro_torch import interop
from repro_torch.checkpoint import tree_leaves
from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, flat_mesh
from repro_torch.distributed.routing import RoutingTableHost
from repro_torch.graphstore import BlockCapacityError, WriteBehindJournal, make_mutation_batch, \
    replay
from test_torch_partitioned_grw import tree_equal
from test_torch_sharded import miss_key, to_np

N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_pstore(d):
    blk = lambda b: JEdgeBlock(**b)
    return JPStore(**{f: blk(d[f]) if f in ("out", "inc") else d[f] for f in JPStore._fields})


def _store_bytes(ps):
    return [t.clone() for t in tree_leaves(ps)]


def _assert_bytes(got, want, tag):
    assert len(got) == len(want), tag
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), tag


@pytest.fixture(scope="module")
def world():
    spec, store = build_world()
    # live recent regions and tombstoned rows: appends, a delete, a dead vertex
    mb = j_batch(spec, new_edges=[(0, 11, 0, [1]), (5, 6, 0, [1]), (1, 7, 0, [1])],
                 del_edges=[2, 9], del_vertices=[13])
    mstore, _ = jax.jit(j_apply, static_argnums=0)(spec, store, mb)
    cspec = J.CacheSpec(capacity=1024, probes=8, max_leaves=16, max_chunks=2)
    jespec = J.EngineSpec(store=spec, cache=cspec, max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    plan = common_watchlist_plan()
    tespec = interop.engine_spec(tuple(spec), tuple(cspec), 32, 32)
    rt = ShardedTxnRuntime(tespec, flat_mesh(N), route_cap_factor=None, device="cpu")
    return dict(spec=spec, store=store, mstore=mstore, jespec=jespec, jttable=jttable,
                jplan=plan, engine=J.GraphEngine(jespec, plan, True, fused=True),
                tspec=interop.store_spec(tuple(spec)), tespec=tespec, pspec=rt.pspec,
                tstore=interop.store_from_numpy(to_np(store), device="cpu"),
                mps=rt.partition_store(interop.store_from_numpy(to_np(mstore), device="cpu")),
                tttable=interop.ttable_from_numpy(to_np(jttable)),
                tplan=interop.plan_from_numpy(to_np(plan)))


def _reference_migrate(pspec, ps, moves):
    return interop.pstore_from_numpy(
        to_np(JM.migrate_vertex_rows(pspec, _j_pstore(interop.pstore_to_numpy(ps)), moves)),
        device="cpu")


# --------------------------------------------------------------- the splice
ROUNDS = {
    "single": [[(0, 2)]],
    "round": [[(0, 3), (5, 2), (6, 0), (13, 0)]],
    "twice_in_a_round": [[(1, 2), (1, 3)]],
    "already_there": [[(4, 0), (6, 1)]],
    "away_and_home": [[(0, 2), (5, 0), (11, 1)], [(0, 0), (5, 1), (11, 0)]],
}


@pytest.mark.parametrize("name", list(ROUNDS))
def test_migrate_vertex_rows_matches_reference(world, name):
    pspec, ps = world["pspec"], world["mps"]
    before = interop.pstore_to_numpy(ps)
    vids = np.arange(pspec.base.v_cap)
    for moves in ROUNDS[name]:
        got = TM.migrate_vertex_rows(pspec, ps, moves)
        want = _reference_migrate(pspec, ps, moves)
        tree_equal(interop.pstore_to_numpy(got), interop.pstore_to_numpy(want))
        jps = _j_pstore(interop.pstore_to_numpy(got))
        assert TM.infer_storage_exceptions(pspec, got) == JM.infer_storage_exceptions(pspec, jps)
        np.testing.assert_array_equal(TM.vertex_row_counts(pspec, got, vids),
                                      JM.vertex_row_counts(pspec, jps, vids))
        ps = got
    tree_equal(interop.pstore_to_numpy(world["mps"]), before)  # functional
    want_exc = {"single": {0: 2}, "round": {0: 3, 5: 2, 6: 0, 13: 0}, "twice_in_a_round": {1: 3},
                "already_there": {6: 1}, "away_and_home": {11: 0}}[name]
    assert TM.infer_storage_exceptions(pspec, ps) == want_exc
    assert TM.vertex_row_counts(pspec, ps, [0, 5, 0, 99]).tolist() == \
        JM.vertex_row_counts(pspec, _j_pstore(interop.pstore_to_numpy(ps)), [0, 5, 0, 99]).tolist()


def test_a_full_destination_raises_as_the_reference(world):
    rt = ShardedTxnRuntime(world["tespec"], flat_mesh(N), route_cap_factor=None, device="cpu")
    ps = rt.partition_store(world["tstore"])
    longest = int(max(ps.out.blk_len.max(), ps.inc.blk_len.max()))
    rt.set_block_capacity(longest)
    ps = rt.partition_store(world["tstore"])
    full = int(ps.out.blk_len.argmax())
    vid = next(v for v in range(16) if v % N != full and int(
        TM.vertex_row_counts(rt.pspec, ps, [v])[0]))
    errs = []
    for fn in (lambda: TM.migrate_vertex_rows(rt.pspec, ps, [(vid, full)]),
               lambda: JM.migrate_vertex_rows(rt.pspec, _j_pstore(interop.pstore_to_numpy(ps)),
                                              [(vid, full)])):
        with pytest.raises(ValueError) as e:
            fn()
        assert type(e.value).__name__ == "BlockCapacityError"
        errs.append((str(e.value), e.value.needed))
    assert errs[0] == errs[1]
    assert isinstance(BlockCapacityError("x", 1), ValueError)


# -------------------------------------------------------------- the readers
def test_hot_set_tracker_matches_reference():
    stream = [[7, 7, 7, 2], [2, 2, 2, 2], [1, 3, 4], [-1, 5, 5, 9, 9, 9], [4] * 6]
    trackers = (TM.HotSetTracker(decay=0.5, cap=3), JM.HotSetTracker(decay=0.5, cap=3),
                TM.HotSetTracker(), JM.HotSetTracker())
    for roots in stream:
        for tr in trackers:
            tr.observe(np.asarray(roots))
        for t, j in (trackers[:2], trackers[2:]):
            assert t.hottest(10) == j.hottest(10)
            assert [t.heat(v) for v in range(-1, 10)] == [j.heat(v) for v in range(-1, 10)]
            assert t.total_heat() == j.total_heat()


def _select_cases(world):
    hot0 = [0] * 50
    return {
        "balanced": (dict(), hot0, [10, 10, 10, 10], {}, ()),
        "skewed": (dict(), hot0, [40, 10, 10, 5], {}, ()),
        "zero_load": (dict(), hot0, [0, 0, 0, 0], {}, ()),
        "cooldown": (dict(), hot0 + [4] * 30, [40, 10, 10, 5], {}, (0,)),
        "spread": (dict(max_moves_per_round=3, load_share_trigger=1.0),
                   [0] * 20 + [4] * 18 + [8] * 15 + [12] * 3, [60, 10, 10, 5], {}, ()),
        "no_headroom": (dict(dst_recent_headroom_frac=0.0), hot0, [40, 10, 10, 5], {}, ()),
        "moved_already": (dict(), hot0 + [4] * 40, [40, 10, 10, 5], {0: 2}, ()),
        "full_table": (dict(), hot0, [40, 10, 10, 5], {9: 2}, ()),
    }


@pytest.mark.parametrize("case", ["balanced", "skewed", "zero_load", "cooldown", "spread",
                                  "no_headroom", "moved_already", "full_table"])
def test_select_migrations_matches_reference(world, case):
    kw, heat, rows, exc, cooldown = _select_cases(world)[case]
    pspec, ps = world["pspec"], world["mps"]
    jps = _j_pstore(interop.pstore_to_numpy(ps))
    cap = 1 if case == "full_table" else 64
    out = []
    for pkg in ("t", "j"):
        M = TM if pkg == "t" else JM
        rh = RoutingTableHost(N, cap=cap, device="cpu") if pkg == "t" else JR.RoutingTableHost(
            N, cap=cap)
        rh.apply_moves(sorted(exc.items()))
        tr = M.HotSetTracker()
        tr.observe(np.asarray(heat))
        out.append(M.select_migrations(M.MigrationPolicy(**kw), tr, rh, pspec,
                                       ps if pkg == "t" else jps, rows, cooldown=cooldown))
    assert out[0] == out[1]
    if case in ("skewed", "spread"):
        assert out[0], case


class _Detector:
    def __init__(self, down):
        self.down = np.asarray(down, bool)

    def down_mask(self):
        return self.down


def test_engine_defers_in_an_outage_then_journals_before_it_moves(world, tmp_path):
    pspec, ps = world["pspec"], world["mps"]
    jps = _j_pstore(interop.pstore_to_numpy(ps))
    seen = {}
    for pkg in ("t", "j"):
        M, Journal = (TM, WriteBehindJournal) if pkg == "t" else (JM, JJournal)
        j = Journal(str(tmp_path / pkg), N)
        rh = RoutingTableHost(N, device="cpu") if pkg == "t" else JR.RoutingTableHost(N)
        eng = M.MigrationEngine(pspec, rh, journal=j, detector=_Detector([0, 1, 0, 0]))
        eng.observe([0] * 50 + [4] * 20)
        p0 = ps if pkg == "t" else jps
        p1, moves = eng.step(p0, [40, 10, 10, 5])
        assert p1 is p0 and moves == [] and eng.deferred_rounds == 1
        assert not rh.has_exceptions() and j.read_records() == [] and not j._pending
        eng.detector = _Detector([0] * N)
        p2, moves = eng.step(p1, [40, 10, 10, 5])
        j.flush()
        recs = [r for r in j.read_records() if r.rtype == REC_MIGRATE]
        seen[pkg] = (moves, eng.metrics(), [r.payload for r in recs], rh.storage_exceptions,
                     M.infer_storage_exceptions(pspec, p2))
    assert seen["t"] == seen["j"]
    moves, metrics, payloads, exc, inferred = seen["t"]
    assert moves and exc == inferred == dict(moves) and len(payloads) == 1
    assert metrics["migration_rounds"] == 1 and metrics["migrated_rows"] > 0
    assert json.loads(payloads[0]) == {"moves": [list(m) for m in moves], "epoch": None}


# ------------------------------------------------------------- the runtime
ROOTS = np.array([0, 3, 5, 6, 7, 11], np.int32)


def _checkpoint(j, rt, ps):
    j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                 store_version=int(ps.version))


def test_migration_preserves_reads_and_replays_byte_for_byte(world, tmp_path):
    espec, ttable, plan = world["tespec"], world["tttable"], world["tplan"]
    cspec = world["jespec"].cache
    rt = ShardedTxnRuntime(espec, flat_mesh(N), route_cap_factor=None, device="cpu")
    ps = rt.partition_store(world["tstore"])
    rhost = rt.attach_routing(RoutingTableHost(N, device="cpu"))
    j = WriteBehindJournal(str(tmp_path / "journal"), N)
    _checkpoint(j, rt, ps)
    eng = TM.MigrationEngine(rt.pspec, rhost, journal=j)
    moves = [(0, 3), (5, 2)]  # native owners 0 and 1: both real moves
    assert all(int(c) > 0 for c in TM.vertex_row_counts(rt.pspec, ps, [0, 5]))
    ps, got = eng.apply(ps, moves)
    assert got == moves and rhost.storage_exceptions == dict(moves) == \
        TM.infer_storage_exceptions(rt.pspec, ps)

    # reads after the move: migrated roots route away from their base
    # owner and never defer (their cache home follows the rows)
    res_h, miss_h, met_h = world["engine"].run(world["store"], J.empty_cache(cspec),
                                               world["jttable"], ROOTS)
    res_m, miss_m, met_m, d = rt.run_gr_tx_batch(ps, rt.empty_cache(), ttable, plan, ROOTS,
                                                 return_deferred=True)
    np.testing.assert_array_equal(res_m, np.asarray(res_h))
    assert miss_key(miss_m) == miss_key(miss_h) and not d.any()
    assert {k: met_m[k] for k in met_h if k != "host_syncs"} == \
        {k: v for k, v in met_h.items() if k != "host_syncs"}
    assert met_m["locality_routed"] > 0 and met_m["locality_retry_rows"] == 0

    # a commit after the move: the migrated vertices' new edges land at
    # their table owners, and the journal marks those owners dirty
    ne = [(5, 12, 0, [1]), (0, 11, 0, [0])]
    mb = make_mutation_batch(world["tspec"], new_edges=ne, set_vprops=[(7, 0, 1)],
                             del_edges=[2], device="cpu")
    st_h, _, m_h = J.run_grw_tx(world["jespec"], world["store"], J.empty_cache(cspec),
                                world["jttable"], j_batch(world["spec"], new_edges=ne,
                                                          set_vprops=[(7, 0, 1)], del_edges=[2]))
    ps2, cs2, m_s = rt.run_grw_tx(ps, rt.empty_cache(), ttable, mb, journal=j)
    assert m_s["op_overflow"] == m_s["store_append_overflow"] == 0
    assert m_h["impacted_keys"] == m_s["impacted_keys"]
    assert TM.infer_storage_exceptions(rt.pspec, ps2) == dict(moves)
    res2_h, miss2_h, _ = world["engine"].run(st_h, J.empty_cache(cspec), world["jttable"], ROOTS)
    res2, miss2, _ = rt.run_gr_tx_batch(ps2, rt.empty_cache(), ttable, plan, ROOTS)
    np.testing.assert_array_equal(res2, np.asarray(res2_h))
    assert miss_key(miss2) == miss_key(miss2_h)
    j.flush()

    # a crash: replay from the pre-migration checkpoint on a fresh runtime
    rt2 = ShardedTxnRuntime(espec, flat_mesh(N), route_cap_factor=None, device="cpu")
    ps_r, _, info = replay(WriteBehindJournal(str(tmp_path / "journal"), N), rt2, ttable)
    assert info["replayed_migrations"] == 1 and info["replayed_commits"] == 1
    _assert_bytes(_store_bytes(ps_r), _store_bytes(ps2), "replayed store")
    assert rt2.rhost is not None and rt2.rhost.storage_exceptions == dict(moves)
    res3, miss3, _ = rt2.run_gr_tx_batch(ps_r, rt2.empty_cache(), ttable, plan, ROOTS)
    np.testing.assert_array_equal(res3, np.asarray(res2_h))
    assert miss_key(miss3) == miss_key(miss2_h)


def test_a_crash_at_each_point_recovers_pre_or_post_never_torn(world, tmp_path):
    espec, ttable = world["tespec"], world["tttable"]
    mk = lambda: ShardedTxnRuntime(espec, flat_mesh(N), route_cap_factor=None, device="cpu")
    rt = mk()
    ps = rt.partition_store(world["tstore"])
    rhost = rt.attach_routing(RoutingTableHost(N, device="cpu"))
    live = tmp_path / "live"
    j = WriteBehindJournal(str(live), N)
    _checkpoint(j, rt, ps)
    batch = lambda **kw: make_mutation_batch(world["tspec"], device="cpu", **kw)
    ps, _, _ = rt.run_grw_tx(ps, rt.empty_cache(), ttable,
                             batch(new_edges=[(1, 12, 0, [1])], set_vprops=[(7, 0, 1)]),
                             journal=j)
    j.flush()
    pre, ps_pre = _store_bytes(ps), ps
    snap = lambda tag: shutil.copytree(live, tmp_path / tag)
    snap("p0")
    len_p0 = os.path.getsize(j.log_path)
    # the round, journal first (MigrationEngine.apply's order)
    moves = [(0, 3), (5, 2)]
    j.append_migrate(moves)
    j.flush()
    snap("p1")
    len_p1 = os.path.getsize(j.log_path)
    ps = TM.migrate_vertex_rows(rt.pspec, ps, moves)
    snap("p2")
    rhost.apply_moves(moves)
    snap("p3")
    post = _store_bytes(ps)
    tree_equal(interop.pstore_to_numpy(ps),
               interop.pstore_to_numpy(_reference_migrate(rt.pspec, ps_pre, moves)))
    ps, _, _ = rt.run_grw_tx(ps, rt.empty_cache(), ttable,
                             batch(new_edges=[(5, 11, 0, [0])], del_edges=[2]), journal=j)
    j.flush()
    snap("p4")
    final = _store_bytes(ps)
    torn = tmp_path / "torn"
    shutil.copytree(tmp_path / "p1", torn)
    with open(torn / os.path.basename(j.log_path), "r+b") as f:
        f.truncate(len_p0 + (len_p1 - len_p0) // 2)
    for tag, want, n_migr, n_commits in (("p0", pre, 0, 1), ("torn", pre, 0, 1),
                                         ("p1", post, 1, 1), ("p2", post, 1, 1),
                                         ("p3", post, 1, 1), ("p4", final, 1, 2)):
        ps_r, _, info = replay(WriteBehindJournal(str(tmp_path / tag), N), mk(), ttable)
        assert (info["replayed_migrations"], info["replayed_commits"]) == (n_migr, n_commits), tag
        _assert_bytes(_store_bytes(ps_r), want, tag)


def test_away_edit_home_reads_as_the_single_host(world, tmp_path):
    """The reference's stale read: a vertex moved away, edited (two of its
    out-edges deleted) and moved home. The port drops the vertex's entries
    at its old cache home in each round, so the batch after the move home
    equals the single-host engine and a fresh execution; it misses what the
    drop took and the edit did not."""
    espec, ttable, plan, cspec = world["tespec"], world["tttable"], world["tplan"], \
        world["jespec"].cache
    roots = np.arange(16, dtype=np.int32)
    rt = ShardedTxnRuntime(espec, flat_mesh(N), route_cap_factor=None, device="cpu")
    ps, cache = rt.partition_store(world["tstore"]), rt.empty_cache()
    rhost = rt.attach_routing(RoutingTableHost(N, device="cpu"))
    eng = TM.MigrationEngine(rt.pspec, rhost)
    store_h, cache_h = world["store"], J.empty_cache(cspec)
    pop_h = JPopulator(world["jespec"], TPL_META)
    drain = ShardedMissDrain(rt, TPL_META)
    # warm both caches with one drain
    _, miss_h, _ = world["engine"].run(store_h, cache_h, world["jttable"], roots)
    pop_h.queue.push(miss_h)
    cache_h = pop_h.drain(store_h, store_h, cache_h, world["jttable"])
    _, miss, _ = rt.run_gr_tx_batch(ps, cache, ttable, plan, roots)
    drain.push(miss)
    cache = drain.drain(ps, ps, cache, ttable)
    assert T.cache_entries(espec.cache, cache) == J.cache_entries(cspec, cache_h)
    Cloc = espec.cache.capacity // N
    at_home = lambda c: int((c.valid & (c.root == 1))[Cloc:2 * Cloc].sum())  # owner 1's block
    had = at_home(cache)
    assert had > 0
    # away: vertex 1's rows go to owner 2, its entries at owner 1 are dropped
    ps, cache, _ = eng.apply(ps, [(1, 2)], cache=cache)
    assert at_home(cache) == 0 and int(cache.n_delete) == had
    # the edit, at vertex 1's table owner
    mb = dict(del_edges=[7, 8])
    store_h, cache_h, _ = J.run_grw_tx(world["jespec"], store_h, cache_h, world["jttable"],
                                       j_batch(world["spec"], **mb))
    ps, cache, _ = rt.run_grw_tx(ps, cache, ttable,
                                 make_mutation_batch(world["tspec"], device="cpu", **mb))
    # home: nothing of vertex 1 was left at owner 1 to serve stale
    ps, cache, _ = eng.apply(ps, [(1, 1)], cache=cache)
    assert not rhost.has_exceptions() and TM.infer_storage_exceptions(rt.pspec, ps) == {}
    res_h, miss_h, met_h = world["engine"].run(store_h, cache_h, world["jttable"], roots)
    res, miss, met = rt.run_gr_tx_batch(ps, cache, ttable, plan, roots)
    np.testing.assert_array_equal(res, np.asarray(res_h))
    # the misses are the single host's plus vertex 1's entries the round
    # dropped that the edit left valid (here its SQ2 entry): a move drops
    # the vertex's entries, it does not carry them
    extra = list(miss_key(miss))
    for k in miss_key(miss_h):
        extra.remove(k)
    assert extra and all(k[1] == 1 for k in extra)
    assert met["hits"] == met_h["hits"] - len(extra)
    # and it equals a fresh execution: the cache-off single host
    res_f, _, _ = J.GraphEngine(world["jespec"], world["jplan"], False, fused=True).run(
        store_h, J.empty_cache(cspec), world["jttable"], roots)
    np.testing.assert_array_equal(res, np.asarray(res_f))
