"""Parity: the port's block maintenance against the JAX package.

At the small world of ``tests/conftest.py``, on a partitioned store with
live recent regions and dead lanes (one commit of every section type,
applied by the reference under the named-axis ``jax.vmap`` that
``tests/test_torch_partitioned_grw.py`` uses): ``compact_block`` (per
shard, with and without ``me``) and ``compact_store`` (purge off and on),
``grow_store``, ``abstract_partitioned_store``,
``block_occupancy`` and ``decide_maintenance``, each against the JAX
function; the gated commit at ``recent_fill_frac=0.0`` against the
reference's ``apply_mutations_partitioned`` followed by its
``compact_store``, at 4 and 1 owners, with its one added host read; and
the runtime's ``maintenance_tick``, ``compact_step``, ``grow_blocks`` and
``set_block_capacity``, with reads unchanged.
Every output is an integer, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable
from repro.graphstore import maintenance as JM
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore import partition as JP
from repro.graphstore.mutations import apply_mutations as j_apply
from repro.graphstore.store import compact as j_compact
import repro_torch.core as T
from repro_torch import interop
from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, flat_mesh
from repro_torch.graphstore import make_mutation_batch as t_batch
from repro_torch.graphstore import maintenance as TM
from repro_torch.graphstore import partition as TP
from test_partitioned_store import _PS_AX, _restack
from test_torch_partitioned_grw import _MUTATIONS, tree_equal
from test_torch_sharded import miss_key, to_np


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N = 4
# the gated commit's batch: appends, deletes (one of an edge appended by
# ``_MUTATIONS``), property edits and a vertex delete
_COMMIT = dict(new_edges=[(1, 12, 0, [1]), (2, 13, 0, [0]), (0, 6, 0, [1])],
               del_edges=[3, 17], set_vprops=[(7, 0, 1)], set_eprops=[(1, 0, 0)],
               del_vertices=[10])


def pnp(ps):
    return interop.pstore_to_numpy(ps)


def _j_apply_partitioned(jpspec, jps, jmb):
    """The reference's partitioned commit under a named-axis vmap."""
    fn = jax.vmap(lambda ps, me: JP.apply_mutations_partitioned(jpspec, ps, jmb, me, "sh"),
                  axis_name="sh", in_axes=(_PS_AX, 0))
    jps2_s, _, ovf = fn(JP.stack_blocks(jpspec, jps), jnp.arange(jpspec.n_shards))
    assert int(ovf[0]) == 0
    return _restack(jpspec, jps2_s)


@pytest.fixture(scope="module")
def mw():
    """Both packages' partitioned store after one commit of ``_MUTATIONS``
    (live recent regions, dead lanes), and the single-host store it came
    from."""
    spec, store = build_world()
    jpspec = JP.default_pspec(spec, N)
    jps = _j_apply_partitioned(jpspec, JP.partition_store(jpspec, store),
                               j_batch(spec, **_MUTATIONS))
    jstore, _ = j_apply(spec, store, j_batch(spec, **_MUTATIONS))
    tpspec = TP.default_pspec(interop.store_spec(tuple(spec)), N)
    tps = interop.pstore_from_numpy(to_np(jps), device="cpu")
    assert any(int(b.blk_len[s]) > int(b.csr_len[s]) for b in (tps.out, tps.inc)
               for s in range(N)), "the fixture needs live recent regions"
    EB = tpspec.e_blk_cap
    assert any(not bool(b.alive[s * EB: s * EB + int(b.blk_len[s])].all())
               for b in (tps.out, tps.inc) for s in range(N)), "the fixture needs dead lanes"
    return dict(spec=spec, jpspec=jpspec, jps=jps, tpspec=tpspec, tps=tps, jstore=jstore)


@pytest.mark.parametrize("purge", [False, True])
def test_compact_block_and_store_match_reference(mw, purge):
    """Per shard and orientation ``compact_block`` (``me`` None and the
    shard) equals the reference's; ``compact_store`` equals the
    reference's; without purge it is also
    ``partition_store`` of the host-compacted store, and purge drops
    exactly the dead lanes."""
    tpspec, jpspec = mw["tpspec"], mw["jpspec"]
    for s in range(N):
        tloc = TP.local_shard(tpspec, mw["tps"], s)
        jloc = JP.local_shard(jpspec, mw["jps"], s)
        for side in ("out", "inc"):
            for me in (None, s):
                got = TM.compact_block(tpspec, getattr(tloc, side), purge=purge, me=me)
                want = JM.compact_block(jpspec, getattr(jloc, side), purge=purge, me=me)
                tree_equal({f: getattr(got, f).numpy() for f in got._fields},
                           {f: np.asarray(getattr(want, f)) for f in want._fields},
                           f"shard {s} {side} me={me}")
    got = TM.compact_store(tpspec, mw["tps"], purge=purge)
    tree_equal(pnp(got), to_np(JM.compact_store(jpspec, mw["jps"], purge=purge)), "compact_store")
    assert (got.out.blk_len == got.out.csr_len).all() and (got.inc.blk_len == got.inc.csr_len).all()
    if purge:
        for b0, b1 in ((mw["tps"].out, got.out), (mw["tps"].inc, got.inc)):
            for s in range(N):
                EB = tpspec.e_blk_cap
                live = b0.alive[s * EB: s * EB + int(b0.blk_len[s])]
                assert int(b1.blk_len[s]) == int(live.sum())
    else:
        host = interop.store_from_numpy(to_np(j_compact(mw["spec"], mw["jstore"])), device="cpu")
        tree_equal(pnp(got), pnp(TP.partition_store(tpspec, host)), "partition of compact")


def test_grow_matches_reference(mw):
    """``grow_store`` equals the reference's and ``partition_store`` under
    the grown spec; a shrink raises."""
    tpspec, jpspec = mw["tpspec"], mw["jpspec"]
    NE = tpspec.e_blk_cap + 13
    tnew, tgrown = TM.grow_store(tpspec, mw["tps"], NE, recent_blk_cap=40)
    jnew, jgrown = JM.grow_store(jpspec, mw["jps"], NE, recent_blk_cap=40)
    assert tuple(tnew) == tuple(jnew) and tnew.e_blk_cap == NE
    tree_equal(pnp(tgrown), to_np(jgrown), "grow_store")
    # the grown store of a compacted world is partition_store under the grown spec
    host = interop.store_from_numpy(to_np(j_compact(mw["spec"], mw["jstore"])), device="cpu")
    _, g2 = TM.grow_store(tpspec, TP.partition_store(tpspec, host), NE)
    tree_equal(pnp(g2), pnp(TP.partition_store(tpspec._replace(e_blk_cap=NE), host)),
               "partition under the grown spec")
    with pytest.raises(ValueError, match="only grow"):
        TM.grow_store(tpspec, mw["tps"], tpspec.e_blk_cap - 1)


def test_abstract_store_occupancy_and_decisions_match_reference(mw):
    tpspec, jpspec = mw["tpspec"], mw["jpspec"]
    meta = TP.abstract_partitioned_store(tpspec)
    jabs = JP.abstract_partitioned_store(jpspec)
    for t, j in zip(jax.tree_util.tree_leaves(tuple(meta)), jax.tree_util.tree_leaves(jabs)):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape) and str(t.dtype) == f"torch.{j.dtype}"
    occ = TM.block_occupancy(tpspec, mw["tps"])
    assert occ == JM.block_occupancy(jpspec, mw["jps"])
    assert occ["max_recent_fill"] > 0
    reports = [occ, dict(max_occupancy=0.1, max_recent_fill=0),
               dict(max_occupancy=0.1, max_recent_fill=tpspec.recent_blk_cap // 2),
               dict(max_occupancy=0.9, max_recent_fill=0), dict(max_occupancy=0.85,
                                                                max_recent_fill=7)]
    for policy in (TM.MaintenancePolicy(), TM.MaintenancePolicy(0.1, 5, 0.8, 1.5, True)):
        jpolicy = JM.MaintenancePolicy(*policy)
        for rep in reports:
            for rows in (0, 5, 5000):
                got = TM.decide_maintenance(tpspec, rep, policy, rows)
                assert tuple(got) == tuple(JM.decide_maintenance(jpspec, rep, jpolicy, rows))


def test_compaction_is_read_invisible_only_within_max_deg(mw):
    """Compaction keeps every gather observable only while no root's merged
    CSR degree exceeds ``max_deg``: the truncation flag counts CSR lanes
    alone, so a root whose recent edges push it past ``max_deg`` reads them
    all before compaction and is truncated after. Both packages alike (the
    reference's design); phase 11 on the card holds gated reads equal to an
    uncompacted control, which needs no read root to cross."""
    tpspec, jpspec = mw["tpspec"], mw["jpspec"]
    root = 0  # ``_MUTATIONS`` appends one edge out of watch-list 0
    loc = TP.local_shard(tpspec, mw["tps"], root % N).out
    d0 = int(loc.indptr[root // N + 1] - loc.indptr[root // N])
    assert int(((loc.key == root) & (torch.arange(tpspec.e_blk_cap) >= int(loc.csr_len[0]))).sum()) == 1
    roots = np.array([root, 4, 8], np.int32)  # the other two own no recent edge
    reads = {}
    for tag, tps, jps in (("before", mw["tps"], mw["jps"]),
                          ("after", TM.compact_store(tpspec, mw["tps"]),
                           JM.compact_store(jpspec, mw["jps"]))):
        for max_deg in (d0, d0 + 1):
            tv = TP.BlockStoreView(tpspec, TP.local_shard(tpspec, tps, 0), 0)
            jv = JP.BlockStoreView(jpspec, JP.local_shard(jpspec, jps, 0), 0)
            got = tv.adjacency(torch.as_tensor(roots), max_deg, incoming=False)
            want = jv.adjacency(jnp.asarray(roots), max_deg, incoming=False)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), f"{tag} {max_deg}")
            other, mask, trunc = (x.numpy() for x in got[:3])
            reads[tag, max_deg] = ([other[i][mask[i]].tolist() for i in range(3)], trunc.tolist())
    assert reads["before", d0 + 1] == reads["after", d0 + 1]  # within max_deg: unchanged
    (before, tb), (after, ta) = reads["before", d0], reads["after", d0]
    assert tb[0] is False and ta[0] is True  # past it: truncated after compaction
    # the recent edge's leaf is read before and cut after (dead lanes stay masked)
    assert len(after[0]) < len(before[0]) and after[0] == before[0][:len(after[0])]
    assert before[1:] == after[1:] and tb[1:] == ta[1:]


@pytest.fixture(scope="module")
def gw():
    """The world before the commit, both packages, for the runtime tests."""
    spec, store = build_world()
    jmb = j_batch(spec, **_MUTATIONS)
    jstore, _ = jax.jit(j_apply, static_argnums=0)(spec, store, jmb)
    jttable, _, _ = enabled_ttable()
    from repro.core import CacheSpec, EngineSpec

    jspec = EngineSpec(store=spec, cache=CacheSpec(capacity=1024, probes=8, max_leaves=16,
                                                   max_chunks=2), max_deg=32, frontier=32)
    tspec = interop.engine_spec(tuple(spec), tuple(jspec.cache), 32, 32)
    return dict(spec=spec, jstore=jstore, tspec=tspec,
                tstore=interop.store_from_numpy(to_np(jstore), device="cpu"),
                tttable=interop.ttable_from_numpy(to_np(jttable)),
                plan=interop.plan_from_numpy(to_np(common_watchlist_plan())))


@pytest.mark.parametrize("n", [4, 1])
def test_gated_commit_equals_apply_then_compact(gw, n):
    """``run_grw_tx(gate=DeviceGate(0.0))`` compacts every block (the
    threshold is 0 lanes) and equals the reference's partitioned apply
    followed by its ``compact_store``; it reads the host once more than the
    ungated commit, and its metrics are the ungated commit's but for the
    post-gate recent fill (0) and ``device_compactions`` (2n)."""
    spec = gw["spec"]
    rt = ShardedTxnRuntime(gw["tspec"], flat_mesh(n), route_cap_factor=None, device="cpu")
    ps = rt.partition_store(gw["tstore"])
    cache = rt.empty_cache()
    mb = t_batch(gw["tspec"].store, device="cpu", **_COMMIT)
    gps, _, gm = rt.run_grw_tx(ps, cache, gw["tttable"], mb, gate=TM.DeviceGate(0.0))
    ups, _, um = rt.run_grw_tx(ps, cache, gw["tttable"], mb)
    jpspec = JP.default_pspec(spec, n)
    jps2 = _j_apply_partitioned(jpspec, JP.partition_store(jpspec, gw["jstore"]),
                                j_batch(spec, **_COMMIT))
    tree_equal(pnp(ups), to_np(jps2), "ungated commit")
    tree_equal(pnp(gps), to_np(JM.compact_store(jpspec, jps2)), "gated commit")
    assert gm["device_compactions"] == 2 * n and gm["store_recent_fill_max"] == 0
    assert um["store_recent_fill_max"] > 0 and "device_compactions" not in um
    assert gm["host_syncs"] == um["host_syncs"] + 1
    for k in ("impacted_keys", "op_overflow", "store_append_overflow", "store_occupancy_max"):
        assert gm[k] == um[k], k
    # a gate no block reaches compacts nothing and leaves the commit as is
    hps, _, hm = rt.run_grw_tx(ps, cache, gw["tttable"], mb, gate=TM.DeviceGate(1.0))
    assert hm["device_compactions"] == 0 and hm["host_syncs"] == gm["host_syncs"]
    tree_equal(pnp(hps), pnp(ups), "gate not reached")


def _reads(rt, ps, gw, roots):
    """Cold reads, CP of every miss, warm reads: results, misses, metrics."""
    out = []
    cache = rt.empty_cache()
    drain = ShardedMissDrain(rt, TPL_META)
    for _ in range(2):
        r, miss, m = rt.run_gr_tx_batch(ps, cache, gw["tttable"], gw["plan"], roots)
        m.pop("host_syncs")
        out.append((r.tolist(), miss_key(miss), m))
        drain.push(miss)
        cache = drain.drain(ps, ps, cache, gw["tttable"])
    return out


def test_runtime_maintenance_leaves_reads_unchanged(gw, tmp_path):
    """``maintenance_tick`` grows (occupancy over the policy's high-water
    mark) and compacts (recent fill over its fraction), journaling GROW then
    COMPACT; ``compact_step`` and ``grow_blocks`` equal
    ``compact_store`` / ``grow_store``; reads are unchanged by each step;
    ``set_block_capacity`` adopts a layout too small for the world, which
    ``partition_store`` refuses."""
    from repro_torch.graphstore.journal import REC_COMPACT, REC_GROW, WriteBehindJournal

    rt = ShardedTxnRuntime(gw["tspec"], flat_mesh(N), route_cap_factor=None, device="cpu")
    rt.set_block_capacity(TP.default_pspec(gw["tspec"].store, N, slack=1.0).e_blk_cap)
    ps = rt.partition_store(gw["tstore"])
    pspec0 = rt.pspec
    roots = np.array([5, 6, 7, 8, 10, 11, 0, 3], np.int32)
    want = _reads(rt, ps, gw, roots)

    occ = rt.store_occupancy(ps)
    policy = TM.MaintenancePolicy(recent_fill_frac=0.0,
                                  grow_occupancy_frac=occ["max_occupancy"], growth_factor=1.5)
    j = WriteBehindJournal(str(tmp_path / "j"), N)
    ps2, info = rt.maintenance_tick(ps, policy, journal=j)
    assert info["compacted"] and info["grown_to"] == rt.pspec.e_blk_cap > pspec0.e_blk_cap
    assert [r.rtype for r in j._pending] == [REC_GROW, REC_COMPACT]
    assert rt.mutation_rows_since_compact == 0
    tree_equal(pnp(ps2), pnp(TM.compact_store(rt.pspec, TM.grow_store(
        pspec0, ps, rt.pspec.e_blk_cap)[1])), "tick")
    assert _reads(rt, ps2, gw, roots) == want

    pspec1 = rt.pspec
    ps3 = rt.grow_blocks(ps2, pspec1.e_blk_cap + 7)
    assert rt.pspec == pspec1._replace(e_blk_cap=pspec1.e_blk_cap + 7)
    tree_equal(pnp(ps3), pnp(TM.grow_store(pspec1, ps2, pspec1.e_blk_cap + 7)[1]), "grow_blocks")
    assert _reads(rt, ps3, gw, roots) == want
    tree_equal(pnp(rt.compact_step(True)(ps3)),
               pnp(TM.compact_store(rt.pspec, ps3, purge=True)), "compact_step")
    assert _reads(rt, rt.compact_step(True)(ps3), gw, roots) == want

    # a recorded layout too small for the world: the window stays within
    # the block, and ingest refuses it
    small = ShardedTxnRuntime(gw["tspec"], flat_mesh(N), route_cap_factor=None, device="cpu")
    small.set_block_capacity(8, recent_blk_cap=64)
    assert small.pspec.e_blk_cap == 8 and small.pspec.recent_blk_cap == 8
    with pytest.raises(TP.BlockCapacityError):
        small.partition_store(gw["tstore"])


def test_cp_after_a_tier_swap_reads_the_grown_blocks(gw):
    """A ``ShardedMissDrain`` built before ``grow_blocks`` populates, after it,
    the same entries as one on a runtime that never grew: its CP steps read
    the runtime's block layout at call time, as the reference's do."""
    roots = np.array([5, 6, 7, 8, 10, 11, 0, 3], np.int32)
    runs = []
    for grow in (True, False):
        rt = ShardedTxnRuntime(gw["tspec"], flat_mesh(N), route_cap_factor=None, device="cpu")
        ps = rt.partition_store(gw["tstore"])
        cache, drain = rt.empty_cache(), ShardedMissDrain(rt, TPL_META)
        _, miss, _ = rt.run_gr_tx_batch(ps, cache, gw["tttable"], gw["plan"], roots[:4])
        drain.push(miss)
        cache = drain.drain(ps, ps, cache, gw["tttable"])
        if grow:
            ps = rt.grow_blocks(ps, rt.pspec.e_blk_cap * 2)
        _, miss, _ = rt.run_gr_tx_batch(ps, cache, gw["tttable"], gw["plan"], roots)
        drain.push(miss)
        cache = drain.drain(ps, ps, cache, gw["tttable"])
        runs.append(T.cache_entries(gw["tspec"].cache, cache))
    assert runs[0] == runs[1] and len(runs[0]) > 0
