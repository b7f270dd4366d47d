"""Parity: the gRW-Tx commit on the port's partitioned tier.

At the small sizes of ``tests/test_torch_sharded.py``, against the JAX
package on the same inputs: the geid index (``rebuild_geid_index``,
``sorted_geid_view``, ``geid_slot_lookup``); ``apply_mutations_partitioned``
run on a ``LocalMesh`` against the reference under a named-axis
``jax.vmap`` (as ``tests/test_partitioned_store.py`` runs it), against
``partition_store`` of the single-host post-state, and leaving its
pre-state as it was; the ownership-gated listener under both policies;
the mesh's ``ALL_GATHER`` and ``ALL_REDUCE_MAX``; and ``ShardedTxnRuntime.run_grw_tx``
at 4 and 1 owners under both policies against the JAX single host, then
reads through the plain ``block_gather`` on the committed state. Integer
outputs throughout, so every comparison is exact.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.invalidation as JI
from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable
from repro.core.population import CachePopulator as JPopulator
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore import partition as JP
from repro.graphstore.mutations import apply_mutations as j_apply
import repro_torch.core as T
import repro_torch.core.invalidation as TI
from repro_torch import interop
from repro_torch.distributed import (
    ALL_GATHER,
    ALL_REDUCE_MAX,
    ShardedMissDrain,
    ShardedTxnRuntime,
    flat_mesh,
)
from repro_torch.graphstore import apply_mutations as t_apply, make_mutation_batch as t_batch
from repro_torch.graphstore import partition as TP
from test_partitioned_store import _PS_AX, _restack
from test_torch_sharded import miss_key, to_np
from test_torch_fixtures import _torch_test_env  # noqa: F401


N = 4
# every section type, on the rows and edges the world has
_MUTATIONS = dict(
    new_vertices=[(1, [0, 1007])],
    new_edges=[(0, 11, 0, [1]), (2, 16, 0, [0]), (3, 5, 0, [1])],
    del_edges=[2, 5], del_vertices=[9],
    set_vprops=[(7, 0, 1), (8, 0, 0), (12, 1, 4242)], set_eprops=[(1, 0, 0), (4, 0, 1)],
)
# a commit on the state ``pw`` builds (whose edges 2 and 5 are dead)
_COMMIT = dict(set_vprops=[(7, 0, 1), (8, 0, 0)], del_edges=[3],
               new_edges=[(0, 11, 0, [1]), (3, 6, 0, [0])], del_vertices=[10],
               set_eprops=[(1, 0, 1)])


def tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            tree_equal(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def pstore_np(ps):
    return interop.pstore_to_numpy(ps)


@pytest.fixture(scope="module")
def pw():
    """The world after one commit (live recent regions, dead lanes), both
    packages, with the port's partition of it."""
    spec, store = build_world()
    mb = j_batch(spec, **_MUTATIONS)
    jstore, _ = jax.jit(j_apply, static_argnums=0)(spec, store, mb)
    jspec = J.EngineSpec(store=spec, cache=J.CacheSpec(capacity=1024, probes=8, max_leaves=16,
                                                        max_chunks=2), max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    tspec = interop.engine_spec(tuple(spec), tuple(jspec.cache), 32, 32)
    tstore = interop.store_from_numpy(to_np(jstore), device="cpu")
    tpspec = TP.default_pspec(tspec.store, N)
    return dict(
        spec=spec, jspec=jspec, jstore=jstore, jttable=jttable, tspec=tspec, tstore=tstore,
        tttable=interop.ttable_from_numpy(to_np(jttable)), tpspec=tpspec,
        jpspec=JP.default_pspec(spec, N), tps=TP.partition_store(tpspec, tstore),
        plan=common_watchlist_plan(),
    )


def test_geid_index_matches_reference(pw):
    jps = JP.partition_store(pw["jpspec"], pw["jstore"])
    EB = pw["tpspec"].e_blk_cap
    eids = np.arange(-2, int(pw["jstore"].e_len) + 3, dtype=np.int32)
    probes = 0
    for s in range(N):
        for side in ("out", "inc"):
            tb = getattr(TP.local_shard(pw["tpspec"], pw["tps"], s), side)
            jb = getattr(JP.local_shard(pw["jpspec"], jps, s), side)
            perm = TP.rebuild_geid_index(tb.blk_len[0], tb.geid)
            np.testing.assert_array_equal(perm.numpy(), np.asarray(
                JP.rebuild_geid_index(jb.blk_len[0], jb.geid)))
            np.testing.assert_array_equal(perm.numpy(), tb.gperm.numpy())
            skey = TP.sorted_geid_view(EB, tb.geid, tb.gperm, tb.blk_len[0])
            np.testing.assert_array_equal(skey.numpy(), np.asarray(
                JP.sorted_geid_view(EB, jb.geid, jb.gperm, jb.blk_len[0])))
            slot, found = TP.geid_slot_lookup(EB, tb.geid, tb.gperm, tb.blk_len[0],
                                              torch.as_tensor(eids))
            jslot, jfound = JP.geid_slot_lookup(EB, jb.geid, jb.gperm, jb.blk_len[0], eids)
            np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
            np.testing.assert_array_equal(slot.numpy()[found.numpy()],
                                          np.asarray(jslot)[np.asarray(jfound)])
            assert torch.equal(tb.geid[slot[found].long()], torch.as_tensor(eids)[found])
            probes += int(found.sum())
    assert probes == 2 * int(pw["jstore"].e_len)  # each edge once per orientation


def _run_partitioned_apply(pspec, ps, mb):
    mesh = flat_mesh(pspec.n_shards)
    outs = mesh.run([TP.apply_mutations_partitioned(pspec, TP.local_shard(pspec, ps, me), mb, me)
                     for me in range(pspec.n_shards)])
    return TP.join_shards([o[0] for o in outs]), [o[1] for o in outs], outs[0][2]


def test_apply_mutations_partitioned_matches_reference(pw):
    """Run on a LocalMesh, the commit equals the reference's under a
    named-axis vmap (blocks, replicated tier, the AppliedMutations of every
    rank, the overflow), and ``partition_store`` of the single-host
    post-state; the pre-state and the store it was split from are left
    bit for bit as they were."""
    spec, tpspec, jpspec = pw["spec"], pw["tpspec"], pw["jpspec"]
    tps = pw["tps"]
    before = (pstore_np(tps), interop.store_to_numpy(pw["tstore"]))
    jmb = j_batch(spec, **_MUTATIONS)
    jps = JP.partition_store(jpspec, pw["jstore"])
    fn = jax.vmap(lambda ps, me: JP.apply_mutations_partitioned(jpspec, ps, jmb, me, "sh"),
                  axis_name="sh", in_axes=(_PS_AX, 0))
    jps2_s, japplied_s, jovf = fn(JP.stack_blocks(jpspec, jps), jnp.arange(N))
    jps2 = _restack(jpspec, jps2_s)

    tmb = t_batch(tpspec.base, device="cpu", **_MUTATIONS)
    tps2, tapplied, tovf = _run_partitioned_apply(tpspec, tps, tmb)
    assert int(tovf) == int(jovf[0]) == 0
    tree_equal(pstore_np(tps2), to_np(jps2), "post-state")
    for s, ta in enumerate(tapplied):
        for f in ta._fields:
            if f != "batch":
                np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                              np.asarray(getattr(japplied_s, f))[s],
                                              err_msg=f"applied.{f} rank {s}")
    ts2, _ = t_apply(tpspec.base, pw["tstore"], tmb)
    tree_equal(pstore_np(tps2), pstore_np(TP.partition_store(tpspec, ts2)), "partition")
    # the ranks wrote copies: neither the views they were given nor the
    # single-host store the blocks were split from changed
    tree_equal(pstore_np(tps), before[0], "pre-state")
    tree_equal(interop.store_to_numpy(pw["tstore"]), before[1], "single-host store")
    assert int(tps2.out.blk_len.sum()) == int(tps.out.blk_len.sum()) + 3


def _op_rows(ops):
    ok = np.asarray(ops.ok)
    cols = [np.asarray(c)[ok] for c in (ops.order, ops.kind, ops.tpl, ops.root, ops.vid)]
    params = np.asarray(ops.params)[ok]
    return [tuple(int(c[i]) for c in cols) + (tuple(params[i].tolist()),)
            for i in range(len(cols[0]))]


def _key_sequences(rows):
    out = {}
    for (_, kind, tpl, root, vid, params) in sorted(rows):
        out.setdefault((tpl, root, params), []).append((kind, vid))
    return out


def _sweeps(sw):
    ok = np.asarray(sw.ok)
    return Counter(zip(np.asarray(sw.tpl)[ok].tolist(), np.asarray(sw.root)[ok].tolist()))


@pytest.mark.parametrize("through", [False, True])
def test_ownership_gated_listener_partitions_emissions(pw, through):
    """Each shard's listener over its pre/post blocks emits a part of the
    reference's single-host stream; together they emit its multiset (ops
    and sweeps), and their order keys restore its per-key sequences."""
    spec, tpspec = pw["spec"], pw["tpspec"]
    jmb = j_batch(spec, **_COMMIT)
    js2, japplied = j_apply(spec, pw["jstore"], jmb)
    jops, jsw = JI.derive_cache_ops(pw["jspec"], pw["jstore"], js2, pw["jttable"], japplied,
                                    through=through)
    want = _op_rows(jops)
    tmb = t_batch(tpspec.base, device="cpu", **_COMMIT)
    tps2, tapplied, _ = _run_partitioned_apply(tpspec, pw["tps"], tmb)
    rows, sweeps = [], Counter()
    for s in range(N):
        views = [TP.BlockStoreView(tpspec, TP.local_shard(tpspec, ps, s), s)
                 for ps in (pw["tps"], tps2)]
        ops, sw = TI.derive_cache_ops_views(pw["tspec"], *views, pw["tttable"], tapplied[s],
                                            through=through)
        mine = _op_rows(ops)
        assert Counter(r[1:] for r in mine) <= Counter(r[1:] for r in want), f"shard {s}"
        rows += mine
        sweeps += _sweeps(sw)
    assert Counter(r[1:] for r in rows) == Counter(r[1:] for r in want)
    assert sweeps == _sweeps(jsw)
    assert _key_sequences(rows) == _key_sequences(want)
    assert any(r[1] != TI.OP_DELETE for r in rows) == through


def test_mesh_all_gather_and_all_reduce_max_are_exact():
    mesh = flat_mesh(3)

    def rank(r):
        rows = torch.arange(4, dtype=torch.int32).reshape(2, 2) + 10 * r
        g = yield (ALL_GATHER, rows)
        m = yield (ALL_REDUCE_MAX, torch.tensor([r, -r, 2**31 - 1 - r], dtype=torch.int32))
        return g, m

    outs = mesh.run([rank(r) for r in range(3)])
    want = torch.cat([torch.arange(4, dtype=torch.int32).reshape(2, 2) + 10 * r for r in range(3)])
    for g, m in outs:
        assert torch.equal(g, want)
        assert m.tolist() == [2, 0, 2**31 - 1] and m.dtype == torch.int32
    assert mesh.counts[ALL_GATHER] == 1 and mesh.counts[ALL_REDUCE_MAX] == 1


@pytest.fixture(scope="module")
def warm(pw):
    """Every SQ1 / SQ2 key of the world's watch-lists and listings, as miss
    records, and the reference's single-host cache populated from them."""
    M = -(2**31) + 1
    ver = int(pw["jstore"].version)
    keys = [(0, r, [a, M, M, s, M, M]) for r in range(4) for a in (0, 1) for s in (0, 1)]
    keys += [(1, r, [a, M, M, M, M, M]) for r in range(4, 16) for a in (0, 1)]
    jm = [J.MissRecord(t, r, np.array(p, np.int32), ver) for t, r, p in keys]
    tm = [T.MissRecord(t, r, np.array(p, np.int32), ver) for t, r, p in keys]
    pop = JPopulator(pw["jspec"], TPL_META)
    pop.queue.push(jm)
    jcache = pop.drain(pw["jstore"], pw["jstore"], J.empty_cache(pw["jspec"].cache), pw["jttable"])
    assert int(jcache.n_evict) == 0
    return dict(jcache=jcache, tm=tm, committed=pop.committed,
                engine=J.GraphEngine(pw["jspec"], pw["plan"], True, fused=True))


@pytest.mark.parametrize("policy", ["write-around", "write-through"])
@pytest.mark.parametrize("n", [4, 1])
def test_partitioned_grw_matches_single_host(pw, warm, n, policy):
    """``ShardedTxnRuntime.run_grw_tx`` against the JAX single host after
    both populated the same keys: ``impacted_keys``, the store (equal to
    ``partition_store`` of the single host's), the cache entries; then the
    same gR batch on both committed states, the partitioned misses through
    the plain ``block_gather``."""
    tspec, spec = pw["tspec"], pw["spec"]
    rt = ShardedTxnRuntime(tspec, flat_mesh(n), route_cap_factor=None, device="cpu")
    pstore = rt.partition_store(pw["tstore"])
    drain = ShardedMissDrain(rt, TPL_META)
    drain.push(warm["tm"])
    pcache = drain.drain(pstore, pstore, rt.empty_cache(), pw["tttable"])
    assert drain.committed == warm["committed"] and int(pcache.n_evict) == 0
    assert T.cache_entries(tspec.cache, pcache) == J.cache_entries(pw["jspec"].cache,
                                                                   warm["jcache"])

    js2, jc2, jm = J.run_grw_tx(pw["jspec"], pw["jstore"], warm["jcache"], pw["jttable"],
                                j_batch(spec, **_COMMIT), policy=policy)
    ps2, pc2, m = rt.run_grw_tx(pstore, pcache, pw["tttable"],
                                t_batch(tspec.store, device="cpu", **_COMMIT), policy)
    assert m["impacted_keys"] == jm["impacted_keys"] > 0
    assert m["op_overflow"] == m["store_append_overflow"] == 0 and m["host_syncs"] >= 1
    assert m["store_recent_fill_max"] == int((ps2.out.blk_len - ps2.out.csr_len).max().clamp(
        min=int((ps2.inc.blk_len - ps2.inc.csr_len).max())))
    js2_t = interop.store_from_numpy(to_np(js2), device="cpu")
    tree_equal(pstore_np(ps2), pstore_np(TP.partition_store(rt.pspec, js2_t)), policy)
    assert T.cache_entries(tspec.cache, pc2) == J.cache_entries(pw["jspec"].cache, jc2)
    assert int(pc2.n_delete) - int(pcache.n_delete) == m["impacted_keys"]

    roots = np.array([5, 6, 7, 8, 10, 11, 0, 3], np.int32)
    jr, jmiss, jmet = warm["engine"].run(js2, jc2, pw["jttable"], roots)
    tr, tmiss, tmet = rt.run_gr_tx_batch(ps2, pc2, pw["tttable"],
                                         interop.plan_from_numpy(to_np(pw["plan"])), roots)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    assert miss_key(tmiss) == miss_key(jmiss)
    assert tmet["hits"] == jmet["hits"] > 0 and tmet["misses"] == jmet["misses"] > 0
