"""Crash and replay on the port's partitioned tier.

Mirrors the reference's crash / restart pin
(``tests/test_durability_runtime.py``) in one process, with no subprocess
and no virtual devices: a stream of gR batches and gated gRW commits (a
tombstone purge enabled once the epoch registry allows it, write-through
on the grown tier), host ``maintenance_tick`` compactions and a capacity
growth, all journaled write-behind by the flusher thread, with full and
incremental checkpoints. After a simulated kill (fresh runtime and journal
objects, torn bytes at the log's tail) ``replay`` rebuilds the partitioned
store byte for byte, through COMMIT, COMPACT and GROW records, and the gR
batches after it equal the uninterrupted run's (results, misses, metrics);
the first incremental checkpoint after it falls back to full. Also: an incremental chain restores to the same bytes as
a full checkpoint of the same store, a MIGRATE record after it replays
through the migration splice (and attaches the placement it rebuilds),
and recovery without a checkpoint raises.
"""

import numpy as np
import pytest

from conftest import build_world, common_watchlist_plan, enabled_ttable
from repro_torch import interop
from repro_torch.distributed import ShardedTxnRuntime, flat_mesh
from repro_torch.graphstore import (
    DeviceGate,
    MaintenancePolicy,
    WriteBehindJournal,
    default_pspec,
    make_mutation_batch,
    replay,
    restore_chain,
)
from test_torch_partitioned_grw import tree_equal
from test_torch_sharded import miss_key, to_np
from test_torch_fixtures import _torch_test_env  # noqa: F401


@pytest.fixture(scope="module")
def dw():
    spec, store = build_world()
    ttable, _, _ = enabled_ttable()
    from repro.core import CacheSpec

    cspec = CacheSpec(capacity=1024, probes=8, max_leaves=16, max_chunks=2)
    return dict(
        spec=interop.store_spec(tuple(spec)),
        espec=interop.engine_spec(tuple(spec), tuple(cspec), 32, 32),
        store=interop.store_from_numpy(to_np(store), device="cpu"),
        ttable=interop.ttable_from_numpy(to_np(ttable)),
        plan=interop.plan_from_numpy(to_np(common_watchlist_plan())),
    )


def _runtime(dw, n):
    rt = ShardedTxnRuntime(dw["espec"], flat_mesh(n), route_cap_factor=None, device="cpu")
    # blocks of the uniform share: smaller checkpoints
    rt.set_block_capacity(default_pspec(dw["espec"].store, n, slack=1.0).e_blk_cap)
    return rt


def _reads(rt, ps, dw, roots):
    res, miss, met = rt.run_gr_tx_batch(ps, rt.empty_cache(), dw["ttable"], dw["plan"], roots)
    met.pop("host_syncs")
    return res.tolist(), miss_key(miss), met


def _batch(dw, **kw):
    return make_mutation_batch(dw["spec"], device="cpu", **kw)


@pytest.mark.parametrize("n", [4, 1])
def test_crash_replay_is_byte_identical(dw, n, tmp_path):
    root = str(tmp_path / "journal")
    roots = np.array([0, 3, 5, 6, 7, 11], np.int32)
    gate = DeviceGate(recent_fill_frac=0.0)  # compacts every block at every commit
    rt = _runtime(dw, n)
    ps = rt.partition_store(dw["store"])
    cache = rt.empty_cache()
    j = WriteBehindJournal(root, rt.n)
    j.start(interval=0.001)
    j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                 store_version=int(ps.version))

    # a pinned gR snapshot makes purge unsafe for the next commit
    pin = j.epochs.pin()
    rt.run_gr_tx_batch(ps, cache, dw["ttable"], dw["plan"], roots)
    ps, cache, m1 = rt.run_grw_tx(
        ps, cache, dw["ttable"],
        _batch(dw, new_edges=[(0, 11, 0, [1]), (3, 6, 0, [0])], set_vprops=[(7, 0, 1)]),
        gate=gate, journal=j)
    assert m1["device_compactions"] == 2 * n and m1["store_recent_fill_max"] == 0
    assert not j.epochs.safe_to_purge(j.epochs.current, j)
    j.epochs.release(pin)
    assert not j.epochs.safe_to_purge(j.epochs.current, j)  # no checkpoint covers it yet
    j.checkpoint_incremental(ps, e_blk_cap=rt.pspec.e_blk_cap,
                             recent_blk_cap=rt.pspec.recent_blk_cap,
                             store_version=int(ps.version))
    assert j.checkpoint_meta(j.checkpoint_seq)["kind"] == "incremental"
    assert j.epochs.safe_to_purge(j.epochs.current, j)

    # tombstones, purged behind the liveness epoch
    blk_before = int(ps.out.blk_len.sum())
    ps, cache, m2 = rt.run_grw_tx(ps, cache, dw["ttable"],
                                  _batch(dw, del_edges=[2, 5], del_vertices=[9]),
                                  gate=gate._replace(purge=True), journal=j)
    assert m2["device_compactions"] == 2 * n and int(ps.out.blk_len.sum()) == blk_before - 2
    assert m2["journal_lag_batches"] <= 2 and m2["host_syncs"] == m1["host_syncs"]

    # a host tick (forced compaction), then a growth, each journaled after
    # the last checkpoint, so that replay repeats them
    ps, cache, _ = rt.run_grw_tx(ps, cache, dw["ttable"],
                                 _batch(dw, new_edges=[(1, 12, 0, [1])]), journal=j)
    ps, info = rt.maintenance_tick(ps, MaintenancePolicy(recent_fill_frac=0.0), journal=j)
    assert info["compacted"] and info["grown_to"] is None
    ps = rt.grow_blocks(ps, rt.pspec.e_blk_cap + 13)
    j.append_grow(rt.pspec.e_blk_cap, rt.pspec.recent_blk_cap)

    # write-through traffic on the grown tier, then a host tick with purge
    ps, cache, m3 = rt.run_grw_tx(
        ps, cache, dw["ttable"],
        _batch(dw, new_edges=[(1, 12, 0, [1]), (2, 13, 0, [0])], set_eprops=[(1, 0, 0)]),
        "write-through", gate=gate, journal=j)
    ps, cache, _ = rt.run_grw_tx(ps, cache, dw["ttable"], _batch(dw, del_edges=[4]), journal=j)
    ps, _ = rt.maintenance_tick(ps, MaintenancePolicy(recent_fill_frac=0.0, purge=True),
                                journal=j)
    ps, cache, _ = rt.run_grw_tx(ps, cache, dw["ttable"],
                                 _batch(dw, new_edges=[(3, 14, 0, [1])]), gate=gate, journal=j)
    j.stop(final_flush=True)
    assert j.metrics()["journal_lag_batches"] == 0
    with open(j.log_path, "ab") as f:  # killed mid-write: a torn tail
        f.write(b"GJL2" + b"\x01" * 9)
    want = _reads(rt, ps, dw, roots)
    live = interop.pstore_to_numpy(ps)
    pspec_live = rt.pspec
    del rt, j  # the crash: runtime and journal objects gone

    rt2 = _runtime(dw, n)
    j2 = WriteBehindJournal(root, rt2.n)
    ps2, last, info = replay(j2, rt2, dw["ttable"])
    assert info == {"replayed_commits": 5, "replayed_compactions": 2, "replayed_growths": 1,
                    "replayed_migrations": 0}, info
    assert rt2.pspec == pspec_live and last == j2.durable_seq
    tree_equal(interop.pstore_to_numpy(ps2), live, "replayed store")
    assert _reads(rt2, ps2, dw, roots) == want
    assert j2.epochs.current == int(ps2.version)
    # the first incremental checkpoint across the growth falls back to full
    j2.checkpoint_incremental(ps2, e_blk_cap=rt2.pspec.e_blk_cap,
                              recent_blk_cap=rt2.pspec.recent_blk_cap,
                              store_version=int(ps2.version))
    assert j2.checkpoint_meta(j2.checkpoint_seq)["kind"] == "full"


def test_incremental_chain_restores_the_full_bytes(dw, tmp_path):
    """full -> incremental -> incremental restores the same bytes as a full
    checkpoint of the same store; a MIGRATE record replays through the
    migration splice; recovery needs a checkpoint."""
    rt = _runtime(dw, 4)
    ps = rt.partition_store(dw["store"])
    cache = rt.empty_cache()
    j = WriteBehindJournal(str(tmp_path / "chain"), rt.n)
    with pytest.raises(FileNotFoundError):
        replay(j, rt, dw["ttable"])
    kw = dict(e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap)
    j.checkpoint_incremental(ps, store_version=0, **kw)  # no base: full
    for mb in (_batch(dw, new_edges=[(0, 5, 0, [1])]),  # owners 0 and 1 only
               _batch(dw, set_vprops=[(7, 0, 1)], new_edges=[(2, 6, 0, [0])])):
        ps, cache, _ = rt.run_grw_tx(ps, cache, dw["ttable"], mb, journal=j)
        j.checkpoint_incremental(ps, store_version=int(ps.version), **kw)
    metas = [j.checkpoint_meta(r) for r in (1, 2)]
    assert [m["kind"] for m in metas] == ["incremental"] * 2
    assert metas[0]["owners"] == [0, 1] and metas[1]["owners"] == [2]
    got, seq, _ = restore_chain(j, rt)
    assert seq == 2
    tree_equal(interop.pstore_to_numpy(got), interop.pstore_to_numpy(ps), "chain")
    j.append_migrate([(5, 2)], epoch=1)
    j.flush()
    from repro_torch.graphstore.migration import migrate_vertex_rows

    rt2 = _runtime(dw, 4)
    got, last, info = replay(j, rt2, dw["ttable"])
    assert info["replayed_migrations"] == 1 and last == 3
    tree_equal(interop.pstore_to_numpy(got),
               interop.pstore_to_numpy(migrate_vertex_rows(rt.pspec, ps, [(5, 2)])), "migrate")
    assert rt2.rhost.storage_exceptions == {5: 2}
