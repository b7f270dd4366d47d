"""Parity: the partitioned runtime's last options, and the eCommerce example.

Against the JAX package on the same inputs:

- ``route_cap_factor="auto"`` at 4 owners: a batch whose second hop's
  frontier lands on one owner overflows the default buckets, is dispatched
  once more with worst-case caps and equals the JAX single host
  (``route_cap_retries`` 1); the ratchet then holds a factor under which
  the same batch no longer retries. ``_effective_cap_factor`` and
  ``_hop_route_caps`` equal the reference's methods, called on a stand-in
  object, over the same owner-stage blocks; a batch that does not overflow
  equals the default runtime's.
- The block layout from ``e_blk_cap`` / ``recent_blk_cap`` and the op caps
  equal the reference constructor's (on a stand-in mesh); a commit past a
  small ``ops_cap`` / ``ops_route_cap`` reports the overflow the reference's
  commit reports under a named-axis ``jax.vmap``.
- ``maintenance_tick(occupancy=)`` reads no block length and reports what
  the reference's tick reports; ``compact_store`` of a migrated store
  equals the reference's.
- ``examples/serve_ecommerce_torch.py`` prints the reference example's hit
  rates, cache stats and population counts, run in the same process.
"""

import ast
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro.core.invalidation as JI
import repro.graphstore.maintenance as JM
import repro.graphstore.migration as JMig
from conftest import MISSING, build_world, enabled_ttable, sq1_hop, sq2_hop
from repro.distributed.graph_serve import ShardedTxnRuntime as JRuntime
from repro.distributed.routing import identity_table as j_identity
from repro.graphstore import StoreSpec as JStoreSpec
from repro.graphstore import ingest as j_ingest
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore import partition as JP
from repro.obs.trace import NULL_TRACER as J_NULL_TRACER
import repro_torch.distributed.graph_serve as graph_serve
import repro_torch.graphstore.maintenance as TM
import repro_torch.graphstore.migration as TMig
from repro_torch import interop
from repro_torch.distributed import ShardedTxnRuntime, flat_mesh
from repro_torch.graphstore import make_mutation_batch
from repro_torch.graphstore import partition as TP
from repro_torch.obs.metrics import OWNER_STAGE_FIELDS
from test_partitioned_store import _PS_AX
from test_torch_migration import _j_pstore
from test_torch_partitioned_grw import _COMMIT, tree_equal
from test_torch_sharded import PLANS, SHARDED_ONLY, miss_key, sw, to_np  # noqa: F401
from test_torch_fixtures import _torch_test_env  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N = 4
FR = OWNER_STAGE_FIELDS.index("frontier_rows")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip(m):
    return {k: v for k, v in m.items() if k not in SHARDED_ONLY}


# ------------------------------------------------- the example, first (longest)
def _fields(line):
    """A mix line's name, ops and hit rate (the latencies and wall time are
    the machine's)."""
    words = line.split()
    return words[0], words[1], next(w for w in words if w.startswith("hit_rate="))


def test_example_twin_prints_the_reference_examples_rates_and_counts(monkeypatch, capsys):
    """Both examples in one process (``str`` hashes, and so the per-mix
    seeds, are salted per process): 12 operations a mix, the same hit rate
    each mix, cache stats and population counts."""
    ref = _load(ROOT / "examples" / "serve_ecommerce.py", "serve_ecommerce")
    twin = _load(ROOT / "examples" / "serve_ecommerce_torch.py", "serve_ecommerce_torch")
    monkeypatch.setattr(sys, "argv", ["serve_ecommerce.py", "--ops", "12"])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve_ecommerce_torch.py", "--ops", "12",
                                      "--device", "cpu"])
    twin.main()
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    assert [_fields(l) for l in got[:3]] == [_fields(l) for l in want[:3]]
    assert [_fields(l)[0] for l in got[:3]] == ["R_hat", "W_hat", "R_low"]
    assert got[3].startswith("cache: ")
    assert ast.literal_eval(got[3][7:]) == ast.literal_eval(want[3][7:])
    assert got[4] == want[4]
    assert int(got[4].split()[1].split("=")[1]) > 0  # CP committed entries


# ------------------------------------------------------------- "auto" caps
def _skew_world():
    """Watch-lists 0-15 each include 8 active listings with Status 0, all of
    ids = 0 mod 4: the second hop of (sq1, sq2) routes every frontier row to
    owner 0, past the default (4, 3) buckets at 4 owners."""
    spec = JStoreSpec(v_cap=256, e_cap=512, n_vprops=2, n_eprops=1, recent_cap=64)
    n_wl, listings = 16, 16 + 4 * np.arange(32)
    nv = int(listings[-1]) + 1
    vlabels = np.array([0] * n_wl + [1] * (nv - n_wl))
    vprops = np.full((nv, 2), MISSING, np.int64)
    vprops[n_wl:, 0] = 0
    vprops[n_wl:, 1] = 1000 + np.arange(n_wl, nv)
    es = [w for w in range(n_wl) for _ in range(8)]
    ed = [int(listings[(w + k) % 32]) for w in range(n_wl) for k in range(8)]
    store = j_ingest(spec, vlabels, vprops, es, ed, [0] * len(es), np.ones((len(es), 1)))
    jespec = J.EngineSpec(store=spec, cache=J.CacheSpec(capacity=256, probes=8, max_leaves=8,
                                                         max_chunks=1), max_deg=32, frontier=8)
    jttable, _, _ = enabled_ttable()
    return dict(jespec=jespec, jstore=store, jttable=jttable,
                tespec=interop.engine_spec(tuple(spec), tuple(jespec.cache), 32, 8),
                tstore=interop.store_from_numpy(to_np(store), device="cpu"),
                tttable=interop.ttable_from_numpy(to_np(jttable)),
                jplan=J.QueryPlan(hops=(sq1_hop(), sq2_hop())))


def _ref_observe(st, stage, n):
    """The reference's skew ratchet, as ``run_gr_tx_batch`` runs it inline
    (``src/repro/distributed/graph_serve.py:1177-1186``)."""
    fr = np.asarray(stage)[:, FR].astype(np.float64)
    if fr.sum() > 0:
        skew = float(fr.max() * n / fr.sum())
        st._route_skew_seen = (skew if st._route_skew_seen is None
                               else max(st._route_skew_seen, skew))


def _ref_stand_in(rcf, espec, n=N, skew=None):
    st = types.SimpleNamespace(route_cap_factor=rcf, _route_skew_seen=skew, espec=espec, n=n)
    st._effective_cap_factor = lambda worst_case=False: JRuntime._effective_cap_factor(
        st, worst_case)
    return st


def test_auto_caps_retry_an_overflowing_batch_to_the_single_host():
    w = _skew_world()
    plan = interop.plan_from_numpy(to_np(w["jplan"]))
    roots = np.arange(16, dtype=np.int32)
    jr, jm, jmet = J.GraphEngine(w["jespec"], w["jplan"], True, fused=True).run(
        w["jstore"], J.empty_cache(w["jespec"].cache), w["jttable"], roots)
    jmet.pop("host_syncs")
    mk = lambda rcf: ShardedTxnRuntime(w["tespec"], flat_mesh(N), route_cap_factor=rcf,
                                       device="cpu")
    rt_def, rt = mk(graph_serve.DEFAULT_ROUTE_CAP_FACTOR), mk("auto")
    ps = rt.partition_store(w["tstore"])
    _, _, dm = rt_def.run_gr_tx_batch(ps, rt_def.empty_cache(), w["tttable"], plan, roots)
    assert dm["route_overflow"] > 0 and dm["route_cap_retries"] == 0  # the default drops rows

    first = rt.run_gr_tx_batch(ps, rt.empty_cache(), w["tttable"], plan, roots)
    r, ms, m = first
    np.testing.assert_array_equal(r, np.asarray(jr))
    assert miss_key(ms) == miss_key(jm) and _strip(m) == jmet
    assert m["route_cap_retries"] == 1 and rt.route_cap_retries == 1 and m["route_overflow"] == 0
    # the retry's reads add to the first dispatch's
    _, _, none_m = mk(None).run_gr_tx_batch(ps, rt.empty_cache(), w["tttable"], plan, roots)
    assert m["host_syncs"] == dm["host_syncs"] + none_m["host_syncs"]
    # the ratchet read the first dispatch's owner-stage block, as the reference reads it
    st = _ref_stand_in("auto", w["jespec"])
    _ref_observe(st, rt.last_owner_stage, N)
    assert rt._route_skew_seen == st._route_skew_seen > 3
    assert rt._effective_cap_factor() == JRuntime._effective_cap_factor(st) == (5, 5)
    again = rt.run_gr_tx_batch(ps, rt.empty_cache(), w["tttable"], plan, roots)
    assert again[2]["route_cap_retries"] == 0 and rt.route_cap_retries == 1
    np.testing.assert_array_equal(again[0], r)
    assert _strip(again[2]) == jmet


def test_auto_caps_leave_a_telemetry_off_runtime_at_the_default():
    w = _skew_world()
    plan = interop.plan_from_numpy(to_np(w["jplan"]))
    rt = ShardedTxnRuntime(w["tespec"], flat_mesh(N), route_cap_factor="auto", telemetry=False,
                           device="cpu")
    ps = rt.partition_store(w["tstore"])
    for _ in range(2):
        _, _, m = rt.run_gr_tx_batch(ps, rt.empty_cache(), w["tttable"], plan,
                                     np.arange(16, dtype=np.int32))
        assert m["route_cap_retries"] == 1 and m["route_overflow"] == 0
    assert rt._effective_cap_factor() == graph_serve.DEFAULT_ROUTE_CAP_FACTOR
    assert rt.route_cap_retries == 2


@pytest.mark.parametrize("rcf", ["auto", (4, 3), None, 2, (5,)])
def test_effective_cap_factor_and_caps_match_the_reference(sw, rcf):
    rt = ShardedTxnRuntime(sw["tspec"], flat_mesh(N), route_cap_factor=rcf, device="cpu")
    st = _ref_stand_in(rcf, sw["jspec"])
    rng = np.random.default_rng(1)
    plan = PLANS["in_out"]
    blocks = [np.zeros((N, len(OWNER_STAGE_FIELDS)), np.int64)]
    for hi in (8, 40, 3, 200, 9):
        b = rng.integers(0, 50, (N, len(OWNER_STAGE_FIELDS)))
        b[:, FR] = rng.integers(0, hi, N)
        blocks.append(b)
    blocks.append(blocks[-1].copy())
    blocks[-1][:, FR] = [0, 90, 0, 3]  # one owner's rows: a skew near n
    for b in blocks:
        rt._observe_route_skew(b)
        _ref_observe(st, b, N)
        for wc in (False, True):
            assert rt._effective_cap_factor(wc) == JRuntime._effective_cap_factor(st, wc)
            for Bloc in (1, 4, 128):
                assert rt._hop_route_caps(plan, Bloc, worst_case=wc) == \
                    JRuntime._hop_route_caps(st, plan, Bloc, worst_case=wc)
    if rcf == "auto":
        assert rt._effective_cap_factor() != graph_serve.DEFAULT_ROUTE_CAP_FACTOR


def test_auto_caps_without_overflow_equal_the_default_runtime(sw):
    plan = interop.plan_from_numpy(to_np(PLANS["in_out"]))
    roots = np.array([5, 6, 7, 8, 9, 0, 3, 11, 12, 4], np.int32)
    outs = []
    for rcf in ("auto", graph_serve.DEFAULT_ROUTE_CAP_FACTOR):
        rt = ShardedTxnRuntime(sw["tspec"], flat_mesh(N), route_cap_factor=rcf, device="cpu")
        ps = rt.partition_store(sw["tstore"])
        outs.append(rt.run_gr_tx_batch(ps, rt.empty_cache(), sw["tttable"], plan, roots))
    (ra, ma, mta), (rd, md, mtd) = outs
    np.testing.assert_array_equal(ra, rd)
    assert miss_key(ma) == miss_key(md) and mta == mtd and mta["route_cap_retries"] == 0


# ------------------------------------------------------ layout and op caps
_MESH = lambda n: types.SimpleNamespace(axis_names=("shard",), shape={"shard": n})


@pytest.mark.parametrize("n,kw", [
    (4, {}), (4, dict(e_blk_cap=300)), (4, dict(recent_blk_cap=16)),
    (4, dict(e_blk_cap=40, recent_blk_cap=64)), (1, dict(e_blk_cap=700, blk_slack=1.5)),
    (4, dict(blk_slack=3.0, recent_blk_cap=8, ops_cap=64, sweep_cap=8)),
    (2, dict(ops_cap=100, ops_route_cap=7)),
], ids=str)
def test_layout_and_caps_match_the_reference_constructor(sw, n, kw):
    jrt = JRuntime(sw["jspec"], _MESH(n), **kw)  # the constructor reads only the mesh's shape
    rt = ShardedTxnRuntime(sw["tspec"], flat_mesh(n), device="cpu", **kw)
    assert (rt.pspec.n_shards, rt.pspec.e_blk_cap, rt.pspec.recent_blk_cap) == \
        (jrt.pspec.n_shards, jrt.pspec.e_blk_cap, jrt.pspec.recent_blk_cap)
    assert tuple(rt.pspec.base) == tuple(jrt.pspec.base)
    assert (rt.ops_cap, rt.sweep_cap, rt.ops_route_cap) == \
        (jrt.ops_cap, jrt.sweep_cap, jrt.ops_route_cap)
    if rt.pspec.e_blk_cap >= 2 * int(sw["tstore"].e_len):
        tree_equal(interop.pstore_to_numpy(rt.partition_store(sw["tstore"])),
                   to_np(JP.partition_store(jrt.pspec, sw["jstore"])))
    rep = ShardedTxnRuntime(sw["tspec"], flat_mesh(n), store_tier="replicated", device="cpu",
                            **kw)
    assert rep.pspec is None


@pytest.fixture(scope="module")
def op_world():
    spec, store = build_world()
    jespec = J.EngineSpec(store=spec, cache=J.CacheSpec(capacity=1024, probes=8, max_leaves=16,
                                                         max_chunks=2), max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    return dict(spec=spec, jstore=store, jespec=jespec, jttable=jttable,
                tspec=interop.engine_spec(tuple(spec), tuple(jespec.cache), 32, 32),
                tstore=interop.store_from_numpy(to_np(store), device="cpu"),
                tttable=interop.ttable_from_numpy(to_np(jttable)))


def _reference_commit_overflow(w, caps):
    """The reference's commit phases on every rank under a named-axis vmap:
    the partitioned apply, the listener over the rank's views and the
    reference's ``_route_and_apply_ops`` (on a stand-in with ``caps``);
    returns the psum of the overflow, as its commit reports it."""
    jpspec = JP.default_pspec(w["spec"], N)
    lspec = w["jespec"]._replace(cache=w["jespec"].cache._replace(capacity=1024 // N))
    stand = types.SimpleNamespace(lspec=lspec, n=N, axes=("sh",), **caps)
    jmb, ident = j_batch(w["spec"], **_COMMIT), j_identity(N)

    def rank(ps, cache, me):
        ps2, applied, _ = JP.apply_mutations_partitioned(jpspec, ps, jmb, me, "sh")
        ops, sweeps = JI.derive_cache_ops_views(
            lspec, JP.BlockStoreView(jpspec, ps, me), JP.BlockStoreView(jpspec, ps2, me),
            w["jttable"], applied, through=False)
        _, _, ovf = JRuntime._route_and_apply_ops(stand, cache, ops, sweeps, False, False,
                                                  rtable=ident)
        return jax.lax.psum(ovf, "sh")

    caches = jax.tree_util.tree_map(lambda x: jnp.stack([x] * N), J.empty_cache(lspec.cache))
    fn = jax.jit(jax.vmap(rank, axis_name="sh", in_axes=(_PS_AX, 0, 0)))
    out = fn(JP.stack_blocks(jpspec, JP.partition_store(jpspec, w["jstore"])), caches,
             jnp.arange(N))
    return int(out[0])


def test_op_caps_report_the_references_commit_overflow(op_world):
    caps = dict(ops_cap=3, sweep_cap=512, ops_route_cap=1)
    want = _reference_commit_overflow(op_world, caps)
    assert want > 0
    tmb = make_mutation_batch(op_world["tspec"].store, device="cpu", **_COMMIT)
    got = {}
    for name, kw in (("tight", caps), ("default", {})):
        rt = ShardedTxnRuntime(op_world["tspec"], flat_mesh(N), route_cap_factor=None,
                               device="cpu", **kw)
        ps = rt.partition_store(op_world["tstore"])
        _, _, got[name] = rt.run_grw_tx(ps, rt.empty_cache(), op_world["tttable"], tmb)
    assert got["tight"]["op_overflow"] == want
    assert got["default"]["op_overflow"] == 0


# ------------------------------------------------------------- maintenance
def test_maintenance_tick_with_an_occupancy_reads_nothing_more(op_world, monkeypatch):
    reads = []
    occupancy = graph_serve.block_occupancy
    monkeypatch.setattr(graph_serve, "block_occupancy",
                        lambda *a: reads.append(1) or occupancy(*a))
    tmb = make_mutation_batch(op_world["tspec"].store, device="cpu", **_COMMIT)
    infos, stores = {}, {}
    for given in (False, True):
        rt = ShardedTxnRuntime(op_world["tspec"], flat_mesh(N), route_cap_factor=None,
                               device="cpu")
        ps, _, m = rt.run_grw_tx(rt.partition_store(op_world["tstore"]),
                                 rt.empty_cache(), op_world["tttable"], tmb)
        occ = dict(max_occupancy=m["store_occupancy_max"],
                   max_recent_fill=m["store_recent_fill_max"])
        del reads[:]
        policy = TM.MaintenancePolicy(recent_fill_frac=0.0)
        stores[given], infos[given] = rt.maintenance_tick(ps, policy,
                                                         occupancy=occ if given else None)
        assert len(reads) == (0 if given else 1)
    assert infos[True] == infos[False] and infos[True]["compacted"]
    tree_equal(interop.pstore_to_numpy(stores[True]), interop.pstore_to_numpy(stores[False]))
    # the reference's tick on a stand-in, given the same report
    jpspec = JP.default_pspec(op_world["spec"], N)
    st = types.SimpleNamespace(pspec=jpspec, tracer=J_NULL_TRACER, mutation_rows_since_compact=0,
                               compact_step=lambda purge: (lambda p: p))
    _, jinfo = JRuntime.maintenance_tick(st, None, JM.MaintenancePolicy(recent_fill_frac=0.0),
                                         occupancy=occ)
    assert jinfo == infos[True]


@pytest.fixture(scope="module")
def migrated():
    spec, store = build_world()
    jmb = j_batch(spec, new_edges=[(0, 11, 0, [1]), (5, 6, 0, [1]), (1, 7, 0, [1])],
                  del_edges=[2, 9])
    from repro.graphstore.mutations import apply_mutations as j_apply

    jstore, _ = j_apply(spec, store, jmb)
    pspec = TP.default_pspec(interop.store_spec(tuple(spec)), N)
    ps = TP.partition_store(pspec, interop.store_from_numpy(to_np(jstore), device="cpu"))
    moves = [(0, 3), (5, 2), (6, 0), (13, 1)]
    mps = TMig.migrate_vertex_rows(pspec, ps, moves)
    jmps = JMig.migrate_vertex_rows(pspec, _j_pstore(interop.pstore_to_numpy(ps)), moves)
    tree_equal(interop.pstore_to_numpy(mps), to_np(jmps), "migrated")
    return dict(pspec=pspec, ps=ps, mps=mps, jmps=jmps)


@pytest.mark.parametrize("purge", [False, True])
def test_migrated_store_compaction_matches_the_reference(migrated, purge):
    # the default compaction folds migrated-in foreign rows into the CSR body
    pspec = migrated["pspec"]
    got = TM.compact_store(pspec, migrated["mps"], purge=purge)
    want = JM.compact_store(pspec, migrated["jmps"], purge=purge)
    tree_equal(interop.pstore_to_numpy(got), to_np(want), "compacted")
