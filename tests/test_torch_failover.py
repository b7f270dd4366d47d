"""The port's failover tier against the reference's.

- **Fault primitives**: ``RetryPolicy``, ``timed_call``, ``FailureDetector``
  (thresholds, straggle marking, the per-owner heartbeat), ``ShardFaultPlan``,
  ``HedgedCalls`` and ``ElasticRunner``, each fed the same script in both
  packages with equal outcomes; the unscripted probe heartbeats from the
  runtime's measured step time in both.
- **Journal watermark**: queued commits freeze ``applied_seq``, count in
  ``queued_commits`` and mark owners checkpoint-dirty as the reference's do;
  the watermark survives a reopen by either package, and a meta without it
  reopens as all applied.
- **Splice**: ``splice_owner_blocks`` equals the reference's numpy function
  on the port's stores, for every owner.
- **Lifecycle on one shard**: crash, detection gap, degraded reads (warm
  hits serve, misses defer), queued commits, recovery, next batch: results,
  deferred flags, misses and metrics (but ``host_syncs``) equal in both
  packages, and the recovered store equals the reference's and a control's
  that took the same commits with no fault, field by field.
- **Lifecycle on four shards** (the port against its own control): every
  row not deferred equals a healthy call and the JAX single-host engine, no
  miss record names a root of the down owner, the store does not move while
  commits queue, and after recovery store and batches equal the control's.
- **Hedge**: the masked hedge wins against a scripted straggler in both
  packages, and the batch after it equals a runtime that never hedged.
- **Healthy batch**: one whose down mask names no owner has the kernel
  calls, host reads and collectives of one with no mask.
- **Failover with migration**: an owner lost after a migration round on
  four shards: its moved-away vertices serve, the next round waits,
  queued commits route through the table attached after the controller
  was built, recovery (replaying a commit before the round and the
  MIGRATE record) equals a control with no fault, and a whole replay on
  the live runtime equals the live store.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.distributed.fault as JF
from conftest import TPL_META, build_world, common_watchlist_plan, enabled_ttable, fig1_plan
from repro.distributed import flat_mesh as j_flat_mesh
from repro.distributed.failover import FailoverController as JController
from repro.distributed.graph_serve import ShardedMissDrain as JDrain
from repro.distributed.graph_serve import ShardedTxnRuntime as JRuntime
from repro.graphstore import WriteBehindJournal as JJournal
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore.partition import EdgeBlock as JEdgeBlock
from repro.graphstore.partition import PartitionedGraphStore as JPStore
from repro.graphstore.partition import splice_owner_blocks as j_splice
import repro_torch.core.cache as cache_mod
import repro_torch.distributed.fault as TF
from repro_torch import interop
from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, flat_mesh
from repro_torch.distributed.failover import FailoverController
from repro_torch.graphstore import WriteBehindJournal, make_mutation_batch, replay
from repro_torch.graphstore.partition import splice_owner_blocks
from repro_torch.kernels.block_gather import ops as bg_ops
from test_torch_partitioned_grw import tree_equal
from test_torch_sharded import miss_key, to_np

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ fault primitives
def _retry_outcome(pkg, script):
    calls, retries = [], []

    def flaky(exc, ok_at=None):
        def fn():
            calls.append(1)
            if ok_at is not None and len(calls) >= ok_at:
                return "ok"
            raise exc
        return fn

    try:
        if script == "zero_attempts":
            pkg.RetryPolicy(max_attempts=0)
        elif script == "predicate_short_circuits":
            pkg.RetryPolicy(max_attempts=5, retryable=lambda e: not isinstance(e, KeyError)).run(
                flaky(KeyError("not transient")))
        elif script == "transient_full_budget":
            pkg.RetryPolicy(max_attempts=3, retryable=lambda e: isinstance(e, OSError)).run(
                flaky(OSError("transient")), on_retry=lambda a, e: retries.append(a))
        elif script == "succeeds_mid_budget":
            out = pkg.RetryPolicy(max_attempts=4).run(flaky(OSError(), ok_at=3),
                                                      on_retry=lambda a, e: retries.append(a))
            return out, len(calls), retries
        elif script == "bounded_node_failure":
            pkg.RetryPolicy(max_attempts=3).run(flaky(pkg.NodeFailure("nope")))
    except Exception as e:  # noqa: BLE001 — the outcome compared
        return type(e).__name__, str(e), len(calls), retries
    return None, len(calls), retries


@pytest.mark.parametrize("script", ["zero_attempts", "predicate_short_circuits",
                                    "transient_full_budget", "succeeds_mid_budget",
                                    "bounded_node_failure"])
def test_retry_policy_matches_reference(script):
    assert _retry_outcome(TF, script) == _retry_outcome(JF, script)


def test_timed_call_matches_reference():
    def outcome(pkg):
        out = [pkg.timed_call(lambda x: x + 1, None, 2), pkg.timed_call(lambda: "fast", 1.0)]
        for fn, timeout in ((lambda: time.sleep(0.3), 0.02), (lambda: 1 / 0, 1.0)):
            try:
                pkg.timed_call(fn, timeout)
            except Exception as e:  # noqa: BLE001 — the outcome compared
                out.append(type(e).__name__)
        return out

    assert outcome(TF) == outcome(JF) == [3, "fast", "CallTimeout", "ZeroDivisionError"]


DETECTOR_SCRIPTS = {
    "threshold_and_recovery": (dict(n=4, fail_threshold=2), [
        ("fail", 1), ("ok", 1, 0.0), ("fail", 1), ("fail", 1), ("fail", 1), ("recover", 1),
        ("recover", 2)]),
    "straggle_marking": (dict(n=2, straggle_after=0.1), [
        ("ok", 0, 0.5), ("ok", 0, 0.01), ("ok", 1, 0.1)]),
    "step_heartbeat": (dict(n=3, fail_threshold=1, straggle_after=0.1), [
        ("step", 0.5, None), ("step", 0.01, None), ("fail", 2), ("step", 0.01, None),
        ("step", 0.5, None)]),
    "per_owner_heartbeat": (dict(n=8, fail_threshold=1, straggle_after=0.1), [
        ("step", 0.08, [0.02] * 5 + [0.5] + [0.02] * 2), ("step", 0.02, [0.02] * 8),
        ("fail", 3), ("step", 0.02, [0.02] * 5 + [0.5] + [0.02] * 2), ("step", 0.5, None),
        ("step", 0.02, [0.02] * 4)]),
}


def _detector_trace(pkg, kw, ops):
    d, trace = pkg.FailureDetector(**kw), []
    for op in ops:
        try:
            if op[0] == "fail":
                d.observe_failure(op[1])
            elif op[0] == "ok":
                d.observe_ok(op[1], latency_s=op[2])
            elif op[0] == "step":
                d.observe_step(op[1], per_owner=None if op[2] is None else np.array(op[2]))
            else:
                d.mark_recovered(op[1])
            err = None
        except ValueError as e:
            err = str(e)
        trace.append((sorted(d.down()), sorted(d.straggling()), d.detections, d.recoveries,
                      d.down_mask().tolist(), err))
    return trace


@pytest.mark.parametrize("name", list(DETECTOR_SCRIPTS))
def test_failure_detector_matches_reference(name):
    kw, ops = DETECTOR_SCRIPTS[name]
    got = _detector_trace(TF, kw, ops)
    assert got == _detector_trace(JF, kw, ops)
    assert any(t[0] or t[1] for t in got)  # the script marks something


def test_shard_fault_plan_matches_reference():
    def trace(pkg):
        p = pkg.ShardFaultPlan(crash={2: 5}, hang={1: (3, 6, 0.2)}, torn_flush_attempts=(0,))
        out = [sorted(p.crashed_at(b)) for b in (4, 5, 99)]
        out += [p.hang_delay(1, b) for b in (2, 3, 5, 6)] + [p.hang_delay(0, 4)]
        for attempt in (0, 1):
            try:
                p.flush_fault(attempt)
                out.append(None)
            except OSError as e:
                out.append(str(e))
        p.revive(2)
        return out + [sorted(p.crashed_at(99))]

    assert trace(TF) == trace(JF)


@pytest.mark.parametrize("case", ["fast_primary", "slow_primary", "primary_raises"])
def test_hedged_calls_match_reference(case):
    def slow():
        time.sleep(0.3)
        return "slow"

    def bad():
        raise RuntimeError("primary died")

    primary, hedge_after = {"fast_primary": (lambda: "fast", 0.5),
                            "slow_primary": (slow, 0.01),
                            "primary_raises": (bad, 5.0)}[case]

    def outcome(pkg):
        h = pkg.HedgedCalls()
        try:
            out = h.call(primary, lambda: "hedge", hedge_after=hedge_after)
        except RuntimeError as e:
            out = str(e)
        return out, h.issued, h.hedged, h.hedge_wins, h.hedge_rate

    assert outcome(TF) == outcome(JF)


def test_hedging_simulation_matches_reference():
    tail = lambda rng: 0.001 + rng.pareto(2.0) * 0.002
    got = TF.HedgedCalls(replicas=2, seed=1).simulate(4000, tail)
    assert got == JF.HedgedCalls(replicas=2, seed=1).simulate(4000, tail)
    assert got["p99_improvement"] > 1.3


def test_elastic_runner_matches_reference(tmp_path):
    """Injected node loss at step 7: re-mesh a level down, restore the
    step-5 checkpoint, finish the 12 steps; each package's own checkpoints."""
    def run(pkg, make_state, add_one, root):
        calls = []

        def step_fn(mesh, state, i):
            calls.append((mesh[1], i))
            return {**state, "x": add_one(state["x"])}

        runner = pkg.ElasticRunner(make_mesh=lambda level: ("mesh", level), make_state=make_state,
                                   step_fn=step_fn, ckpt_dir=str(root), ckpt_every=5)
        state, log = runner.run(12, inject_failure_at=7)
        return np.asarray(state["x"]).tolist(), int(state["mesh_level"]), log, calls

    import jax.numpy as jnp

    got = run(TF, lambda mesh: {"x": torch.zeros(3), "mesh_level": torch.tensor(mesh[1])},
              lambda x: x + 1, tmp_path / "t")
    want = run(JF, lambda mesh: {"x": jnp.zeros(3), "mesh_level": jnp.int32(mesh[1])},
               lambda x: x + 1, tmp_path / "j")
    assert got == want
    assert got[0] == [12.0] * 3 and any(e[0] == "failover" for e in got[2])


def test_probe_heartbeats_from_measured_step_time():
    class _Rt:
        n = 4
        pspec = object()  # a partitioned runtime's block layout
        last_step_seconds = 0.0
        last_step_owner_seconds = None

    steps = [(0.01, None), (0.2, None), (0.01, None), (0.04, [0.01, 0.01, 0.3, 0.01]),
             (0.01, [0.01] * 4)]
    traces = []
    for pkg, ctl in ((TF, FailoverController), (JF, JController)):
        rt, det = _Rt(), pkg.FailureDetector(n=4, straggle_after=0.05)
        c, trace = ctl(rt, None, None, detector=det), []
        for b, (s, per) in enumerate(steps):
            rt.last_step_seconds, rt.last_step_owner_seconds = s, per
            trace.append((sorted(c.probe(b)), sorted(det.straggling())))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[0][1][1] == [0, 1, 2, 3] and traces[0][3][1] == [2]


# ------------------------------------------------------------ journal watermark
def _batches(n_owners):
    spec, _ = build_world()
    tspec = interop.store_spec(tuple(spec))
    edges = [[(0, 5, 0, [1])], [(1, 8, 0, [0])], [(2, 9, 0, [1]), (6, 3, 0, [0])]]
    return ([j_batch(spec, new_edges=e) for e in edges],
            [make_mutation_batch(tspec, new_edges=e, device="cpu") for e in edges])


def _watermarks(j):
    m = j.metrics()
    return {k: m[k] for k in ("applied_seq", "queued_commits", "dirty_owners",
                              "dirty_owners_since_ckpt", "journal_lag_batches")}


def test_applied_watermark_freezes_and_reopens_in_both_packages(tmp_path):
    jb, tb = _batches(4)
    seen = {}
    for tag, Journal, b in (("t", WriteBehindJournal, tb), ("j", JJournal, jb)):
        j = Journal(str(tmp_path / tag), 4)
        s1 = j.append_commit(b[0], commit_version=1)
        trace = [_watermarks(j)]
        s2 = j.append_commit(b[1], applied=False)
        s3 = j.append_commit(b[2], applied=False)
        trace.append(_watermarks(j))
        j.flush()
        trace.append(_watermarks(j))
        seen[tag] = (trace, (s1, s2, s3))
    assert seen["t"] == seen["j"]
    (s1, s2, s3) = seen["t"][1]
    assert seen["t"][0][1]["applied_seq"] == s1 and seen["t"][0][1]["queued_commits"] == 2
    # each package reopens either's journal at the same watermark
    for tag in ("t", "j"):
        for Journal in (WriteBehindJournal, JJournal):
            j2 = Journal(str(tmp_path / tag), 4)
            assert j2.applied_seq == s1
            assert [r.seq for r in j2.read_records(after_seq=j2.applied_seq)] == [s2, s3]


def test_queued_and_gated_commits_mark_owners_dirty_as_the_reference(tmp_path):
    jb, tb = _batches(4)
    traces = []
    for tag, Journal, b in (("t", WriteBehindJournal, tb), ("j", JJournal, jb)):
        j, trace = Journal(str(tmp_path / tag), 4), []
        for i, mb in enumerate(b):
            j.append_commit(mb, applied=i != 1)
            trace.append(_watermarks(j))
        j.flush()
        trace.append(_watermarks(j))
        j.append_commit(b[0], device_compactions=1)  # the gate may rewrite any block
        trace.append(_watermarks(j))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[0][-1]["dirty_owners_since_ckpt"] == 4 and traces[0][-2]["dirty_owners"] == 0


def test_meta_without_applied_seq_reopens_as_all_applied(tmp_path):
    _, tb = _batches(4)
    j = WriteBehindJournal(str(tmp_path / "j"), 4)
    j.append_commit(tb[0])
    j.append_commit(tb[1], applied=False)
    j.flush()
    with open(j.meta_path) as f:
        meta = json.load(f)
    assert meta["applied_seq"] == 1
    del meta["applied_seq"]
    with open(j.meta_path, "w") as f:
        json.dump(meta, f)
    for Journal in (WriteBehindJournal, JJournal):
        assert Journal(str(tmp_path / "j"), 4).applied_seq == 2


# ---------------------------------------------------------------------- splice
def _j_pstore(d):
    blk = lambda b: JEdgeBlock(**b)
    return JPStore(**{f: blk(d[f]) if f in ("out", "inc") else d[f] for f in JPStore._fields})


@pytest.fixture(scope="module")
def small():
    spec, store = build_world()
    cspec = J.CacheSpec(capacity=256, probes=8, max_leaves=16, max_chunks=2)
    jespec = J.EngineSpec(store=spec, cache=cspec, max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    return dict(spec=spec, store=store, jespec=jespec, jttable=jttable,
                tspec=interop.store_spec(tuple(spec)),
                tespec=interop.engine_spec(tuple(spec), tuple(cspec), 32, 32),
                tstore=interop.store_from_numpy(to_np(store), device="cpu"),
                tttable=interop.ttable_from_numpy(to_np(jttable)))


@pytest.mark.parametrize("owner", [0, 1, 2, 3])
def test_splice_owner_blocks_matches_reference(small, owner):
    rt = ShardedTxnRuntime(small["tespec"], flat_mesh(4), route_cap_factor=None, device="cpu")
    live = rt.partition_store(small["tstore"])
    replayed, cache = live, rt.empty_cache()
    for e in ([(0, 5, 0, [1]), (1, 8, 0, [0])], [(2, 9, 0, [1]), (7, 3, 0, [0])]):
        mb = make_mutation_batch(small["tspec"], new_edges=e, device="cpu")
        replayed, cache, _ = rt.run_grw_tx(replayed, cache, small["tttable"], mb)
    live_np, rep_np = interop.pstore_to_numpy(live), interop.pstore_to_numpy(replayed)
    want = j_splice(rt.pspec, _j_pstore(live_np), _j_pstore(rep_np), owner)
    src = interop.pstore_from_numpy(rep_np, device="cpu")
    got = splice_owner_blocks(rt.pspec, live, src, owner)
    assert got.out.key.data_ptr() == src.out.key.data_ptr()  # written in place
    tree_equal(interop.pstore_to_numpy(got), to_np(want))
    tree_equal(interop.pstore_to_numpy(live), live_np)  # the live store is left as it was
    assert not all(np.array_equal(rep_np[b][f], live_np[b][f])
                   for b in ("out", "inc") for f in ("key", "blk_len"))


# ------------------------------------------------------- one-shard lifecycle
def _lifecycle(pkg, small, tmp_path, control: bool):
    """The reference's one-shard crash / degrade / recover story, with a
    warm cache: batch 0 populates roots 0 and 1, the crash lands at batch 1
    (the detection gap), batch 2 serves degraded, two commits queue,
    recovery, batch 3. Returns what each step showed."""
    is_t = pkg == "t"
    roots0, roots = np.array([0, 1], np.int32), np.array([0, 1, 2, 3], np.int32)
    edges = ([(0, 9, 0, [1])], [(1, 8, 0, [0])])
    if is_t:
        espec, store, ttable = small["tespec"], small["tstore"], small["tttable"]
        plan = interop.plan_from_numpy(to_np(fig1_plan()))
        batches = [make_mutation_batch(small["tspec"], new_edges=e, device="cpu") for e in edges]
        mk = lambda: ShardedTxnRuntime(espec, flat_mesh(1), route_cap_factor=None, device="cpu")
        Journal, Ctl, F, Drain = WriteBehindJournal, FailoverController, TF, ShardedMissDrain
        host = interop.pstore_to_numpy
    else:
        espec, store, ttable, plan = small["jespec"], small["store"], small["jttable"], fig1_plan()
        batches = [j_batch(small["spec"], new_edges=e) for e in edges]
        mk = lambda: JRuntime(espec, j_flat_mesh(1), route_cap_factor=None)
        Journal, Ctl, F, Drain = JJournal, JController, JF, JDrain
        host = lambda ps: to_np(jax.device_get(ps))
    key = lambda m: {k: v for k, v in m.items() if k != "host_syncs"}
    out = {}

    if control:  # the same commits with no fault
        rt_c = mk()
        ps_c, cache_c = rt_c.partition_store(store), rt_c.empty_cache()
        for mb in batches:
            ps_c, cache_c, _ = rt_c.run_grw_tx(ps_c, cache_c, ttable, mb)
        out["control"] = host(ps_c)

    rt = mk()
    ps, cache = rt.partition_store(store), rt.empty_cache()
    j = Journal(str(tmp_path / pkg), rt.n)
    j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                 store_version=0)
    ctl = Ctl(rt, j, ttable, plan=F.ShardFaultPlan(crash={0: 1}),
              detector=F.FailureDetector(n=1, fail_threshold=2))
    ctl.probe(0)
    r, d, ms, m = ctl.run_gr(ps, cache, plan, roots0, 0)
    out[0] = (np.asarray(r).tolist(), np.asarray(d).tolist(), miss_key(ms), key(m))
    drain = Drain(rt, TPL_META)
    drain.push(ms)
    cache = drain.drain(ps, ps, cache, ttable)
    ctl.probe(1)
    with pytest.raises(F.NodeFailure):
        ctl.run_gr(ps, cache, plan, roots, 1)
    ctl.probe(2)
    r, d, ms, m = ctl.run_gr(ps, cache, plan, roots, 2)
    out[2] = (np.asarray(r).tolist(), np.asarray(d).tolist(), miss_key(ms), key(m))
    before = host(ps)
    writes = []
    for mb in batches:
        ps, cache, w = ctl.run_grw(ps, cache, mb)
        writes.append(w)
    out["writes"] = writes
    tree_equal(host(ps), before)  # queued: the store does not move
    ps, cache, info = ctl.recover(ps, cache, 0)
    out["recover"] = {k: info[k] for k in ("replayed_commits", "replayed_to_seq",
                                           "drained_commits", "recovered_owner")}
    out["store"] = host(ps)
    ctl.probe(3)
    r, d, ms, m = ctl.run_gr(ps, cache, plan, roots, 3)
    out[3] = (np.asarray(r).tolist(), np.asarray(d).tolist(), miss_key(ms), key(m))
    out["metrics"] = ctl.metrics()
    out["journal"] = {k: v for k, v in j.metrics().items() if k != "flushed_bytes"}
    return out


def test_single_shard_crash_degrade_recover_matches_reference(small, tmp_path):
    got, want = _lifecycle("t", small, tmp_path, True), _lifecycle("j", small, tmp_path, False)
    for k in (0, 2, 3, "writes", "recover", "metrics", "journal"):
        assert got[k] == want[k], k
    tree_equal(got["store"], want["store"])
    tree_equal(got["store"], got["control"])
    res2, def2, miss2, m2 = got[2]
    # the warm roots hit through the outage; the cold ones defer, with no
    # miss record, and the degraded batch reports its staleness bound
    assert def2 == [False, False, True, True] and m2["hits"] == 2 and not miss2
    assert m2["deferred_rows"] == m2["deferred"] == 2 and m2["staleness_bound_commits"] == 0
    assert [w["queued"] for w in got["writes"]] == [1, 1]
    assert got["writes"][1]["queued_commits"] == 2
    assert got["recover"]["drained_commits"] == 2 and not any(got[3][1])
    assert got["metrics"]["detections"] == got["metrics"]["recoveries"] == 1


# ------------------------------------------------------ four-shard lifecycle
@pytest.fixture(scope="module")
def big():
    spec, store = build_world(n_watchlists=8, n_listings=24, seed=1)
    cspec = J.CacheSpec(capacity=1024, probes=8, max_leaves=16, max_chunks=2)
    jespec = J.EngineSpec(store=spec, cache=cspec, max_deg=32, frontier=32)
    jttable, _, _ = enabled_ttable()
    return dict(spec=spec, store=store, jespec=jespec, jttable=jttable,
                tspec=interop.store_spec(tuple(spec)),
                tespec=interop.engine_spec(tuple(spec), tuple(cspec), 32, 32),
                tstore=interop.store_from_numpy(to_np(store), device="cpu"),
                tttable=interop.ttable_from_numpy(to_np(jttable)))


PLANS = {"fig1": (fig1_plan(), np.arange(0, 8, dtype=np.int32)),
         "in_out": (common_watchlist_plan(), np.arange(8, 32, dtype=np.int32))}


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_four_shard_crash_against_a_control_and_the_single_host(big, plan_name, tmp_path):
    jplan, roots = PLANS[plan_name]
    plan = interop.plan_from_numpy(to_np(jplan))
    espec, ttable = big["tespec"], big["tttable"]
    edges = ([(0, 9, 0, [1]), (5, 13, 0, [1])], [(1, 8, 0, [0]), (6, 21, 0, [1])])
    batches = [make_mutation_batch(big["tspec"], new_edges=e, device="cpu") for e in edges]
    mk = lambda: ShardedTxnRuntime(espec, flat_mesh(4), route_cap_factor=None, device="cpu")
    rt, rt_c = mk(), mk()
    ps = ps_c = rt.partition_store(big["tstore"])
    cache, cache_c = rt.empty_cache(), rt_c.empty_cache()
    engine = J.GraphEngine(big["jespec"], jplan, True, fused=True)
    # batch 0 on both sides, half the roots populated
    warm = roots[::2]

    def warm_up(r_, c):
        _, ms, _ = r_.run_gr_tx_batch(ps, c, ttable, plan, warm)
        d = ShardedMissDrain(r_, TPL_META)
        d.push(ms)
        return d.drain(ps, ps, c, ttable)

    cache, cache_c = warm_up(rt, cache), warm_up(rt_c, cache_c)
    j = WriteBehindJournal(str(tmp_path / "j"), 4)
    j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                 store_version=int(ps.version))
    ctl = FailoverController(rt, j, ttable, plan=TF.ShardFaultPlan(crash={1: 1}),
                             detector=TF.FailureDetector(n=4, fail_threshold=1))
    ctl.probe(1)  # detected at once: batch 1 serves degraded
    res, deferred, misses, m = ctl.run_gr(ps, cache, plan, roots, 1)
    healthy, _, _ = rt.run_gr_tx_batch(ps, cache, ttable, plan, roots)
    jres, _, _ = engine.run(big["store"], J.empty_cache(big["jespec"].cache), big["jttable"],
                            roots)
    keep = ~deferred
    assert deferred.any() and keep.any() and m["hits"] > 0 and m["deferred_rows"] > 0
    np.testing.assert_array_equal(res[keep], healthy[keep])
    np.testing.assert_array_equal(res[keep], np.asarray(jres)[keep])
    assert not any(x.root % 4 == 1 for x in misses)  # CP must not build from lost blocks
    if plan_name == "fig1":
        assert deferred.tolist() == [r % 4 == 1 and r not in warm for r in roots]
    before = interop.pstore_to_numpy(ps)
    for mb in batches:
        ps, cache, w = ctl.run_grw(ps, cache, mb)
        assert w["queued"] == 1
        ps_c, cache_c, _ = rt_c.run_grw_tx(ps_c, cache_c, ttable, mb)
    tree_equal(interop.pstore_to_numpy(ps), before)
    ps, cache, info = ctl.recover(ps, cache, 1)
    assert info["drained_commits"] == 2 and info["replayed_commits"] == 0
    tree_equal(interop.pstore_to_numpy(ps), interop.pstore_to_numpy(ps_c))
    for b in (2, 3):
        ctl.probe(b)
        got = ctl.run_gr(ps, cache, plan, roots, b)
        want = rt_c.run_gr_tx_batch(ps_c, cache_c, ttable, plan, roots, return_deferred=True)
        np.testing.assert_array_equal(got[0], want[0])
        assert not got[1].any() and miss_key(got[2]) == miss_key(want[1])
        got_m = {k: v for k, v in got[3].items() if k in want[2] and k != "host_syncs"}
        assert got_m == {k: v for k, v in want[2].items() if k != "host_syncs"}
        d, d_c = ShardedMissDrain(rt, TPL_META), ShardedMissDrain(rt_c, TPL_META)
        d.push(got[2])
        d_c.push(want[1])
        cache, cache_c = d.drain(ps, ps, cache, ttable), d_c.drain(ps_c, ps_c, cache_c, ttable)


# ----------------------------------------------------- failover and migration
def test_failover_composes_with_migration(big, tmp_path):
    """Owner 1 crashes on a store whose vertices 9 and 13 (native to owner
    1) migrated away before it: their misses serve from owners 2 and 3
    while owner 1's other misses defer; a migration round waits while the
    owner is down; a queued commit marks its new edges' table owners
    dirty, though the controller was built before the table was attached
    (the serve loop's order); recovery replays a commit of the moved
    vertices and the MIGRATE record after it from the pre-migration
    checkpoint, splices, and drains the queued commit through the table,
    and the store and later batches equal a control that took the same
    commits and round with no fault. A whole replay of the journal on the
    live runtime, whose table holds the moves, equals the live store byte
    for byte: the commit before the round routes through the table of its
    point in the log."""
    from repro_torch.distributed.routing import RoutingTableHost
    from repro_torch.graphstore.migration import MigrationEngine, infer_storage_exceptions

    plan = interop.plan_from_numpy(to_np(fig1_plan()))
    roots = np.arange(8, 32, dtype=np.int32)
    espec, ttable = big["tespec"], big["tttable"]
    mk = lambda: ShardedTxnRuntime(espec, flat_mesh(4), route_cap_factor=None, device="cpu")
    rt, rt_c = mk(), mk()
    ps = ps_c = rt.partition_store(big["tstore"])
    cache, cache_c = rt.empty_cache(), rt_c.empty_cache()
    j = WriteBehindJournal(str(tmp_path / "j"), 4)
    j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                 store_version=int(ps.version))
    ctl = FailoverController(rt, j, ttable, plan=TF.ShardFaultPlan(crash={1: 1}),
                             detector=TF.FailureDetector(n=4, fail_threshold=1))
    hosts = [r.attach_routing(RoutingTableHost(4, device="cpu")) for r in (rt, rt_c)]
    eng = MigrationEngine(rt.pspec, hosts[0], journal=j, detector=ctl.detector)
    # a commit of the vertices about to move, between the checkpoint and
    # the round: it appends at their native owner
    mb0 = make_mutation_batch(big["tspec"], new_edges=[(9, 21, 0, [1]), (13, 9, 0, [1])],
                              device="cpu")
    ps, cache, w0 = ctl.run_grw(ps, cache, mb0)
    assert w0["queued"] == 0
    ps_c, cache_c, _ = rt_c.run_grw_tx(ps_c, cache_c, ttable, mb0)
    moves = [(9, 2), (13, 3)]
    ps, cache, _ = eng.apply(ps, moves, cache=cache)
    ps_c, cache_c, _ = MigrationEngine(rt.pspec, hosts[1]).apply(ps_c, moves, cache=cache_c)
    j.flush()  # the flusher's work: recovery replays durable records only
    ctl.probe(1)  # detected at once: batch 1 serves degraded
    res, deferred, misses, m = ctl.run_gr(ps, cache, plan, roots, 1)
    want = rt_c.run_gr_tx_batch(ps_c, cache_c, ttable, plan, roots, return_deferred=True)
    lost = [r % 4 == 1 and r not in (9, 13) for r in roots]
    assert deferred.tolist() == lost and m["deferred_rows"] == sum(lost)
    np.testing.assert_array_equal(res[~deferred], want[0][~deferred])
    assert sorted(x.root for x in misses if x.root % 4 == 1) == [9, 13]
    # the round waits for the recovery
    eng.observe([9] * 40)
    ps_w, cache_w, mv = eng.step(ps, [0, 40, 0, 0], cache=cache)
    assert mv == [] and ps_w is ps and eng.deferred_rounds == 1
    mb = make_mutation_batch(big["tspec"], new_edges=[(1, 9, 0, [1]), (9, 20, 0, [1])],
                             device="cpu")
    j._dirty_owners.clear()
    ps, cache, w = ctl.run_grw(ps, cache, mb)
    assert w["queued"] == 1 and j._dirty_owners == {1, 0, 2}  # 9 -> its table owner 2
    ps_c, cache_c, _ = rt_c.run_grw_tx(ps_c, cache_c, ttable, mb)
    ps, cache, info = ctl.recover(ps, cache, 1)
    assert info["replayed_migrations"] == 1 and info["drained_commits"] == 1
    assert info["replayed_commits"] == 1
    tree_equal(interop.pstore_to_numpy(ps), interop.pstore_to_numpy(ps_c))
    assert infer_storage_exceptions(rt.pspec, ps) == hosts[0].storage_exceptions == dict(moves)
    ps_r, _, rinfo = replay(j, rt, ttable)
    assert (rinfo["replayed_commits"], rinfo["replayed_migrations"]) == (2, 1)
    tree_equal(interop.pstore_to_numpy(ps_r), interop.pstore_to_numpy(ps))
    assert rt.rhost is hosts[0]
    ctl.probe(2)
    got = ctl.run_gr(ps, cache, plan, roots, 2)
    want = rt_c.run_gr_tx_batch(ps_c, cache_c, ttable, plan, roots, return_deferred=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert not got[1].any() and miss_key(got[2]) == miss_key(want[1])
    assert {k: v for k, v in got[3].items() if k in want[2] and k != "host_syncs"} == \
        {k: v for k, v in want[2].items() if k != "host_syncs"}


# ----------------------------------------------------------------------- hedge
def test_hedged_read_masks_the_straggler_as_the_reference(small, tmp_path):
    outs = []
    for tag in ("t", "j"):
        if tag == "t":
            rt = ShardedTxnRuntime(small["tespec"], flat_mesh(1), route_cap_factor=None,
                                   device="cpu")
            store, ttable = small["tstore"], small["tttable"]
            plan, F, Journal, Ctl = (interop.plan_from_numpy(to_np(fig1_plan())), TF,
                                     WriteBehindJournal, FailoverController)
        else:
            rt = JRuntime(small["jespec"], j_flat_mesh(1), route_cap_factor=None)
            store, ttable, plan, F, Journal, Ctl = (small["store"], small["jttable"], fig1_plan(),
                                                    JF, JJournal, JController)
        ps, cache = rt.partition_store(store), rt.empty_cache()
        roots = np.array([0, 1, 2, 3], np.int32)
        rt.run_gr_tx_batch(ps, cache, ttable, plan, roots)  # warm, outside the race
        hedge = F.HedgedCalls()
        ctl = Ctl(rt, Journal(str(tmp_path / tag), 1), ttable,
                  plan=F.ShardFaultPlan(hang={0: (0, 10, 2.0)}),
                  detector=F.FailureDetector(n=1, fail_threshold=2, straggle_after=1.0),
                  hedge=hedge, hedge_after=0.05)
        ctl.probe(0)
        assert ctl.detector.straggling() == frozenset({0}) and not ctl.detector.down()
        t0 = time.perf_counter()
        res, deferred, misses, m = ctl.run_gr(ps, cache, plan, roots, 0)
        assert time.perf_counter() - t0 < 1.5  # the hedge's time, not the straggler's
        m.pop("host_syncs")
        outs.append((np.asarray(res).tolist(), deferred.tolist(), miss_key(misses), m,
                     hedge.hedged, hedge.hedge_wins, hedge.hedge_rate))
    assert outs[0] == outs[1]
    assert outs[0][3]["hedged"] == 1 and all(outs[0][1])


def test_the_batch_after_a_hedge_equals_a_runtime_that_never_hedged(big, tmp_path):
    """Owner 2 straggles in batch 0 only: the masked hedge wins; the loser
    launches nothing and records nothing, so batch 1 (unhedged) equals a
    runtime that never hedged: result, misses, metrics, host reads, the
    owner-stage block and the mesh's collective counts."""
    plan = interop.plan_from_numpy(to_np(common_watchlist_plan()))
    roots = np.arange(8, 32, dtype=np.int32)
    mk = lambda: ShardedTxnRuntime(big["tespec"], flat_mesh(4), route_cap_factor=None,
                                   device="cpu")
    rt, rt_c = mk(), mk()
    ps = rt.partition_store(big["tstore"])
    cache = rt.empty_cache()
    ctl = FailoverController(rt, WriteBehindJournal(str(tmp_path / "j"), 4), big["tttable"],
                             plan=TF.ShardFaultPlan(hang={2: (0, 1, 2.0)}),
                             detector=TF.FailureDetector(n=4, straggle_after=1.0),
                             hedge=TF.HedgedCalls(), hedge_after=0.05)
    counts0 = dict(rt.mesh.counts)
    ctl.probe(0)
    res, deferred, _, m = ctl.run_gr(ps, cache, plan, roots, 0)
    assert m["hedged"] == 1 and deferred.any() and ctl.hedge.hedge_wins == 1
    hedge_counts = {k: rt.mesh.counts[k] - counts0[k] for k in counts0}
    # one program's collectives were adopted: the winner's alone
    rt_c.run_gr_tx_batch(ps, cache, big["tttable"], plan, roots,
                                     down=np.array([0, 0, 1, 0], bool))
    assert hedge_counts == rt_c.mesh.counts
    time.sleep(2.1)  # past the scripted delay: a loser that ran on would have run by now
    assert {k: rt.mesh.counts[k] - counts0[k] for k in counts0} == hedge_counts
    ctl.probe(1)
    assert not ctl.detector.straggling()
    got = ctl.run_gr(ps, cache, plan, roots, 1)
    want = rt_c.run_gr_tx_batch(ps, cache, big["tttable"], plan, roots, return_deferred=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert miss_key(got[2]) == miss_key(want[1]) and not got[3]["hedged"]
    assert {k: got[3][k] for k in want[2]} == want[2]
    np.testing.assert_array_equal(rt.last_owner_stage, rt_c.last_owner_stage)
    assert rt.mesh.counts == rt_c.mesh.counts


# ------------------------------------------------------------- healthy batch
def test_healthy_batch_keeps_its_kernel_calls_host_reads_and_collectives(big, monkeypatch):
    plan = interop.plan_from_numpy(to_np(common_watchlist_plan()))
    roots = np.arange(8, 32, dtype=np.int32)
    calls = {"cache_probe": 0, "block_gather": 0}
    for mod, name in ((cache_mod, "cache_probe"), (bg_ops, "block_gather")):
        inner = getattr(mod, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    seen = []
    for how in ("plain", "down_all_false"):
        rt = ShardedTxnRuntime(big["tespec"], flat_mesh(4), route_cap_factor=None, device="cpu")
        ps, cache = rt.partition_store(big["tstore"]), rt.empty_cache()
        kw = {}
        if how == "down_all_false":
            kw["down"] = np.zeros(4, bool)
        for k in calls:
            calls[k] = 0
        res, ms, m, d = rt.run_gr_tx_batch(ps, cache, big["tttable"], plan, roots,
                                           return_deferred=True, **kw)
        seen.append((res.tolist(), miss_key(ms), m, dict(calls), dict(rt.mesh.counts)))
        assert not d.any() and m["deferred"] == 0
    assert seen[0] == seen[1]
    assert seen[0][3]["cache_probe"] > 0 and seen[0][3]["block_gather"] > 0


# ------------------------------------------------------ the degraded hook
@pytest.mark.parametrize("down_owner", [0, 1, 2, 3, "all"])
def test_down_owners_defer_their_misses_and_serve_their_hits(big, down_owner):
    """With half the roots cached, a batch that names ``down_owner`` (or
    every owner) down defers exactly the cold roots it owns: they come back
    flagged, counted in ``deferred`` and with no miss record; every other
    row, and the other owners' miss records, equal a healthy call's."""
    plan = interop.plan_from_numpy(to_np(fig1_plan()))
    roots = np.arange(0, 8, dtype=np.int32)
    rt = ShardedTxnRuntime(big["tespec"], flat_mesh(4), route_cap_factor=None, device="cpu")
    ps, cache = rt.partition_store(big["tstore"]), rt.empty_cache()
    warm = roots[:4]  # one warm and one cold root at each owner
    _, ms, _ = rt.run_gr_tx_batch(ps, cache, big["tttable"], plan, warm)
    drain = ShardedMissDrain(rt, TPL_META)
    drain.push(ms)
    cache = drain.drain(ps, ps, cache, big["tttable"])
    down = np.ones(4, bool) if down_owner == "all" else np.arange(4) == down_owner
    res, misses, m, deferred = rt.run_gr_tx_batch(ps, cache, big["tttable"], plan, roots,
                                                  down=down, return_deferred=True)
    healthy, h_misses, h_m = rt.run_gr_tx_batch(ps, cache, big["tttable"], plan, roots)
    lost = down[roots % 4] & ~np.isin(roots, warm)
    assert deferred.tolist() == lost.tolist() and m["deferred"] == int(lost.sum()) > 0
    np.testing.assert_array_equal(res[~deferred], healthy[~deferred])
    assert miss_key(misses) == miss_key([x for x in h_misses if not down[x.root % 4]])
    assert m["hits"] == h_m["hits"] == len(warm) and m["misses"] == h_m["misses"] - lost.sum()


def test_unscripted_hedge_with_a_fast_primary_serves_the_full_batch(big, tmp_path):
    """Without a fault plan the straggler comes from the measured per-owner
    heartbeat and the primary starts at once: within the hedge deadline it
    wins, no hedge is launched, the batch is the healthy one, and every
    read-epoch pin is released."""
    plan = interop.plan_from_numpy(to_np(fig1_plan()))
    roots = np.arange(0, 8, dtype=np.int32)
    rt = ShardedTxnRuntime(big["tespec"], flat_mesh(4), route_cap_factor=None, device="cpu")
    ps, cache = rt.partition_store(big["tstore"]), rt.empty_cache()
    j = WriteBehindJournal(str(tmp_path / "j"), 4)
    hedge = TF.HedgedCalls()
    ctl = FailoverController(rt, j, big["tttable"],
                             detector=TF.FailureDetector(n=4, straggle_after=1.0),
                             hedge=hedge, hedge_after=60.0)
    rt.last_step_seconds, rt.last_step_owner_seconds = 2.0, [0.1, 0.1, 2.0, 0.1]
    ctl.probe(0)
    assert ctl.detector.straggling() == frozenset({2}) and not ctl.detector.down()
    res, deferred, misses, m = ctl.run_gr(ps, cache, plan, roots, 0)
    healthy, h_misses, h_m = rt.run_gr_tx_batch(ps, cache, big["tttable"], plan, roots)
    np.testing.assert_array_equal(res, healthy)
    assert not deferred.any() and miss_key(misses) == miss_key(h_misses)
    assert m["hedged"] == 0 and (hedge.issued, hedge.hedged, hedge.hedge_wins) == (1, 0, 0)
    jm = j.metrics()
    assert jm["open_pins"] == 0 and jm["leaked_pin_releases"] == 0
