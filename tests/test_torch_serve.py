"""The port's serve loop and its owner-stage telemetry.

- **Owner stage**: at 4 and 1 owners the ``last_owner_stage`` columns sum
  to the batch's global metrics (route overflow counted at the origin, on
  roots that all live at one owner), and a ``telemetry=False`` runtime
  gives the same results, metrics and ``LocalMesh.counts`` with
  ``last_owner_stage`` left ``None``.
- **Serve-loop parity**: ``repro.launch.serve`` run as a subprocess and
  ``repro_torch.launch.serve`` in process with the same flags (the twin on
  the CPU) return the same ``total`` and report the same counters (but
  ``host_syncs``), owner-stage matrix, hit locality, latency-class counts
  and span counts (but ``journal_flush``, whose count depends on timing),
  in five flag sets, one of them a crash of owner 1 with its recovery
  (the ``failover:`` line's counts equal too), one hot-vertex migration
  with half the roots on a hot set of owner 1 (the ``routing:`` line and
  the moves of every round equal too), and one on the replicated store
  tier (no store-tier, maintenance or durability line on either side).
- **A crash under migration**: ``--inject-crash 1:3 --migrate --hot-frac
  0.5``, commits that touch the hot vertices: the commit queued while
  owner 1 is down marks its new edges' table owners dirty (the table is
  attached after the failover controller is built), and ``replay`` of the
  journal, through its incremental checkpoints, equals the live store.
- **Growth through the loop**: blocks small enough that a commit crosses
  the 0.85 occupancy high-water grow at the next batch boundary with a
  GROW record after that commit's; every read equals a run that never
  grows, and ``replay`` of the journal equals the live store.
"""

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import tree_leaves
from repro_torch.core.runtime import bucket_for
from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, base_owner, flat_mesh
from repro_torch.graphstore import BlockCapacityError, WriteBehindJournal, replay
from repro_torch.graphstore.journal import REC_COMMIT, REC_GROW
from repro_torch.launch import serve
from repro_torch.obs.metrics import OWNER_STAGE_FIELDS
from repro_torch.obs.telemetry import ServeTelemetry
from repro_torch.obs.validate import validate_file
from test_torch_fixtures import _torch_test_env  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--shards", "4", "--batches", "6", "--batch", "16", "--vertices", "256",
        "--checkpoint-every", "2"]
CASES = {
    "default": BASE,
    "writes_purge_hot": BASE + ["--write-every", "1", "--purge", "--full-checkpoints",
                                "--hot-frac", "0.5", "--snapshot-every", "2"],
    # owner 1 crashes at batch 3: batch 3 is unavailable, batches 4 and 5
    # serve degraded, recovery runs after batch 5's reads
    "crash_recover": BASE + ["--inject-crash", "1:3", "--recover-after", "2"],
    # a round after every batch: 6 rounds moving owner 1's hot vertices
    "migrate_hot": BASE + ["--migrate", "--hot-frac", "0.5"],
    # the replicated baseline: reads and CP drains only, no journal
    "replicated": BASE + ["--store-tier", "replicated"],
}
# the failover line's counts, beside the total's
FAILOVER_KEYS = ("unavailable_batches", "degraded_batches", "deferred_rows",
                 "queued_commits_drained", "detections", "recoveries", "hedge_rate")
# a column of the owner-stage block and the global metric it sums to
COLUMN_SUMS = {"probe_hits": "hits", "miss_rows": "misses", "edges_scanned": "edges_scanned",
               "leaf_fetches": "leaf_fetches", "route_overflow": "route_overflow",
               "deferred_rows": "deferred"}


@pytest.fixture(scope="module")
def world():
    args = serve.parse_args(["--vertices", "256", "--device", "cpu"])
    espec, plan, ttable, store, rng = serve.reference_world(args, "cpu")
    return dict(espec=espec, plan=plan, ttable=ttable, store=store, rng=rng)


def _tpl_meta(plan):
    return {0: (plan.hops[0].direction, plan.hops[0].edge_label)}


def _metrics_without_syncs(m):
    return {k: v for k, v in m.items() if k != "host_syncs"}


@pytest.mark.parametrize("n", [4, 1])
@pytest.mark.parametrize("traffic", ["uniform", "one_owner_tight_caps"])
def test_owner_stage_sums_and_telemetry_off_is_the_same(world, n, traffic):
    tight = traffic == "one_owner_tight_caps"
    caps = (1,) if tight else None
    rts = {on: ShardedTxnRuntime(world["espec"], flat_mesh(n), device="cpu", telemetry=on,
                                 route_cap_factor=caps) for on in (True, False)}
    ps = rts[True].partition_store(world["store"])
    caches = {on: rt.empty_cache() for on, rt in rts.items()}
    drains = {on: ShardedMissDrain(rt, _tpl_meta(world["plan"])) for on, rt in rts.items()}
    rng = np.random.default_rng(7)
    V = world["espec"].store.v_cap
    hot = np.flatnonzero(base_owner(np.arange(V), n) == min(1, n - 1))  # owner 1's vertices
    overflow = 0
    for b in range(3):
        roots = (rng.choice(hot, 64) if tight else rng.integers(0, V, 64)).astype(np.int32)
        outs = {}
        for on, rt in rts.items():
            counts0 = dict(rt.mesh.counts)
            res, misses, m = rt.run_gr_tx_batch(ps, caches[on], world["ttable"], world["plan"],
                                                roots)
            delta = {k: rt.mesh.counts[k] - counts0[k] for k in counts0}
            outs[on] = (res.tolist(), sorted((x.root, x.tpl_idx) for x in misses), m, delta)
            drains[on].push(misses)
            caches[on] = drains[on].drain(ps, ps, caches[on], world["ttable"], 512)
        # the block adds no collective, no host read and no metric
        assert outs[True] == outs[False]
        assert rts[False].last_owner_stage is None
        stage, m = rts[True].last_owner_stage, outs[True][2]
        assert stage.shape == (n, len(OWNER_STAGE_FIELDS)) and stage.dtype == np.int64
        col = dict(zip(OWNER_STAGE_FIELDS, stage.sum(axis=0).tolist()))
        for field, metric in COLUMN_SUMS.items():
            assert col[field] == m[metric], (field, col, m)
        # one hop: every live root is one owner-side frontier row
        assert col["frontier_rows"] + m["route_overflow"] == len(roots)
        assert rts[True].last_step_seconds > 0
        if tight and n > 1:
            # every root lives at owner 1; each origin rank overflows the rows
            # past its bucket to owner 1, counted at the origin
            Bloc = max(bucket_for(64), n) // n
            live = np.clip(64 - Bloc * np.arange(n), 0, Bloc)  # each origin's live rows
            per_origin = stage[:, OWNER_STAGE_FIELDS.index("route_overflow")]
            assert per_origin.tolist() == np.maximum(live - -(-Bloc // n), 0).tolist()
            owner_rows = stage[:, OWNER_STAGE_FIELDS.index("frontier_rows")]
            assert owner_rows.tolist() == [0, len(roots) - m["route_overflow"], 0, 0][:n]
        overflow += m["route_overflow"]
    assert (overflow > 0) == (tight and n > 1)


def test_elastic_partition_grows_blocks_that_cannot_hold_the_store(world):
    rt = ShardedTxnRuntime(world["espec"], flat_mesh(4), device="cpu")
    rt.set_block_capacity(8)
    with pytest.raises(BlockCapacityError) as e:
        rt.partition_store(world["store"])
    ps = rt.partition_store(world["store"], elastic=True)
    assert rt.pspec.e_blk_cap == max(int(np.ceil(e.value.needed * 1.25)), 9)
    # the same blocks as a partition made under the grown layout from the start
    grown = ShardedTxnRuntime(world["espec"], flat_mesh(4), device="cpu")
    grown.set_block_capacity(rt.pspec.e_blk_cap)
    for a, b in zip(tree_leaves(ps), tree_leaves(grown.partition_store(world["store"])),
                    strict=True):
        assert torch.equal(a, b)


def _span_counts(path):
    c = collections.Counter()
    for line in open(path):
        ev = json.loads(line)
        if ev["type"] == "span":
            c[ev["name"]] += 1
    c.pop("journal_flush", None)
    return dict(c)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Both cases of ``repro.launch.serve``, run at once as subprocesses;
    each returns its ``total`` (the last stdout line) and its trace."""
    procs = {}
    for name, flags in CASES.items():
        d = tmp_path_factory.mktemp(f"ref_{name}")
        argv = flags + ["--trace", str(d / "trace.jsonl"), "--journal-dir", str(d / "journal")]
        code = ("import json, sys; from repro.launch.serve import main; "
                "print(json.dumps(main(sys.argv[1:])))")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        procs[name] = (d, subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT,
                                           env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (d, p) in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-4000:]
        out[name] = (json.loads(stdout.strip().splitlines()[-1]), d / "trace.jsonl", stdout)
    return out


def _summary(stdout):
    """The run line's counts: requests, hits, misses, populated, overflow."""
    line = next(l for l in stdout.splitlines() if " gR-Txs on " in l)
    return {k: int(v) for k, v in (w.split("=") for w in line.split(": ")[1].split(" (")[0]
                                   .split())}


def _routing_lines(stdout):
    """The ``routing:`` line and each round's ``migrated`` line."""
    return [l for l in stdout.splitlines() if l.startswith("routing: ") or " migrated " in l]


def _failover_line(stdout):
    """The failover line's counts (its seconds left out), or None."""
    line = next((l for l in stdout.splitlines() if l.startswith("failover: ")), None)
    if line is None:
        return None
    kv = dict(w.split("=") for w in line[len("failover: "):].split())
    return {k: kv[k] for k in FAILOVER_KEYS}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_loop_matches_the_reference(case, reference_runs, tmp_path, capsys):
    ref_total, ref_trace, ref_out = reference_runs[case]
    trace = tmp_path / "trace.jsonl"
    total = serve.main(CASES[case] + ["--device", "cpu", "--trace", str(trace),
                                      "--journal-dir", str(tmp_path / "journal")])
    out = capsys.readouterr().out
    for t in (total, ref_total):
        t.pop("trace_events")  # counts journal_flush spans: timing-dependent
        t.pop("recovery_seconds", None)  # a timing
    assert total == ref_total
    assert _summary(out) == _summary(ref_out)
    assert _failover_line(out) == _failover_line(ref_out)
    assert _routing_lines(out) == _routing_lines(ref_out)
    if case == "migrate_hot":
        assert total["migration_rounds"] >= 1 and total["locality_routed"] > 0
    if case == "crash_recover":
        assert total["unavailable_batches"] == 1 and total["recoveries"] == 1
        assert total["deferred_rows"] == total["deferred"] > 0
    if case == "replicated":
        # the baseline serves reads and CP only: no blocks, no journal
        for head in ("store tier:", "journal:", "maintenance:", "durability:"):
            assert not any(l.startswith(head) for l in out.splitlines() + ref_out.splitlines())
        assert "[replicated]" in next(l for l in out.splitlines() if " gR-Txs on " in l)
    for path in (trace, ref_trace):
        validate_file(str(path), expect_report=True)
    rep, ref_rep = (json.loads(open(p).read().splitlines()[-1]) for p in (trace, ref_trace))
    assert _metrics_without_syncs(rep["counters"]) == _metrics_without_syncs(ref_rep["counters"])
    assert rep["owner_stage"] == ref_rep["owner_stage"]
    assert rep["hit_locality"] == ref_rep["hit_locality"]
    assert ({c: v["count"] for c, v in rep["latency"].items()}
            == {c: v["count"] for c, v in ref_rep["latency"].items()})
    assert _span_counts(trace) == _span_counts(ref_trace)


def test_growth_at_the_next_batch_boundary_replays_and_reads_alike(world, tmp_path):
    espec, ttable, plan = world["espec"], world["ttable"], world["plan"]
    args = serve.parse_args(["--batches", "8", "--batch", "16", "--write-every", "1",
                             "--checkpoint-every", "100", "--snapshot-every", "0",
                             "--device", "cpu"])
    from repro_torch.graphstore import make_mutation_batch

    def run(tag, small):
        rng = np.random.default_rng(3)
        V = espec.store.v_cap
        rt = ShardedTxnRuntime(espec, flat_mesh(4), device="cpu", route_cap_factor=None)
        ps = rt.partition_store(world["store"])
        if small:
            # the fullest block just under the high-water: the commits cross it
            longest = int(max(ps.out.blk_len.max(), ps.inc.blk_len.max()))
            rt.set_block_capacity(int(np.ceil(longest / 0.849)))
            ps = rt.partition_store(world["store"])
        e_blk_cap0 = rt.pspec.e_blk_cap
        reads, commits = [], []
        inner = rt.run_gr_tx_batch

        def recorded(*a):
            res, misses, m = inner(*a)
            reads.append((res.tolist(), sorted((x.root, x.tpl_idx) for x in misses),
                          _metrics_without_syncs(m)))
            return res, misses, m

        rt.run_gr_tx_batch = recorded

        def next_commit(b):
            commits.append(b)
            ne = [(int(rng.integers(0, V)), int(rng.integers(0, V)), 0, [1]) for _ in range(8)]
            return make_mutation_batch(espec.store, new_edges=ne, device="cpu")

        args.journal_dir = str(tmp_path / tag)
        tel = ServeTelemetry(4, trace_path=str(tmp_path / f"{tag}.jsonl"))
        rt.tracer = tel.tracer
        logs = []
        out = serve.serve_loop(args, rt, ps, ttable, _tpl_meta(plan),
                               lambda b: (plan, rng.integers(0, V, 16).astype(np.int32)),
                               next_commit, tel, log=logs.append)
        return rt, out, reads, logs, e_blk_cap0

    rt, out, reads, logs, eb0 = run("grows", True)
    _, out_big, reads_big, _, _ = run("never_grows", False)
    grew = [l for l in logs if "grew to" in l]
    crossed = [l for l in logs if "crossed high-water" in l]
    assert len(grew) == len(crossed) == 1 and out.total["swap_events"] == rt.swap_events == 1
    b_cross = int(crossed[0].split()[1].rstrip(":"))
    assert grew[0].startswith(f"batch {b_cross + 1}:")
    assert rt.pspec.e_blk_cap == int(np.ceil(eb0 * 2.0))
    assert reads == reads_big
    # the GROW record follows the commit of the batch that crossed
    j = WriteBehindJournal(str(tmp_path / "grows"), 4)
    kinds = [r.rtype for r in j.read_records()]
    assert kinds.count(REC_GROW) == 1
    assert kinds.index(REC_GROW) == b_cross + 1 and kinds[:b_cross + 1] == [REC_COMMIT] * (
        b_cross + 1)
    spans = _span_counts(tmp_path / "grows.jsonl")
    assert spans["hot_swap_pause"] == 1 and spans["grw_step"] == 8 and spans["gr_dispatch"] == 8
    rt2 = ShardedTxnRuntime(espec, flat_mesh(4), device="cpu")
    ps2, _, info = replay(j, rt2, ttable)
    assert info["replayed_growths"] == 1 and info["replayed_commits"] == 8
    assert rt2.pspec == rt.pspec
    for a, b in zip(tree_leaves(ps2), tree_leaves(out.pstore), strict=True):
        assert torch.equal(a, b)


def test_a_crash_under_migration_marks_table_owners_and_replays_alike(world, tmp_path,
                                                                     monkeypatch):
    args = serve.parse_args(BASE + ["--inject-crash", "1:3", "--recover-after", "2", "--migrate",
                                    "--hot-frac", "0.5", "--write-every", "1", "--batches", "8",
                                    "--device", "cpu", "--journal-dir", str(tmp_path / "j")])
    espec, plan, ttable, store, rng = serve.reference_world(args, "cpu")
    rt = ShardedTxnRuntime(espec, flat_mesh(4), device="cpu")
    ps = rt.partition_store(store, elastic=True)
    next_batch, _ = serve.reference_traffic(args, espec, plan, rng, "cpu")
    hot = [v for v in range(args.vertices) if v % 4 == 1][:4]
    from repro_torch.graphstore import make_mutation_batch

    def next_commit(b):
        # edges among the hottest vertices, which the rounds move away
        ne = [(hot[0], hot[1], 0, [1]), (hot[2], hot[3], 0, [0]), (hot[1], hot[2], 0, [1])]
        return make_mutation_batch(espec.store, new_edges=ne, device="cpu")

    # the owners each commit marks checkpoint-dirty, beside its new edges'
    # table owners (the checkpoint-dirty set: the flusher thread may empty
    # the flush-dirty one as soon as the record is durable)
    marked = []
    inner = WriteBehindJournal.append_commit

    def recorded(self, batch, **kw):
        before = set(self._dirty_since_ckpt)
        self._dirty_since_ckpt.clear()
        seq = inner(self, batch, **kw)
        ends = np.concatenate([batch.ne_src[:int(batch.ne_n)].cpu().numpy(),
                               batch.ne_dst[:int(batch.ne_n)].cpu().numpy()])
        marked.append((kw.get("applied", True), set(self._dirty_since_ckpt),
                       {int(o) for o in rt.rhost.storage_owner(ends)},
                       {int(o) for o in base_owner(ends, 4)}))
        self._dirty_since_ckpt |= before
        return seq

    monkeypatch.setattr(WriteBehindJournal, "append_commit", recorded)
    out = serve.serve_loop(args, rt, ps, ttable, _tpl_meta(plan), next_batch, next_commit,
                           ServeTelemetry(4), log=lambda _: None)
    assert out.total["recoveries"] == 1 and out.total["migration_rounds"] >= 1
    queued = [m for m in marked if not m[0]]
    assert queued and any(want != base for _, _, want, base in queued)
    for _, got, want, _ in marked:
        assert want <= got, (got, want)
    monkeypatch.undo()
    j = WriteBehindJournal(args.journal_dir, 4)
    # the newest checkpoint is incremental and follows the drained commit
    assert j.latest_checkpoint()[1]["kind"] == "incremental"
    ps2, _, info = replay(j, ShardedTxnRuntime(espec, flat_mesh(4), device="cpu"), ttable)
    for a, b in zip(tree_leaves(ps2), tree_leaves(out.pstore), strict=True):
        assert torch.equal(a, b)


def test_maintenance_and_journal_spans(world, tmp_path):
    """``compaction_tick`` (with the ``hot_swap_pause`` of a growth and the
    ``compact_store`` of a compaction inside it), and the journal's ``journal_flush`` and
    ``checkpoint``, the flushes recorded from the flusher thread while the
    caller reads the tracer."""
    from repro_torch.graphstore import MaintenancePolicy, make_mutation_batch
    from repro_torch.obs.trace import Tracer

    tracer = Tracer()
    rt = ShardedTxnRuntime(world["espec"], flat_mesh(4), device="cpu", tracer=tracer)
    ps = rt.partition_store(world["store"])
    j = WriteBehindJournal(str(tmp_path / "j"), 4, tracer=tracer)
    j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                 store_version=int(ps.version))
    j.start(interval=0.001)
    cache = rt.empty_cache()
    for i in range(3):
        mb = make_mutation_batch(world["espec"].store, new_edges=[(i, i + 1, 0, [1])],
                                 device="cpu")
        ps, cache, _ = rt.run_grw_tx(ps, cache, world["ttable"], mb, journal=j)
        tracer.snapshot()  # reads while the flusher may be recording
    ps, info = rt.maintenance_tick(ps, MaintenancePolicy(recent_fill_frac=0.0,
                                                         grow_occupancy_frac=0.0), journal=j)
    assert info["compacted"] and info["grown_to"] is not None
    j.checkpoint_incremental(ps, e_blk_cap=rt.pspec.e_blk_cap,
                             recent_blk_cap=rt.pspec.recent_blk_cap,
                             store_version=int(ps.version))
    j.stop(final_flush=True)
    snap = tracer.snapshot()
    counts = {k: v["count"] for k, v in snap.items()}
    assert {k: counts[k] for k in ("grw_step", "compaction_tick", "hot_swap_pause",
                                   "compact_store", "checkpoint")} == {
        "grw_step": 3, "compaction_tick": 1, "hot_swap_pause": 1, "compact_store": 1,
        "checkpoint": 2}
    # each checkpoint flushes first; the flusher thread flushed the rest
    assert counts["journal_flush"] >= 2 and j.metrics()["journal_lag_batches"] == 0
    assert snap["compaction_tick"]["total_s"] >= snap["hot_swap_pause"]["total_s"]
