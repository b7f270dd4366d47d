"""Parity: the port's write-behind journal and checkpoints against the JAX
package.

- A COMMIT payload (``encode_commit``) and its GJL2 frame are byte-identical
  to the reference's for every mutation section, with and without a gate;
  either package decodes the other's.
- A journal written by either package is read back by the other with the
  same records (COMMIT, COMPACT, GROW, MIGRATE), and a checkpoint saved by
  either (a partitioned store, an incremental overlay tree) is restored by
  the other with equal arrays.
- A torn tail and a flipped byte are handled at every byte offset of a small
  log, by both packages alike.
- Bounded flush retries lose no record and duplicate none; the flusher
  thread absorbs a fault; the dirty-owner map, metrics, reopen, the epoch
  registry, ``RetryPolicy`` and ``timed_call`` behave as the reference's.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from conftest import build_world
from repro.checkpoint import restore_checkpoint as j_restore, save_checkpoint as j_save
from repro.graphstore import journal as JJ
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore import partition as JP
from repro.graphstore.maintenance import DeviceGate as JGate
from repro_torch import interop
from repro_torch.checkpoint import restore_checkpoint as t_restore, save_checkpoint as t_save
from repro_torch.distributed.fault import CallTimeout, RetryPolicy, timed_call
from repro_torch.graphstore import journal as TJ
from repro_torch.graphstore import make_mutation_batch as t_batch
from repro_torch.graphstore import partition as TP
from repro_torch.graphstore.maintenance import DeviceGate
from test_torch_partitioned_grw import tree_equal
from test_torch_sharded import to_np

SPEC, _ = build_world()
TSPEC = interop.store_spec(tuple(SPEC))
SECTIONS = {
    "new_vertices": dict(new_vertices=[(1, [0, 1007]), (0, [3, -5])]),
    "new_edges": dict(new_edges=[(0, 11, 0, [1]), (2, 16, 0, [0])]),
    "del_edges": dict(del_edges=[2, 5, 9]),
    "del_vertices": dict(del_vertices=[9]),
    "set_vprops": dict(set_vprops=[(7, 0, 1), (12, 1, 4242)]),
    "set_eprops": dict(set_eprops=[(1, 0, 0), (4, 0, 1)]),
    "empty": dict(),
}
SECTIONS["all"] = {k: v for d in SECTIONS.values() for k, v in d.items()}


def _mb(i):
    return dict(new_edges=[(i % 4, 4 + (i % 8), 0, [1])], set_vprops=[(i % 4, 0, i % 2)])


@pytest.mark.parametrize("gate", [None, (0.25, True), (0.0, False)], ids=["nogate", "g25p", "g0"])
@pytest.mark.parametrize("section", list(SECTIONS))
def test_commit_frame_is_byte_identical(section, gate, tmp_path):
    kw = SECTIONS[section]
    policy = "write-through" if gate else "write-around"
    jp = JJ.encode_commit(j_batch(SPEC, **kw), policy=policy,
                          gate=JGate(*gate) if gate else None)
    tp = TJ.encode_commit(t_batch(TSPEC, device="cpu", **kw), policy=policy,
                          gate=DeviceGate(*gate) if gate else None)
    assert tp == jp
    rec = TJ.JournalRecord(3, TJ.REC_COMMIT, tp)
    tj = TJ.WriteBehindJournal(str(tmp_path / "t"), 4)
    jj = JJ.WriteBehindJournal(str(tmp_path / "j"), 4)
    assert tj._frame(rec) == jj._frame(JJ.JournalRecord(*rec))
    # each package decodes the other's payload
    tb, tpol, tg = TJ.decode_commit(jp, device="cpu")
    jb, jpol, jg = JJ.decode_commit(tp)
    assert tpol == jpol == policy and (tg is None) == (gate is None)
    if gate:
        assert tuple(tg) == tuple(jg) == (gate[0], gate[1])
    for f in tb._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), f)
        assert getattr(tb, f).dtype == torch.int32


def _write(pkg, root, spec):
    """A journal of every record type, flushed in two groups."""
    J, batch = (JJ, lambda **k: j_batch(spec, **k)) if pkg == "jax" else \
        (TJ, lambda **k: t_batch(TSPEC, device="cpu", **k))
    gate = (JGate if pkg == "jax" else DeviceGate)(0.5, False)
    j = J.WriteBehindJournal(root, 4)
    j.append_commit(batch(**_mb(0)), commit_version=1)
    j.append_commit(batch(**SECTIONS["all"]), policy="write-through", gate=gate,
                    commit_version=2)
    j.flush()
    j.append_compact(purge=True)
    j.append_grow(96, 40)
    j.append_migrate([(5, 2), (9, 0)], epoch=3)
    j.append_commit(batch(**_mb(3)), gate=gate, commit_version=3)
    j.flush()
    return j


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_written_by_either_is_read_by_the_other(writer, tmp_path):
    root = str(tmp_path / "j")
    w = _write(writer, root, SPEC)
    reader = (TJ if writer == "jax" else JJ).WriteBehindJournal(root, 4)
    got, want = reader.read_records(), w.read_records()
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert [r.rtype for r in got] == [1, 1, 2, 3, 4, 1]
    assert reader.durable_seq == w.durable_seq == 6 and reader.next_seq == 7
    assert json.load(open(reader.meta_path))["durable_seq"] == 6
    with open(os.path.join(root, "wal.log"), "rb") as f:
        data = f.read()
    other = str(tmp_path / "k")
    _write("torch" if writer == "jax" else "jax", other, SPEC)
    with open(os.path.join(other, "wal.log"), "rb") as f:
        assert f.read() == data  # the same records give the same bytes


def _small_pstore():
    spec, store = build_world()
    jpspec = JP.default_pspec(spec, 4)
    return jpspec, JP.partition_store(jpspec, store)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_saved_by_either_is_restored_by_the_other(writer, tmp_path):
    """A partitioned store and an incremental overlay tree (a dict of dicts,
    leaves by sorted key) round-trip across the packages."""
    jpspec, jps = _small_pstore()
    tpspec = TP.default_pspec(TSPEC, 4)
    tps = interop.pstore_from_numpy(to_np(jps), device="cpu")
    overlay = TJ._incremental_tree(TJ._to_numpy_tree(tps), [1, 3], 4, tpspec.e_blk_cap)
    d = str(tmp_path / "ck")
    if writer == "jax":
        j_save(d, 7, jps)
        j_save(d, 8, overlay)
        got = t_restore(d, 7, TP.abstract_partitioned_store(tpspec), device="cpu")
        tree_equal(interop.pstore_to_numpy(got), to_np(jps), "store")
        got_o = t_restore(d, 8, TJ._overlay_template(tpspec, [1, 3]), device="cpu")
        tree_equal({k: {f: x.numpy() for f, x in v.items()} for k, v in got_o.items()},
                   overlay, "overlay")
    else:
        t_save(d, 7, tps)
        t_save(d, 8, overlay)
        got = j_restore(d, 7, JP.abstract_partitioned_store(jpspec))
        tree_equal(to_np(got), to_np(jps), "store")
        got_o = j_restore(d, 8, JJ._overlay_template(jpspec, [1, 3]))
        tree_equal({k: {f: np.asarray(x) for f, x in v.items()} for k, v in got_o.items()},
                   overlay, "overlay")
    for i, leaf in enumerate(json.load(open(os.path.join(d, "step_7", "manifest.json")))["leaves"]):
        assert leaf["dtype"] in ("int32", "bool"), (i, leaf)
    with pytest.raises(ValueError, match="shape"):
        t_restore(d, 7, TP.abstract_partitioned_store(tpspec._replace(e_blk_cap=5)), device="cpu")


def test_torn_tail_and_corruption_at_every_byte_offset(tmp_path):
    """A log of four frames (two commits, a compact, a grow), cut at every
    byte offset and with every single byte flipped: both packages return
    exactly the complete, intact frames before the damage, and a journal
    reopened on a cut log resumes at the last intact seq."""
    root = str(tmp_path / "w")
    j = TJ.WriteBehindJournal(root, 2)
    caps = (1, 1, 1, 1, 1, 1)
    j.append_commit(t_batch(TSPEC, device="cpu", caps=caps, new_edges=[(0, 5, 0, [1])]))
    j.append_compact(purge=False)
    j.append_commit(t_batch(TSPEC, device="cpu", caps=caps, set_vprops=[(7, 0, 1)]))
    j.append_grow(64, 32)
    j.flush()
    data = open(j.log_path, "rb").read()
    ends = [end for _, end in j._scan()]
    assert len(ends) == 4 and ends[-1] == len(data)
    readers = [TJ.WriteBehindJournal(str(tmp_path / "t"), 2),
               JJ.WriteBehindJournal(str(tmp_path / "j"), 2)]

    def seqs(blob):
        out = []
        for r in readers:
            with open(r.log_path, "wb") as f:
                f.write(blob)
            out.append([rec.seq for rec in r.read_records()])
        assert out[0] == out[1]
        return out[0]

    for k in range(len(data) + 1):
        assert seqs(data[:k]) == list(range(1, 1 + sum(e <= k for e in ends))), k
        if k < len(data):
            flipped = bytearray(data)
            flipped[k] ^= 0x5A
            frame = sum(e <= k for e in ends)  # the frame holding byte k
            assert seqs(bytes(flipped)) == list(range(1, 1 + frame)), k
    for k in (0, 9, ends[1], ends[1] + 20, len(data) - 1):
        cut = str(tmp_path / f"cut{k}")
        os.makedirs(cut)
        with open(os.path.join(cut, "wal.log"), "wb") as f:
            f.write(data[:k])
        r = TJ.WriteBehindJournal(cut, 2)
        intact = sum(e <= k for e in ends)
        assert r.durable_seq == intact and r.next_seq == intact + 1
        r.append_compact()
        r.flush()  # truncates the torn bytes, reuses no seq
        assert [x.seq for x in r.read_records()] == list(range(1, intact + 2))


@pytest.mark.parametrize("mode", ["fault", "timeout"])
def test_bounded_flush_retries_lose_and_duplicate_nothing(mode, tmp_path):
    """Injected torn flushes (or a hung write past ``io_timeout``) are
    retried within the budget; once it is exhausted the flush raises
    ``FlushError`` with the records still pending, and a later flush writes
    each exactly once."""
    fails = {"n": 2}
    hang = threading.Event()

    def fault(attempt):
        if attempt < fails["n"]:
            if mode == "fault":
                raise OSError(f"injected flush fault {attempt}")
            hang.wait(0.5)  # a hung filesystem: past io_timeout

    j = TJ.WriteBehindJournal(str(tmp_path / "j"), 2, flush_fault=fault,
                              retry=RetryPolicy(max_attempts=4),
                              io_timeout=0.1 if mode == "timeout" else None)
    for i in range(3):
        j.append_commit(t_batch(TSPEC, device="cpu", **_mb(i)))
    assert j.flush() == 3
    m = j.metrics()
    assert m["flush_retries"] == 2 and m["flush_failures"] == 0 and m["flushes"] == 1
    assert [r.seq for r in j.read_records()] == [1, 2, 3]
    fails["n"] = 10**9
    j.append_commit(t_batch(TSPEC, device="cpu", **_mb(3)))
    with pytest.raises(TJ.FlushError):
        j.flush()
    assert j.metrics()["flush_failures"] == 1 and j.metrics()["flush_queue_depth"] == 1
    time.sleep(0.6 if mode == "timeout" else 0)  # the hung writers finish
    fails["n"] = 0
    assert j.flush() == 1
    assert [r.seq for r in j.read_records()] == [1, 2, 3, 4]
    hang.set()


def test_flusher_thread_metrics_dirty_owners_and_reopen(tmp_path):
    calls = []

    def fault(attempt):
        calls.append(attempt)
        if len(calls) == 1:
            raise OSError("injected")

    root = str(tmp_path / "j")
    j = TJ.WriteBehindJournal(root, 4, flush_fault=fault, retry=RetryPolicy(max_attempts=3))
    # dirty owners: edges (0,5) and (4,9) touch owners 0 and 1; deletes all
    j.append_commit(t_batch(TSPEC, device="cpu", new_edges=[(0, 5, 0, [1]), (4, 9, 0, [0])]),
                    commit_version=4)
    assert j.metrics()["dirty_owners"] == 2 and j.epochs.current == 4
    j.append_commit(t_batch(TSPEC, device="cpu", del_edges=[3]))
    j.append_compact()
    m = j.metrics()
    assert m["dirty_owners"] == 4 and m["journal_lag_batches"] == 3
    assert m["flush_queue_depth"] == 3 and m["dirty_owners_since_ckpt"] == 4
    j.start(interval=0.001)
    for i in range(4):
        j.append_commit(t_batch(TSPEC, device="cpu", **_mb(i)))
    deadline = time.monotonic() + 10
    while j.metrics()["flush_queue_depth"] and time.monotonic() < deadline:
        time.sleep(0.01)
    j.stop()
    assert j._thread is None
    m = j.metrics()
    assert m["journal_lag_batches"] == 0 and m["dirty_owners"] == 0 and m["durable_seq"] == 7
    assert [r.seq for r in j.read_records()] == list(range(1, 8))
    # the reference's keys, the applied watermark and the queued commits of
    # degraded mode among them
    assert set(m) == set(JJ.WriteBehindJournal(str(tmp_path / "ref"), 4).metrics())
    assert m["applied_seq"] == 7 and m["queued_commits"] == 0
    # reopen: the log is the ground truth, not the meta file
    os.remove(j.meta_path)
    with open(j.log_path, "ab") as f:
        f.write(b"\x00" * 9)
    j2 = TJ.WriteBehindJournal(root, 4)
    assert j2.durable_seq == 7 and j2.next_seq == 8


def test_epoch_registry_gates_purge(tmp_path):
    e = TJ.EpochRegistry()
    e.advance(5)
    t1 = e.pin()
    e.advance(7)
    e.advance(6)  # monotone
    assert e.current == 7 and e.min_pinned() == 5
    assert not e.safe_to_purge(7) and e.safe_to_purge(5)
    e.release(t1)
    assert e.safe_to_purge(7)
    with pytest.raises(KeyError):
        with e.pin_scope():
            assert e.open_pins() == 1 and not e.safe_to_purge(8)
            raise KeyError("a failed read")
    assert e.open_pins() == 0 and e.leaked_releases == 1
    j = TJ.WriteBehindJournal(str(tmp_path / "j"), 2)
    j.checkpoint_version = 6
    j.epochs.advance(7)
    assert not j.epochs.safe_to_purge(7, j)
    j.checkpoint_version = 7
    assert j.epochs.safe_to_purge(7, j)


def test_retry_policy_and_timed_call():
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    seen = []

    def flaky(x):
        seen.append(x)
        if len(seen) < 3:
            raise OSError("transient")
        return x * 2

    assert RetryPolicy(max_attempts=3).run(flaky, 21, on_retry=lambda a, e: None) == 42
    seen.clear()
    never = RetryPolicy(max_attempts=5, retryable=lambda e: not isinstance(e, OSError))
    with pytest.raises(OSError):
        never.run(flaky, 1)
    assert len(seen) == 1  # not retryable: surfaced at once
    assert timed_call(lambda a, b=0: a + b, None, 1, b=2) == 3
    assert timed_call(lambda a: a, 1.0, 5) == 5
    with pytest.raises(CallTimeout):
        timed_call(time.sleep, 0.05, 0.5)
    with pytest.raises(ZeroDivisionError):
        timed_call(lambda: 1 // 0, 1.0)
