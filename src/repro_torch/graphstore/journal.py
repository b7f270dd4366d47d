"""Write-behind durability for the partitioned store: an append-only
journal of committed gRW mutation batches, a coalescing flusher, and
checkpoint + replay that rebuild a crashed store byte for byte.

PyTorch package twin of ``repro.graphstore.journal``, with its record
format byte for byte, so either package reads the other's journal. Commits
land in the device store at once; ``append_commit`` queues the record (one
copy of the batch to the host, no I/O) and marks the owners it touches
dirty; the flusher persists the queue behind the serve loop with bounded
retries (``distributed.fault.RetryPolicy``). While an owner is down the
failover tier journals commits *unapplied* (``applied=False``): the
applied watermark ``applied_seq`` stops, and recovery replays up to it
(``replay_to_owner``), then applies the rest against the live store
(``drain_queued``).

Record format
=============

A journal is a sequence of self-delimiting frames::

    MAGIC "GJL2" (4s) | seq (u64 LE) | rtype (u8) | payload_len (u32 LE) |
    crc32(header[0:17] + payload) (u32 LE) | payload

The crc covers the header fields too, so a flipped bit anywhere in a frame
(a corrupted length included) fails at that frame.

- ``COMMIT`` (1): one committed ``MutationBatch``: a JSON spec (field names,
  shapes, dtypes, and the commit's write policy and maintenance gate)
  followed by the arrays' raw bytes. Replay re-runs each commit through the
  same policy and gate; the gate's compactions are a function of (store,
  batch, gate), so replay reproduces the block layout too.
- ``COMPACT`` (2): a host-scheduled compaction (its purge flag).
- ``GROW`` (3): a capacity change (``e_blk_cap``, ``recent_blk_cap``).
- ``MIGRATE`` (4): a hot-vertex migration round (its moves), replayed
  through the same deterministic splice (``graphstore.migration``).

A torn tail (a short frame or a crc mismatch) ends a scan: every complete
frame before it replays, the partial one is dropped.

Coalescing
==========

Each flush drains the whole pending queue as ONE write + fsync. Records are
never merged or reordered. A flush that fails mid-write leaves bytes past
the last durable offset; the retry truncates back to it and rewrites the
group, so a record is never lost and never written twice.

Epochs and purge
================

``compact_block(purge=True)`` reclaims tombstone lanes, after which a
mutation naming a purged geid resolves to "not found". ``EpochRegistry``
allows purge only when no reader pins an epoch older than the store version
and the journal's checkpoint covers that version.

Flushes and checkpoints run in ``journal_flush`` and ``checkpoint`` spans
of the journal's ``tracer`` (``repro_torch.obs.trace``; the flusher thread
records into it too, so it must be thread-safe, as ``Tracer`` is).

Replay rebuilds the routing table's trajectory with the store: the
restored checkpoint's placement is read back from its bytes
(``migration.infer_storage_exceptions``), each MIGRATE advances it, and
each replayed COMMIT routes its appends through the table of its point in
the log.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.distributed.fault import RetryPolicy, timed_call
from repro_torch.distributed.routing import base_owner
from repro_torch.graphstore.maintenance import DeviceGate
from repro_torch.graphstore.mutations import MutationBatch
from repro_torch.graphstore.partition import abstract_partitioned_store, splice_owner_blocks
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.utils import resolve_device

_MAGIC = b"GJL2"
_HEADER = struct.Struct("<4sQBII")  # magic, seq, rtype, payload_len, crc32
_CRC_OFFSET = _HEADER.size - 4  # 17: the crc is the header's trailing u32


def _frame_crc(header: bytes, offset: int, payload: bytes) -> int:
    """crc32 over the header (without its crc field), then the payload."""
    crc = zlib.crc32(header[offset: offset + _CRC_OFFSET])
    return zlib.crc32(payload, crc) & 0xFFFFFFFF


REC_COMMIT = 1
REC_COMPACT = 2
REC_GROW = 3
REC_MIGRATE = 4


class FlushError(RuntimeError):
    """The flusher exhausted its bounded retries; records stay pending."""


def _serialize_arrays(fields: dict, meta: dict) -> bytes:
    """JSON spec + concatenated raw bytes for a dict of numpy arrays."""
    spec, blobs = [], []
    for name, arr in fields.items():
        a = np.asarray(arr)
        spec.append({"name": name, "shape": list(a.shape), "dtype": str(a.dtype)})
        blobs.append(np.ascontiguousarray(a).tobytes())
    head = json.dumps({"fields": spec, "meta": meta}).encode()
    return struct.pack("<I", len(head)) + head + b"".join(blobs)


def _deserialize_arrays(payload: bytes):
    (hlen,) = struct.unpack_from("<I", payload, 0)
    head = json.loads(payload[4: 4 + hlen].decode())
    off = 4 + hlen
    fields = {}
    for f in head["fields"]:
        dt = np.dtype(f["dtype"])
        n = int(np.prod(f["shape"], dtype=np.int64)) * dt.itemsize
        fields[f["name"]] = np.frombuffer(payload[off: off + n], dtype=dt).reshape(f["shape"])
        off += n
    return fields, head["meta"]


def batch_to_numpy(batch: MutationBatch) -> dict:
    """Every field of a batch as a numpy array, in field order. Tensor
    fields (all int32) cross to the host in ONE copy."""
    vals = [getattr(batch, f) for f in MutationBatch._fields]
    if not all(isinstance(v, torch.Tensor) for v in vals):
        return {f: np.asarray(v) for f, v in zip(MutationBatch._fields, vals)}
    flat = torch.cat([v.reshape(-1).to(torch.int32) for v in vals]).cpu().numpy()
    out, off = {}, 0
    for f, v in zip(MutationBatch._fields, vals):
        out[f] = flat[off: off + v.numel()].reshape(tuple(v.shape))
        off += v.numel()
    return out


def encode_commit(batch: MutationBatch, *, policy: str = "write-around",
                  gate: Optional[DeviceGate] = None) -> bytes:
    """Payload of a COMMIT record: the batch arrays + the step config."""
    meta = {"policy": policy}
    if gate is not None:
        meta["gate"] = [float(gate.recent_fill_frac), bool(gate.purge)]
    return _serialize_arrays(batch_to_numpy(batch), meta)


def decode_commit(payload: bytes, device=None):
    """Inverse of ``encode_commit`` -> ``(MutationBatch, policy, gate)``, the
    batch's tensors on ``device`` (CUDA unless another is named)."""
    dev = resolve_device(device)
    fields, meta = _deserialize_arrays(payload)
    batch = MutationBatch(**{f: torch.tensor(fields[f], device=dev)
                             for f in MutationBatch._fields})
    gate = meta.get("gate")
    if gate is not None:
        gate = DeviceGate(recent_fill_frac=gate[0], purge=bool(gate[1]))
    return batch, meta["policy"], gate


class JournalRecord(NamedTuple):
    seq: int
    rtype: int
    payload: bytes


class EpochRegistry:
    """Readers pin the store version they read at; purge reclaims only
    behind the oldest pinned epoch and the journal's checkpoint (module
    docstring). Thread-safe: the flusher thread and the serve loop both
    touch it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pins: dict[int, int] = {}
        self._next_token = 0
        self.current = 0
        self.leaked_releases = 0

    def advance(self, epoch: int) -> None:
        """Record a new committed store version (monotone)."""
        with self._lock:
            self.current = max(self.current, int(epoch))

    def pin(self, epoch: Optional[int] = None) -> int:
        """Pin an epoch (default: the current one); returns a release token."""
        with self._lock:
            tok = self._next_token
            self._next_token += 1
            self._pins[tok] = self.current if epoch is None else int(epoch)
            return tok

    def release(self, token: int) -> None:
        with self._lock:
            self._pins.pop(token, None)

    @contextlib.contextmanager
    def pin_scope(self, epoch: Optional[int] = None):
        """A pin released on every exit path; ``leaked_releases`` counts the
        pins it released on an exception's way out."""
        tok = self.pin(epoch)
        try:
            yield tok
        except BaseException:
            with self._lock:
                self.leaked_releases += 1
            raise
        finally:
            self.release(tok)

    def open_pins(self) -> int:
        with self._lock:
            return len(self._pins)

    def min_pinned(self) -> int:
        """The oldest live snapshot's epoch (the current one when none)."""
        with self._lock:
            return min(self._pins.values(), default=self.current)

    def safe_to_purge(self, store_version: int,
                      journal: Optional["WriteBehindJournal"] = None) -> bool:
        """True iff every tombstone (epoch <= store_version) is older than
        the oldest pinned epoch and covered by the journal's checkpoint."""
        if self.min_pinned() < int(store_version):
            return False
        if journal is not None and journal.checkpoint_version < int(store_version):
            return False
        return True


def _to_numpy_tree(tree):
    """A tree of tensors as the same tree of host numpy arrays."""
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return tree_unflatten(tree, [host(x) for x in tree_leaves(tree)])


class WriteBehindJournal:
    """Append-only write-behind journal + coalescing flusher + checkpoints.

    ``append_commit`` is the acceptance point: it queues the record and
    marks the touched owners dirty, with no I/O. ``flush`` (or the thread
    ``start`` runs) drains the queue; ``checkpoint`` /
    ``checkpoint_incremental`` bound replay time.

    ``flush_fault(attempt)`` is called after half of a group's bytes are
    written and before the rest: raising simulates a torn flush, which the
    bounded retries must absorb without losing or duplicating a record.
    ``io_timeout`` bounds each write and checkpoint save (``timed_call``).
    ``tracer`` (an ``obs.trace.Tracer``) times each flush and checkpoint;
    the default records nothing.
    """

    def __init__(self, root: str, n_shards: int, *, retry: Optional[RetryPolicy] = None,
                 flush_fault: Optional[Callable[[int], None]] = None,
                 io_timeout: Optional[float] = None, tracer=None):
        self.root = root
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.n = n_shards
        self.retry = retry if retry is not None else RetryPolicy(max_attempts=4)
        self.flush_fault = flush_fault
        self.io_timeout = io_timeout
        os.makedirs(root, exist_ok=True)
        self.log_path = os.path.join(root, "wal.log")
        self.meta_path = os.path.join(root, "journal_meta.json")
        self.ckpt_dir = os.path.join(root, "ckpt")
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()  # one flusher at a time
        self._pending: list[JournalRecord] = []
        self._dirty_owners: set[int] = set()
        # owners whose blocks changed since the last checkpoint (cleared only
        # by a checkpoint): what an incremental checkpoint persists
        self._dirty_since_ckpt: set[int] = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._queued_commits = 0  # journaled unapplied since the last drain
        self.epochs = EpochRegistry()
        self.next_seq = 1
        self.durable_seq = 0
        # the highest seq applied to the live device store: it follows
        # next_seq - 1 until an outage queues commits unapplied, then stays
        # at the outage's start until ``drain_queued``
        self.applied_seq = 0
        self._durable_offset = 0
        self.checkpoint_seq = 0
        self.checkpoint_version = 0
        self.flushes = 0
        self.flush_retries = 0
        self.flush_failures = 0
        self.flushed_records = 0
        self.flushed_bytes = 0
        self._load_meta()

    # ------------------------------------------------------------- appends
    def _append(self, rtype: int, payload: bytes) -> int:
        with self._lock:
            seq = self.next_seq
            self.next_seq += 1
            self._pending.append(JournalRecord(seq, rtype, payload))
            return seq

    def append_commit(self, batch: MutationBatch, *, policy: str = "write-around",
                      gate: Optional[DeviceGate] = None,
                      commit_version: Optional[int] = None, device_compactions: int = 0,
                      applied: bool = True, route: Optional[Callable] = None) -> int:
        """Queue one committed gRW batch and mark the owners it touches dirty.

        The batch crosses to the host in one copy (``batch_to_numpy``).
        ``device_compactions > 0`` marks every owner checkpoint-dirty (the
        gate may rewrite any block). New edges mark their endpoints' owners:
        ``route`` maps ids to owners (``RoutingTableHost.storage_owner`` once
        vertices have moved; the base rule ``v mod n`` by default); deletes
        and edge-prop edits name geids, whose owners the host cannot tell,
        so they mark every owner dirty.

        ``applied=False`` is degraded mode's write: the record is durable like
        any other but was not applied to the live store, so ``applied_seq``
        stays where it is and ``queued_commits`` counts it until
        ``drain_queued`` applies it."""
        fields = batch_to_numpy(batch)
        seq = self._append(REC_COMMIT, encode_commit(MutationBatch(**fields), policy=policy,
                                                     gate=gate))
        owners = set()
        k = int(fields["ne_n"])
        if k:
            route = route if route is not None else (lambda v: base_owner(v, self.n))
            for ids in (fields["ne_src"], fields["ne_dst"]):
                owners.update(int(o) for o in np.unique(np.asarray(route(ids[:k]))))
        if int(fields["de_n"]) or int(fields["se_n"]) or int(device_compactions) > 0:
            owners.update(range(self.n))
        with self._lock:
            self._dirty_owners |= owners
            self._dirty_since_ckpt |= owners
            if applied:
                self.applied_seq = max(self.applied_seq, seq)
            else:
                self._queued_commits += 1
        if commit_version is not None:
            self.epochs.advance(commit_version)
        return seq

    def _append_layout(self, rtype: int, meta: dict) -> int:
        """A record that rewrites every owner's blocks (all go
        checkpoint-dirty), applied to the live store as it is journaled."""
        seq = self._append(rtype, json.dumps(meta).encode())
        with self._lock:
            self._dirty_since_ckpt.update(range(self.n))
            self.applied_seq = max(self.applied_seq, seq)
        return seq

    def append_compact(self, *, purge: bool = False) -> int:
        """Journal a host-scheduled compaction (replayed at its point)."""
        return self._append_layout(REC_COMPACT, {"purge": bool(purge)})

    def append_grow(self, e_blk_cap: int, recent_blk_cap: int) -> int:
        """Journal a capacity change (replayed at its point)."""
        return self._append_layout(REC_GROW, {"e_blk_cap": int(e_blk_cap),
                                              "recent_blk_cap": int(recent_blk_cap)})

    def append_migrate(self, moves, epoch: Optional[int] = None) -> int:
        """Journal a hot-vertex migration round: the moves ``[(vid, dst),
        ...]`` and the routing-table epoch they produce, framed as the
        reference frames them."""
        return self._append_layout(REC_MIGRATE, {
            "moves": [[int(v), int(d)] for v, d in moves],
            "epoch": None if epoch is None else int(epoch),
        })

    # ------------------------------------------------------------- flusher
    def _frame(self, rec: JournalRecord) -> bytes:
        head = _HEADER.pack(_MAGIC, rec.seq, rec.rtype, len(rec.payload), 0)
        crc = _frame_crc(head, 0, rec.payload)
        return head[:_CRC_OFFSET] + struct.pack("<I", crc) + rec.payload

    def flush(self) -> int:
        """Group-commit the pending queue: one write + fsync for the whole
        group, with bounded retries (truncate to the durable offset, rewrite
        the group). Returns the number of records made durable."""
        with self._flush_lock, self.tracer.span("journal_flush"):
            return self._flush_locked()

    def _flush_locked(self) -> int:
        with self._lock:
            group = list(self._pending)
        if not group:
            return 0
        buf = b"".join(self._frame(r) for r in group)
        attempt_box = [0]

        def write_group():
            attempt = attempt_box[0]
            attempt_box[0] += 1
            with open(self.log_path, "ab") as f:
                f.truncate(self._durable_offset)  # drop a failed attempt's bytes
                f.seek(self._durable_offset)
                half = len(buf) // 2
                f.write(buf[:half])
                f.flush()
                if self.flush_fault is not None:
                    self.flush_fault(attempt)  # may raise: a torn flush
                f.write(buf[half:])
                f.flush()
                os.fsync(f.fileno())

        def on_retry(attempt, exc):
            self.flush_retries += 1

        try:
            self.retry.run(lambda: timed_call(write_group, self.io_timeout), on_retry=on_retry)
        except Exception as e:  # noqa: BLE001 — surfaced as flusher state
            self.flush_failures += 1
            raise FlushError(f"flush failed after {self.retry.max_attempts} attempts: {e}") from e
        with self._lock:
            self._durable_offset += len(buf)
            self.durable_seq = group[-1].seq
            self._pending = self._pending[len(group):]  # appended meanwhile: still pending
            if not self._pending:
                self._dirty_owners.clear()
            self.flushes += 1
            self.flushed_records += len(group)
            self.flushed_bytes += len(buf)
        self._save_meta()
        return len(group)

    def start(self, interval: float = 0.005) -> None:
        """Start the flusher thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    if self._pending:
                        self.flush()
                except FlushError:
                    pass  # counted; the records stay pending for the next cycle
                self._stop.wait(interval)

        self._thread = threading.Thread(target=loop, name="journal-flusher", daemon=True)
        self._thread.start()

    def stop(self, *, final_flush: bool = True) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                raise RuntimeError("the journal flusher did not stop within 10 s")
            self._thread = None
        if final_flush and self._pending:
            self.flush()

    # ------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        with self._lock:
            pending = len(self._pending)
            dirty = len(self._dirty_owners)
            dirty_ckpt = len(self._dirty_since_ckpt)
            queued = self._queued_commits
            applied = self.applied_seq
        return {
            "journal_lag_batches": (self.next_seq - 1) - self.durable_seq,
            "flush_queue_depth": pending,
            "dirty_owners": dirty,
            "dirty_owners_since_ckpt": dirty_ckpt,
            "applied_seq": applied,
            "queued_commits": queued,
            "open_pins": self.epochs.open_pins(),
            "leaked_pin_releases": self.epochs.leaked_releases,
            "flushes": self.flushes,
            "flush_retries": self.flush_retries,
            "flush_failures": self.flush_failures,
            "flushed_records": self.flushed_records,
            "flushed_bytes": self.flushed_bytes,
            "durable_seq": self.durable_seq,
            "checkpoint_seq": self.checkpoint_seq,
            "pinned_epoch_min": self.epochs.min_pinned(),
        }

    # -------------------------------------------------------- meta durable
    def _save_meta(self) -> None:
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "durable_seq": self.durable_seq,
                "durable_offset": self._durable_offset,
                "checkpoint_seq": self.checkpoint_seq,
                "checkpoint_version": self.checkpoint_version,
                "applied_seq": self.applied_seq,
            }, f)
        os.replace(tmp, self.meta_path)

    def _load_meta(self) -> None:
        meta_applied = None
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                m = json.load(f)
            self.checkpoint_seq = int(m.get("checkpoint_seq", 0))
            self.checkpoint_version = int(m.get("checkpoint_version", 0))
            if "applied_seq" in m:
                meta_applied = int(m["applied_seq"])
        # the log is the ground truth: a flush that landed before the meta
        # rewrite keeps its seqs, a torn group's complete frames stay valid
        off, seq = 0, 0
        for rec, end in self._scan():
            seq, off = rec.seq, end
        self.durable_seq, self._durable_offset = seq, off
        self.next_seq = seq + 1
        # the watermark the meta knew, clamped to what survived on the log;
        # a meta without one predates degraded mode: everything was applied
        self.applied_seq = seq if meta_applied is None else min(meta_applied, seq)

    # ----------------------------------------------------------- read path
    def _scan(self):
        """``(record, end offset)`` of every complete frame, up to the first
        short frame or crc mismatch."""
        if not os.path.exists(self.log_path):
            return
        with open(self.log_path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HEADER.size <= len(data):
            magic, seq, rtype, plen, crc = _HEADER.unpack_from(data, off)
            end = off + _HEADER.size + plen
            if magic != _MAGIC or end > len(data):
                return  # torn tail
            payload = data[off + _HEADER.size: end]
            if _frame_crc(data, off, payload) != crc:
                return  # torn tail
            yield JournalRecord(seq, rtype, bytes(payload)), end
            off = end

    def read_records(self, *, after_seq: int = 0) -> list[JournalRecord]:
        """Every complete frame with ``seq > after_seq``; a torn tail ends
        the scan."""
        return [rec for rec, _ in self._scan() if rec.seq > after_seq]

    # --------------------------------------------------- checkpoint/replay
    def _mark(self):
        """Flush, then the seq a checkpoint taken now covers and the owners
        dirty since the last one."""
        self.flush()
        with self._lock:
            return self.next_seq - 1, sorted(self._dirty_since_ckpt)

    def _publish(self, seq: int, tree, spec_meta: dict) -> str:
        """Save ``tree`` as checkpoint ``seq``, record ``spec_meta`` beside it
        and advance the checkpoint watermark."""
        path = timed_call(save_checkpoint, self.io_timeout, self.ckpt_dir, seq, tree)
        with open(os.path.join(path, "journal.json"), "w") as f:
            json.dump(spec_meta, f)
        with self._lock:
            self._dirty_since_ckpt.clear()
        self.checkpoint_seq = seq
        self.checkpoint_version = int(spec_meta["store_version"])
        self._save_meta()
        return path

    def checkpoint(self, pstore, *, e_blk_cap: int, recent_blk_cap: int,
                   store_version: int) -> str:
        """Snapshot the whole partitioned store, covering every appended
        record. The block layout is recorded so recovery rebuilds the right
        shapes before it replays."""
        with self.tracer.span("checkpoint"):
            seq, _ = self._mark()
            return self._publish(seq, pstore, {
                "kind": "full", "e_blk_cap": int(e_blk_cap),
                "recent_blk_cap": int(recent_blk_cap), "store_version": int(store_version),
            })

    def checkpoint_incremental(self, pstore, *, e_blk_cap: int, recent_blk_cap: int,
                               store_version: int) -> str:
        """Snapshot only the checkpoint-dirty owners' block rows (plus the
        replicated vertex tier and the scalars) on top of the previous
        checkpoint. Falls back to a full ``checkpoint`` when there is no base
        or the block layout changed since (an overlay cannot splice across a
        GROW). Restore walks the chain (``restore_chain``)."""
        base = self.latest_checkpoint()
        if (base is None or int(base[1]["e_blk_cap"]) != int(e_blk_cap)
                or int(base[1]["recent_blk_cap"]) != int(recent_blk_cap)):
            return self.checkpoint(pstore, e_blk_cap=e_blk_cap, recent_blk_cap=recent_blk_cap,
                                   store_version=store_version)
        with self.tracer.span("checkpoint"):
            seq, owners = self._mark()
            tree = _incremental_tree(_to_numpy_tree(pstore), owners, self.n, int(e_blk_cap))
            return self._publish(seq, tree, {
                "kind": "incremental", "base_seq": int(base[0]), "owners": owners,
                "e_blk_cap": int(e_blk_cap), "recent_blk_cap": int(recent_blk_cap),
                "store_version": int(store_version),
            })

    def latest_checkpoint(self):
        """``(seq, spec_meta)`` of the newest checkpoint, or None."""
        seq = latest_step(self.ckpt_dir)
        if seq is None:
            return None
        return seq, self.checkpoint_meta(seq)

    def checkpoint_meta(self, seq: int) -> dict:
        with open(os.path.join(self.ckpt_dir, f"step_{seq}", "journal.json")) as f:
            return json.load(f)


_BLOCK_FIELDS = ("key", "other", "label", "alive", "props", "geid", "gperm", "indptr",
                 "blk_len", "csr_len")


def _incremental_tree(host_pstore, owners, n: int, e_blk_cap: int) -> dict:
    """The overlay an incremental checkpoint persists (numpy, host side):
    the replicated vertex tier and the scalars whole, and the listed
    owners' block rows of both orientations. A dict of dicts, so its leaf
    order is the sorted keys'."""
    idx = np.asarray(owners, np.int64)

    def rows(b) -> dict:
        out = {}
        for f in _BLOCK_FIELDS:
            a = np.asarray(getattr(b, f))
            out[f] = a.reshape((n, -1) + a.shape[1:])[idx]
            if f in ("blk_len", "csr_len"):
                out[f] = out[f].reshape(len(owners))
        return out

    p = host_pstore
    return {
        "vertex": {"vlabel": np.asarray(p.vlabel), "valive": np.asarray(p.valive),
                   "vprops": np.asarray(p.vprops), "vversion": np.asarray(p.vversion)},
        "scalars": {"v_len": np.asarray(p.v_len), "e_len": np.asarray(p.e_len),
                    "version": np.asarray(p.version)},
        "out": rows(p.out),
        "inc": rows(p.inc),
    }


def _apply_overlay(host_pstore, tree: dict, owners, n: int):
    """Splice an incremental overlay's owner rows (and the whole vertex
    tier and scalars) into a host-side (numpy) store; the inverse of
    ``_incremental_tree``."""
    idx = np.asarray(owners, np.int64)

    def blk(b, t: dict):
        def row(cur, new):
            cur = np.asarray(cur)
            out = cur.reshape((n,) + new.shape[1:]).copy()
            out[idx] = new
            return out.reshape(cur.shape)

        return b._replace(**{f: row(getattr(b, f), t[f]) for f in _BLOCK_FIELDS})

    return host_pstore._replace(
        **tree["vertex"], **tree["scalars"],
        out=blk(host_pstore.out, tree["out"]), inc=blk(host_pstore.inc, tree["inc"]),
    )


def _overlay_template(pspec, owners) -> dict:
    """``meta`` tensors shaped like ``_incremental_tree``'s leaves."""
    full = abstract_partitioned_store(pspec)
    k, n = len(owners), pspec.n_shards

    def rows(b) -> dict:
        out = {}
        for f in _BLOCK_FIELDS:
            t = getattr(b, f)
            shape = (k,) if f in ("blk_len", "csr_len") else (k, t.shape[0] // n) + t.shape[1:]
            out[f] = torch.empty(shape, dtype=t.dtype, device="meta")
        return out

    return {
        "vertex": {f: getattr(full, f) for f in ("vlabel", "valive", "vprops", "vversion")},
        "scalars": {f: getattr(full, f) for f in ("v_len", "e_len", "version")},
        "out": rows(full.out), "inc": rows(full.inc),
    }


def restore_chain(journal: WriteBehindJournal, rt):
    """Restore the newest checkpoint, walking its incremental chain back to
    the last full snapshot and splicing each overlay forward (oldest first).
    The runtime adopts the chain's block capacity first (a chain shares one
    layout). Returns ``(pstore, seq, spec_meta)``, the store on the
    runtime's device."""
    ck = journal.latest_checkpoint()
    if ck is None:
        raise FileNotFoundError(f"no checkpoint under {journal.ckpt_dir}; recovery needs at "
                                f"least one (journal records only deltas)")
    seq, spec_meta = ck
    rt.set_block_capacity(spec_meta["e_blk_cap"], recent_blk_cap=spec_meta["recent_blk_cap"])
    chain = []  # (seq, meta) of the incrementals, newest first
    cur_seq, cur_meta = seq, spec_meta
    while cur_meta.get("kind", "full") == "incremental":
        chain.append((cur_seq, cur_meta))
        cur_seq = int(cur_meta["base_seq"])
        cur_meta = journal.checkpoint_meta(cur_seq)
    restore = lambda s, template: _to_numpy_tree(
        restore_checkpoint(journal.ckpt_dir, s, template, device="cpu"))
    pstore = restore(cur_seq, abstract_partitioned_store(rt.pspec))
    for inc_seq, inc_meta in reversed(chain):
        owners = [int(o) for o in inc_meta["owners"]]
        tree = restore(inc_seq, _overlay_template(rt.pspec, owners))
        pstore = _apply_overlay(pstore, tree, owners, rt.n)
    leaves = [torch.from_numpy(np.asarray(x)).to(rt.device) for x in tree_leaves(pstore)]
    return tree_unflatten(pstore, leaves), seq, spec_meta


def _apply_record(rt, ttable, pstore, cache, rec, default_policy: str, info: dict, tag: str,
                  rhost=None):
    """Re-run one journal record through the step family the live run
    used (COMMIT: the recorded policy and gate, routed through ``rhost``,
    the table of the record's point in the log; COMPACT:
    ``compact_step``; GROW: ``grow_blocks``; MIGRATE: the splice, the moved
    vertices' entries dropped from their old cache homes in ``cache`` and
    the moves applied to ``rhost``), counting it in ``info[f"{tag}_..."]``.
    Returns ``(pstore, cache)``."""
    if rec.rtype == REC_COMMIT:
        batch, policy, gate = decode_commit(rec.payload, device=rt.device)
        pstore, cache, _ = rt.run_grw_tx(pstore, cache, ttable, batch, policy or default_policy,
                                         gate=gate, occupancy_metrics=False, rtable=rhost)
        info[f"{tag}_commits"] += 1
    elif rec.rtype == REC_COMPACT:
        pstore = rt.compact_step(json.loads(rec.payload.decode())["purge"])(pstore)
        info[f"{tag}_compactions"] += 1
    elif rec.rtype == REC_GROW:
        m = json.loads(rec.payload.decode())
        pstore = rt.grow_blocks(pstore, m["e_blk_cap"], recent_blk_cap=m["recent_blk_cap"])
        info[f"{tag}_growths"] += 1
    elif rec.rtype == REC_MIGRATE:
        from repro_torch.graphstore.migration import (
            drop_cached_roots, migrate_vertex_rows, moved_away,
        )

        moves = [(int(v), int(d)) for v, d in json.loads(rec.payload.decode())["moves"]]
        pstore = migrate_vertex_rows(rt.pspec, pstore, moves)
        cache = drop_cached_roots(cache, rt.n, *moved_away(rt.n, rhost, moves))
        if rhost is not None:
            rhost.apply_moves(moves)
        info[f"{tag}_migrations"] += 1
    else:
        raise ValueError(f"journal record {rec.seq} has unknown type {rec.rtype}")
    return pstore, cache


def replay(journal: WriteBehindJournal, rt, ttable, *, default_policy: str = "write-around",
           upto_seq: Optional[int] = None):
    """Rebuild the partitioned store of a crashed shard group: restore the
    newest checkpoint (``restore_chain``), then re-apply every durable
    record after it through the step family the live run used (COMMIT: the
    recorded policy and gate; COMPACT: ``compact_step``; GROW:
    ``grow_blocks``; MIGRATE: ``migrate_vertex_rows``). The store path of a
    commit does not depend on the cache, so replay against an empty cache
    reproduces the pre-crash store byte for byte. ``upto_seq`` stops at a
    watermark: recovery from a live outage replays only what the dead store
    had applied (``journal.applied_seq``); the queued rest is
    ``drain_queued``'s. Returns ``(pstore, last_seq, info)``.

    The routing table's trajectory comes with it: the restored placement is
    read from the bytes (``infer_storage_exceptions``), each MIGRATE
    advances it, and each COMMIT routes its appends through it. A runtime
    with no table attached gets the rebuilt one (serving a migrated store
    without it would route moved vertices to owners that lack their rows);
    one that has a table keeps it (its cache overlay is not in the bytes).
    """
    from repro_torch.distributed.routing import RoutingTableHost
    from repro_torch.graphstore.migration import infer_storage_exceptions

    info = {"replayed_commits": 0, "replayed_compactions": 0, "replayed_growths": 0,
            "replayed_migrations": 0}
    pstore, last, _ = restore_chain(journal, rt)
    cache = rt.empty_cache()
    exc = infer_storage_exceptions(rt.pspec, pstore)
    rhost = RoutingTableHost(rt.n, cap=max(64, len(exc)), device=rt.device)
    if exc:
        rhost.apply_moves(sorted(exc.items()))
    for rec in journal.read_records(after_seq=last):
        if upto_seq is not None and rec.seq > upto_seq:
            break
        pstore, cache = _apply_record(rt, ttable, pstore, cache, rec, default_policy, info,
                                      "replayed", rhost)
        last = rec.seq
    journal.epochs.advance(int(pstore.version))
    if rhost.has_exceptions() and rt.rhost is None:
        rt.attach_routing(rhost)
    return pstore, last, info


def replay_to_owner(journal: WriteBehindJournal, rt, ttable, *, live_pstore, owner: int):
    """Recovery as migration: rebuild a dead owner's blocks from durable
    state and graft them into the live store that kept serving degraded.

    ``replay(upto_seq=journal.applied_seq)`` rebuilds the pre-outage store
    (the checkpoint chain and the journal up to the applied watermark, so
    the commits queued during the outage stay out), then
    ``partition.splice_owner_blocks`` moves the dead owner's out / inc block
    rows into it from nowhere but the replay, and every other owner's rows
    from ``live_pstore``. The geid index (``gperm``) travels inside the rows,
    so the spliced store serves at once. The splice writes into the
    replayed store in place on the device: recovery holds the live store,
    the replayed one and the host copy ``restore_chain`` reads, no more.
    The caller then runs ``drain_queued`` and marks the owner healthy.
    Returns ``(pstore, info)``; ``info`` adds ``replay_seconds`` and
    ``splice_seconds``."""
    t0 = time.perf_counter()
    replayed, last, info = replay(journal, rt, ttable, upto_seq=journal.applied_seq)
    t1 = time.perf_counter()
    pstore = splice_owner_blocks(rt.pspec, live_pstore, replayed, owner)
    int(pstore.version)  # the splice's copies end before its time is taken
    info.update(recovered_owner=int(owner), replayed_to_seq=int(last),
                replay_seconds=t1 - t0, splice_seconds=time.perf_counter() - t1)
    return pstore, info


def drain_queued(journal: WriteBehindJournal, rt, ttable, pstore, cache):
    """Apply the commits that queued (durable, unapplied) during an outage,
    in journal order, through the normal gRW step against the LIVE store and
    cache, so the write policy and the maintenance listener see them as
    commits that landed late, which they are. Advances
    ``journal.applied_seq`` record by record and clears the queued count.
    The runtime's attached ``RoutingTableHost`` routes the drained appends
    and takes the moves of drained MIGRATE records. Returns ``(pstore,
    cache, info)``; ``info`` adds ``drain_seconds``."""
    t0 = time.perf_counter()
    journal.flush()
    info = {"drained_commits": 0, "drained_compactions": 0, "drained_growths": 0,
            "drained_migrations": 0}
    for rec in journal.read_records(after_seq=journal.applied_seq):
        pstore, cache = _apply_record(rt, ttable, pstore, cache, rec, "write-around", info,
                                      "drained", rt.rhost)
        with journal._lock:
            journal.applied_seq = max(journal.applied_seq, rec.seq)
    with journal._lock:
        journal._queued_commits = 0
    journal.epochs.advance(int(pstore.version))
    info["drain_seconds"] = time.perf_counter() - t0
    return pstore, cache, info
