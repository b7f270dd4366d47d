"""Fault tolerance for the serve loop and for elastic runs.

PyTorch package twin of ``repro.distributed.fault``:

- ``RetryPolicy``: bounded exponential-backoff retries with a
  ``retryable`` predicate (the journal flusher's retry loop);
- ``timed_call``: a bounded-wall-clock wrapper for journal flush and
  checkpoint I/O, so a hung filesystem surfaces as ``CallTimeout`` instead
  of freezing the serve loop;
- ``ShardFaultPlan`` / ``FailureDetector``: the serve loop's per-batch
  failure model: scripted crash, hang and torn-flush injection, and the
  consecutive-failure heartbeat detector that turns probe outcomes into a
  ``down`` owner set (degraded-mode serving masks those owners' miss
  segments; see ``distributed.failover``);
- ``HedgedCalls``: straggler mitigation: race a call against a delayed
  hedge and take the first to finish; ``simulate`` keeps the offline
  sampler harness for the p99-versus-cost trade;
- ``ElasticRunner``: a step loop under checkpoint / restart: on a node
  failure it rebuilds a smaller mesh, restores the last checkpoint
  (``repro_torch.checkpoint``) and resumes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff.

    ``retryable(exc) -> bool`` classifies failures: a non-transient error
    surfaces at once instead of burning the attempt budget. ``None``
    retries everything.
    """

    max_attempts: int = 3
    base_delay: float = 0.0  # seconds
    retryable: Optional[Callable[[Exception], bool]] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")

    def run(self, fn: Callable, *args, on_retry: Optional[Callable] = None):
        for attempt in range(self.max_attempts):
            try:
                return fn(*args)
            except Exception as e:  # noqa: BLE001 — classified, then re-raised or retried
                if self.retryable is not None and not self.retryable(e):
                    raise
                if attempt == self.max_attempts - 1:
                    raise
                if on_retry:
                    on_retry(attempt, e)
                if self.base_delay:
                    time.sleep(self.base_delay * (2**attempt))


class NodeFailure(RuntimeError):
    """Raised (or injected) when a worker or owner is lost mid-step."""


class CallTimeout(RuntimeError):
    """A bounded-wall-clock call (``timed_call``) exceeded its budget."""


def timed_call(fn: Callable, timeout: Optional[float], *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` with a wall-clock bound.

    ``timeout=None`` calls inline. Otherwise the call runs on a worker
    thread and ``CallTimeout`` is raised if it does not finish in time; the
    worker finishes in the background (Python threads cannot be killed),
    which suits the I/O calls this wraps: the journal's retry truncates back
    to the last durable offset before it rewrites.
    """
    if timeout is None:
        return fn(*args, **kwargs)
    box: dict = {}
    done = threading.Event()

    def work():
        try:
            box["ok"] = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — re-raised on the caller
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=work, daemon=True).start()
    if not done.wait(timeout):
        raise CallTimeout(f"{getattr(fn, '__name__', fn)!s} exceeded {timeout:.3f}s")
    if "err" in box:
        raise box["err"]
    return box["ok"]


@dataclass
class ShardFaultPlan:
    """A scripted per-batch fault schedule for chaos runs.

    - ``crash[shard] = batch``: the shard's storage is lost from that batch
      on (its probes fail, an unmasked read raises ``NodeFailure``) until
      ``revive``: recovery rebuilds its blocks.
    - ``hang[shard] = (from_batch, to_batch, delay_s)``: the shard is alive
      but straggling in ``[from_batch, to_batch)``: its probes succeed with
      ``delay_s`` latency, which the detector's straggle threshold and the
      hedged read path react to.
    - ``torn_flush_attempts``: journal flush attempts to tear (compose with
      ``WriteBehindJournal(flush_fault=plan.flush_fault)``).
    """

    crash: dict = field(default_factory=dict)  # shard -> batch
    hang: dict = field(default_factory=dict)  # shard -> (from, to, delay_s)
    torn_flush_attempts: tuple = ()

    def crashed_at(self, batch: int) -> frozenset:
        """Shards whose storage is gone as of ``batch``."""
        return frozenset(s for s, b in self.crash.items() if batch >= b)

    def hang_delay(self, shard: int, batch: int) -> float:
        ent = self.hang.get(shard)
        if ent is None:
            return 0.0
        lo, hi, delay = ent
        return float(delay) if lo <= batch < hi else 0.0

    def revive(self, shard: int) -> None:
        """Recovery finished: the (replacement) owner serves again."""
        self.crash.pop(shard, None)

    def flush_fault(self, attempt: int) -> None:
        """``WriteBehindJournal`` fault hook: tear the listed attempts."""
        if attempt in self.torn_flush_attempts:
            raise OSError(f"injected torn flush at attempt {attempt}")


@dataclass
class FailureDetector:
    """Heartbeat-driven failure detection over ``n`` owner shards.

    The serve loop probes each shard once a batch (``observe_ok`` /
    ``observe_failure``); ``fail_threshold`` consecutive failures mark a
    shard down (one blip does not flap the mesh into degraded mode), and
    ``straggle_after`` seconds of probe latency mark it straggling: alive,
    so nothing defers, but the hedged read path races a masked call against
    it. ``mark_recovered`` clears both once recovery completes.
    """

    n: int
    fail_threshold: int = 2
    straggle_after: Optional[float] = None
    _consecutive: dict = field(default_factory=dict)
    _down: set = field(default_factory=set)
    _straggling: set = field(default_factory=set)
    detections: int = 0
    recoveries: int = 0

    def observe_ok(self, shard: int, latency_s: float = 0.0) -> None:
        self._consecutive[shard] = 0
        if self.straggle_after is not None:
            if latency_s >= self.straggle_after:
                self._straggling.add(shard)
            else:
                self._straggling.discard(shard)

    def observe_step(self, latency_s: float, per_owner=None) -> None:
        """Feed one measured serving step's wall clock to the live owners.

        ``per_owner`` (float[n], seconds) is the work-attributed per-owner
        step latency (``ShardedTxnRuntime.last_step_owner_seconds``): each
        live owner observes its own share, so one straggling owner trips
        ``straggle_after`` alone. Without it every live owner observes the
        whole step, which a straggler inflates for the whole mesh. Owners
        already down keep their state: a crash surfaces through
        ``observe_failure``, never through timing."""
        if per_owner is not None:
            per = np.asarray(per_owner, dtype=np.float64).reshape(-1)
            if per.shape[0] != self.n:
                raise ValueError(f"per_owner has {per.shape[0]} entries for {self.n} owners")
            for s in range(self.n):
                if s not in self._down:
                    self.observe_ok(s, latency_s=float(per[s]))
            return
        for s in range(self.n):
            if s not in self._down:
                self.observe_ok(s, latency_s=latency_s)

    def observe_failure(self, shard: int) -> None:
        c = self._consecutive.get(shard, 0) + 1
        self._consecutive[shard] = c
        if c >= self.fail_threshold and shard not in self._down:
            self._down.add(shard)
            self._straggling.discard(shard)
            self.detections += 1

    def down(self) -> frozenset:
        return frozenset(self._down)

    def straggling(self) -> frozenset:
        return frozenset(self._straggling)

    def mark_recovered(self, shard: int) -> None:
        if shard in self._down:
            self.recoveries += 1
        self._down.discard(shard)
        self._straggling.discard(shard)
        self._consecutive[shard] = 0

    def down_mask(self) -> np.ndarray:
        """The read path's ``down`` input: bool[n], True = owner down."""
        m = np.zeros((self.n,), bool)
        for s in self._down:
            m[s] = True
        return m


@dataclass
class ElasticRunner:
    """Checkpoint / restart with an elastic re-mesh.

    ``make_mesh(level) -> mesh`` (level 0 = the full fleet; a ``LocalMesh``
    of fewer ranks a level down, say), ``make_state(mesh) -> state``,
    ``step_fn(mesh, state, step) -> state``. A ``NodeFailure`` drops one
    mesh level (at most ``max_mesh_level``) and resumes from the latest
    checkpoint in ``ckpt_dir``, restored into ``make_state``'s template.
    """

    make_mesh: Callable
    make_state: Callable
    step_fn: Callable
    ckpt_dir: str
    ckpt_every: int = 10
    max_mesh_level: int = 2
    failures_tolerated: int = field(default=8)

    def run(self, n_steps: int, inject_failure_at: Optional[int] = None):
        from repro_torch.checkpoint import (
            latest_step, restore_checkpoint, save_checkpoint, tree_leaves,
        )

        level = 0
        mesh = self.make_mesh(level)
        state = self.make_state(mesh)
        step = failures = 0
        log = []
        while step < n_steps:
            try:
                if inject_failure_at is not None and step == inject_failure_at and failures == 0:
                    raise NodeFailure(f"injected node loss at step {step}")
                state = self.step_fn(mesh, state, step)
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    save_checkpoint(self.ckpt_dir, step, state)
                    log.append(("ckpt", step, level))
            except NodeFailure as e:
                failures += 1
                if failures > self.failures_tolerated:
                    raise
                level = min(level + 1, self.max_mesh_level)
                mesh = self.make_mesh(level)  # the elastic downgrade
                last = latest_step(self.ckpt_dir)
                log.append(("failover", step, level, str(e)))
                template = self.make_state(mesh)
                if last is None:
                    state, step = template, 0
                else:
                    # restored onto the device the new mesh's state lives on
                    device = next((x.device for x in tree_leaves(template)
                                   if hasattr(x, "device")), "cpu")
                    state = restore_checkpoint(self.ckpt_dir, last, template, device=device)
                    step = last
        return state, log


@dataclass
class HedgedCalls:
    """Tail-latency hedging: take the faster of a call and its hedge.

    ``call`` runs ``primary`` and, if it has not finished within
    ``hedge_after`` seconds, launches ``hedge`` too and returns whichever
    finishes first. The read path uses it when the detector reports a
    straggling but alive owner: the primary is the full batch, the hedge
    the masked call. ``issued`` / ``hedged`` / ``hedge_wins`` make the
    hedge rate a serve metric.

    The loser runs on to its end on its daemon thread (a thread cannot be
    killed), so a caller whose callables write shared state gives each
    racer state of its own (``FailoverController.run_gr`` does).
    ``latency_sampler(rng) -> seconds`` models one replica's service time
    for ``simulate``."""

    replicas: int = 2
    seed: int = 0
    issued: int = 0
    hedged: int = 0
    hedge_wins: int = 0

    def call(self, primary: Callable, hedge: Callable, hedge_after: float):
        """Race ``primary`` against a delayed ``hedge``; the first result
        wins. Returns ``(result, from_hedge)``; the winner's exception
        propagates."""
        self.issued += 1
        lock = threading.Lock()
        first: dict = {}
        done = threading.Event()

        def run(tag: str, fn: Callable):
            try:
                r, err = fn(), None
            except Exception as e:  # noqa: BLE001 — re-raised if it won
                r, err = None, e
            with lock:
                if not first:
                    first["tag"], first["r"], first["err"] = tag, r, err
                    done.set()

        threading.Thread(target=run, args=("primary", primary), daemon=True).start()
        if not done.wait(hedge_after):
            self.hedged += 1
            threading.Thread(target=run, args=("hedge", hedge), daemon=True).start()
        done.wait()
        won_hedge = first["tag"] == "hedge"
        self.hedge_wins += int(won_hedge)
        if first["err"] is not None:
            raise first["err"]
        return first["r"], won_hedge

    @property
    def hedge_rate(self) -> float:
        return self.hedged / self.issued if self.issued else 0.0

    def simulate(self, n_requests: int, latency_sampler) -> dict:
        rng = np.random.default_rng(self.seed)
        solo = np.array([latency_sampler(rng) for _ in range(n_requests)])
        hedged = np.array([min(latency_sampler(rng) for _ in range(self.replicas))
                           for _ in range(n_requests)])
        return {
            "solo_p99": float(np.percentile(solo, 99)),
            "hedged_p99": float(np.percentile(hedged, 99)),
            "p99_improvement": float(np.percentile(solo, 99) / np.percentile(hedged, 99)),
            "extra_work": float(self.replicas - 1),
        }
