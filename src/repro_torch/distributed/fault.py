"""Bounded retries and bounded-wall-clock calls for the journal's I/O.

PyTorch package twin of ``repro.distributed.fault``, the part the
write-behind journal needs (``graphstore.journal``):

- ``RetryPolicy``: bounded exponential-backoff retries with a
  ``retryable`` predicate (the journal flusher's retry loop);
- ``timed_call``: a bounded-wall-clock wrapper for journal flush and
  checkpoint I/O, so a hung filesystem surfaces as ``CallTimeout`` instead
  of freezing the serve loop.

The failure model of the serve loop (``ShardFaultPlan``,
``FailureDetector``, ``ElasticRunner``, ``HedgedCalls``) belongs to
failover and is not ported yet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


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
