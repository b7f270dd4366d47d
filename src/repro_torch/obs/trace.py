"""Low-overhead ``Span``/``Tracer`` API with structured JSONL export.

PyTorch package twin of ``repro.obs.trace``. A span times host wall
clock only: it never synchronizes the card, so a span that should cover
device work must close after a host read of that work's result.

The serve loop wraps each host-side phase (device dispatch, blocking
sync, result unpack, journal flush, checkpoint, compaction tick,
hot-swap pause) in ``tracer.span(name)``. A span costs one
``perf_counter`` pair plus a dict update (~1-2 us) — negligible against
multi-millisecond serve batches.

``NullTracer`` (the module-level ``NULL_TRACER``) is the zero-cost
default: its ``span`` returns a shared re-entrant no-op context
manager, so instrumented code paths need no ``if tracing:`` branches.

When a sink (``JsonlTraceWriter``) is attached, every span additionally
emits one ``{"type": "span", ...}`` JSONL event; with or without a
sink, the tracer aggregates per-name call counts, total wall-clock, and
a :class:`~repro_torch.obs.histogram.LatencyHistogram` for percentile
reporting. All entry points are thread-safe — the write-behind journal
flusher records spans from its background thread.
"""

from __future__ import annotations

import json
import threading
import time

from repro_torch.obs.histogram import LatencyHistogram


class JsonlTraceWriter:
    """Append-only JSONL sink; one event object per line."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "w", encoding="utf-8")
        self._lock = threading.Lock()
        self.events_written = 0

    def emit(self, event: dict) -> None:
        line = json.dumps(event, separators=(",", ":"), sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")
            self.events_written += 1

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _Span:
    """Context manager timing one named phase; records into its tracer."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "seconds")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self._t0
        self._tracer.record(self.name, self.seconds, self.attrs)
        return False


class _NullSpan:
    """Shared, re-entrant, stateless no-op span."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: every call is a no-op with near-zero cost."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def record(self, name: str, seconds: float, attrs: dict | None = None):
        pass

    def snapshot(self) -> dict:
        return {}


NULL_TRACER = NullTracer()


class Tracer:
    """Aggregates per-name span timings; optionally emits JSONL events.

    ``sink`` is a :class:`JsonlTraceWriter` (or anything with an
    ``emit(dict)`` method); when ``None`` the tracer only aggregates.
    """

    enabled = True

    def __init__(self, sink: JsonlTraceWriter | None = None):
        self.sink = sink
        self._lock = threading.Lock()
        self._stats: dict[str, list] = {}          # name -> [count, total_s]
        self._hist: dict[str, LatencyHistogram] = {}

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs or None)

    def record(self, name: str, seconds: float,
               attrs: dict | None = None) -> None:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                self._stats[name] = [1, seconds]
                self._hist[name] = h = LatencyHistogram()
            else:
                st[0] += 1
                st[1] += seconds
                h = self._hist[name]
            h.record(seconds)
        if self.sink is not None:
            ev = {"type": "span", "name": name, "dur_s": seconds,
                  "ts": time.time()}
            if attrs:
                ev["attrs"] = attrs
            self.sink.emit(ev)

    def histogram(self, name: str) -> LatencyHistogram | None:
        with self._lock:
            return self._hist.get(name)

    def snapshot(self) -> dict:
        """Per-name aggregate view: count, total_s, p50/p95/p99/p999."""
        with self._lock:
            names = list(self._stats)
            out = {}
            for name in names:
                count, total = self._stats[name]
                pct = self._hist[name].percentiles()
                out[name] = {"count": int(count), "total_s": float(total),
                             **{k: pct[k] for k in ("p50", "p95", "p99",
                                                    "p999")}}
        return out
