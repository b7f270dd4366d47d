"""``ServeTelemetry`` — the serve-loop observability aggregator.

PyTorch package twin of ``repro.obs.telemetry``: the same ``meta``,
``span``, ``snapshot`` and ``report`` events.

Composes the histogram, trace, and owner-stage pieces into the object
``repro_torch.launch.serve`` drives: per-traffic-class streaming latency
histograms (cached vs. uncached gR-Txs, gRW commits, CP drains),
per-owner step-latency histograms, cumulative owner-stage counters, and
periodic JSONL snapshots plus an end-of-run report (both schema-valid
per :mod:`repro_torch.obs.schema`).

Cached/uncached gR attribution is weighted at batch granularity: a
batch whose step took ``t`` seconds with ``h`` probe hits and ``m``
miss rows contributes ``t`` to the cached-class histogram with weight
``h`` and to the uncached class with weight ``m`` — the streaming
analogue of the paper's per-class response-time tables, without
tracking individual transactions through the fused device step.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.obs.metrics import (
    OWNER_STAGE_FIELDS,
    attribute_step_seconds,
    hit_locality,
    owner_stage_rows,
)
from repro_torch.obs.schema import LATENCY_CLASSES, SCHEMA_VERSION
from repro_torch.obs.trace import NULL_TRACER, JsonlTraceWriter, Tracer


class ServeTelemetry:
    """Aggregates serve-loop latency + owner-stage state; emits JSONL."""

    def __init__(self, n_shards: int, trace_path: str | None = None):
        self.n = int(n_shards)
        self.writer = JsonlTraceWriter(trace_path) if trace_path else None
        self.tracer = Tracer(sink=self.writer)
        self.latency = {cls: LatencyHistogram() for cls in LATENCY_CLASSES}
        self.owner_step = [LatencyHistogram() for _ in range(self.n)]
        self.owner_stage_total = np.zeros(
            (self.n, len(OWNER_STAGE_FIELDS)), dtype=np.int64)
        self.batches = 0
        self.counters: dict[str, int] = {}
        self._meta_emitted = False
        # meta must be the first event in the stream — emit it eagerly so
        # spans recorded before the first batch (e.g. the journal's
        # startup checkpoint) cannot precede it
        self._emit_meta()

    # -- recording --------------------------------------------------------

    def _emit_meta(self):
        if self.writer is None or self._meta_emitted:
            return
        self._meta_emitted = True
        self.writer.emit({
            "type": "meta", "version": SCHEMA_VERSION, "shards": self.n,
            "stage_fields": list(OWNER_STAGE_FIELDS), "ts": time.time(),
        })

    def record_gr(self, step_seconds: float, metrics: dict,
                  owner_stage=None) -> np.ndarray | None:
        """One gR batch. Returns the per-owner attributed seconds (or
        None when the runtime ran without device telemetry)."""
        self._emit_meta()
        self.batches += 1
        for k, v in metrics.items():
            if isinstance(v, (int, np.integer)):
                self.counters[k] = self.counters.get(k, 0) + int(v)
        hits = int(metrics.get("hits", 0))
        misses = int(metrics.get("misses", 0))
        self.latency["gr_cached"].record(step_seconds, weight=max(hits, 0))
        self.latency["gr_uncached"].record(step_seconds, weight=max(misses, 0))
        if owner_stage is None:
            return None
        stage = np.asarray(owner_stage, dtype=np.int64)
        self.owner_stage_total += stage
        per_owner = attribute_step_seconds(step_seconds, stage)
        for s in range(self.n):
            self.owner_step[s].record(float(per_owner[s]))
        return per_owner

    def record_grw(self, seconds: float) -> None:
        self._emit_meta()
        self.latency["grw"].record(seconds)

    def record_cp_drain(self, seconds: float) -> None:
        self._emit_meta()
        self.latency["cp_drain"].record(seconds)

    def bump(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    # -- hit locality (cache-locality router signal) ----------------------

    def hit_locality(self) -> np.ndarray:
        return hit_locality(self.owner_stage_total)

    # -- snapshots / report -----------------------------------------------

    def _json_pct(self, h: LatencyHistogram) -> dict:
        pct = h.percentiles()
        out = {}
        for k, v in pct.items():
            if isinstance(v, float) and v != v:  # NaN -> null (empty class)
                out[k] = None
            else:
                out[k] = v
        return out

    def _state(self) -> dict:
        return {
            "owner_stage": owner_stage_rows(self.owner_stage_total),
            "hit_locality": [float(v) for v in self.hit_locality()],
            "latency": {cls: self._json_pct(h)
                        for cls, h in self.latency.items()},
            "owner_step_latency": [self._json_pct(h)
                                   for h in self.owner_step],
            "spans": self.tracer.snapshot(),
        }

    def snapshot(self, batch: int) -> dict:
        ev = {"type": "snapshot", "batch": int(batch), "ts": time.time(),
              **self._state()}
        self._emit_meta()
        if self.writer is not None:
            self.writer.emit(ev)
        return ev

    def report(self) -> dict:
        ev = {"type": "report", "batches": self.batches, "ts": time.time(),
              "counters": dict(self.counters), **self._state()}
        self._emit_meta()
        if self.writer is not None:
            self.writer.emit(ev)
            self.writer.flush()
        return ev

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
