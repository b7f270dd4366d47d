"""Runtime observability tier.

PyTorch package twin of ``repro.obs``. Every piece is numpy + stdlib
only:

- :mod:`repro_torch.obs.histogram` — fixed-bucket log-scale latency
  histograms with exact merge algebra, giving streaming p50/p95/p99/p99.9
  without storing raw samples.
- :mod:`repro_torch.obs.trace` — a low-overhead ``Span``/``Tracer`` API
  for host-side per-phase wall-clock (dispatch, result copy, unpack,
  journal flush, checkpoint, compaction tick, capacity growth), with
  optional structured JSONL export.
- :mod:`repro_torch.obs.metrics` — the per-owner/per-stage metrics block
  that rides the serving step's one metrics all-reduce (field order
  contract + host-side attribution helpers, including the cache
  hit-locality signal).

:mod:`repro_torch.obs.telemetry` composes the three into
``ServeTelemetry``, the serve-loop aggregator used by
``repro_torch.launch.serve``; :mod:`repro_torch.obs.schema` validates the
emitted JSONL trace events (``python -m repro_torch.obs.validate
trace.jsonl``).
"""

from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.obs.metrics import (
    OWNER_STAGE_FIELDS,
    attribute_step_seconds,
    hit_locality,
    owner_load_share,
    owner_stage_rows,
)
from repro_torch.obs.telemetry import ServeTelemetry
from repro_torch.obs.trace import NULL_TRACER, JsonlTraceWriter, NullTracer, Tracer

__all__ = [
    "LatencyHistogram",
    "OWNER_STAGE_FIELDS",
    "attribute_step_seconds",
    "hit_locality",
    "owner_load_share",
    "owner_stage_rows",
    "ServeTelemetry",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "JsonlTraceWriter",
]
