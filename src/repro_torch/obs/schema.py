"""Hand-rolled validators for the JSONL trace event schema.

PyTorch package twin of ``repro.obs.schema``: the same schema version,
event types and latency classes, so each package's validator accepts
the other's trace and both reject the same malformed events.

The container has no ``jsonschema`` package, so the schema is enforced
by plain predicate functions — one per event type — raising
``ValueError`` with a path-qualified message on the first violation.
``validate_event`` dispatches on ``event["type"]``:

- ``meta``     — one per trace, first line: run shape + field contract.
- ``span``     — one per traced phase execution: name + duration.
- ``snapshot`` — periodic serve-loop state: per-owner stage counters,
  hit locality, latency percentiles per traffic class, span aggregates.
- ``report``   — one per trace, last line: same shape as ``snapshot``
  plus run totals.

``docs/OBSERVABILITY.md`` documents every field (the format is shared);
``python -m repro_torch.obs.validate trace.jsonl`` checks a file end to end.
"""

from __future__ import annotations

import math

from repro_torch.obs.metrics import OWNER_STAGE_FIELDS

SCHEMA_VERSION = 1

EVENT_TYPES = ("meta", "span", "snapshot", "report")

# percentile keys every latency-class entry must carry
PCT_KEYS = ("p50", "p95", "p99", "p999")

# traffic classes the serve loop reports
LATENCY_CLASSES = ("gr_cached", "gr_uncached", "grw", "cp_drain")


def _fail(path: str, msg: str):
    raise ValueError(f"{path}: {msg}")


def _need(ev: dict, key: str, typ, path: str):
    if key not in ev:
        _fail(path, f"missing required key {key!r}")
    v = ev[key]
    if typ is float:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            _fail(f"{path}.{key}", f"expected number, got {type(v).__name__}")
        return float(v)
    if typ is int:
        if isinstance(v, bool) or not isinstance(v, int):
            _fail(f"{path}.{key}", f"expected int, got {type(v).__name__}")
        return v
    if not isinstance(v, typ):
        _fail(f"{path}.{key}",
              f"expected {typ.__name__}, got {type(v).__name__}")
    return v


def _check_percentiles(d: dict, path: str):
    for k in PCT_KEYS:
        if k not in d:
            _fail(path, f"missing percentile {k!r}")
        v = d[k]
        if v is None:
            continue  # empty class: no samples yet
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            _fail(f"{path}.{k}", "expected number or null")
        if not math.isnan(v) and v < 0:
            _fail(f"{path}.{k}", f"negative latency {v}")
    n = _need(d, "count", int, path)
    if n < 0:
        _fail(f"{path}.count", "negative count")


def validate_meta(ev: dict):
    path = "meta"
    if _need(ev, "version", int, path) != SCHEMA_VERSION:
        _fail(f"{path}.version", f"expected {SCHEMA_VERSION}")
    n = _need(ev, "shards", int, path)
    if n < 1:
        _fail(f"{path}.shards", "must be >= 1")
    fields = _need(ev, "stage_fields", list, path)
    if tuple(fields) != OWNER_STAGE_FIELDS:
        _fail(f"{path}.stage_fields",
              f"field contract mismatch: {fields} != "
              f"{list(OWNER_STAGE_FIELDS)}")
    _need(ev, "ts", float, path)


def validate_span(ev: dict):
    path = "span"
    name = _need(ev, "name", str, path)
    if not name:
        _fail(f"{path}.name", "empty span name")
    d = _need(ev, "dur_s", float, path)
    if d < 0:
        _fail(f"{path}.dur_s", f"negative duration {d}")
    _need(ev, "ts", float, path)
    if "attrs" in ev and not isinstance(ev["attrs"], dict):
        _fail(f"{path}.attrs", "expected object")


def _check_state(ev: dict, path: str, *, shards: int | None):
    stage = _need(ev, "owner_stage", list, path)
    if shards is not None and len(stage) != shards:
        _fail(f"{path}.owner_stage",
              f"expected {shards} owner rows, got {len(stage)}")
    for i, row in enumerate(stage):
        if not isinstance(row, dict):
            _fail(f"{path}.owner_stage[{i}]", "expected object")
        for f in OWNER_STAGE_FIELDS:
            if f not in row:
                _fail(f"{path}.owner_stage[{i}]", f"missing field {f!r}")
            v = row[f]
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                _fail(f"{path}.owner_stage[{i}].{f}",
                      f"expected non-negative int, got {v!r}")
    loc = _need(ev, "hit_locality", list, path)
    if len(loc) != len(stage):
        _fail(f"{path}.hit_locality", "length != n owner rows")
    for i, v in enumerate(loc):
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not (0.0 <= v <= 1.0):
            _fail(f"{path}.hit_locality[{i}]", f"expected rate in [0,1]: {v!r}")
    lat = _need(ev, "latency", dict, path)
    for cls in LATENCY_CLASSES:
        if cls not in lat:
            _fail(f"{path}.latency", f"missing class {cls!r}")
        _check_percentiles(lat[cls], f"{path}.latency.{cls}")
    owner_step = _need(ev, "owner_step_latency", list, path)
    if len(owner_step) != len(stage):
        _fail(f"{path}.owner_step_latency", "length != n owner rows")
    for i, d in enumerate(owner_step):
        if not isinstance(d, dict):
            _fail(f"{path}.owner_step_latency[{i}]", "expected object")
        _check_percentiles(d, f"{path}.owner_step_latency[{i}]")
    spans = _need(ev, "spans", dict, path)
    for name, agg in spans.items():
        if not isinstance(agg, dict):
            _fail(f"{path}.spans.{name}", "expected object")
        _need(agg, "count", int, f"{path}.spans.{name}")
        _need(agg, "total_s", float, f"{path}.spans.{name}")


def validate_snapshot(ev: dict, *, shards: int | None = None):
    path = "snapshot"
    b = _need(ev, "batch", int, path)
    if b < 0:
        _fail(f"{path}.batch", "negative batch index")
    _need(ev, "ts", float, path)
    _check_state(ev, path, shards=shards)


def validate_report(ev: dict, *, shards: int | None = None):
    path = "report"
    b = _need(ev, "batches", int, path)
    if b < 0:
        _fail(f"{path}.batches", "negative batch count")
    _need(ev, "ts", float, path)
    _need(ev, "counters", dict, path)
    _check_state(ev, path, shards=shards)


def validate_event(ev: dict, *, shards: int | None = None):
    """Validate one parsed JSONL event; raises ValueError on violation."""
    if not isinstance(ev, dict):
        raise ValueError(f"event must be an object, got {type(ev).__name__}")
    t = ev.get("type")
    if t not in EVENT_TYPES:
        raise ValueError(f"unknown event type {t!r} (expected one of "
                         f"{EVENT_TYPES})")
    if t == "meta":
        validate_meta(ev)
    elif t == "span":
        validate_span(ev)
    elif t == "snapshot":
        validate_snapshot(ev, shards=shards)
    else:
        validate_report(ev, shards=shards)
    return t
