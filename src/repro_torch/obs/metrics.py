"""Per-owner/per-stage device metrics: field contract + host helpers.

PyTorch package twin of ``repro.obs.metrics``: the same seven fields in
the same order, so a trace of either package validates with the other.

The sharded serving step accumulates stage counters *per owner shard*
into a fixed-shape ``[n_shards, len(OWNER_STAGE_FIELDS)]`` block that
rides the step's existing single metrics all-reduce (each rank writes its
local stage counters at its own row; the sum of the flattened block
assembles the full matrix on every rank, adding no collective). ``distributed.graph_serve._MeshTier`` owns the
device side; this module owns the field-order contract and the
host-side reads so neither drifts from the other.

Attribution sides (documented, deliberate):

- ``probe_hits`` / ``miss_rows`` / ``edges_scanned`` / ``leaf_fetches``
  and ``frontier_rows`` accumulate at the *owner* shard — the shard
  whose cache/storage segment actually did the work after routing.
- ``route_overflow`` and ``deferred_rows`` accumulate at the *origin*
  (querying) shard: overflow is detected before the exchange, and
  deferral is recorded against the home rows of the query.

``hit_locality`` is the per-shard cache hit-rate signal a
cache-locality router reads; ``attribute_step_seconds`` splits the
measured collective-step wall-clock across owners in proportion to
attributed device work, so a failure detector can mark a single
straggler instead of the whole mesh.
"""

from __future__ import annotations

import numpy as np

# Field order is the device contract: _MeshTier.reduce_metrics stacks
# its locals in exactly this order, as the reference's does. Change both
# packages together.
OWNER_STAGE_FIELDS = (
    "frontier_rows",   # owner-side frontier occupancy summed over hops
    "probe_hits",      # cache probe hits at the owner segment
    "miss_rows",       # miss rows executed against owner storage
    "edges_scanned",   # adjacency rows scanned by owner miss-exec
    "leaf_fetches",    # leaf fetches issued by owner miss-exec
    "route_overflow",  # origin-side rows dropped by route-cap overflow
    "deferred_rows",   # origin-side home rows deferred (degraded mode)
)

# Fields whose magnitude tracks device time spent; used to split the
# collective step wall-clock across owners.
WORK_FIELDS = ("frontier_rows", "edges_scanned")


def _as_matrix(owner_stage) -> np.ndarray:
    m = np.asarray(owner_stage, dtype=np.int64)
    if m.ndim != 2 or m.shape[1] != len(OWNER_STAGE_FIELDS):
        raise ValueError(
            f"owner_stage must be [n_shards, {len(OWNER_STAGE_FIELDS)}], "
            f"got shape {m.shape}")
    return m


def owner_stage_rows(owner_stage) -> list[dict]:
    """``[{field: int}]`` per owner — the JSONL snapshot shape."""
    m = _as_matrix(owner_stage)
    return [dict(zip(OWNER_STAGE_FIELDS, row.tolist())) for row in m]


def hit_locality(owner_stage) -> np.ndarray:
    """Per-owner cache hit rate: hits / (hits + miss_rows), NaN-free.

    Owners that saw no probes this step report 0.0 (no signal), so the
    vector is always finite and directly usable as router weights.
    """
    m = _as_matrix(owner_stage)
    hits = m[:, OWNER_STAGE_FIELDS.index("probe_hits")].astype(np.float64)
    miss = m[:, OWNER_STAGE_FIELDS.index("miss_rows")].astype(np.float64)
    denom = hits + miss
    out = np.zeros(m.shape[0], dtype=np.float64)
    nz = denom > 0
    out[nz] = hits[nz] / denom[nz]
    return out


def owner_load_share(owner_stage) -> np.ndarray:
    """Per-owner share of frontier-row load — the migration trigger.

    ``share[s] = frontier_rows[s] / sum(frontier_rows)``; a balanced mesh
    reads ``1/n`` everywhere, a hot owner reads above it. Zero total load
    returns the uniform ``1/n`` vector (no signal → no skew claimed).
    ``max(owner_load_share(...)) * n`` is the skew factor a migration
    policy compares against its trigger.
    """
    m = _as_matrix(owner_stage)
    n = m.shape[0]
    rows = m[:, OWNER_STAGE_FIELDS.index("frontier_rows")].astype(np.float64)
    total = rows.sum()
    if total <= 0 or n == 0:
        return np.full(n, 1.0 / max(n, 1), dtype=np.float64)
    return rows / total


def attribute_step_seconds(step_seconds: float, owner_stage) -> np.ndarray:
    """Split one collective step's wall-clock across owners by work.

    ``per_owner[s] = step_seconds * work[s] / mean(work)`` where
    ``work = frontier_rows + edges_scanned``. On a balanced mesh every
    owner gets ``step_seconds`` — exactly the old collective-step
    semantics — while a hot owner is attributed proportionally more, so
    a failure detector can see *which* owner is dragging the step.
    A step with zero attributed work (all-hit, empty frontier) falls
    back to uniform attribution.
    """
    m = _as_matrix(owner_stage)
    n = m.shape[0]
    work = np.zeros(n, dtype=np.float64)
    for f in WORK_FIELDS:
        work += m[:, OWNER_STAGE_FIELDS.index(f)].astype(np.float64)
    total = work.sum()
    if total <= 0 or n == 0:
        return np.full(n, float(step_seconds), dtype=np.float64)
    return float(step_seconds) * work * n / total
