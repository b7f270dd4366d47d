"""Optimistic commit protocol (the FDB OCC analogue).

PyTorch twin of ``repro.graphstore.txn``. A transaction reads at a snapshot
version and records the vertices its result depends on; commit succeeds
only if none of them was written after the snapshot. The asynchronous
cache-population path uses it so that a CP transaction racing a gRW-Tx
aborts instead of installing a stale entry.
"""

from __future__ import annotations

import torch

from repro_torch.graphstore.store import GraphStore, StoreSpec
from repro_torch.utils import take_along0


class TxnError(Exception):
    """Raised (host-side) when a transaction exceeds its retry budget."""


def conflicts(spec: StoreSpec, store: GraphStore, read_version, read_set,
              read_mask, axis=None):
    """True iff any vertex in ``read_set`` was written after ``read_version``.

    ``axis=None`` collapses the whole read set to one verdict; ``axis=1``
    checks a [B, W] batch of per-transaction read sets independently.
    """
    ver = take_along0(store.vversion, read_set)
    hit = read_mask & (ver > read_version)
    return hit.any() if axis is None else hit.any(dim=axis)


def commit_with_conflict_check(spec: StoreSpec, store: GraphStore, read_version,
                               read_set, read_mask, apply_fn):
    """Functionally commit ``apply_fn(store)`` iff the read set is clean.

    Returns (store', committed: bool tensor). ``apply_fn`` must be pure.
    """
    bad = conflicts(spec, store, read_version, read_set, read_mask)
    new_store = apply_fn(store)
    merged = type(store)(*(torch.where(bad, a, b) for a, b in zip(store, new_store)))
    return merged, ~bad
