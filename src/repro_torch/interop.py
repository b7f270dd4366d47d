"""State carried across between the JAX package and the port.

The JAX package's state is given here as dicts of numpy arrays (a
``NamedTuple._asdict()`` with each value passed through ``np.asarray``), never
as JAX objects, so this module imports numpy and torch only. With it the
tests feed both packages the same state and compare what comes out.

The sharded runtime keeps one global ``CacheState`` whose slot tensors are
the owners' blocks in order, so ``cache_from_numpy`` / ``cache_to_numpy``
carry a co-partitioned cache as they carry a single-host one.

Dtypes: ids, labels, properties and counters are int32 on both sides; the
cache fingerprint is uint32 in the reference and int32 holding the same
bits in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache import CacheSpec, CacheState
from repro_torch.core.engine import EngineSpec, Hop, QueryPlan
from repro_torch.core.templates import PredSpec, TemplateTable
from repro_torch.gnn.graph import GraphBatch
from repro_torch.graphstore.partition import EdgeBlock, PartitionedGraphStore
from repro_torch.graphstore.store import GraphStore, StoreSpec
from repro_torch.utils import resolve_device


def _tensor(a, dev):
    a = np.array(a, copy=True)  # writable, contiguous, 0-d kept 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=dev)


def _numpy(t: torch.Tensor):
    return t.detach().cpu().numpy()


def store_from_numpy(d: dict, device=None) -> GraphStore:
    dev = resolve_device(device)
    return GraphStore(**{f: _tensor(d[f], dev) for f in GraphStore._fields})


def store_to_numpy(store: GraphStore) -> dict:
    return {f: _numpy(getattr(store, f)) for f in GraphStore._fields}


def pstore_from_numpy(d: dict, device=None) -> PartitionedGraphStore:
    """A partitioned store from the reference's fields, the two edge blocks
    as nested dicts."""
    dev = resolve_device(device)
    blk = lambda b: EdgeBlock(**{f: _tensor(b[f], dev) for f in EdgeBlock._fields})
    return PartitionedGraphStore(**{
        f: blk(d[f]) if f in ("out", "inc") else _tensor(d[f], dev)
        for f in PartitionedGraphStore._fields
    })


def pstore_to_numpy(ps: PartitionedGraphStore) -> dict:
    blk = lambda b: {f: _numpy(getattr(b, f)) for f in EdgeBlock._fields}
    return {f: blk(getattr(ps, f)) if f in ("out", "inc") else _numpy(getattr(ps, f))
            for f in PartitionedGraphStore._fields}


def cache_from_numpy(d: dict, device=None) -> CacheState:
    dev = resolve_device(device)
    return CacheState(**{f: _tensor(d[f], dev) for f in CacheState._fields})


def cache_to_numpy(cache: CacheState) -> dict:
    out = {f: _numpy(getattr(cache, f)) for f in CacheState._fields}
    out["fp"] = out["fp"].view(np.uint32)
    return out


def _fields(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def pred_from_numpy(d) -> PredSpec:
    d = _fields(d)
    return PredSpec(
        label=np.asarray(d["label"], np.int32),
        prop_ids=np.asarray(d["prop_ids"], np.int32),
        ops=np.asarray(d["ops"], np.int32),
        vals=np.asarray(d["vals"], np.int32),
        wild=np.asarray(d["wild"], bool),
    )


def ttable_from_numpy(d) -> TemplateTable:
    """A template table from the reference's fields (predicates as dicts or
    NamedTuples of arrays)."""
    d = _fields(d)
    return TemplateTable(
        direction=np.asarray(d["direction"], np.int32),
        edge_label=np.asarray(d["edge_label"], np.int32),
        pr=pred_from_numpy(d["pr"]),
        pe=pred_from_numpy(d["pe"]),
        pl=pred_from_numpy(d["pl"]),
        read_enabled=np.asarray(d["read_enabled"], bool),
        write_enabled=np.asarray(d["write_enabled"], bool),
    )


def store_spec(t) -> StoreSpec:
    """``StoreSpec`` from a plain tuple ``(v_cap, e_cap, n_vprops, n_eprops,
    recent_cap)``."""
    return StoreSpec(*tuple(t))


def cache_spec(t) -> CacheSpec:
    """``CacheSpec`` from a plain tuple ``(capacity, probes, max_leaves,
    max_chunks[, use_pallas])``: the reference's trailing kernel switch is
    dropped, since the port's read path always runs the kernel."""
    return CacheSpec(*tuple(t)[: len(CacheSpec._fields)])


def engine_spec(store_t, cache_t, max_deg: int, frontier: int) -> EngineSpec:
    return EngineSpec(store_spec(store_t), cache_spec(cache_t), int(max_deg), int(frontier))


def hop_from_numpy(d) -> Hop:
    d = _fields(d)
    return Hop(
        direction=int(d["direction"]), edge_label=int(d["edge_label"]),
        pr=pred_from_numpy(d["pr"]), pe=pred_from_numpy(d["pe"]),
        pl=pred_from_numpy(d["pl"]), tpl_idx=int(d["tpl_idx"]),
        params=np.asarray(d["params"], np.int32),
    )


def plan_from_numpy(d) -> QueryPlan:
    d = _fields(d)
    return QueryPlan(
        hops=tuple(hop_from_numpy(h) for h in d["hops"]), final=int(d["final"]),
        final_prop=int(d["final_prop"]), post_filter=d["post_filter"],
        extra_phases=int(d["extra_phases"]),
    )


def gnn_params_from_numpy(tree, device=None):
    """GNN parameters from the reference's nested layout (dicts and lists
    of ``(w, b)`` pairs, each array as numpy), with the same nesting."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(x, dev)

    return conv(tree)


def gnn_params_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: gnn_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gnn_params_to_numpy(v) for v in tree)
    return _numpy(tree)


def graph_batch_from_numpy(d: dict, device=None) -> GraphBatch:
    """A ``GraphBatch`` from a dict of its fields (arrays as numpy; None
    for an absent optional field; ``n_graphs`` as an int)."""
    dev = resolve_device(device)
    return GraphBatch(**{
        k: v if v is None or k == "n_graphs" else _tensor(v, dev) for k, v in d.items()
    })
