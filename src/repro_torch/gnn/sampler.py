"""Neighbor sampling for minibatch GNN training (minibatch_lg shape).

PyTorch twin of ``repro.gnn.sampler``. ``FanoutSampler`` is the real
multi-layer fanout sampler (GraphSAGE-style) over host CSR arrays.
``CachedNeighborSampler`` is the paper's technique applied to GNN data
loading: the one-hop *neighbor list* of a vertex is exactly a one-hop
sub-query result (empty predicates), so it is cached in the core cache,
served on hits without touching the storage CSR, populated asynchronously
on misses, and write-around-invalidated when gRW-Txs mutate the graph,
giving a *consistent* sampling cache over a dynamic graph.

As in the reference, each ``neighbors(v)`` call is one batch-1 cache
lookup (the ``cache_probe`` kernel on the card); a miss reads the store's
list with ``gather_out`` and queues a CP record. The sampled batch is built
on the host with the reference's numpy draws, so both packages sample the
same batch from the same seed, and is returned on the sampler's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cache import cache_lookup
from repro_torch.core.keys import PARAM_LEN
from repro_torch.core.runtime import MissRecord
from repro_torch.gnn.graph import GraphBatch
from repro_torch.graphstore.store import gather_out
from repro_torch.utils import PROP_MISSING, resolve_device


class CSRGraph(NamedTuple):
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    feats: np.ndarray  # [N, F]
    labels: np.ndarray  # [N]

    @staticmethod
    def random(rng, n, avg_deg, d_feat, n_classes=16):
        deg = rng.poisson(avg_deg, n).astype(np.int64)
        indptr = np.zeros(n + 1, np.int64)
        indptr[1:] = np.cumsum(deg)
        indices = rng.integers(0, n, indptr[-1]).astype(np.int32)
        return CSRGraph(
            indptr=indptr,
            indices=indices,
            feats=rng.normal(size=(n, d_feat)).astype(np.float32),
            labels=rng.integers(0, n_classes, n).astype(np.int32),
        )


class FanoutSampler:
    """Layer-wise fanout sampling producing a padded GraphBatch on
    ``device`` (CUDA unless the caller names another)."""

    def __init__(self, graph: CSRGraph, fanouts, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.g = graph
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def neighbors(self, v: int) -> np.ndarray:
        return self.g.indices[self.g.indptr[v] : self.g.indptr[v + 1]]

    def sample(self, seeds: np.ndarray) -> GraphBatch:
        """Returns a padded subgraph: nodes = seeds + sampled frontier(s);
        edges point child -> parent (messages flow to the seed side)."""
        nodes = list(map(int, seeds))
        node_of = {v: i for i, v in enumerate(nodes)}
        src, dst = [], []
        frontier = list(map(int, seeds))
        cap_nodes = self._cap_nodes(len(seeds))
        cap_edges = self._cap_edges(len(seeds))
        for f in self.fanouts:
            nxt = []
            for v in frontier:
                nb = self.neighbors(v)
                if len(nb) == 0:
                    continue
                take = self.rng.choice(nb, size=min(f, len(nb)), replace=False)
                for u in map(int, take):
                    if u not in node_of:
                        if len(nodes) >= cap_nodes:
                            continue
                        node_of[u] = len(nodes)
                        nodes.append(u)
                    if len(src) < cap_edges:
                        src.append(node_of[u])
                        dst.append(node_of[v])
                        nxt.append(u)
            frontier = nxt
        n, e = cap_nodes, cap_edges
        nf = np.zeros((n, self.g.feats.shape[1]), np.float32)
        nf[: len(nodes)] = self.g.feats[nodes]
        lab = np.zeros(n, np.int32)
        lab[: len(nodes)] = self.g.labels[nodes]
        es = np.zeros(e, np.int32)
        ed = np.zeros(e, np.int32)
        es[: len(src)] = src
        ed[: len(dst)] = dst
        nm = np.zeros(n, bool)
        nm[: len(nodes)] = True
        em = np.zeros(e, bool)
        em[: len(src)] = True
        t = lambda a: torch.from_numpy(a).to(self.device)
        return GraphBatch(
            node_feat=t(nf),
            edge_src=t(es),
            edge_dst=t(ed),
            node_mask=t(nm),
            edge_mask=t(em),
            labels=t(lab),
        )

    def _cap_nodes(self, b):
        n = b
        layer = b
        for f in self.fanouts:
            layer = layer * f
            n += layer
        return n

    def _cap_edges(self, b):
        e = 0
        layer = b
        for f in self.fanouts:
            layer = layer * f
            e += layer
        return e


class CachedNeighborSampler(FanoutSampler):
    """Fanout sampler whose one-hop neighbor lists are served by the paper's
    cache over a live (mutable) graphstore. ``device`` (CUDA unless the
    caller names another) is where the store and cache live and where the
    sampled batches go."""

    def __init__(self, espec, store, cache, ttable, tpl_idx, populator, fanouts, seed=0,
                 device=None):
        self.device = resolve_device(device)
        self.espec = espec
        self.store = store
        self.cache = cache
        self.ttable = ttable
        self.tpl_idx = tpl_idx
        self.pop = populator
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        self.hits = 0
        self.misses = 0
        self._params = np.full((1, PARAM_LEN), int(PROP_MISSING), np.int32)
        self._key = tuple(
            torch.as_tensor(a, device=self.device)
            for a in (np.full(1, tpl_idx, np.int32), self._params)
        )

    # the CSRGraph-facing bits are replaced by cache-backed lookups
    def neighbors(self, v: int) -> np.ndarray:
        tpl, params = self._key
        root = torch.full((1,), v, dtype=torch.int32, device=self.device)
        hit, vals, lmask, _ = cache_lookup(self.espec.cache, self.cache, tpl, root, params)
        if bool(hit[0]):
            self.hits += 1
            return vals[0][lmask[0]].cpu().numpy()
        self.misses += 1
        _, other, mask, _ = gather_out(self.espec.store, self.store, root, self.espec.max_deg)
        self.pop.queue.push(
            [MissRecord(self.tpl_idx, v, self._params[0], int(self.store.version))]
        )
        return np.unique(other[0][mask[0]].cpu().numpy())

    def populate(self):
        self.cache = self.pop.drain(self.store, self.store, self.cache, self.ttable)

    def sample_store(self, seeds: np.ndarray, feats: np.ndarray, labels: np.ndarray):
        """Like ``sample`` but features/labels come from external arrays."""
        self.g = CSRGraph(  # adapter so FanoutSampler.sample works
            indptr=None, indices=None, feats=feats, labels=labels
        )
        return self.sample(seeds)
