"""The port stands alone and runs on the card by default.

- No module of ``repro_torch``, nor ``chip_smoke.py`` or the port's example,
  imports ``jax`` or anything of the JAX package ``repro``.
- The entry points default to CUDA and raise when it is absent, instead of
  falling back to the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro") or m.startswith("jax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.core import CacheSpec, EngineSpec, GraphEngine, QueryPlan, empty_cache
    from repro_torch.core.engine import build_grw_step
    from repro_torch.core.population import CachePopulator
    from repro_torch.distributed import ShardedTxnRuntime, flat_mesh
    from repro_torch.gnn import CachedNeighborSampler, CSRGraph, FanoutSampler
    from repro_torch.gnn.config import GNNConfig
    from repro_torch.gnn.graph import random_graph_batch
    from repro_torch.gnn.models import init_params
    from repro_torch.graphstore import StoreSpec, empty_store, ingest, make_mutation_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = StoreSpec(v_cap=8, e_cap=16, n_vprops=1, n_eprops=1, recent_cap=4)
    espec = EngineSpec(store=spec, cache=CacheSpec(capacity=16, max_leaves=4), max_deg=4, frontier=4)
    calls = [
        lambda: ingest(spec, [0], np.zeros((1, 1)), [0], [0], [0], np.zeros((1, 1))),
        lambda: empty_store(spec),
        lambda: empty_cache(espec.cache),
        lambda: GraphEngine(espec, QueryPlan(hops=())),
        lambda: CachePopulator(espec, {}),
        lambda: build_grw_step(espec),
        lambda: make_mutation_batch(spec),
        lambda: ShardedTxnRuntime(espec, flat_mesh(2)),
    ]
    # the GNN serving path's entry points, each run on the CPU when asked
    cfg = GNNConfig(name="t", kind="pna", n_layers=1, d_hidden=4, d_in=3, n_classes=2)
    graph = CSRGraph.random(np.random.default_rng(0), 8, 2, 3)
    seeds = np.array([0, 1])

    def cached(**dev):
        store = ingest(spec, [0] * 4, np.zeros((4, 1)), [0, 1], [1, 2], [0, 0],
                       np.zeros((2, 1)), device="cpu")
        return CachedNeighborSampler(espec, store, empty_cache(espec.cache, device="cpu"),
                                     None, 0, CachePopulator(espec, {}, device="cpu"), (2,),
                                     **dev).sample_store(seeds, graph.feats, graph.labels)

    gnn_calls = [
        lambda **dev: init_params(cfg, torch.Generator(), **dev)["head"][0][0],
        lambda **dev: random_graph_batch(torch.Generator(), 4, 6, 3, **dev).node_feat,
        lambda **dev: FanoutSampler(graph, (2, 2), **dev).sample(seeds).node_feat,
        lambda **dev: cached(**dev).edge_src,
    ]
    for call in calls + gnn_calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the CPU is there when asked for
    assert empty_store(spec, device="cpu").vlabel.device.type == "cpu"
    for call in gnn_calls:
        assert call(device="cpu").device.type == "cpu"
