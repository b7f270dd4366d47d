"""The port stands alone and runs on the card by default.

- No module of ``repro_torch``, nor ``chip_smoke.py`` or the port's examples,
  imports ``jax`` or anything of the JAX package ``repro``.
- The entry points default to CUDA and raise when it is absent, instead of
  falling back to the CPU.
- Every serve-loop flag is ported: the failover and migration flags parse
  to the reference's defaults, and a crash without the journal, or a crash
  or a migration on the replicated store tier, is an argument error, as
  there.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_fixtures import _torch_test_env  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "train_lm_100m_torch.py", ROOT / "examples" / "gnn_cached_sampling_torch.py",
    ROOT / "examples" / "serve_ecommerce_torch.py",
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


@pytest.mark.parametrize("module", ["graphstore/migration.py", "distributed/routing.py",
                                    "distributed/failover.py", "launch/serve.py",
                                    "graphstore/mutations.py", "core/invalidation.py",
                                    "core/runtime.py", "distributed/graph_serve.py"])
def test_the_partitioned_tiers_twins_are_checked(module):
    """The twins of the sharded tiers' reference modules are among the
    files the import check walks (the migration tier since slice 12, the
    replicated tier since slice 13)."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES and (ROOT / "src" / "repro" / module).exists()


def _fixed_zero_writes(path):
    """Assignments of the constant 0 to a ``["route_cap_retries"]`` item."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) \
                and node.value.value == 0:
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant) \
                        and t.slice.value == "route_cap_retries":
                    yield node.lineno


@pytest.mark.parametrize("module", ["distributed/graph_serve.py", "launch/serve.py"])
def test_route_cap_retries_are_counted_not_fixed(module):
    """The "auto" caps' retries are the runtime's count in the batch metrics
    and in the serve loop's report, no longer a fixed 0."""
    path = ROOT / "src" / "repro_torch" / module
    text = path.read_text()
    assert not list(_fixed_zero_writes(path)), f"{module} writes a fixed route_cap_retries"
    assert "route_cap_retries=0" not in text and "not ported" not in text
    assert "route_cap_retries" in text


@pytest.mark.parametrize("module", ["optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
                                    "optim/compression.py", "configs/__init__.py",
                                    "configs/gemma3_4b.py", "configs/glm4_9b.py",
                                    "configs/grok_1_314b.py", "configs/kimi_k2_1t_a32b.py",
                                    "configs/gat_cora.py", "configs/egnn.py", "configs/nequip.py",
                                    "configs/ecommerce_graph.py", "launch/train.py"])
def test_the_training_twins_are_checked(module):
    """The twins of the training path's reference modules (slice 14: the
    optimizers, the configs registry and its modules, the training entry
    point) are among the files the import check walks."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES and (ROOT / "src" / "repro" / module).exists()


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.core import CacheSpec, EngineSpec, GraphEngine, QueryPlan, empty_cache
    from repro_torch.core.engine import build_grw_step
    from repro_torch.core.population import CachePopulator
    from repro_torch.distributed import ShardedTxnRuntime, flat_mesh
    from repro_torch.distributed.routing import RoutingTableHost
    from repro_torch.gnn import CachedNeighborSampler, CSRGraph, FanoutSampler
    from repro_torch.gnn.config import GNNConfig
    from repro_torch.gnn.graph import random_graph_batch
    from repro_torch.gnn.models import init_params
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.graphstore import StoreSpec, empty_store, ingest, make_mutation_batch
    from repro_torch.graphstore.journal import decode_commit, encode_commit
    from repro_torch.launch import serve, train

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
        # durability: a replayed commit and a restored checkpoint land on CUDA
        lambda: decode_commit(encode_commit(make_mutation_batch(spec, device="cpu"))),
        lambda: restore_checkpoint("unused", 0, None),
        # the serve loop, with no flags, and the failover and migration
        # tiers under it
        lambda: serve.main([]),
        lambda: serve.main(["--inject-crash", "1:3", "--recover-after", "2"]),
        lambda: serve.main(["--migrate", "--hot-frac", "0.5"]),
        lambda: serve.main(["--store-tier", "replicated"]),
        lambda: ShardedTxnRuntime(espec, flat_mesh(2), store_tier="replicated"),
        lambda: RoutingTableHost(4),
        # training: the LM entry point and its data stream
        lambda: train.main(["--arch", "gemma3-4b", "--smoke", "--steps", "1"]),
        lambda: next(train.synthetic_batches(64, 1, 4)),
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
    # the two-tower and LM serving paths' entry points
    from repro_torch.configs import two_tower_retrieval, yi_6b
    from repro_torch.lm.model import init_kv_cache, init_params as lm_init
    from repro_torch.recsys.twotower import init_params as tt_init

    serve_calls = [
        lambda **dev: tt_init(two_tower_retrieval.SMOKE, torch.Generator(), **dev)["user_b0"],
        lambda **dev: lm_init(yi_6b.SMOKE, torch.Generator(), **dev)["layers"]["wq"],
        lambda **dev: init_kv_cache(yi_6b.SMOKE, 1, 4, **dev).k,
    ]
    for call in calls + gnn_calls + serve_calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the CPU is there when asked for
    assert empty_store(spec, device="cpu").vlabel.device.type == "cpu"
    for call in gnn_calls + serve_calls:
        assert call(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("flags", [["--migrate", "--store-tier", "replicated"],
                                   ["--inject-crash", "1:3", "--store-tier", "replicated"]],
                         ids=lambda f: f[0])
def test_unported_serve_flags_raise(flags, capsys):
    """The flags the replicated store tier cannot serve exit as the
    reference's ``ap.error`` does (status 2, its message), before anything
    is built: ``--migrate`` needs the partitioned tier, ``--inject-crash``
    the journal, which the replicated tier keeps none of."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as e:
        serve.main(flags + ["--device", "cpu"])
    assert e.value.code == 2
    want = {"--migrate": "--migrate requires the partitioned store tier",
            "--inject-crash": "--inject-crash requires the journal (degraded-mode writes queue "
                              "there)"}[flags[0]]
    assert f"error: {want}" in capsys.readouterr().err


def test_migration_serve_flags_parse_as_the_reference():
    """``--migrate`` and ``--hot-frac`` are ported: they parse to the
    reference's values (defaults off and 0.0)."""
    from repro_torch.launch import serve

    args = serve.parse_args([])
    assert (args.migrate, args.hot_frac) == (False, 0.0)
    args = serve.parse_args(["--migrate", "--hot-frac", "0.5"])
    assert (args.migrate, args.hot_frac) == (True, 0.5)


@pytest.mark.parametrize("flags", [["--inject-crash", "1:3"], ["--recover-after", "2"],
                                   ["--hedge-after", "0.1"]], ids=lambda f: f[0])
def test_failover_serve_flags_parse_as_the_reference(flags):
    """The failover flags are ported: each parses to the reference's value
    (defaults: no crash, recovery after 4 batches, a 0.05 s hedge), and a
    crash without the journal is an argument error before anything is built."""
    from repro_torch.launch import serve

    args = serve.parse_args(flags)
    want = {"inject_crash": None, "recover_after": 4, "hedge_after": 0.05}
    name = flags[0][2:].replace("-", "_")
    want[name] = type(want[name])(flags[1]) if want[name] is not None else flags[1]
    assert {k: getattr(args, k) for k in want} == want
    with pytest.raises(SystemExit):
        serve.parse_args(["--inject-crash", "1:3", "--no-journal"])


@pytest.mark.parametrize("module", ["launch/steps.py", "launch/dryrun.py", "launch/mesh.py",
                                    "distributed/sharding.py", "lm/model.py",
                                    "recsys/twotower.py"])
def test_the_dryrun_twins_are_checked(module):
    """The twins of the dry-run's reference modules (slice 18: the steps,
    the dry-run, the mesh shapes, the spec helpers and the models' spec
    rules) are among the files the import check walks."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES and (ROOT / "src" / "repro" / module).exists()


def test_the_dryrun_holds_cells_against_cuda_by_default(monkeypatch, tmp_path):
    """``python -m repro_torch.launch.dryrun`` holds the cells against the
    card unless ``--device`` names another device, and raises where there
    is none, before it builds a cell."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "build_cell", lambda *a, **k: pytest.fail("built a cell"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "pna", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
