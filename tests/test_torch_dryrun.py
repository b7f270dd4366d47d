"""Parity: the port's dry-run (``repro_torch.launch.{mesh,steps,dryrun}``,
the shape-only spec helpers of ``distributed.sharding``) against the JAX
package's, and the dry-run end to end on the CPU.

- ``python -m repro_torch.launch.dryrun --all --device cpu`` runs once for
  the module, over every (architecture x shape) cell on both production
  meshes, built and run on ``meta``; the cells it builds are kept. It
  writes one record a (cell, mesh) and one a skipped cell, 82 in all, and
  exits 0; every LM cell and the recsys serving cells trace, with FLOPs; a
  cell that does not trace names the line that stopped it;
  ``--skip-done`` runs nothing again; a cell that fails to build is
  recorded and the exit code is 1.
- Every cell the run built holds the same multiset of argument leaves
  (shape, dtype, spec) as the reference's ``build_cell`` on a
  ``jax.sharding.AbstractMesh`` of the production sizes (its
  in_shardings' specs, in one spelling), and the same bytes a device (each
  leaf's shard shape under its sharding). The cache's fingerprint is
  uint32 in the reference and its bits in int32 in the port, so a uint32
  leaf counts as int32.
- ``maybe_spec`` and ``add_data_axis`` against the reference's on a
  seeded sweep of shapes, specs and meshes.
- For each family's SMOKE cell at small shapes, the FLOPs counted over the
  step run on ``meta`` equal those counted over the same step run for real
  on the CPU.
- ``ShardedTxnRuntime(use_cache=False)`` and ``blk_slack=1.0`` against the
  JAX runtime with the same options.
"""

import collections
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.launch import steps as j_steps
from repro_torch import configs as t_configs
from repro_torch.distributed import sharding as t_sharding
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import ShapeMesh, make_debug_mesh, make_production_mesh
from test_torch_fixtures import _torch_test_env  # noqa: F401

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _reference_mesh_restored():
    """The reference's ``build_cell`` installs its mesh process-wide
    (``set_mesh``), and its model code constrains against it: each test
    leaves it as it found it, so no later test in the worker runs under a
    production mesh."""
    prev = j_sharding.active_mesh()
    yield
    j_sharding.set_mesh(prev)


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The dry-run over every cell, once: its exit code, its folder, its
    records by file name, and each (arch, shape, mesh) it built as its
    leaves and its bytes a device."""
    built, inner = {}, dryrun.build_cell

    def recording(arch, shape, mesh, **kw):
        step, specs, args = inner(arch, shape, mesh, **kw)
        kind = "multipod" if "pod" in mesh.shape else "pod"
        built[arch, shape, kind] = (steps.cell_leaves(args, specs),
                                    steps.argument_bytes(args, specs, mesh))
        return step, specs, args

    out = str(tmp_path_factory.mktemp("dryrun"))
    dryrun.build_cell = recording
    try:
        rc = dryrun.main(["--all", "--device", "cpu", "--out", out])
    finally:
        dryrun.build_cell = inner
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            recs[name] = json.load(f)
    return dict(rc=rc, out=out, recs=recs, built=built)


def _j_leaves(arch, shape, mesh_kind):
    """The reference cell's leaves as (shape, dtype, spec) and its bytes a
    device."""
    mesh = AbstractMesh(*MESHES[mesh_kind])
    _, shardings, args = j_steps.build_cell(arch, shape, mesh)
    is_sh = lambda x: isinstance(x, NamedSharding)
    leaves = jax.tree_util.tree_leaves(args)
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=is_sh)
    assert len(leaves) == len(shs)
    out, nbytes = [], 0
    for leaf, sh in zip(leaves, shs):
        shape_, dt = tuple(leaf.shape), np.dtype(leaf.dtype)
        nbytes += int(np.prod(sh.shard_shape(shape_), dtype=np.int64)) * dt.itemsize
        name = "int32" if dt == np.uint32 else str(dt)
        out.append((shape_, name, steps.norm_spec(tuple(sh.spec), len(shape_))))
    return out, nbytes


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_build_cell_leaves_and_bytes_equal_the_references(dry, arch, mesh_kind):
    cells = [c for c in t_configs.all_cells() if c["arch"] == arch and not c["skip"]]
    assert cells == [c for c in j_configs.all_cells() if c["arch"] == arch and not c["skip"]]
    for c in cells:
        want, want_bytes = _j_leaves(arch, c["shape"], mesh_kind)
        got, got_bytes = dry["built"][arch, c["shape"], mesh_kind]
        where = f"{arch}/{c['shape']}/{mesh_kind}"
        assert collections.Counter(got) == collections.Counter(want), where
        assert got_bytes == want_bytes, (where, got_bytes, want_bytes)


def test_a_rebuilt_cell_equals_the_runs():
    """``build_cell`` outside the dry-run gives the cell the run recorded."""
    mesh = make_production_mesh(multi_pod=True)
    _, specs, args = steps.build_cell("two-tower-retrieval", "train_batch", mesh)
    want, want_bytes = _j_leaves("two-tower-retrieval", "train_batch", "multipod")
    assert collections.Counter(steps.cell_leaves(args, specs)) == collections.Counter(want)
    assert steps.argument_bytes(args, specs, mesh) == want_bytes


def test_kimi_k2_training_share_does_not_fit_one_card(dry):
    _, nbytes = dry["built"]["kimi-k2-1t-a32b", "train_4k", "pod"]
    assert round(nbytes / 2**30, 1) == 137.0
    assert nbytes > 80 * 10**9


def _sweep(seed, n):
    rng = np.random.default_rng(seed)
    axes = [None, "data", "model", "pod", "absent", ("pod", "data"), ("data", "model"),
            ("pod", "data", "model")]
    meshes = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
              ((1, 4), ("data", "model")), ((8,), ("data",))]
    for _ in range(n):
        sizes, names = meshes[rng.integers(len(meshes))]
        rank = int(rng.integers(0, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 8, 16, 48, 256, 512, 1000, 4096]))
                      for _ in range(rank))
        spec = tuple(axes[i] for i in rng.integers(0, len(axes), int(rng.integers(0, rank + 2))))
        yield sizes, names, shape, spec


def _j_spec(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


@pytest.mark.parametrize("seed", range(4))
def test_spec_helpers_equal_the_references_on_a_sweep(seed):
    for sizes, names, shape, spec in _sweep(seed, 400):
        jm, tm = AbstractMesh(sizes, names), ShapeMesh(sizes, names)
        want = _j_spec(j_sharding.maybe_spec(shape, spec, jm))
        assert t_sharding.maybe_spec(shape, spec, tm) == want, (sizes, shape, spec)
        for data_axes in (("data",), ("pod", "data")):
            jw = _j_spec(j_sharding.add_data_axis(P(*want), shape, jm, axes=data_axes))
            tw = t_sharding.add_data_axis(want, shape, tm, axes=data_axes)
            assert tw == jw, (sizes, shape, want, data_axes)


def test_meshes_and_the_active_mesh():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_debug_mesh(2, 4).shape == {"data": 2, "model": 4}
    prev = t_sharding.active_mesh()
    try:
        t_sharding.set_mesh(None)
        assert t_sharding.maybe_spec((4, 4), ("data",)) == ()
        assert t_sharding.add_data_axis(("model",), (4, 4)) == ("model",)
        t_sharding.set_mesh(make_debug_mesh(1, 4))
        assert t_sharding.maybe_spec((8, 8), (None, "model")) == (None, "model")
        assert t_sharding.add_data_axis((None, "model"), (8, 8)) == (None, "model")
    finally:
        t_sharding.set_mesh(prev)
    x = torch.zeros(3)
    assert t_sharding.constrain(x, "data") is x


def test_all_cells_are_recorded_and_the_run_exits_0(dry):
    recs = dry["recs"]
    assert dry["rc"] == 0
    cells = t_configs.all_cells()
    skipped = [c for c in cells if c["skip"]]
    assert len(cells) == 43 and len(skipped) == 4
    assert len(recs) == 2 * (len(cells) - len(skipped)) + len(skipped) == 82
    assert len(dry["built"]) == 78
    for c in skipped:
        assert recs[f"{c['arch']}__{c['shape']}__skip.json"]["skipped"] == c["skip"]
    for name, r in recs.items():
        assert r["ok"], name
        if "skipped" in r:
            continue
        assert r["memory"]["argument_bytes"] == dry["built"][r["arch"], r["shape"], r["mesh"]][1]
        assert r["memory"]["argument_bytes"] > 0 and r["fits_card"] is None
        if r["traced"]:
            assert r["trace_error"] is None and r["cost"]["flops_global"] >= 0
            assert r["memory"]["output_bytes"] > 0
        else:  # the file and line of the read that stopped it
            path, line = r["trace_error"].split(":")[:2]
            assert path.startswith("repro_torch/") and path.endswith(".py") and line.isdigit()
            assert r["cost"]["flops_global"] is None and r["memory"]["output_bytes"] is None


def test_lm_and_recsys_serving_cells_trace_with_flops(dry):
    recs = dry["recs"]
    fams = {a: t_configs.get_arch(a).FAMILY for a in t_configs.ARCH_IDS}
    must = [r for r in recs.values() if "skipped" not in r and (
        fams[r["arch"]] == "lm" or r["shape"] in ("serve_p99", "serve_bulk", "retrieval_cand"))]
    assert len(must) == 2 * (16 + 3)
    for r in must:
        assert r["traced"] and r["cost"]["flops_global"] > 0, r
    # a cell's FLOPs are counted once and shared by its two meshes
    for r in must:
        mesh = "multipod" if r["mesh"] == "pod" else "pod"
        other = recs[f"{r['arch']}__{r['shape']}__{mesh}.json"]
        assert other["cost"] == r["cost"]
    kimi = recs["kimi-k2-1t-a32b__train_4k__pod.json"]["memory"]["argument_bytes"]
    assert round(kimi / 2**30, 1) == 137.0


def test_skip_done_reruns_nothing_and_a_failed_cell_exits_1(dry, monkeypatch, capsys):
    out, recs = dry["out"], dry["recs"]
    # the skip records are rewritten, as the reference rewrites them
    done = [n for n in recs if not n.endswith("__skip.json")]
    before = {n: os.path.getmtime(os.path.join(out, n)) for n in done}
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: pytest.fail("ran a done cell"))
    assert dryrun.main(["--all", "--device", "cpu", "--out", out, "--skip-done"]) == 0
    assert {n: os.path.getmtime(os.path.join(out, n)) for n in done} == before
    monkeypatch.undo()

    def broken(*a, **k):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    rc = dryrun.main(["--arch", "pna", "--shape", "molecule", "--mesh", "pod", "--device", "cpu",
                      "--out", out])
    assert rc == 1
    rec = json.load(open(os.path.join(out, "pna__molecule__pod.json")))
    assert not rec["ok"] and rec["error"] == "RuntimeError: no such cell"
    assert "[FAIL] pna/molecule/pod" in capsys.readouterr().out


# each family's SMOKE cell, cut to shapes a CPU runs in a second
SMOKE_CELLS = [
    ("glm4-9b", "train_4k", dict(seq_len=16, global_batch=2)),
    ("glm4-9b", "prefill_32k", dict(seq_len=16, global_batch=2)),
    ("kimi-k2-1t-a32b", "decode_32k", dict(seq_len=16, global_batch=2)),
    ("gemma3-4b", "train_4k", dict(seq_len=32, global_batch=1)),
    ("gat-cora", "full_graph_sm", dict(n_nodes=40, n_edges=100, d_feat=12, n_classes=5)),
    ("egnn", "molecule", dict(n_nodes=48, n_edges=96, d_feat=8, n_classes=1, n_graphs=4)),
    ("two-tower-retrieval", "train_batch", dict(batch=16)),
    ("two-tower-retrieval", "serve_p99", dict(batch=8, n_candidates=5)),
    ("two-tower-retrieval", "retrieval_cand", dict(batch=1, n_candidates=300)),
]


@pytest.mark.parametrize("arch,shape,info", SMOKE_CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in SMOKE_CELLS])
def test_meta_flops_equal_a_real_cpu_run(arch, shape, info):
    cfg = t_configs.get_arch(arch).SMOKE
    mesh = make_debug_mesh()
    step, _, args = steps.build_cell(arch, shape, mesh, cfg=cfg, info=info)
    meta = dryrun.trace_cell(step, args)
    assert meta["traced"], meta
    step, _, args = steps.build_cell(arch, shape, mesh, cfg=cfg, info=info, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    assert meta["flops_global"] == counter.get_total_flops() > 0
    assert meta["output_bytes"] == dryrun._tensor_bytes(out)


# --------------------------------------------- the runtime options the cells set
@pytest.fixture(scope="module")
def nocache_world():
    import repro.core as J
    from conftest import build_world, common_watchlist_plan, enabled_ttable
    from repro.graphstore import make_mutation_batch as j_batch
    from repro.graphstore.mutations import apply_mutations as j_apply
    from repro_torch import interop
    from test_torch_sharded import to_np

    spec, store = build_world()
    mb = j_batch(spec, new_edges=[(0, 11, 0, [1]), (3, 6, 0, [1]), (1, 7, 0, [1])],
                 del_edges=[2], set_vprops=[(7, 0, 0)], del_vertices=[9])
    jstore, _ = jax.jit(j_apply, static_argnums=0)(spec, store, mb)
    jspec = J.EngineSpec(store=spec, cache=J.CacheSpec(capacity=1024, probes=8, max_leaves=16,
                                                        max_chunks=2), max_deg=32, frontier=32)
    plan = common_watchlist_plan()
    return dict(
        spec=spec, jspec=jspec, jstore=jstore, jttable=enabled_ttable()[0],
        tspec=interop.engine_spec(tuple(spec), tuple(jspec.cache), 32, 32),
        tstore=interop.store_from_numpy(to_np(jstore), device="cpu"),
        tttable=interop.ttable_from_numpy(to_np(enabled_ttable()[0])),
        plan=plan, tplan=interop.plan_from_numpy(to_np(plan)),
        engine=J.GraphEngine(jspec, plan, False, fused=True),
    )


@pytest.mark.parametrize("n", [4, 1])
def test_runtime_without_cache_and_tight_blocks_equals_the_references(nocache_world, n):
    """``use_cache=False`` and ``blk_slack=1.0`` (the dry-run cells'
    options): the block layout equals the reference's ``default_pspec(...,
    slack=1.0)`` partition field for field, and reads equal the JAX engine
    with the cache off (results, metrics but the sharded-only ones, misses),
    a full cache never probed."""
    import repro.core as J
    from repro.graphstore import partition as JP
    from repro_torch import interop
    from repro_torch.distributed import ShardedTxnRuntime, flat_mesh
    from test_torch_partition import assert_tree_equal, to_np
    from test_torch_sharded import SHARDED_ONLY, miss_key

    w = nocache_world
    rt = ShardedTxnRuntime(w["tspec"], flat_mesh(n), use_cache=False, blk_slack=1.0,
                           route_cap_factor=None, device="cpu")
    jpspec = JP.default_pspec(w["spec"], n, slack=1.0)
    assert tuple(rt.pspec) == tuple(jpspec)
    assert rt.pspec.e_blk_cap < ShardedTxnRuntime(w["tspec"], flat_mesh(n), device="cpu") \
        .pspec.e_blk_cap or n == 1
    pstore = rt.partition_store(w["tstore"])
    assert_tree_equal(interop.pstore_to_numpy(pstore), to_np(JP.partition_store(jpspec,
                                                                                  w["jstore"])))
    jcache, tcache = J.empty_cache(w["jspec"].cache), rt.empty_cache()
    for roots in (np.array([5, 6, 7, 8, 9, 0, 3], np.int32), np.arange(16, dtype=np.int32)):
        jr, jm, jmet = w["engine"].run(w["jstore"], jcache, w["jttable"], roots)
        tr, tm, tmet = rt.run_gr_tx_batch(pstore, tcache, w["tttable"], w["tplan"], roots)
        np.testing.assert_array_equal(tr, np.asarray(jr))
        for k in SHARDED_ONLY:
            tmet.pop(k)
        jmet.pop("host_syncs")
        assert tmet == jmet and tmet["hits"] == 0 and tmet["misses"] > 0
        assert miss_key(tm) == miss_key(jm)
    assert int(tcache.n_hit) == int(tcache.n_miss) == 0  # never probed
