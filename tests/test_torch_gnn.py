"""Parity: the port's GNN serving path (segment ops, the PNA layer and
model, the cached neighbour sampler) against the JAX package's, on the same
numpy inputs and weights.

Tolerances: segment ops 1e-5 (fp32 sums in another order than XLA's);
PNA logits and loss rtol 1e-4, atol 1e-4 (four layers of fp32 MLPs on top
of those sums). The cached sampler is held exactly: batches, hit and miss
counts, cache arrays and impacted keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.gnn.graph as JG
import repro_torch.core.cache as T_cache
from repro.gnn import GNNConfig as JConfig
from repro.gnn.layers import pna_layer
from repro.gnn.models import forward, init_params as j_init, loss_fn
from repro_torch import interop
from repro_torch.configs import pna as pna_cfg
from repro_torch.gnn import GNNConfig, graph as TG
from repro_torch.gnn.layers import mlp, pna_layer as t_pna_layer
from repro_torch.gnn.models import forward as t_forward, init_params, loss_fn as t_loss
from test_torch_cache import assert_cache_same
from test_torch_engine import to_np

# the reference under jit (configs static): the same arrays as its eager
# call, at a fraction of the CPU time of compiling every op on its own
j_pna_layer = jax.jit(pna_layer, static_argnums=1)
j_forward = jax.jit(forward, static_argnums=0)
j_loss = jax.jit(loss_fn, static_argnums=0)
SEG_TOL = 1e-5
PNA_TOL = 1e-4
NARROW = dict(name="pna-narrow", kind="pna", n_layers=4, d_hidden=12, d_in=20, n_classes=5,
              aggregators=("mean", "max", "min", "std"),
              scalers=("identity", "amplification", "attenuation"))


def _batch(seed, N, E, d_feat, n_classes):
    """A padded batch with masked edges and nodes, and isolated nodes (the
    last quarter receives no edge)."""
    rng = np.random.default_rng(seed)
    return dict(
        node_feat=rng.normal(size=(N, d_feat)).astype(np.float32),
        edge_src=rng.integers(0, N, E).astype(np.int32),
        edge_dst=rng.integers(0, 3 * N // 4, E).astype(np.int32),
        node_mask=rng.random(N) < 0.9,
        edge_mask=rng.random(E) < 0.8,
        labels=rng.integers(0, n_classes, N).astype(np.int32),
        positions=None, graph_ids=None, n_graphs=1,
    )


def _both(d):
    jg = JG.GraphBatch(**{k: v if v is None or k == "n_graphs" else jnp.asarray(v)
                          for k, v in d.items()})
    return jg, interop.graph_batch_from_numpy(d, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _params(cfg_kw, seed):
    jp = j_init(JConfig(**cfg_kw), jax.random.PRNGKey(seed))
    return jp, interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("D", [1, 9, 40])
def test_segment_ops(D):
    d = _batch(D, 64, 300, D, 4)
    rng = np.random.default_rng(D + 1)
    m = rng.normal(size=(300, D)).astype(np.float32)
    mj, mt = jnp.asarray(m), torch.as_tensor(m)
    dst, em = d["edge_dst"], d["edge_mask"]
    args_j, args_t = (jnp.asarray(dst), 64, jnp.asarray(em)), (torch.as_tensor(dst), 64,
                                                               torch.as_tensor(em))
    for name in ("scatter_sum", "scatter_max", "scatter_min"):
        got = getattr(TG, name)(mt, *args_t)
        _close(got, getattr(JG, name)(mj, *args_j), SEG_TOL)
        assert not got[48:].any(), f"{name}: isolated nodes must be zero"
    mean, cnt = TG.scatter_mean(mt, *args_t)
    jmean, jcnt = JG.scatter_mean(mj, *args_j)
    _close(mean, jmean, SEG_TOL)
    _close(cnt, jcnt, 0)
    _close(TG.degrees(*args_t), JG.degrees(*args_j), 0)
    _close(TG.segment_softmax(mt, *args_t), JG.segment_softmax(mj, *args_j), SEG_TOL)


@pytest.mark.parametrize("D", [1, 9, 40])
def test_segment_ops_over_one_csr(D):
    """The segment sums given one ``edge_csr`` of the batch: the JAX
    package's values, and bit for bit what each call's own sort gives."""
    d = _batch(D + 5, 64, 300, D, 4)
    m = np.random.default_rng(D + 6).normal(size=(300, D)).astype(np.float32)
    mj, mt = jnp.asarray(m), torch.as_tensor(m)
    dst, em = d["edge_dst"], d["edge_mask"]
    args_j, args_t = (jnp.asarray(dst), 64, jnp.asarray(em)), (torch.as_tensor(dst), 64,
                                                               torch.as_tensor(em))
    csr = TG.edge_csr(*args_t)
    got = TG.scatter_sum(mt, *args_t, csr)
    _close(got, JG.scatter_sum(mj, *args_j), SEG_TOL)
    assert torch.equal(got, TG.scatter_sum(mt, *args_t))
    mean, cnt = TG.scatter_mean(mt, *args_t, csr)
    jmean, jcnt = JG.scatter_mean(mj, *args_j)
    _close(mean, jmean, SEG_TOL)
    _close(cnt, jcnt, 0)
    _close(TG.degrees(*args_t, csr), JG.degrees(*args_j), 0)
    soft = TG.segment_softmax(mt, *args_t, csr)
    _close(soft, JG.segment_softmax(mj, *args_j), SEG_TOL)
    assert torch.equal(soft, TG.segment_softmax(mt, *args_t))


def test_forward_sorts_the_edges_once(monkeypatch):
    """``forward`` (and ``loss_fn`` through it) calls ``prepare_edges`` once
    and hands that CSR to every segment sum of every layer: five a PNA
    layer; the logits equal, bit for bit, a forward whose sums each sort
    the edges themselves."""
    cfg_kw = NARROW
    _, tp = _params(cfg_kw, 5)
    _, tg = _both(_batch(6, 128, 600, cfg_kw["d_in"], cfg_kw["n_classes"]))
    tc = GNNConfig(**cfg_kw)
    prepared, sums = [], []
    inner_prepare, inner_spmm = TG.prepare_edges, TG.segment_spmm
    monkeypatch.setattr(TG, "prepare_edges",
                        lambda *a, **k: prepared.append(inner_prepare(*a, **k)) or prepared[-1])
    monkeypatch.setattr(TG, "segment_spmm",
                        lambda *a, **k: sums.append(k.get("csr")) or inner_spmm(*a, **k))
    logits = t_forward(tc, tp, tg)
    assert len(prepared) == 1, f"{len(prepared)} prepare_edges calls in one forward"
    assert len(sums) == 5 * cfg_kw["n_layers"] and all(c is prepared[0] for c in sums)
    t_loss(tc, tp, tg)
    assert len(prepared) == 2 and len(sums) == 10 * cfg_kw["n_layers"]
    h = tg.node_feat
    for lp in tp["layers"]:
        h = t_pna_layer(lp, tc, h, tg.edge_src, tg.edge_dst, tg.edge_mask, tg.node_mask)
    assert torch.equal(logits, mlp(tp["head"], h))


def test_pna_layer_smoke():
    cfg_kw = {f: getattr(pna_cfg.SMOKE, f) for f in pna_cfg.SMOKE.__dataclass_fields__}
    jp, tp = _params(cfg_kw, 1)
    d = _batch(2, 96, 400, cfg_kw["d_in"], cfg_kw["n_classes"])
    jg, tg = _both(d)
    got = t_pna_layer(tp["layers"][0], GNNConfig(**cfg_kw), tg.node_feat, tg.edge_src,
                    tg.edge_dst, tg.edge_mask, tg.node_mask)
    want = j_pna_layer(jp["layers"][0], JConfig(**cfg_kw), jg.node_feat, jg.edge_src,
                       jg.edge_dst, jg.edge_mask, jg.node_mask)
    _close(got, want, PNA_TOL)


@pytest.mark.parametrize("which", ["smoke", "narrow"])
def test_pna_forward_and_loss(which):
    cfg_kw = NARROW if which == "narrow" else {
        f: getattr(pna_cfg.SMOKE, f) for f in pna_cfg.SMOKE.__dataclass_fields__}
    jp, tp = _params(cfg_kw, 3)
    jg, tg = _both(_batch(4, 128, 600, cfg_kw["d_in"], cfg_kw["n_classes"]))
    jc, tc = JConfig(**cfg_kw), GNNConfig(**cfg_kw)
    logits = t_forward(tc, tp, tg)
    assert logits.shape == (128, cfg_kw["n_classes"])
    _close(logits, j_forward(jc, jp, jg), PNA_TOL)
    _close(t_loss(tc, tp, tg), j_loss(jc, jp, jg), PNA_TOL)


def test_init_params_layout_and_unported_kinds():
    cfg = GNNConfig(**NARROW)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = j_init(JConfig(**NARROW), jax.random.PRNGKey(0))
    shapes = lambda t: [tuple(x.shape) for x in jax.tree_util.tree_leaves(t)]
    assert shapes(interop.params_to_numpy(tp)) == shapes(jp)
    back = interop.params_from_numpy(interop.params_to_numpy(tp), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                  jax.tree_util.tree_leaves(tp)))
    gat = GNNConfig(name="gat", kind="gat", n_layers=2, d_hidden=8, d_in=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(gat, torch.Generator(), device="cpu")
    g = TG.random_graph_batch(torch.Generator().manual_seed(1), 10, 30, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_forward(gat, tp, g)
    assert g.node_feat.shape == (10, 4) and g.edge_src.dtype == torch.int32
    assert g.to("cpu").edge_dst is not None


# ------------------------------------------------ the example's cached loop
N, E_INIT, D_FEAT, EPOCHS = 256, 1024, 16, 3


def _example_world(pkg):
    """``examples/gnn_cached_sampling.py``'s world in package ``pkg`` (the
    JAX package or the port on the CPU), from the same numpy draws."""
    if pkg == "jax":
        from repro.core import ANY_LABEL, DIR_OUT, CacheSpec, EngineSpec, Template
        from repro.core import empty_cache, make_template_table
        from repro.core.lifecycle import GraphQP, ServiceCoordinator
        from repro.core.population import CachePopulator
        from repro.gnn import CachedNeighborSampler
        from repro.graphstore import StoreSpec, ingest
        dev = {}
    else:
        from repro_torch.core import ANY_LABEL, DIR_OUT, CacheSpec, EngineSpec, Template
        from repro_torch.core import empty_cache, make_template_table
        from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator
        from repro_torch.core.population import CachePopulator
        from repro_torch.gnn import CachedNeighborSampler
        from repro_torch.graphstore import StoreSpec, ingest
        dev = {"device": "cpu"}
    M = -(2**31) + 1
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E_INIT)
    dst = rng.integers(0, N, E_INIT)
    spec = StoreSpec(v_cap=512, e_cap=4096, n_vprops=1, n_eprops=1, recent_cap=256)
    store = ingest(spec, [0] * N, np.full((N, 1), M), src, dst, [0] * E_INIT,
                   np.full((E_INIT, 1), M), **dev)
    nbr = Template("NBR", DIR_OUT, (ANY_LABEL, []), (ANY_LABEL, []), (ANY_LABEL, []))
    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    sc.register(0)
    sc.enable(0)
    ttable = qp.ttable_masks(make_template_table([nbr]), 1)
    espec = EngineSpec(store=spec, cache=CacheSpec(capacity=2048, max_leaves=32, max_chunks=2),
                       max_deg=64, frontier=32)
    pop = CachePopulator(espec, {0: (DIR_OUT, -1)}, **dev)
    sampler = CachedNeighborSampler(espec, store, empty_cache(espec.cache, **dev), ttable,
                                    tpl_idx=0, populator=pop, fanouts=(5, 3), **dev)
    return espec, ttable, sampler


def test_cached_sampler_loop_matches_reference(monkeypatch):
    """The example's loop (3 epochs, a gRW after each) with evaluation in
    place of training: the same batches, hits, misses, cache arrays after
    every populate() and impacted keys on both packages; losses within
    1e-4 on the same weights.

    The reference sampler calls ``cache_lookup`` and ``gather_out`` eagerly
    (~0.5 s a lookup on the CPU); the test hands it the same two functions
    under ``jax.jit``, compiled once, which compute the same arrays."""
    import repro.core.cache as j_cache
    import repro.graphstore.store as j_store
    from repro.core.engine import run_grw_tx as j_grw
    from repro.graphstore import make_mutation_batch as j_mb
    from repro_torch.core.engine import run_grw_tx as t_grw
    from repro_torch.graphstore import make_mutation_batch as t_mb

    monkeypatch.setattr(j_cache, "cache_lookup", jax.jit(j_cache.cache_lookup, static_argnums=0))
    monkeypatch.setattr(j_store, "gather_out", jax.jit(j_store.gather_out, static_argnums=(0, 3)))
    M = -(2**31) + 1
    jspec, jtt, js = _example_world("jax")
    tspec, ttt, ts = _example_world("torch")
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    cfg_kw = dict(name="sage-demo", kind="pna", n_layers=2, d_hidden=16, d_in=D_FEAT,
                  n_classes=4)
    jp, tp = _params(cfg_kw, 0)
    for epoch in range(EPOCHS):
        seeds = rng.choice(N, size=16, replace=False)
        jg, tg = js.sample_store(seeds, feats, labels), ts.sample_store(seeds, feats, labels)
        for f in ("node_feat", "edge_src", "edge_dst", "node_mask", "edge_mask", "labels"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                          err_msg=f"epoch {epoch}: {f}")
        assert (ts.hits, ts.misses) == (js.hits, js.misses), epoch
        _close(t_loss(GNNConfig(**cfg_kw), tp, tg), j_loss(JConfig(**cfg_kw), jp, jg), PNA_TOL)
        js.populate()
        ts.populate()
        assert_cache_same(tspec.cache, ts.cache, jspec.cache, js.cache, f"epoch {epoch}")
        new = [(int(rng.integers(0, N)), int(rng.integers(0, N)), 0, [M])]
        dele = [int(rng.integers(0, E_INIT))]
        js.store, js.cache, jm = j_grw(jspec, js.store, js.cache, jtt,
                                       j_mb(jspec.store, new_edges=new, del_edges=dele))
        ts.store, ts.cache, tm = t_grw(tspec, ts.store, ts.cache, ttt,
                                       t_mb(tspec.store, new_edges=new, del_edges=dele,
                                            device="cpu"), device="cpu")
        assert tm["impacted_keys"] == jm["impacted_keys"], epoch
        assert_cache_same(tspec.cache, ts.cache, jspec.cache, js.cache, f"gRW {epoch}")
    assert ts.hits > 0, "later epochs should hit the neighbour-list cache"


def _queue(pop):
    """A populator's queued miss records, in order, with their attempts."""
    return [(int(r.tpl_idx), int(r.root), tuple(np.asarray(r.params).tolist()),
             int(r.read_version), a) for r, a in pop.queue.q]


def test_batched_sampler_mixed_layer_matches_reference(monkeypatch):
    """One sampling whose frontiers repeat vertices and mix hits with misses
    in one layer (a CP drain of only part of the queue before it): the same
    batch, hits and misses as the reference's batch-1 loop, and the same
    miss records queued in the same order, before ``populate()``."""
    import repro.core.cache as j_cache
    import repro.graphstore.store as j_store

    monkeypatch.setattr(j_cache, "cache_lookup", jax.jit(j_cache.cache_lookup, static_argnums=0))
    monkeypatch.setattr(j_store, "gather_out", jax.jit(j_store.gather_out, static_argnums=(0, 3)))
    _, _, js = _example_world("jax")
    _, _, ts = _example_world("torch")
    layers = []
    inner = ts.lookup

    def logged(vs):
        out, hit = inner(vs)
        layers.append((np.asarray(vs).tolist(), hit.tolist()))
        return out, hit

    ts.lookup = logged
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    first = rng.choice(N, size=12, replace=False)
    for s in (js, ts):
        s.sample_store(first, feats, labels)
        s.cache = s.pop.drain(s.store, s.store, s.cache, s.ttable, 20)
    assert _queue(ts.pop) == _queue(js.pop)
    seeds = np.concatenate([first[:6], first[:3], rng.choice(N, size=6, replace=False)])
    layers.clear()
    jg, tg = js.sample_store(seeds, feats, labels), ts.sample_store(seeds, feats, labels)
    for f in ("node_feat", "edge_src", "edge_dst", "node_mask", "edge_mask", "labels"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)
    assert (ts.hits, ts.misses) == (js.hits, js.misses)
    assert _queue(ts.pop) == _queue(js.pop)
    assert ts.pop.queue._seen_inflight == js.pop.queue._seen_inflight
    assert len(layers) == len(ts.fanouts)
    assert any(any(hit) and not all(hit) and len(set(vs)) < len(vs) for vs, hit in layers), \
        "no layer repeated a vertex and mixed hits with misses"


def test_sampler_looks_up_once_per_layer(monkeypatch):
    """Each ``sample_store`` makes one ``cache_lookup`` (one probe launch on
    the card) per fanout layer over the whole frontier, and at most one
    ``gather_out`` per layer over its misses."""
    import repro_torch.core.cache as t_cache
    import repro_torch.gnn.sampler as t_sampler

    _, _, ts = _example_world("torch")
    counts = {"cache_lookup": 0, "gather_out": 0, "cache_probe": 0}

    def counting(mod, name):
        inner = getattr(mod, name)

        def f(*a, **kw):
            counts[name] += 1
            return inner(*a, **kw)

        monkeypatch.setattr(mod, name, f)

    counting(t_sampler, "cache_lookup")
    counting(t_sampler, "gather_out")
    counting(t_cache, "cache_probe")
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    L = len(ts.fanouts)
    for epoch in range(3):
        counts.update(dict.fromkeys(counts, 0))
        ts.sample_store(rng.choice(N, size=16, replace=False), feats, labels)
        assert counts["cache_lookup"] == counts["cache_probe"] == L, (epoch, counts)
        assert counts["gather_out"] <= L, (epoch, counts)
        ts.populate()
    assert ts.hits > 0 and ts.misses > 0


def _lean_per_chunk(spec, cache, tpl_id, root, params):
    """``cache_lookup_lean`` with one ``cache_probe`` call per chunk: the
    loop the folded launch replaced, kept as its reference."""
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref

    L, C = spec.max_leaves, spec.max_chunks
    tpl_eff = cache.tpl * C + cache.chunk
    tpl = torch.full_like(root, tpl_id)
    h, fp = T_cache._chunk_hashes(tpl, root, params, C)

    def probe(c):
        return cache_probe_ref(tpl_eff, cache.root, cache.fp, cache.valid, tpl * C + c, root,
                               h[:, c].contiguous(), fp[:, c].contiguous(), probes=spec.probes)

    found0, slot0 = probe(0)
    s0 = slot0.clamp(min=0).long()
    tlen = torch.where(found0, cache.total_len[s0], 0)
    need = ((tlen + L - 1) // L).clamp(1, C)
    ok, parts = found0, [cache.vals[s0]]
    for c in range(1, C):
        f, s = probe(c)
        sc = s.clamp(min=0).long()
        parts.append(cache.vals[sc])
        ok = ok & ((need <= c) | f) & ((need <= c) | (cache.total_len[sc] == tlen))
    version = torch.where(ok, cache.version[s0], -1)
    return ok, torch.cat(parts, -1), torch.where(ok, tlen, 0), version


@pytest.mark.parametrize("cap,probes,L,C", [(64, 8, 4, 3), (16, 4, 4, 2), (1024, 8, 8, 2)])
def test_folded_probe_matches_per_chunk_probe(cap, probes, L, C):
    """``cache_lookup_lean``'s one launch over every chunk key gives the
    per-chunk probes' (hit, leaves_raw, count, version) bit for bit, on a
    cache whose entries spill into continuation chunks (and, in the tiny
    table, lose some of them to evictions)."""
    from test_torch_cache import _batch

    rng = np.random.default_rng(cap + C)
    spec = T_cache.CacheSpec(capacity=cap, probes=probes, max_leaves=L, max_chunks=C)
    cache = T_cache.empty_cache(spec, device="cpu")
    for _ in range(2):
        cache = T_cache.cache_insert(spec, cache, *map(torch.as_tensor, _batch(rng, 40, L, C)))
    assert bool((cache.valid & (cache.chunk > 0)).any()), "no continuation chunk cached"
    tpl, root, params = _batch(rng, 40, L, C)[:3]
    roots = torch.as_tensor(np.concatenate([root, np.arange(8, dtype=np.int32)]))
    ps = torch.as_tensor(np.concatenate([params, params[:8]]))
    chained = 0
    for t in range(3):
        got = T_cache.cache_lookup_lean(spec, cache, t, roots, ps)
        want = _lean_per_chunk(spec, cache, t, roots, ps)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), t
        chained += int((got[2] > L).sum())
    assert chained > 0, "no hit read a continuation chunk"
