"""Parity: write-through cache maintenance on one host.

The port's write-through gRW step (``get_grw_step(..., "write-through")``:
apply mutations + op-stream derivation + compaction + sweeps + the
key-segmented value-edit apply), its sink path ``write_through_update``,
the two op-stream appliers and ``_value_row``'s corner cases, against the
JAX package on the same seeded inputs, bit for bit (stats included). Then
the property of ``tests/test_write_through_convergence.py``: every entry
that survives a write-through commit equals a fresh CP repopulation.
"""

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.invalidation as JI
from conftest import E_INCLUDES, P_STATUS, TPL_META, build_world, enabled_ttable, fig1_plan
from repro.graphstore import apply_mutations as j_apply, make_mutation_batch as j_batch
import repro_torch.core as T
import repro_torch.core.invalidation as TI
from repro_torch import interop
from repro_torch.core.population import populate_step
from repro_torch.graphstore import apply_mutations as t_apply, make_mutation_batch as t_batch
from repro_torch.utils import SyncCount
from test_torch_engine import Both, to_np
from test_torch_invalidation import _populate_all, _random_commit

_j_write_through = jax.jit(JI.write_through_update, static_argnums=0)
_j_apply_stream = jax.jit(JI.apply_op_stream, static_argnums=0)
_j_segmented = jax.jit(JI.apply_op_stream_segmented, static_argnums=0)


def _cache_equal(tcache, jcache, what):
    got, want = interop.cache_to_numpy(tcache), to_np(jcache)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}.{k}")


def _stream_equal(tops, jops):
    for f in TI.CacheOpStream._fields:
        np.testing.assert_array_equal(getattr(tops, f).numpy(), np.asarray(getattr(jops, f)),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_write_through_grw_step_random_batches(seed):
    """``run_grw_tx(..., "write-through")`` over random mixed batches on a
    fully populated cache: post-store, cache (stats included) and metrics
    equal the reference's after every commit, and some entries survive."""
    w = Both(seed=seed)
    rng = np.random.default_rng(10 + seed)
    _populate_all(w)
    for _ in range(3):
        kw = _random_commit(rng, int(w.jstore.v_len), int(w.jstore.e_len))
        w.grw("write-through", **kw)  # compares store, cache and metrics
        _populate_all(w)
    assert int(w.tcache.valid.sum()) > 0


def _applied(w, kw):
    js2, japplied = j_apply(w.jspec.store, w.jstore, j_batch(w.jspec.store, **kw))
    ts2, tapplied = t_apply(w.tspec.store, w.tstore, t_batch(w.tspec.store, device="cpu", **kw))
    return js2, japplied, ts2, tapplied


_MIXED = dict(new_edges=[(0, 11, E_INCLUDES, [1]), (2, 10, E_INCLUDES, [1])],
              del_edges=[1], del_vertices=[9], set_vprops=[(8, P_STATUS, 1), (7, P_STATUS, 0)],
              set_eprops=[(0, 0, 0)])


def test_write_through_update_sink_path():
    """The sink path (each emission applied at once, value edits walked row
    by row) equals the reference's on a batch of every mutation kind."""
    w = Both(seed=4)
    _populate_all(w)
    rng = np.random.default_rng(4)
    for kw in (_MIXED, _random_commit(rng, int(w.jstore.v_len), int(w.jstore.e_len))):
        js2, japplied, ts2, tapplied = _applied(w, kw)
        jc = _j_write_through(w.jspec, w.jstore, js2, w.jcache, w.jttable, japplied)
        tc = TI.write_through_update(w.tspec, w.tstore, ts2, w.tcache, w.tttable, tapplied)
        w.jstore, w.jcache, w.tstore, w.tcache = js2, jc, ts2, tc
        w.check_state("write_through_update")


def test_op_stream_appliers_agree():
    """The derived write-through stream equals the reference's; the
    sequential ``apply_op_stream`` and the key-segmented apply leave the
    same cache as each other and as the reference's sequential walk."""
    w = Both(seed=2)
    _populate_all(w)
    js2, japplied, ts2, tapplied = _applied(w, _MIXED)
    jops, jsw = JI.derive_cache_ops(w.jspec, w.jstore, js2, w.jttable, japplied, through=True)
    tops, tsw = TI.derive_cache_ops(w.tspec, w.tstore, ts2, w.tttable, tapplied, through=True)
    _stream_equal(tops, jops)
    for f in TI.SweepStream._fields:
        np.testing.assert_array_equal(getattr(tsw, f).numpy(), np.asarray(getattr(jsw, f)))
    assert bool((tops.ok & (tops.kind != TI.OP_DELETE)).any()), "no value ops derived"
    jc = _j_apply_stream(w.jspec.cache, w.jcache, jops)
    seq = TI.apply_op_stream(w.tspec.cache, w.tcache, tops)
    syncs = SyncCount()
    seg = TI.apply_op_stream_segmented(w.tspec.cache, w.tcache, tops, syncs)
    assert syncs.n == 1
    _cache_equal(seq, jc, "apply_op_stream")
    _cache_equal(seg, jc, "apply_op_stream_segmented")
    _cache_equal(seg, _j_segmented(w.jspec.cache, w.jcache, jops), "segmented vs reference")


# (entry, op, leaf): a full single-chunk entry, a two-chunk entry, a
# partial entry; the leaf already present or absent; a missing key and a
# masked row
_VALUE_ROW_CASES = [
    ("full", "add", "absent"), ("full", "add", "present"), ("full", "remove", "present"),
    ("multi", "add", "absent"), ("multi", "remove", "present"),
    ("partial", "add", "absent"), ("partial", "add", "present"),
    ("partial", "remove", "present"), ("partial", "remove", "absent"),
    ("missing", "add", "absent"), ("masked", "add", "absent"),
]


@pytest.mark.parametrize("entry,op,leaf", _VALUE_ROW_CASES)
def test_value_row_corner_cases(entry, op, leaf):
    w = Both()
    L = w.tspec.cache.max_leaves
    M = -(2**31) + 1
    params = np.array([1, M, M, 0, M, M], np.int32)
    lens = {"full": L, "multi": L + 3, "partial": 5}
    leaves = np.full((3, 2 * L), -1, np.int32)
    for i, n in enumerate(lens.values()):
        leaves[i, :n] = 100 + 10 * i + np.arange(n)
    roots = np.array([0, 1, 2], np.int32)
    args = (0, roots, np.broadcast_to(params, (3, 6)), leaves, np.array(list(lens.values())),
            np.ones(3, np.int32), np.ones(3, bool))
    jc = J.cache_insert(w.jspec.cache, w.jcache, *args)
    tc = T.cache_insert(w.tspec.cache, w.tcache, *(torch.as_tensor(np.ascontiguousarray(a))
                                                   for a in args))
    _cache_equal(tc, jc, "insert")
    row = {"full": 0, "multi": 1, "partial": 2, "missing": 3, "masked": 2}[entry]
    root = row
    vid = int(leaves[min(row, 2), 1]) if leaf == "present" else 7
    mask = entry != "masked"
    jout = JI._value_row(w.jspec.cache, jc, 0, root, params, vid, mask, op == "add")
    tout = TI._value_row(w.tspec.cache, tc, 0, root, torch.as_tensor(params), vid, mask,
                         op == "add")
    _cache_equal(tout, jout, f"{entry}/{op}/{leaf}")
    changed = not torch.equal(tout.vals, tc.vals) or not torch.equal(tout.valid, tc.valid)
    assert changed == (entry in ("full", "multi", "partial") and
                       (entry == "multi" or (op == "add") != (leaf == "present"))), \
        "the edit took effect where it should not, or did not where it should"


@pytest.mark.parametrize("seed", range(4))
def test_write_through_entries_equal_fresh_repopulation(seed):
    """Every entry a write-through commit keeps holds exactly the leaf set a
    fresh CP repopulation of its key gives on the post-commit store."""
    spec, jstore = build_world(n_watchlists=5, n_listings=14, seed=seed)
    cspec = T.CacheSpec(capacity=1024, probes=8, max_leaves=8, max_chunks=2)
    espec = interop.engine_spec(tuple(spec), tuple(cspec), 32, 16)
    store = interop.store_from_numpy(to_np(jstore), device="cpu")
    ttable = interop.ttable_from_numpy(to_np(enabled_ttable()[0]))
    rng = np.random.default_rng(100 + seed)

    plan = interop.plan_from_numpy(to_np(fig1_plan()))
    eng = T.GraphEngine(espec, plan, True, device="cpu")
    _, misses, _ = eng.run(store, T.empty_cache(cspec, device="cpu"), ttable,
                           np.arange(5, dtype=np.int32))
    pop = T.CachePopulator(espec, TPL_META, device="cpu")
    pop.queue.push(misses)
    cache = pop.drain(store, store, T.empty_cache(cspec, device="cpu"), ttable)
    keys = sorted({(m.tpl_idx, m.root, tuple(m.params.tolist())) for m in misses})
    assert keys

    e_len = int(store.e_len)
    listings = lambda k: rng.integers(5, 19, k)
    mb = t_batch(
        spec, device="cpu",
        new_edges=[(int(rng.integers(0, 4)), int(v), E_INCLUDES, [int(rng.integers(0, 2))])
                   for v in listings(rng.integers(0, 3))],
        del_edges=[int(e) for e in rng.choice(e_len, rng.integers(0, 3), replace=False)],
        set_vprops=[(int(v), P_STATUS, int(rng.integers(0, 2)))
                    for v in listings(rng.integers(0, 4))],
        del_vertices=[int(v) for v in listings(rng.integers(0, 2))],
    )
    store2, cache_wt, _ = T.run_grw_tx(espec, store, cache, ttable, mb,
                                       policy="write-through", device="cpu")

    k_roots = torch.tensor([k[1] for k in keys], dtype=torch.int32)
    k_params = torch.tensor([k[2] for k in keys], dtype=torch.int32)
    hop = plan.hops[0]
    cache_re, _, _ = populate_step(
        espec, store2, store2, T.empty_cache(cspec, device="cpu"), ttable, tpl_idx=0,
        direction=hop.direction, edge_label=hop.edge_label, roots=k_roots, params=k_params,
        mask=torch.ones(len(keys), dtype=torch.bool),
        read_versions=torch.full((len(keys),), int(store2.version), dtype=torch.int32),
    )
    checked = 0
    for i, (tpl, root, _) in enumerate(keys):
        hit_wt, lv_wt, lm_wt, _ = T.cache_lookup(cspec, cache_wt, tpl, k_roots[i:i + 1],
                                                 k_params[i:i + 1])
        if not bool(hit_wt[0]):
            continue  # deleted (sweep or fallback): repopulation's job
        hit_re, lv_re, lm_re, _ = T.cache_lookup(cspec, cache_re, tpl, k_roots[i:i + 1],
                                                 k_params[i:i + 1])
        assert bool(hit_re[0]), f"kept ({tpl}, {root}) but a fresh execution cannot cache it"
        got, want = set(lv_wt[0][lm_wt[0]].tolist()), set(lv_re[0][lm_re[0]].tolist())
        assert got == want, f"key ({tpl}, {root}): {got} != {want}"
        assert int(lm_wt[0].sum()) == len(got), "the in-place edit grew a duplicate"
        checked += 1
    assert checked > 0, "no surviving entry was checked"


def test_requalified_leaf_goes_last_in_both_packages():
    """Pins the one way write-through differs from a fresh execution, the
    same in both packages: a value add appends a re-qualified leaf at the
    end of its entry, where a fresh CP repopulation lists it in edge order.
    The entry keeps the leaf set, not the order, so a multi-hop frontier
    truncated to F leaves can keep other leaves than the cache-off engine.
    Should the reference come to insert in edge order, this test fails and
    the port follows it."""
    w = Both(seed=0)
    _populate_all(w)
    h = to_np(w.jstore)
    e_len = int(h["e_len"])
    M = -(2**31) + 1
    params = np.array([1, M, M, 0, M, M], np.int32)  # IsActive 1, Status 0
    found = None
    for root in range(4):  # the watch-lists
        eids = [e for e in range(e_len) if h["esrc"][e] == root and h["ealive"][e]
                and h["eprops"][e, 0] == 1]
        status = [int(h["vprops"][h["edst"][e], P_STATUS]) for e in eids]
        # a listing that does not qualify yet, before one that does
        for i, s in enumerate(status):
            if s == 1 and 0 in status[i + 1:]:
                found = (root, int(h["edst"][eids[i]]))
                break
        if found:
            break
    assert found, "the seeded world has no watch-list to re-qualify a leaf in"
    root, leaf = found
    w.grw("write-through", set_vprops=[(leaf, P_STATUS, 0)])  # both packages, bit for bit

    key = (torch.tensor([root], dtype=torch.int32), torch.from_numpy(params[None]))
    hit, lv, lm, _ = T.cache_lookup(w.tspec.cache, w.tcache, 0, *key)
    jhit, jlv, jlm, _ = J.cache_lookup(w.jspec.cache, w.jcache, 0, np.array([root], np.int32),
                                       params[None])
    assert bool(hit[0]) and bool(jhit[0]), "write-through dropped the entry"
    cached = lv[0][lm[0]].tolist()
    assert cached == np.asarray(jlv)[0][np.asarray(jlm)[0]].tolist()
    assert cached[-1] == leaf, "the re-qualified leaf is not at the end of its entry"

    hop = fig1_plan().hops[0]
    fresh, _, _ = populate_step(
        w.tspec, w.tstore, w.tstore, T.empty_cache(w.tspec.cache, device="cpu"), w.tttable,
        tpl_idx=0, direction=int(hop.direction), edge_label=int(hop.edge_label), roots=key[0],
        params=key[1], mask=torch.ones(1, dtype=torch.bool),
        read_versions=torch.tensor([int(w.tstore.version)], dtype=torch.int32))
    fhit, flv, flm, _ = T.cache_lookup(w.tspec.cache, fresh, 0, *key)
    assert bool(fhit[0])
    fresh_order = flv[0][flm[0]].tolist()
    assert sorted(cached) == sorted(fresh_order), "the entry's leaf set differs"
    assert cached != fresh_order, "write-through now lists the leaf in edge order"
