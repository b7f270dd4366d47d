"""Parity: the port's gR-Tx engine and CP population against the JAX package.

The quickstart sequence end to end (miss -> populate -> hit -> gRW-Tx
write-around -> fresh read), then the §2 two-hop ``q_common`` and the odd
batch sizes 0, 1 and 5 on both ``fused`` settings. Compared: results, miss
records, metrics except ``host_syncs``, and the post-populate and post-gRW
store and cache, bit for bit.
"""

import numpy as np
import pytest
import torch

import repro.core as J
from conftest import (
    P_STATUS,
    TPL_META,
    build_world,
    common_watchlist_plan,
    enabled_ttable,
    fig1_plan,
)
from repro.core.population import CachePopulator as JPopulator
from repro.graphstore import make_mutation_batch as j_batch
import repro_torch.core as T
from repro_torch import interop
from repro_torch.core.population import CachePopulator as TPopulator
from repro_torch.graphstore import make_mutation_batch as t_batch


def to_np(x):
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_np(v) for v in x)
    if isinstance(x, (int, float, str, bool, type(None), np.ndarray)):
        return x
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


class Both:
    """The same world held by both packages."""

    def __init__(self, seed=0):
        spec, jstore = build_world(seed=seed)
        self.jspec = J.EngineSpec(store=spec, cache=J.CacheSpec(
            capacity=1024, probes=8, max_leaves=16, max_chunks=2), max_deg=32, frontier=32)
        self.tspec = interop.engine_spec(tuple(spec), tuple(self.jspec.cache), 32, 32)
        self.jttable, _, _ = enabled_ttable()
        self.tttable = interop.ttable_from_numpy(to_np(self.jttable))
        self.jstore, self.jcache = jstore, J.empty_cache(self.jspec.cache)
        self.tstore = interop.store_from_numpy(to_np(jstore), device="cpu")
        self.tcache = T.empty_cache(self.tspec.cache, device="cpu")
        self.jpop = JPopulator(self.jspec, TPL_META)
        self.tpop = TPopulator(self.tspec, TPL_META, device="cpu")

    _engines: dict = {}  # JAX engines jit once per (espec, plan); reuse them

    def run(self, plan, roots, fused=True, use_cache=True):
        roots = np.asarray(roots, np.int32)
        key = (self.jspec, fused, use_cache, plan.final, plan.post_filter,
               tuple((h.tpl_idx, tuple(np.asarray(h.params).tolist())) for h in plan.hops))
        if key not in self._engines:
            self._engines[key] = J.GraphEngine(self.jspec, plan, use_cache, fused=fused)
        jr, jm, jmet = self._engines[key].run(self.jstore, self.jcache, self.jttable, roots)
        tr, tm, tmet = T.GraphEngine(
            self.tspec, interop.plan_from_numpy(to_np(plan)), use_cache, fused=fused,
            device="cpu").run(self.tstore, self.tcache, self.tttable, roots)
        np.testing.assert_array_equal(tr, np.asarray(jr))
        assert [(m.tpl_idx, m.root, m.params.tolist(), m.read_version) for m in tm] == \
            [(m.tpl_idx, m.root, np.asarray(m.params).tolist(), m.read_version) for m in jm]
        jmet, tmet = dict(jmet), dict(tmet)
        assert tmet.pop("host_syncs") >= 1
        jmet.pop("host_syncs")
        assert tmet == jmet
        return tr, jm, tm, tmet

    def populate(self, jm, tm):
        self.jpop.queue.push(jm)
        self.tpop.queue.push(tm)
        self.jcache = self.jpop.drain(self.jstore, self.jstore, self.jcache, self.jttable)
        self.tcache = self.tpop.drain(self.tstore, self.tstore, self.tcache, self.tttable)
        assert (self.tpop.committed, self.tpop.aborted) == (self.jpop.committed, self.jpop.aborted)
        self.check_state("populate")

    def grw(self, policy="write-around", **kw):
        self.jstore, self.jcache, jmw = J.run_grw_tx(
            self.jspec, self.jstore, self.jcache, self.jttable, j_batch(self.jspec.store, **kw),
            policy=policy)
        self.tstore, self.tcache, tmw = T.run_grw_tx(
            self.tspec, self.tstore, self.tcache, self.tttable,
            t_batch(self.tspec.store, device="cpu", **kw), policy=policy, device="cpu")
        assert tmw.pop("host_syncs") >= 1
        assert tmw == jmw
        self.check_state("gRW")
        return tmw

    def check_state(self, what):
        assert T.cache_entries(self.tspec.cache, self.tcache) == \
            J.cache_entries(self.jspec.cache, self.jcache), what
        for got, want in ((interop.cache_to_numpy(self.tcache), to_np(self.jcache)),
                          (interop.store_to_numpy(self.tstore), to_np(self.jstore))):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}.{k}")


@pytest.mark.parametrize("fused", [True, False])
def test_quickstart_sequence(fused):
    w = Both()
    plan = fig1_plan()
    roots = [0, 1, 2, 3]
    _, jm, tm, m1 = w.run(plan, roots, fused)
    assert m1["misses"] == 4 and m1["hits"] == 0
    w.populate(jm, tm)
    res, _, _, m2 = w.run(plan, roots, fused)
    assert m2["hits"] == 4 and m2["phases"] == 2  # n+2 -> 2
    # flip the Status of a listing on watch-list 0: write-around invalidates
    leaf = int(res[0][res[0] >= 0][0])
    mw = w.grw(set_vprops=[(leaf, P_STATUS, 1)])
    assert mw["impacted_keys"] >= 1
    res3, _, _, m3 = w.run(plan, roots, fused)
    assert leaf not in res3[0].tolist() and m3["misses"] >= 1


@pytest.mark.parametrize("fused", [True, False])
def test_q_common_and_odd_batches(fused):
    w = Both(seed=1)
    plan = common_watchlist_plan()
    listings = np.arange(4, 16, dtype=np.int32)
    for B in (0, 1, 5, 12):
        _, jm, tm, _ = w.run(plan, listings[:B], fused)
        w.populate(jm, tm)
    # mixed hit/miss second pass, a write, then the uncached engine agrees
    _, jm, tm, m = w.run(plan, listings[::-1], fused)
    assert m["hits"] > 0
    w.populate(jm, tm)
    w.grw(new_edges=[(0, 10, 0, [1]), (1, 11, 0, [1])], del_edges=[0],
          set_vprops=[(12, P_STATUS, 1)])
    cached, _, _, _ = w.run(plan, listings, fused)
    uncached, _, _, _ = w.run(plan, listings, fused, use_cache=False)
    np.testing.assert_array_equal(cached, uncached)
    w.run(fig1_plan(), np.arange(4, dtype=np.int32), fused)
