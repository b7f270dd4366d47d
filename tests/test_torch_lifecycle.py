"""Parity: the port's host-side modules — the one-hop oracle, the query
rewrite rules, the Service Coordinator's lifecycle — and the port's keys
against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from conftest import (
    P_LISTING_ID,
    TEMPLATES,
    build_world,
    common_watchlist_plan,
    enabled_ttable,
    fig1_plan,
    sq2_hop,
)
from repro.core.oracle import HostStore as JHostStore, onehop_oracle as j_oracle
import repro_torch.core as T
from repro_torch import interop
from repro_torch.core.keys import key_fingerprint, key_slot_hash
from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator, TemplateState
from repro_torch.core.oracle import HostStore, onehop_oracle
from test_torch_engine import to_np


@pytest.mark.parametrize("seed", [0, 2])
def test_onehop_oracle(seed):
    spec, jstore = build_world(seed=seed)
    tstore = interop.store_from_numpy(to_np(jstore), device="cpu")
    jhs, ths = JHostStore(jstore), HostStore(tstore)
    for jplan in (fig1_plan(1, 0), fig1_plan(0, 1), J.QueryPlan(hops=(sq2_hop(1),))):
        jhop = jplan.hops[0]
        thop = interop.hop_from_numpy(to_np(jhop))
        for root in range(-1, int(jstore.v_len) + 1):
            want = j_oracle(jhs, jhop.direction, jhop.edge_label, jhop.pr, jhop.pe,
                            jhop.pl, root, jhop.params)
            got = onehop_oracle(ths, thop.direction, thop.edge_label, thop.pr, thop.pe,
                                thop.pl, root, thop.params)
            assert got == want, (root, got, want)


def test_rewrite_rules():
    for jplan in (fig1_plan(), common_watchlist_plan(),
                  J.QueryPlan(hops=fig1_plan().hops, final=J.FINAL_VALUES,
                              final_prop=P_LISTING_ID)):
        tplan = interop.plan_from_numpy(to_np(jplan))
        for unique in (frozenset(), frozenset({P_LISTING_ID})):
            want = J.rewrite_plan(jplan, unique)
            got = T.rewrite_plan(tplan, unique)
            assert got.post_filter == want.post_filter
            assert (got.final, got.final_prop) == (want.final, want.final_prop)
            for gh, wh in zip(got.hops, want.hops):
                for f in ("pr", "pe", "pl"):
                    for a, b in zip(getattr(gh, f), getattr(wh, f)):
                        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lifecycle_masks_and_removal():
    jttable, _, _ = enabled_ttable()
    ttable = T.make_template_table([T.Template(
        t.name, t.direction, (t.root[0], []), (t.edge[0], []), (t.leaf[0], []),
        t.edge_label) for t in TEMPLATES])
    qps = [GraphQP("a"), GraphQP("b")]
    sc = ServiceCoordinator(qps, seed=3, drop_prob=0.3)
    for t in range(2):
        sc.register(t)
        sc.enable(t)
        assert sc.check_safety()
    masked = qps[0].ttable_masks(ttable, 2)
    np.testing.assert_array_equal(masked.read_enabled, np.asarray(jttable.read_enabled))
    np.testing.assert_array_equal(masked.write_enabled, np.asarray(jttable.write_enabled))
    # disable + remove reclaims the template's cache subspace (clearRange)
    spec = T.CacheSpec(capacity=64, probes=4, max_leaves=4, max_chunks=2)
    cache = T.empty_cache(spec, device="cpu")
    M = -(2**31) + 1
    params = torch.full((4, 6), M, dtype=torch.int32)
    cache = T.cache_insert(spec, cache, torch.tensor([0, 0, 1, 1]), torch.arange(4),
                           params, torch.zeros((4, 8), dtype=torch.int32),
                           torch.tensor([1, 2, 3, 4]), 1, torch.ones(4, dtype=torch.bool))
    cache = sc.disable_and_remove(0, cache, spec)
    assert sc.states[0] == TemplateState.REMOVED and sc.check_safety()
    assert {e[0] for e in T.cache_entries(spec, cache)} == {1}
    assert sc.messages_dropped > 0


def test_key_hashes_match():
    rng = np.random.default_rng(5)
    roots = rng.integers(0, 1000, 50).astype(np.int32)
    params = rng.integers(-(2**31) + 1, 2**31 - 1, (50, 6), dtype=np.int64).astype(np.int32)
    for tpl in (0, 3, 17):
        for jf, tf in ((J.key_slot_hash, key_slot_hash), (J.key_fingerprint, key_fingerprint)):
            want = np.asarray(jf(tpl, jnp.asarray(roots), jnp.asarray(params)))
            got = tf(tpl, torch.as_tensor(roots), torch.as_tensor(params)).numpy()
            np.testing.assert_array_equal(got.astype(np.uint32), want)
