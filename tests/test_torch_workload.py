"""Parity: ``repro_torch.workload`` against ``benchmarks/workload.py``.

The same seed gives the same world (labels, properties, every store array,
the includes edge ids, the template table's masks), at the reference's
default sizes and at a second seed with other counts; the templates and
query plans are equal field for field; a run of ``make_write`` draws gives
the same batches; ``measure_route_skew`` returns the same report at 4 and
8 shards. Integer data throughout, so every comparison is exact.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference's benchmarks package

import benchmarks.workload as JW  # noqa: E402
import repro_torch.workload as TW  # noqa: E402
from repro_torch import interop  # noqa: E402
from test_torch_sharded import to_np  # noqa: E402
from test_torch_fixtures import _torch_test_env  # noqa: E402, F401

WORLDS = {"default": dict(seed=0),
          "second": dict(seed=7, n_users=40, n_watchlists=60, n_listings=300)}


@pytest.fixture(scope="module")
def worlds():
    return {name: (JW.build_world(**kw), TW.build_world(device="cpu", **kw))
            for name, kw in WORLDS.items()}


def tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)) and not isinstance(want, np.ndarray):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            tree_equal(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("name", list(WORLDS))
def test_world_matches_reference(worlds, name):
    jw, tw = worlds[name]
    assert tuple(tw.spec) == tuple(jw.spec)
    assert tw.espec == interop.engine_spec(tuple(jw.spec), tuple(jw.espec.cache),
                                           jw.espec.max_deg, jw.espec.frontier)
    assert (tw.n_users, tw.n_watchlists, tw.n_listings) == \
        (jw.n_users, jw.n_watchlists, jw.n_listings)
    assert tw.includes_eids == jw.includes_eids
    tree_equal(interop.store_to_numpy(tw.store), to_np(jw.store), "store")
    tree_equal(to_np(tw.ttable), to_np(jw.ttable), "ttable")
    assert tw.ttable.read_enabled.all() and tw.ttable.write_enabled.all()
    states = lambda sc: {t: st.value for t, st in sc.states.items()}
    assert tw.sc.check_safety() and states(tw.sc) == states(jw.sc)
    for label in (TW.L_USER, TW.L_WATCHLIST, TW.L_LISTING):
        assert tw.vertex_range(label) == jw.vertex_range(label)
    # the generators are left in the same state
    assert tw.rng.integers(0, 1 << 30) == jw.rng.integers(0, 1 << 30)


def test_templates_and_plans_match_reference():
    import repro.core as J
    import repro_torch.core as T

    def fields(t, wildcard):
        # each package has its own WILDCARD sentinel
        conds = lambda side: (side[0], [(p, op, "?" if v is wildcard else v) for p, op, v in side[1]])
        return {k: conds(v) if k in ("root", "edge", "leaf") else v for k, v in vars(t).items()}

    for got, want in zip(TW.TEMPLATES, JW.TEMPLATES, strict=True):
        assert fields(got, T.WILDCARD) == fields(want, J.WILDCARD)
    assert TW.TPL_META == JW.TPL_META
    assert (TW.WRITE_MIX, TW.MIXES, TW.MISSING) == (JW.WRITE_MIX, JW.MIXES, JW.MISSING)
    for got, want in zip(TW.query_plans(), JW.query_plans(), strict=True):
        assert got[0] == want[0] and got[2:] == want[2:]
        tree_equal(to_np(got[1]), to_np(want[1]), got[0])
    for name, make in TW.hops().items():
        tree_equal(to_np(make()), to_np(JW.hops()[name]()), name)


def test_make_write_draws_match_reference(worlds):
    jw, tw = worlds["default"]
    jw.rng, tw.rng = np.random.default_rng(11), np.random.default_rng(11)
    kinds, weights = zip(*JW.WRITE_MIX)
    weights = np.array(weights) / sum(weights)
    seen = set()
    for _ in range(60):
        kind = kinds[int(jw.rng.choice(len(kinds), p=weights))]
        assert kind == kinds[int(tw.rng.choice(len(kinds), p=weights))]
        (jk, jmb), (tk, tmb) = JW.make_write(jw, kind), TW.make_write(tw, kind)
        assert jk == tk == kind and (jmb is None) == (tmb is None)
        seen.add(kind if jmb is not None else "no-op")
        if jmb is not None:
            assert tmb.ne_src.device.type == "cpu"
            for f in jmb._fields:
                np.testing.assert_array_equal(getattr(tmb, f).numpy(), np.asarray(getattr(jmb, f)),
                                              err_msg=f)
    assert seen == {"upsert", "last_seen", "del_edges", "no-op"}


@pytest.mark.parametrize("n_shards", [4, 8])
def test_route_skew_matches_reference(worlds, n_shards):
    jw, tw = worlds["default"]
    jw.rng, tw.rng = np.random.default_rng(3), np.random.default_rng(3)
    got = TW.measure_route_skew(tw, n_shards=n_shards, batch=128, n_batches=24)
    want = JW.measure_route_skew(jw, n_shards=n_shards, batch=128, n_batches=24)
    assert got == want and got["frontier"] is not None


def test_zipf_picks_are_the_worlds_draws():
    tw = TW.build_world(device="cpu", n_users=4, n_watchlists=4, n_listings=8)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    tw.rng = a
    want = [tw.zipf_pick(10, 500) for _ in range(64)]
    got = TW.zipf_picks(b, 10, 500, 64)
    assert got.dtype == np.int32 and got.tolist() == want


def test_the_scaled_world_has_the_schema():
    w = TW.build_scaled_world(np.random.default_rng(0), "cpu", 1, max_deg=16)
    r = w.ranges()
    assert r == {TW.L_USER: (0, 200), TW.L_WATCHLIST: (200, 500), TW.L_LISTING: (500, 2500)}
    s = interop.store_to_numpy(w.store)
    e = int(s["e_len"])
    lab, src, dst = s["elabel"][:e], s["esrc"][:e], s["edst"][:e]
    inc = np.asarray(w.includes_eids)
    assert (lab[inc] == TW.E_INCLUDES).all() and (lab == TW.E_INCLUDES).sum() == len(inc)
    assert (np.bincount(src[inc], minlength=500)[200:] <= 16 - 8).all()
    assert len(set(zip(src[inc].tolist(), dst[inc].tolist()))) == len(inc)  # no duplicate pair
    assert (lab == TW.E_OWNS).sum() == 300 and (lab == TW.E_SOLD_BY).sum() == 2000
    assert w.espec.cache.capacity == 1 << 12 and w.ttable.read_enabled.all()


def test_build_world_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TW.build_world(n_users=4, n_watchlists=4, n_listings=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TW.build_scaled_world(np.random.default_rng(0), None, 1)
