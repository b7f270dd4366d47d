"""The eCommerce production workload on the PyTorch port (synthetic twin of §5).

Twin of ``benchmarks/workload.py``. It is no benchmark: it defines no cell
and no metric, only the world, the query and write mixes and the route-skew
measurement that the port's callers (``examples/serve_ecommerce_torch.py``,
``chip_smoke.py``) run.

World: users own watch-lists; watch-lists include listings (edge property
IsActive); listings are sold by users. Listing vertices carry Status (0/1),
a unique ListingId, and LastSeen. Access is Zipfian.

Six one-hop sub-query templates (the paper's production count) cover the
query mix; queries reference 1-4 one-hop sub-queries; one aggregate query
references none (Lesson 3's indirect beneficiary, ~14% of traffic). Write
mix follows Table 7: Upsert 44.85%, Update-LastSeen 43.94%, Delete-Edges
11.22%; >25% of upserts are predicate no-ops (Lesson 2).

Workload mixes (§5 Figure 4): R-hat 99% reads at high load, W-hat 62:38,
R-low 94:6 at low load.

``build_world`` makes the reference's draws in the reference's order, so a
seed gives the reference's world. ``build_scaled_world`` is the same schema
at ``scale`` times those counts, drawn in bulk (other draws, so another
world) for sizes a Python loop cannot build; both return a ``World``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import (
    ANY_LABEL,
    DIR_IN,
    DIR_OUT,
    FINAL_COUNT,
    FINAL_IDS,
    FINAL_VALUES,
    OP_EQ,
    WILDCARD,
    CacheSpec,
    EngineSpec,
    Hop,
    QueryPlan,
    Template,
    make_pred,
    make_template_table,
)
from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator
from repro_torch.graphstore import StoreSpec, ingest, make_mutation_batch
from repro_torch.utils import PROP_MISSING

MISSING = int(PROP_MISSING)

# labels
L_USER, L_WATCHLIST, L_LISTING = 2, 0, 1
E_INCLUDES, E_OWNS, E_SOLD_BY = 0, 1, 2
# vprops
P_STATUS, P_LISTING_ID, P_LAST_SEEN = 0, 1, 2
# eprops
P_ISACTIVE = 0

TEMPLATES = [
    Template("SQ1", DIR_OUT, (L_WATCHLIST, []),
             (ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
             (L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]), edge_label=E_INCLUDES),
    Template("SQ2", DIR_IN, (L_LISTING, []),
             (ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
             (L_WATCHLIST, []), edge_label=E_INCLUDES),
    Template("SQ3", DIR_OUT, (L_USER, []), (ANY_LABEL, []),
             (L_WATCHLIST, []), edge_label=E_OWNS),
    Template("SQ4", DIR_IN, (L_WATCHLIST, []), (ANY_LABEL, []),
             (L_USER, []), edge_label=E_OWNS),
    Template("SQ5", DIR_OUT, (L_LISTING, []), (ANY_LABEL, []),
             (L_USER, []), edge_label=E_SOLD_BY),
    Template("SQ6", DIR_IN, (L_USER, []), (ANY_LABEL, []),
             (L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]), edge_label=E_SOLD_BY),
]
TPL_META = {
    0: (DIR_OUT, E_INCLUDES), 1: (DIR_IN, E_INCLUDES), 2: (DIR_OUT, E_OWNS),
    3: (DIR_IN, E_OWNS), 4: (DIR_OUT, E_SOLD_BY), 5: (DIR_IN, E_SOLD_BY),
}


def _params(*pairs):
    p = np.full(6, MISSING, np.int32)
    for i, v in pairs:
        p[i] = v
    return p


def hops():
    """Hop factories bound to the registered templates."""
    sq1 = lambda ia=1, st=0: Hop(
        DIR_OUT, E_INCLUDES, make_pred(L_WATCHLIST, []),
        make_pred(ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
        make_pred(L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]),
        0, _params((0, ia), (3, st)))
    sq2 = lambda ia=1: Hop(
        DIR_IN, E_INCLUDES, make_pred(L_LISTING, []),
        make_pred(ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
        make_pred(L_WATCHLIST, []), 1, _params((0, ia)))
    sq3 = lambda: Hop(
        DIR_OUT, E_OWNS, make_pred(L_USER, []), make_pred(ANY_LABEL, []),
        make_pred(L_WATCHLIST, []), 2, _params())
    sq5 = lambda: Hop(
        DIR_OUT, E_SOLD_BY, make_pred(L_LISTING, []), make_pred(ANY_LABEL, []),
        make_pred(L_USER, []), 4, _params())
    sq6 = lambda st=0: Hop(
        DIR_IN, E_SOLD_BY, make_pred(L_USER, []), make_pred(ANY_LABEL, []),
        make_pred(L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]), 5,
        _params((3, st)))
    # the aggregate query's hop matches NO registered template (tpl_idx=-1):
    # it scans all includes edges regardless of IsActive
    agg = lambda: Hop(
        DIR_OUT, E_INCLUDES, make_pred(L_WATCHLIST, []),
        make_pred(ANY_LABEL, []), make_pred(L_LISTING, []), -1, _params())
    return dict(sq1=sq1, sq2=sq2, sq3=sq3, sq5=sq5, sq6=sq6, agg=agg)


def query_plans():
    """The query-template mix: (name, plan, root_label, weight, class)."""
    h = hops()
    return [
        # Figure 1: watch-list actives (1 one-hop), the dominant query
        ("q_fig1", QueryPlan((h["sq1"](),), FINAL_IDS), L_WATCHLIST, 0.30, "cached"),
        # §2 two-hop: other listings sharing a watch-list (+ rewriteable filter)
        ("q_common", QueryPlan((h["sq2"](), h["sq1"]()), FINAL_IDS,
                               post_filter=("prop_neq_root", P_LISTING_ID)),
         L_LISTING, 0.18, "cached"),
        # user's active listings across their watch-lists (2 one-hops)
        ("q_user", QueryPlan((h["sq3"](), h["sq1"]()), FINAL_IDS),
         L_USER, 0.14, "cached"),
        # 4 one-hops: active listings sold by sellers of the user's watched items
        ("q_sellers", QueryPlan(
            (h["sq3"](), h["sq1"](), h["sq5"](), h["sq6"]()), FINAL_IDS),
         L_USER, 0.10, "cached"),
        # valueMap query (rewrite drops the fetch phase)
        ("q_values", QueryPlan((h["sq1"](),), FINAL_VALUES,
                               final_prop=P_LISTING_ID), L_WATCHLIST, 0.14, "cached"),
        # Lesson 3: the aggregate query, no one-hop template, no rewrite
        ("q_agg", QueryPlan((h["agg"](),), FINAL_COUNT, extra_phases=2),
         L_WATCHLIST, 0.14, "agg"),
    ]


def serving_lifecycle(templates):
    """Every template registered and enabled for reads and writes through
    one query processor (the safe lifecycle): ``(ttable, coordinator,
    qp)``."""
    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    for t in range(len(templates)):
        sc.register(t)
        sc.enable(t)
    assert sc.check_safety()
    return qp.ttable_masks(make_template_table(templates), len(templates)), sc, qp


def _pick(rng, lo, hi, a=1.3):
    """One Zipf(a) draw over ``[lo, hi)`` from ``rng``: rank r at ``lo + r``,
    the tail folded onto ``hi - 1``."""
    return lo + min(int(rng.zipf(a)) - 1, hi - lo - 1)


def zipf_picks(rng, lo, hi, n, a=1.3):
    """``n`` draws of ``World.zipf_pick(lo, hi, a)`` at once, as int32: the
    same values, in the same order, from the same stream."""
    return (lo + np.minimum(rng.zipf(a, n) - 1, hi - lo - 1)).astype(np.int32)


@dataclass
class World:
    spec: StoreSpec
    espec: EngineSpec
    store: object
    ttable: object
    sc: object
    qp: object
    n_users: int
    n_watchlists: int
    n_listings: int
    rng: np.random.Generator
    includes_eids: list = field(default_factory=list)

    def zipf_pick(self, lo, hi, a=1.3):
        return _pick(self.rng, lo, hi, a)

    def vertex_range(self, label):
        if label == L_USER:
            return 0, self.n_users
        if label == L_WATCHLIST:
            return self.n_users, self.n_users + self.n_watchlists
        return self.n_users + self.n_watchlists, self.n_users + self.n_watchlists + self.n_listings

    def ranges(self) -> dict:
        """{label: vertex_range(label)} for the three labels."""
        return {lab: self.vertex_range(lab) for lab in (L_USER, L_WATCHLIST, L_LISTING)}


def _world(spec, espec, store, rng, n_users, n_watchlists, n_listings, includes):
    ttable, sc, qp = serving_lifecycle(TEMPLATES)
    return World(spec=spec, espec=espec, store=store, ttable=ttable, sc=sc, qp=qp,
                 n_users=n_users, n_watchlists=n_watchlists, n_listings=n_listings,
                 rng=rng, includes_eids=includes)


def build_world(
    n_users=200, n_watchlists=300, n_listings=2000, avg_wl_size=12,
    seed=0, cache_capacity=8192, max_deg=64, device=None,
) -> World:
    """The reference's world, its draws in its order; the store on
    ``device`` (CUDA unless another is named)."""
    rng = np.random.default_rng(seed)
    nv = n_users + n_watchlists + n_listings
    spec = StoreSpec(
        v_cap=1 << (nv + 512).bit_length(), e_cap=1 << 16, n_vprops=3,
        n_eprops=1, recent_cap=512,
    )
    vlabels = np.array(
        [L_USER] * n_users + [L_WATCHLIST] * n_watchlists + [L_LISTING] * n_listings
    )
    vprops = np.full((nv, 3), MISSING, np.int64)
    l0 = n_users + n_watchlists
    vprops[l0:, P_STATUS] = rng.integers(0, 2, n_listings)
    vprops[l0:, P_LISTING_ID] = 10_000 + np.arange(n_listings)
    vprops[:, P_LAST_SEEN] = 0
    es, ed, el, ep = [], [], [], []
    # owns: each watch-list owned by a user
    for w in range(n_users, n_users + n_watchlists):
        es.append(int(rng.integers(0, n_users)))
        ed.append(w)
        el.append(E_OWNS)
        ep.append([MISSING])
    # includes: Zipf watch-list sizes
    for w in range(n_users, n_users + n_watchlists):
        size = min(int(rng.zipf(1.4) * avg_wl_size / 3) + 2, max_deg - 8)
        members = rng.choice(np.arange(l0, nv), size=min(size, n_listings), replace=False)
        for m in members:
            es.append(w)
            ed.append(int(m))
            el.append(E_INCLUDES)
            ep.append([int(rng.integers(0, 2))])
    # sold_by: each listing sold by one user
    for li in range(l0, nv):
        es.append(li)
        ed.append(int(rng.integers(0, n_users)))
        el.append(E_SOLD_BY)
        ep.append([MISSING])
    store = ingest(spec, vlabels, vprops, es, ed, el, np.array(ep), device=device)
    cspec = CacheSpec(capacity=cache_capacity, probes=8, max_leaves=32, max_chunks=2)
    espec = EngineSpec(store=spec, cache=cspec, max_deg=max_deg, frontier=32)
    includes = [i for i, lab in enumerate(el) if lab == E_INCLUDES]
    return _world(spec, espec, store, rng, n_users, n_watchlists, n_listings, includes)


def build_scaled_world(rng, device, scale, max_deg=64) -> World:
    """The schema of ``build_world`` at ``scale`` times its default counts,
    vectorised numpy from ``rng`` (its own draws: not ``build_world``'s
    world at scale 1). Watch-list sizes are Zipf(1.4) as there, capped at
    ``max_deg - 8``, members drawn with replacement and duplicate pairs
    dropped. The FULL config's 8 edge slots per vertex; at scale 1600 this
    is v_cap 2^22, e_cap 2^25 and a 2^18-slot cache (2^26 slots / 256
    chips). ``includes_eids`` is an array of the includes edges' slots."""
    n_users, n_wl, n_list = 200 * scale, 300 * scale, 2000 * scale
    nv = n_users + n_wl + n_list
    u0, w0, l0 = 0, n_users, n_users + n_wl
    vlabels = np.concatenate([np.full(n_users, L_USER), np.full(n_wl, L_WATCHLIST),
                              np.full(n_list, L_LISTING)]).astype(np.int32)
    vprops = np.full((nv, 3), MISSING, np.int32)
    vprops[l0:, P_STATUS] = rng.integers(0, 2, n_list)
    vprops[l0:, P_LISTING_ID] = 10_000 + np.arange(n_list)
    vprops[:, P_LAST_SEEN] = 0
    wl = np.arange(w0, w0 + n_wl, dtype=np.int64)
    # owns: each watch-list owned by a user
    own_src = rng.integers(u0, u0 + n_users, n_wl)
    # includes: Zipf(1.4) watch-list sizes, capped; no duplicate pairs
    sizes = np.minimum((rng.zipf(1.4, n_wl) * 12 // 3 + 2), max_deg - 8)
    inc_src = np.repeat(wl, sizes)
    inc_dst = l0 + rng.integers(0, n_list, len(inc_src))
    _, first = np.unique(inc_src * n_list + (inc_dst - l0), return_index=True)
    keep = np.sort(first)
    inc_src, inc_dst = inc_src[keep], inc_dst[keep]
    inc_act = rng.integers(0, 2, len(inc_src))
    # sold_by: each listing sold by one user
    sold_dst = rng.integers(u0, u0 + n_users, n_list)
    esrc = np.concatenate([own_src, inc_src, np.arange(l0, nv)])
    edst = np.concatenate([wl, inc_dst, sold_dst])
    elab = np.concatenate([np.full(n_wl, E_OWNS), np.full(len(inc_src), E_INCLUDES),
                           np.full(n_list, E_SOLD_BY)])
    eprops = np.concatenate([np.full(n_wl, MISSING), inc_act, np.full(n_list, MISSING)])
    v_cap = 1 << (nv + 512).bit_length()
    spec = StoreSpec(v_cap=v_cap, e_cap=8 * v_cap, n_vprops=3, n_eprops=1, recent_cap=1024)
    assert nv <= spec.v_cap and len(esrc) <= spec.e_cap
    store = ingest(spec, vlabels, vprops, esrc, edst, elab, eprops[:, None], device=device)
    cap = max(1 << 12, 1 << ((1 << 18) * scale // 1600).bit_length() - 1)
    cspec = CacheSpec(capacity=cap, probes=8, max_leaves=32, max_chunks=2)
    espec = EngineSpec(store=spec, cache=cspec, max_deg=max_deg, frontier=32)
    includes = n_wl + np.arange(len(inc_src))  # edge slots of the includes edges
    return _world(spec, espec, store, rng, n_users, n_wl, n_list, includes)


# --------------------------------------------------------------- write mix
def draw_write(rng, spec, ranges, includes, kind: str, device=None):
    """The draws of one ``make_write`` from ``rng``, over the vertex
    ``ranges`` ({label: (lo, hi)}) and the includes edge slots
    ``includes``: a ``MutationBatch`` on ``device``, or None for a
    predicate no-op upsert."""
    l0, l1 = ranges[L_LISTING]
    w0, w1 = ranges[L_WATCHLIST]
    if kind == "upsert":
        # Type 1: upsert a sub-graph; ~30% are predicate no-ops (Lesson 2)
        if rng.random() < 0.3:
            return None
        listing = _pick(rng, l0, l1)
        wl = _pick(rng, w0, w1)
        return make_mutation_batch(
            spec, set_vprops=[(listing, P_STATUS, int(rng.integers(0, 2)))],
            new_edges=[(wl, listing, E_INCLUDES, [int(rng.integers(0, 2))])], device=device)
    if kind == "last_seen":
        # Type 2: LastSeen is not referenced by any template predicate
        v = _pick(rng, l0, l1)
        return make_mutation_batch(
            spec, set_vprops=[(v, P_LAST_SEEN, int(rng.integers(1, 1 << 30)))], device=device)
    if kind == "del_edges":
        k = int(rng.integers(1, 4))
        eids = rng.choice(includes, size=k, replace=False)
        return make_mutation_batch(spec, del_edges=[int(e) for e in eids], device=device)
    raise ValueError(kind)


def make_write(world: World, kind: str):
    """Returns (kind, MutationBatch | None). None = predicate no-op upsert.
    The batch lies on the world's store's device."""
    return kind, draw_write(world.rng, world.spec, world.ranges(), world.includes_eids, kind,
                            world.store.vlabel.device)


WRITE_MIX = [("upsert", 0.4485), ("last_seen", 0.4394), ("del_edges", 0.1122)]

# workload mixes: (name, read_fraction, arrival_rate_relative)
MIXES = {
    "R_hat": dict(read_frac=0.99, load=1.0),  # heavy read-dominated
    "W_hat": dict(read_frac=0.62, load=0.85),  # batch-write window
    "R_low": dict(read_frac=0.94, load=0.35),  # low load
}


# ----------------------------------------------------------- route skew
def _skew_stats(factors) -> dict:
    f = np.array(factors)
    return dict(
        mean=round(float(f.mean()), 3), p50=round(float(np.percentile(f, 50)), 3),
        p99=round(float(np.percentile(f, 99)), 3),
        p999=round(float(np.percentile(f, 99.9)), 3),
        max=round(float(f.max()), 3),
        recommended_cap_factor=int(np.ceil(np.percentile(f, 99.9))),
    )


def measure_route_skew(world: World, n_shards: int = 8, batch: int = 512,
                       n_batches: int = 200) -> dict:
    """Measure the per-owner routing skew of the production query mix.

    ``ShardedTxnRuntime`` routes each hop's frontier roots to their owner
    shards into per-peer buckets of ``route_cap_factor * rows / n`` slots.
    For each query batch this takes the largest per-owner share of the root
    frontier as a multiple of the uniform share (``batch / n``); the p99.9
    of that multiplier is the cap factor that bounds overflow at ~0.1% of
    batches. Hops >= 2 route leaf-derived roots: for every multi-hop plan
    the hop-1 frontier is derived on the host from the first hop's
    adjacency (direction and edge label; each root's leaves deduplicated and
    capped at the engine's result width) and measured against its own
    uniform share (``frontier``). ``per_hop_recommended`` gives both as the
    tuple ``ShardedTxnRuntime(route_cap_factor=...)`` takes."""
    plans = query_plans()
    weights = np.array([w for (_, _, _, w, _) in plans])
    weights /= weights.sum()

    store = world.store
    host = lambda x: x.cpu().numpy()
    e_len = int(store.e_len)
    esrc = host(store.esrc)[:e_len]
    edst = host(store.edst)[:e_len]
    elab = host(store.elabel)[:e_len]
    ealive = host(store.ealive)[:e_len]
    rw = int(world.espec.result_width)
    adj = {}

    def hop1_frontier(roots, direction, edge_label):
        key = (int(direction), int(edge_label))
        if key not in adj:
            k, o = (edst, esrc) if direction == DIR_IN else (esrc, edst)
            sel = ealive & ((edge_label < 0) | (elab == edge_label))
            order = np.argsort(k[sel], kind="stable")
            adj[key] = (k[sel][order], o[sel][order])
        ks, os_ = adj[key]
        lo = np.searchsorted(ks, roots, side="left")
        hi = np.searchsorted(ks, roots, side="right")
        parts = []
        for l, h in zip(lo, hi):
            if h > l:
                ls = os_[l:h]
                _, first = np.unique(ls, return_index=True)
                parts.append(ls[np.sort(first)][:rw])
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    root_factors, frontier_factors = [], []
    for _ in range(n_batches):
        _, plan, label, _, _ = plans[int(world.rng.choice(len(plans), p=weights))]
        lo, hi = world.vertex_range(label)
        roots = np.array([world.zipf_pick(lo, hi) for _ in range(batch)])
        owners = np.mod(roots, n_shards)  # interleaved ownership
        counts = np.bincount(owners, minlength=n_shards)
        root_factors.append(counts.max() / (batch / n_shards))
        if len(plan.hops) > 1:
            fr = hop1_frontier(roots, plan.hops[0].direction, plan.hops[0].edge_label)
            if len(fr):
                c = np.bincount(np.mod(fr, n_shards), minlength=n_shards)
                frontier_factors.append(c.max() / (len(fr) / n_shards))
    out = dict(n_shards=n_shards, batch=batch, n_batches=n_batches)
    out.update(_skew_stats(root_factors))
    out["frontier"] = (
        dict(_skew_stats(frontier_factors), n_batches=len(frontier_factors))
        if frontier_factors else None
    )
    out["per_hop_recommended"] = [out["recommended_cap_factor"]] + (
        [out["frontier"]["recommended_cap_factor"]] if out["frontier"] else []
    )
    return out
