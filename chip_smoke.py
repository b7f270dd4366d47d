"""Drive the PyTorch port's main path on one CUDA card and check it.

The paper's single-host loop at one chip's share of the production
configuration (``src/repro/configs/ecommerce_graph.py`` FULL, 2^30 vertices
over a 256-chip pod): an eCommerce graph of 4M vertices and ~16M edges with
a 2^18-slot one-hop result cache, built on the card from ``--seed``. Phases:

1. the card (``nvidia-smi`` name and power limit);
2. the CUDA kernels built from ``src/repro_torch/csrc`` (seconds);
3. the world: counts and resident bytes;
4. traffic through the port's entry points: the R-hat (99 % reads) then
   W-hat (62:38) mixes of the eCommerce workload, gR batches of 512 Zipf
   roots, CP population draining 256 misses every 10 operations, gRW-Txs
   with write-around invalidation. The kernel launch counts are zeroed just
   before and read just after; ``cache_probe`` must have launched;
5. each kernel against its plain PyTorch version on the main path's inputs
   and shapes, ``torch.equal`` on every output, with kernel / plain / bound
   times;
6. consistency of the final state: cached results against a numpy one-hop
   reference, and against the engine with the cache off;
7. the partitioned tier: the final store split over 4 owner shards in one
   process, 12 gR batches of the six read plans through
   ``ShardedTxnRuntime`` with CP through ``ShardedMissDrain``, each batch
   held equal to the single-host engine (results always; metrics, miss
   multisets and cache entries while neither cache evicted), with latency
   percentiles of both, ``route_overflow`` under the default caps, per-shard
   store bytes and the ``block_gather`` launches (counted around the
   partitioned calls only); then ``cache_probe`` and ``block_gather`` against
   their plain versions on every input the partitioned path gave them
   (``block_gather``'s recent-region lanes must have scanned edges in both
   orientations), with times for the largest;
8. GNN serving at the ``minibatch_lg`` shape: a graph sized like Reddit
   (232,965 vertices, ~7.4M edges, 602 fp32 features, 41 classes) in the
   store, 1,024 seeds at fanouts (15, 10) through ``CachedNeighborSampler``
   (one ``cache_probe`` lookup per neighbour list), the PNA forward and loss
   at FULL widths, CP of every miss, a gRW-Tx of 64 new and 64 deleted
   edges, and a second epoch whose cache-served lists must equal the
   store's. ``segment_spmm`` launches are counted around the forwards only;
   every call they made is held to the plain version (fp32 allclose), one
   bf16 call too, and the kernel forward's logits to the plain forward's;
   times at the largest call beside its bound and ``torch.sparse.mm``.

Between 4 and 5, in 7 and in 8, a short ``torch.profiler`` window prints
the device's busy time by kernel and its idle share.

Any failure raises (non-zero exit). The last stdout line is the device
JSON; the line before it the card, and before that the kernels JSON.

Run:  python3 chip_smoke.py [--seed 0]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; non-tensor fp32 ops/s,
# used as the operations bound for the kernels' integer compares
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

MISSING = -(2**31) + 1
L_USER, L_WATCHLIST, L_LISTING = 2, 0, 1
E_INCLUDES, E_OWNS, E_SOLD_BY = 0, 1, 2
P_STATUS, P_LISTING_ID, P_LAST_SEEN = 0, 1, 2
P_ISACTIVE = 0
WRITE_MIX = [("upsert", 0.4485), ("last_seen", 0.4394), ("del_edges", 0.1122)]
MIXES = [("R_hat", 0.99), ("W_hat", 0.62)]
N_OPS = 100  # operations per traffic mix
BATCH = 512  # Zipf roots per gR batch
SCALE = 1600  # multiple of benchmarks/workload.py's default world size


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ world
def build_world(rng, device, scale, max_deg=64):
    """The eCommerce schema of ``benchmarks/workload.py`` at ``scale`` times
    its default counts: users own watch-lists, watch-lists include listings
    (IsActive), listings are sold by users. Vectorised numpy from ``rng``."""
    from repro_torch.core import CacheSpec, EngineSpec
    from repro_torch.graphstore import StoreSpec, ingest

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
    # the FULL config's 8 edge slots per vertex; at scale 1600 this is
    # v_cap 2^22, e_cap 2^25 and a 2^18-slot cache (2^26 slots / 256 chips)
    v_cap = 1 << (nv + 512).bit_length()
    spec = StoreSpec(v_cap=v_cap, e_cap=8 * v_cap, n_vprops=3, n_eprops=1, recent_cap=1024)
    assert nv <= spec.v_cap and len(esrc) <= spec.e_cap
    store = ingest(spec, vlabels, vprops, esrc, edst, elab, eprops[:, None], device=device)
    cap = max(1 << 12, 1 << ((1 << 18) * scale // 1600).bit_length() - 1)
    cspec = CacheSpec(capacity=cap, probes=8, max_leaves=32, max_chunks=2)
    espec = EngineSpec(store=spec, cache=cspec, max_deg=max_deg, frontier=32)
    includes = n_wl + np.arange(len(inc_src))  # edge slots of the includes edges
    ranges = {L_USER: (u0, w0), L_WATCHLIST: (w0, l0), L_LISTING: (l0, nv)}
    return espec, store, ranges, includes, len(esrc)


def templates_and_plans():
    """The six templates, six query plans and weights of the workload."""
    from repro_torch.core import (
        ANY_LABEL, DIR_IN, DIR_OUT, FINAL_COUNT, FINAL_IDS, FINAL_VALUES, OP_EQ,
        WILDCARD, Hop, QueryPlan, Template, make_pred,
    )

    T = [
        Template("SQ1", DIR_OUT, (L_WATCHLIST, []), (ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
                 (L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]), edge_label=E_INCLUDES),
        Template("SQ2", DIR_IN, (L_LISTING, []), (ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
                 (L_WATCHLIST, []), edge_label=E_INCLUDES),
        Template("SQ3", DIR_OUT, (L_USER, []), (ANY_LABEL, []), (L_WATCHLIST, []), edge_label=E_OWNS),
        Template("SQ4", DIR_IN, (L_WATCHLIST, []), (ANY_LABEL, []), (L_USER, []), edge_label=E_OWNS),
        Template("SQ5", DIR_OUT, (L_LISTING, []), (ANY_LABEL, []), (L_USER, []), edge_label=E_SOLD_BY),
        Template("SQ6", DIR_IN, (L_USER, []), (ANY_LABEL, []),
                 (L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]), edge_label=E_SOLD_BY),
    ]
    meta = {0: (DIR_OUT, E_INCLUDES), 1: (DIR_IN, E_INCLUDES), 2: (DIR_OUT, E_OWNS),
            3: (DIR_IN, E_OWNS), 4: (DIR_OUT, E_SOLD_BY), 5: (DIR_IN, E_SOLD_BY)}

    def params(*pairs):
        p = np.full(6, MISSING, np.int32)
        for i, v in pairs:
            p[i] = v
        return p

    sq1 = Hop(DIR_OUT, E_INCLUDES, make_pred(L_WATCHLIST, []),
              make_pred(ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
              make_pred(L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]), 0, params((0, 1), (3, 0)))
    sq2 = Hop(DIR_IN, E_INCLUDES, make_pred(L_LISTING, []),
              make_pred(ANY_LABEL, [(P_ISACTIVE, OP_EQ, WILDCARD)]),
              make_pred(L_WATCHLIST, []), 1, params((0, 1)))
    sq3 = Hop(DIR_OUT, E_OWNS, make_pred(L_USER, []), make_pred(ANY_LABEL, []),
              make_pred(L_WATCHLIST, []), 2, params())
    sq5 = Hop(DIR_OUT, E_SOLD_BY, make_pred(L_LISTING, []), make_pred(ANY_LABEL, []),
              make_pred(L_USER, []), 4, params())
    sq6 = Hop(DIR_IN, E_SOLD_BY, make_pred(L_USER, []), make_pred(ANY_LABEL, []),
              make_pred(L_LISTING, [(P_STATUS, OP_EQ, WILDCARD)]), 5, params((3, 0)))
    agg = Hop(DIR_OUT, E_INCLUDES, make_pred(L_WATCHLIST, []), make_pred(ANY_LABEL, []),
              make_pred(L_LISTING, []), -1, params())
    plans = [
        ("q_fig1", QueryPlan((sq1,), FINAL_IDS), L_WATCHLIST, 0.30),
        ("q_common", QueryPlan((sq2, sq1), FINAL_IDS, post_filter=("prop_neq_root", P_LISTING_ID)),
         L_LISTING, 0.18),
        ("q_user", QueryPlan((sq3, sq1), FINAL_IDS), L_USER, 0.14),
        ("q_sellers", QueryPlan((sq3, sq1, sq5, sq6), FINAL_IDS), L_USER, 0.10),
        ("q_values", QueryPlan((sq1,), FINAL_VALUES, final_prop=P_LISTING_ID), L_WATCHLIST, 0.14),
        ("q_agg", QueryPlan((agg,), FINAL_COUNT, extra_phases=2), L_WATCHLIST, 0.14),
    ]
    return T, meta, plans


def zipf_pick(rng, lo, hi, n, a=1.3):
    return (lo + np.minimum(rng.zipf(a, n) - 1, hi - lo - 1)).astype(np.int32)


def make_write(rng, espec, ranges, includes, kind, device):
    """One gRW batch of the workload's write mix (None = predicate no-op)."""
    from repro_torch.graphstore import make_mutation_batch

    spec = espec.store
    if kind == "upsert":
        if rng.random() < 0.3:
            return None
        listing = int(zipf_pick(rng, *ranges[L_LISTING], 1)[0])
        wl = int(zipf_pick(rng, *ranges[L_WATCHLIST], 1)[0])
        return make_mutation_batch(
            spec, set_vprops=[(listing, P_STATUS, int(rng.integers(0, 2)))],
            new_edges=[(wl, listing, E_INCLUDES, [int(rng.integers(0, 2))])], device=device)
    if kind == "last_seen":
        v = int(zipf_pick(rng, *ranges[L_LISTING], 1)[0])
        return make_mutation_batch(
            spec, set_vprops=[(v, P_LAST_SEEN, int(rng.integers(1, 1 << 30)))], device=device)
    eids = rng.choice(includes, size=int(rng.integers(1, 4)), replace=False)
    return make_mutation_batch(spec, del_edges=[int(e) for e in eids], device=device)


def tensor_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state)


# ----------------------------------------------------------------- timing
def cuda_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The device-side (kernel, copy) events of a profile."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters=20, match=None) -> float | None:
    """Device time per call of ``fn`` (the sum of the kernels it launches,
    or of those whose name contains ``match``), from ``torch.profiler``;
    None when the profiler records no such device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in device_events(prof) if match is None or match in e.name]
    return sum(e.time_range.elapsed_us() for e in evs) / iters / 1e3 if evs else None


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


# ---------------------------------------------------------------- phases
def run_traffic(seed, espec, state, ttable, plans, meta, ranges, includes, dev):
    from repro_torch.core import GraphEngine, build_grw_step
    from repro_torch.core.population import CachePopulator
    from repro_torch.kernels.cache_probe import ops as cp_ops

    store, cache = state
    engines = {n: GraphEngine(espec, p, use_cache=True, device=dev) for n, p, _, _ in plans}
    pop = CachePopulator(espec, meta, device=dev)
    grw = build_grw_step(espec, device=dev)
    weights = np.array([w for *_, w in plans])
    weights /= weights.sum()
    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)

    # warm-up: one small batch per plan, outside the measured mixes
    wrng = np.random.default_rng(seed + 99)
    for name, plan, label, _ in plans:
        _, misses, _ = engines[name].run(store, cache, ttable, zipf_pick(wrng, *ranges[label], 8))
        pop.queue.push(misses)
    cache = pop.drain(store, store, cache, ttable, 256)
    torch.cuda.synchronize()

    report = {}
    for mi, (mix, read_frac) in enumerate(MIXES):
        rng = np.random.default_rng(seed + 1000 * (mi + 1))
        lat, wlat, syncs = [], [], []
        hits = misses_n = 0
        c0, a0, l0 = pop.committed, pop.aborted, cp_ops.launches
        for i in range(N_OPS):
            if rng.random() < read_frac:
                name, plan, label, _ = plans[int(rng.choice(len(plans), p=weights))]
                roots = zipf_pick(rng, *ranges[label], BATCH)
                t0 = time.perf_counter()
                _, misses, m = engines[name].run(store, cache, ttable, roots)
                lat.append((time.perf_counter() - t0) * 1e3)
                pop.queue.push(misses)
                hits += m["hits"]
                misses_n += m["misses"]
                syncs.append(m["host_syncs"])
            else:
                kind = kinds[int(rng.choice(len(kinds), p=wweights))]
                mb = make_write(rng, espec, ranges, includes, kind, dev)
                if mb is not None:
                    t0 = time.perf_counter()
                    store, cache, _, ovf = grw(store, cache, ttable, mb)
                    assert int(ovf) == 0, "gRW maintenance ops overflowed their caps"
                    wlat.append((time.perf_counter() - t0) * 1e3)
            if i % 10 == 9:
                cache = pop.drain(store, store, cache, ttable, 256)
        torch.cuda.synchronize()
        report[mix] = dict(
            gr_batches=len(lat), p50_ms=pct(lat, 50), p95_ms=pct(lat, 95), p99_ms=pct(lat, 99),
            grw_txs=len(wlat), grw_p50_ms=pct(wlat, 50), grw_p99_ms=pct(wlat, 99),
            hit_rate=hits / max(hits + misses_n, 1), hits=hits, misses=misses_n,
            host_syncs_per_batch=float(np.mean(syncs)) if syncs else 0.0,
            committed=pop.committed - c0, aborted=pop.aborted - a0, queued=len(pop.queue),
            cache_probe_launches=cp_ops.launches - l0,
        )
        print(f"traffic {mix}: " + json.dumps(report[mix]), flush=True)
        assert report[mix]["cache_probe_launches"] > 0, f"{mix} never launched cache_probe"
    return (store, cache), report, engines


def profiled(tag, what, body, host_ops=True):
    """Runs ``body()`` under ``torch.profiler`` and prints its wall time,
    the device's busy time by kernel and its idle share. ``host_ops=False``
    traces the device alone. Returns ``(wall_ms, busy_ms)``; busy is None
    when no device time was recorded."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    if not events:
        print(f"profile{tag}: no device time recorded (not measured)", flush=True)
        return wall_ms, None
    by_name: dict = {}
    for e in events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"profile{tag}: {what}, wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms in {len(events)} device events, idle share "
          f"{1 - busy_ms / wall_ms:.4f}", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"profile{tag} kernel: {name[:70]:70s} device_ms={us / 1e3:.3f} calls={n}",
              flush=True)
    return wall_ms, busy_ms


def profile_window(tag, seed, plans, ranges, run):
    """Device time by kernel over a short steady window of gR batches
    (two of each cached read plan, ``run(name, roots)`` each)."""
    rng = np.random.default_rng(seed + 5)
    batches = [(n, label) for n, _, label, _ in plans if n != "q_agg"] * 2
    roots = [(name, zipf_pick(rng, *ranges[label], BATCH)) for name, label in batches]
    profiled(tag, f"{len(batches)} gR batches", lambda: [run(n, r) for n, r in roots])


def probe_inputs(espec, cache, hop, roots, dev):
    """The read path's kernel inputs for chunk 0 of ``hop`` over ``roots``
    (the same preparation ``core.cache.cache_lookup_lean`` does)."""
    from repro_torch.core.cache import _SEED_FP, _SEED_SLOT, _key_cols
    from repro_torch.utils import hash_rows, u32_bits

    C = espec.cache.max_chunks
    r = torch.as_tensor(roots, device=dev)
    params = torch.as_tensor(hop.params, device=dev).expand(len(roots), -1)
    cols = _key_cols(hop.tpl_idx, r, params, 0)
    return (
        (cache.tpl * C + cache.chunk).contiguous(), cache.root, cache.fp, cache.valid,
        (cols[0] * C + cols[-1]).contiguous(), cols[1].contiguous(),
        u32_bits(hash_rows(cols, _SEED_SLOT)).contiguous(),
        u32_bits(hash_rows(cols, _SEED_FP)).contiguous(),
    )


def probe_bound(args_, hit, slot, probes):
    """Least bytes/ops: each key's inputs (tpl, root, h, fp: 4 B each) and
    outputs (hit 1 B, slot 4 B) once, plus the slots its window walk must
    read (up to its first match) across all keys, once (tpl, root, fp 4 B
    each, valid 1 B)."""
    c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp = args_
    C, B = c_tpl.shape[0], tpl.shape[0]
    base = h & (C - 1)
    visited = torch.where(hit, ((slot.long() - base) & (C - 1)) + 1, probes)
    lanes = torch.arange(probes, device=h.device)
    live = lanes[None, :] < visited[:, None]
    touched = torch.zeros(C, dtype=torch.bool, device=h.device)
    touched[((base[:, None] + lanes[None, :]) & (C - 1))[live]] = True
    n_slots = int(touched.sum())
    nbytes = B * (4 + 4 + 4 + 4) + B * (1 + 4) + n_slots * (4 + 4 + 4 + 1)
    ops = int(visited.sum()) * 4
    return nbytes, ops


def gather_bound(args_, max_deg, edge_val):
    start, deg, dst, eprop, vprop, roots = args_
    valid = roots[roots >= 0].long()
    uniq = torch.unique(valid)
    d = deg[uniq].clamp(0, max_deg)
    n_lanes = int(d.sum())
    # lanes whose edge passes must also read the leaf's property
    lanes = torch.arange(max_deg, device=roots.device)
    pos = (start[uniq][:, None] + lanes[None, :]).clamp(0, dst.shape[0] - 1)
    within = lanes[None, :] < d[:, None]
    n_leaf = int((within & (eprop[pos] == edge_val)).sum())
    B = roots.shape[0]
    nbytes = B * 4 + len(uniq) * 8 + n_lanes * 8 + n_leaf * 4 + B * max_deg * (4 + 1)
    ops = B * max_deg * 4
    return nbytes, ops


def bound_ms(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def timings(kernel_fn, plain_fn) -> dict:
    """``ms`` / ``plain_ms``: CUDA-event time per call over back-to-back calls
    (what a caller pays, host work of the wrapper included);
    ``device_ms`` / ``plain_device_ms``: device time per call from the
    profiler (the kernels alone)."""
    return dict(
        ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(plain_fn, iters=20),
        device_ms=device_ms(kernel_fn), plain_device_ms=device_ms(plain_fn),
    )


def fmt_us(t) -> str:
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.3f}"
    return (f"kernel_us={us(t['ms'])} (device {us(t['device_ms'])}) "
            f"plain_us={us(t['plain_ms'])} (device {us(t['plain_device_ms'])})")


def check_kernels(espec, state, plans, ranges, launches, dev, seed):
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref
    from repro_torch.kernels.onehop_gather import ops as og_ops
    from repro_torch.kernels.onehop_gather.ref import onehop_gather_ref

    store, cache = state
    rng = np.random.default_rng(seed + 7)
    sq1 = dict((n, p) for n, p, _, _ in plans)["q_fig1"].hops[0]
    P = espec.cache.probes
    rows = []
    # cache_probe at the read path's shapes: hop 1 (512 roots) and a second
    # hop's flattened frontier (512 x 32 = 16,384 keys), on the populated cache
    for n_keys in (512, 16384):
        roots = zipf_pick(rng, *ranges[L_WATCHLIST], n_keys)
        a = probe_inputs(espec, cache, sq1, roots, dev)
        got = cp_ops.cache_probe(*a, probes=P)
        want = cache_probe_ref(*a, probes=P)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"cache_probe disagrees with its plain version at {n_keys} keys"
        err = int((got[1].long() - want[1].long()).abs().max())
        kern = lambda: cp_ops.cache_probe(*a, probes=P)
        plain_fn = lambda: cache_probe_ref(*a, probes=P)
        t = timings(kern, plain_fn)
        nbytes, ops = probe_bound(a, want[0], want[1], P)
        bms, by = bound_ms(nbytes, ops)
        print(f"kernel cache_probe keys={n_keys} cap={espec.cache.capacity} probes={P} "
              f"hits={int(got[0].sum())} {fmt_us(t)} bound_us={bms * 1e3:.4f} "
              f"({by}, {nbytes} B)", flush=True)
        row = dict(name="cache_probe", route="cuda", source="src/repro_torch/csrc/cache_probe.cu",
                   replaces="src/repro/kernels/cache_probe/kernel.py:44",
                   launches=launches["cache_probe"], max_abs_err=err, **t,
                   bound_ms=bms, bound_by=by, library_ms=None, shape=f"keys={n_keys}")
    rows.append(row)  # the JSON row carries the larger (hop-2) shape

    # onehop_gather over the store's CSR: 512 watch-list roots + -1 padding
    s = store
    start = s.out_indptr[:-1].contiguous()
    deg = (s.out_indptr[1:] - s.out_indptr[:-1]).contiguous()
    perm = s.out_perm.long()
    dst = s.edst[perm].contiguous()
    eprop = s.eprops[perm, P_ISACTIVE].contiguous()
    vprop = s.vprops[:, P_STATUS].contiguous()
    roots = np.concatenate([zipf_pick(rng, *ranges[L_WATCHLIST], 512), np.full(64, -1, np.int32)])
    a = (start, deg, dst, eprop, vprop, torch.as_tensor(roots, device=dev))
    kw = dict(max_deg=espec.max_deg, edge_val=1, leaf_val=0)
    got = og_ops.onehop_gather(*a, **kw)
    want = onehop_gather_ref(*a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        "onehop_gather disagrees with its plain version"
    err = int((got[0].long() - want[0].long()).abs().max())
    t = timings(lambda: og_ops.onehop_gather(*a, **kw), lambda: onehop_gather_ref(*a, **kw))
    nbytes, ops = gather_bound(a, espec.max_deg, 1)
    bms, by = bound_ms(nbytes, ops)
    print(f"kernel onehop_gather roots={len(roots)} max_deg={espec.max_deg} "
          f"V={start.shape[0]} E={dst.shape[0]} kept={int(got[1].sum())} {fmt_us(t)} "
          f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B)", flush=True)
    rows.append(dict(name="onehop_gather", route="cuda", source="src/repro_torch/csrc/onehop_gather.cu",
                     replaces="src/repro/kernels/onehop_gather/kernel.py:45",
                     launches=launches["onehop_gather"], max_abs_err=err, **t,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     shape=f"roots={len(roots)},max_deg={espec.max_deg}", on_main_path=False))
    return rows


def check_consistency(espec, state, ttable, plans, ranges, engines, dev, seed):
    from repro_torch.core import GraphEngine

    store, cache = state
    rng = np.random.default_rng(seed + 13)
    byname = {n: (p, label) for n, p, label, _ in plans}
    e_len, csr_len = int(store.e_len), int(store.csr_len)
    assert e_len - csr_len <= espec.store.recent_cap, "recent region overflowed"
    h = {f: getattr(store, f).cpu().numpy() for f in
         ("esrc", "edst", "elabel", "ealive", "eprops", "vlabel", "valive", "vprops")}
    F = espec.frontier

    # (a) q_fig1 / q_values against a vectorised numpy one-hop reference
    for name in ("q_fig1", "q_values"):
        lo, hi = ranges[L_WATCHLIST]
        roots = np.unique(np.concatenate([zipf_pick(rng, lo, hi, 128),
                                          rng.integers(lo, hi, 128).astype(np.int32)]))
        res, _, m = engines[name].run(store, cache, ttable, roots)
        src, dst = h["esrc"][:e_len], h["edst"][:e_len]
        sel = (np.isin(src, roots) & h["ealive"][:e_len] & (h["elabel"][:e_len] == E_INCLUDES)
               & (h["eprops"][:e_len, P_ISACTIVE] == 1))
        s, d = src[sel], dst[sel]
        ok = (h["valive"][d] & (h["vlabel"][d] == L_LISTING) & (h["vprops"][d, P_STATUS] == 0)
              & h["valive"][s] & (h["vlabel"][s] == L_WATCHLIST))
        s, d = s[ok], d[ok]
        for i, r in enumerate(roots):
            leaves = d[s == r]
            want = set(leaves.tolist()) if name == "q_fig1" else \
                set(h["vprops"][leaves, P_LISTING_ID].tolist())
            got = set(res[i][res[i] >= 0].tolist())
            if len(want) <= F:
                assert got == want, f"{name} root {r}: {sorted(got)} != {sorted(want)}"
            else:  # the frontier keeps the first F distinct leaves
                assert got <= want and len(got) == F, f"{name} root {r}"
        print(f"consistency {name}: {len(roots)} roots equal the numpy one-hop reference "
              f"(hits={m['hits']})", flush=True)

    # (b) multi-hop plans: cached engine == engine with the cache off
    for name in ("q_common", "q_sellers"):
        plan, label = byname[name]
        plain = GraphEngine(espec, plan, use_cache=False, device=dev)
        hits = 0
        for _ in range(8):
            roots = zipf_pick(rng, *ranges[label], 512)
            a, _, m = engines[name].run(store, cache, ttable, roots)
            b, _, _ = plain.run(store, cache, ttable, roots)
            for i in range(len(roots)):
                assert set(a[i][a[i] >= 0].tolist()) == set(b[i][b[i] >= 0].tolist()), \
                    f"{name} root {roots[i]}: cached result differs from uncached"
            hits += m["hits"]
        print(f"consistency {name}: 8 batches of 512 equal the uncached engine "
              f"(hits={hits})", flush=True)


# ---------------------------------------------------- partitioned tier
N_OWNERS = 4  # owner shards held in one process on the one card
P_ROUNDS = 2  # rounds over the six read plans in phase 7
# miss records each side populates after a phase-7 batch: the same records
# on both sides (the first by key), few enough that a 2^18-slot cache is
# unlikely to evict, which the entry comparison needs
P_CP_PER_BATCH = 512
SHARDED_ONLY = ("route_overflow", "locality_routed", "route_cap_retries",
                "locality_retry_rows", "host_syncs")


def miss_key(ms):
    return sorted((m.tpl_idx, m.root, tuple(np.asarray(m.params).tolist()), m.read_version)
                  for m in ms)


class CallCapture:
    """Wraps kernel wrappers, given as ``(module, name)`` pairs, while the
    ``with`` block is open, and keeps the arguments of every call they get,
    so each kernel is held to its plain version on exactly the inputs the
    path gave it. It keeps references, not copies: every such input is a
    fresh tensor or a view of store or cache state, which the path never
    writes in place."""

    def __init__(self, *targets):
        self.inner = {t: getattr(*t) for t in targets}
        self.calls = {name: [] for _, name in targets}

    def __enter__(self):
        for (mod, name), inner in self.inner.items():
            setattr(mod, name, self._wrap(name, inner))
        return self

    def _wrap(self, name, inner):
        def wrapped(*args, **kw):
            self.calls[name].append((args, kw))
            return inner(*args, **kw)

        return wrapped

    def __exit__(self, *exc):
        for (mod, name), inner in self.inner.items():
            setattr(mod, name, inner)


def run_partitioned(seed, espec, store, ttable, plans, meta, ranges, engines, dev):
    """Phase 7: the partitioned gR-Tx tier over N_OWNERS owner shards, with
    CP through ``ShardedMissDrain``, against the single-host engine on the
    same store and batches (both caches start empty; after every batch both
    populate the same ``P_CP_PER_BATCH`` miss records)."""
    import repro_torch.core.cache as cache_mod
    from repro_torch.core import CachePopulator, cache_entries, empty_cache
    from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, flat_mesh
    from repro_torch.graphstore.partition import local_shard
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.cache_probe import ops as cp_ops

    torch.cuda.reset_peak_memory_stats()
    mesh = flat_mesh(N_OWNERS)
    rt = ShardedTxnRuntime(espec, mesh, device=dev)
    t0 = time.perf_counter()
    pstore = rt.partition_store(store)
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    rep = rt.store_bytes(pstore)
    print(f"partitioned store: {N_OWNERS} owners, e_blk_cap {rt.pspec.e_blk_cap}, "
          f"recent_blk_cap {rt.pspec.recent_blk_cap}, built in {part_s:.2f}s; per shard "
          f"{rep['per_shard_bytes'] / 2**20:.1f} MiB (blocks {rep['per_shard_block_bytes'] / 2**20:.1f}"
          f" MiB) vs replicated {rep['replicated_per_shard_bytes'] / 2**20:.1f} MiB, ratio "
          f"{rep['ratio']:.4f}; blk_len-csr_len per shard out "
          f"{(pstore.out.blk_len - pstore.out.csr_len).tolist()} in "
          f"{(pstore.inc.blk_len - pstore.inc.csr_len).tolist()}", flush=True)
    # the kernels' calls on the partitioned path (the read path reaches
    # cache_probe through core.cache's name for it)
    capture = CallCapture((bg_ops, "block_gather"), (cache_mod, "cache_probe"))
    capture.inc_keys = {local_shard(rt.pspec, pstore, s).inc.key.data_ptr()
                        for s in range(N_OWNERS)}

    hcache, pcache = empty_cache(espec.cache, device=dev), rt.empty_cache()
    hpop = CachePopulator(espec, meta, device=dev)
    drain = ShardedMissDrain(rt, meta)
    rng = np.random.default_rng(seed + 21)
    lat_h, lat_p, syncs_h, syncs_p = [], [], [], []
    overflow = equal_metrics = 0
    bg = {"block_gather": 0, "cache_probe": 0}
    cp_ops.launches = bg_ops.launches = 0
    for _ in range(P_ROUNDS):
        for name, plan, label, _ in plans:
            roots = zipf_pick(rng, *ranges[label], BATCH)
            t = time.perf_counter()
            rh, mh, meth = engines[name].run(store, hcache, ttable, roots)
            lat_h.append((time.perf_counter() - t) * 1e3)
            l0 = (bg_ops.launches, cp_ops.launches)
            with capture:
                t = time.perf_counter()
                rp, mp, metp = rt.run_gr_tx_batch(pstore, pcache, ttable, plan, roots)
                lat_p.append((time.perf_counter() - t) * 1e3)
                drain.push(sorted(mp, key=lambda m: miss_key([m]))[:P_CP_PER_BATCH])
                pcache = drain.drain(pstore, pstore, pcache, ttable, k=1 << 30)
            bg["block_gather"] += bg_ops.launches - l0[0]
            bg["cache_probe"] += cp_ops.launches - l0[1]
            syncs_h.append(meth["host_syncs"])
            syncs_p.append(metp["host_syncs"])
            # a dropped row is a wrong result: the default caps must drop none
            assert metp["route_overflow"] == 0, f"partitioned {name}: route_overflow " \
                f"{metp['route_overflow']}"
            overflow += metp["route_overflow"]
            assert np.array_equal(rh, rp), f"partitioned {name}: result differs"
            hpop.queue.push(sorted(mh, key=lambda m: miss_key([m]))[:P_CP_PER_BATCH])
            hcache = hpop.drain(store, store, hcache, ttable, 1 << 30)
            if int(hcache.n_evict) == 0 and int(pcache.n_evict) == 0:
                meth.pop("host_syncs")
                for k in SHARDED_ONLY:
                    metp.pop(k)
                assert metp == meth, f"partitioned {name}: metrics {metp} != {meth}"
                assert miss_key(mp) == miss_key(mh), f"partitioned {name}: misses differ"
                equal_metrics += 1
    torch.cuda.synchronize()
    n_evict = (int(hcache.n_evict), int(pcache.n_evict))
    assert (drain.committed, drain.aborted) == (hpop.committed, hpop.aborted), "CP outcomes differ"
    entries_equal = None
    if n_evict == (0, 0):
        entries_equal = cache_entries(espec.cache, hcache) == cache_entries(espec.cache, pcache)
        assert entries_equal, "partitioned cache entries differ from the single-host cache"
    report = dict(
        batches=len(lat_p), p50_ms=pct(lat_p, 50), p95_ms=pct(lat_p, 95), p99_ms=pct(lat_p, 99),
        single_p50_ms=pct(lat_h, 50), single_p95_ms=pct(lat_h, 95), single_p99_ms=pct(lat_h, 99),
        route_overflow=int(overflow), batches_metrics_equal=equal_metrics,
        host_syncs_per_batch=float(np.mean(syncs_p)),
        single_host_syncs_per_batch=float(np.mean(syncs_h)),
        committed=drain.committed, aborted=drain.aborted, n_evict_single=n_evict[0],
        n_evict_partitioned=n_evict[1], entries_equal=entries_equal,
        block_gather_launches=bg["block_gather"],
        block_gather_launches_per_batch=bg["block_gather"] / len(lat_p),
        cache_probe_launches=bg["cache_probe"], mesh_collectives=dict(mesh.counts),
        partition_s=part_s, per_shard_bytes=rep["per_shard_bytes"],
        replicated_bytes=rep["replicated_per_shard_bytes"], bytes_ratio=rep["ratio"],
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("partitioned: " + json.dumps(report), flush=True)
    assert bg["block_gather"] > 0, "the partitioned path never launched block_gather"
    assert bg["cache_probe"] > 0, "the partitioned path never launched cache_probe"
    profile_window(" partitioned", seed, plans, ranges,
                   lambda name, r: rt.run_gr_tx_batch(pstore, pcache, ttable,
                                                      dict((n, p) for n, p, _, _ in plans)[name], r))
    return report, capture


def block_gather_bound(args_, kw, out):
    """Least bytes: each output once, each per-row input once, and the block
    and vertex records the run's data needs, each once: the leaf id of every
    distinct slot the lanes name, the recent keys in the region, the CSR
    offsets of every distinct local root, the edge record (alive, label,
    props) of every distinct scanned slot, the liveness of every distinct
    scanned leaf and root, and the vertex record (label, props) of every
    distinct leaf past the edge filters."""
    from repro_torch.core.templates import MAX_CONDS

    (indptr, key, other, label, alive, props, vlabel, valive, vprops, csr_len, blk_len,
     roots, lroot, rvalid, cvalid, rmask, r_ok, pe_bound, pl_bound) = args_
    leaf, scan, emask, qual, trunc = out
    B, W = leaf.shape
    max_deg, R, EB = kw["max_deg"], kw["recent_cap"], kw["e_blk_cap"]
    v_cap = valive.shape[0]
    start = indptr[lroot.long()]
    lane = torch.arange(max_deg, device=roots.device)
    csr_slots = (start[:, None] + lane[None, :]).clamp(0, EB - 1)
    sid = csr_len.clamp(0, EB - R) + torch.arange(R, device=roots.device)
    slots = torch.cat([csr_slots, sid[None, :].expand(B, R)], dim=1)
    in_region = int(((sid >= csr_len) & (sid < blk_len)).sum())
    u = lambda x: int(torch.unique(x).numel())
    nep, nvp = props.shape[1], vprops.shape[1]
    nbytes = (B * W * (4 + 1 + 1 + 1) + B  # outputs
              + B * (4 + 4 + 4 * 1 + 4 * 2 * MAX_CONDS)  # per-row inputs
              + u(slots) * 4 + in_region * 4 + u(torch.cat([lroot, lroot + 1])) * 4
              + u(slots[scan]) * (1 + 4 + 4 * nep)
              + u(torch.cat([leaf[scan].clamp(0, v_cap - 1), roots.clamp(0, v_cap - 1)]))
              + u(leaf[emask].clamp(0, v_cap - 1)) * (4 + 4 * nvp))
    ops = B * W * 12  # index, compare and select work per lane
    return nbytes, ops


def check_partitioned_kernels(capture, launches, max_deg):
    """Phase 7's kernels held bit-equal to their plain versions on every
    call the partitioned path made: ``cache_probe`` on each owner's C/n-slot
    block, ``block_gather`` in both orientations, whose recent-region lanes
    (index >= max_deg) must have scanned edges in each. The largest call of
    each is timed; returns the ``block_gather`` JSON row of the larger
    orientation (both print)."""
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref

    calls = capture.calls["cache_probe"]
    assert calls, "the partitioned path made no cache_probe call"
    for a, kw in calls:
        got, want = cp_ops.cache_probe(*a, **kw), cache_probe_ref(*a, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"cache_probe disagrees with its plain version at {a[4].shape[0]} keys"
    a, kw = max(calls, key=lambda c: c[0][4].shape[0])
    hit, slot = cache_probe_ref(*a, **kw)
    t = timings(lambda: cp_ops.cache_probe(*a, **kw), lambda: cache_probe_ref(*a, **kw))
    nbytes, ops = probe_bound(a, hit, slot, kw["probes"])
    bms, by = bound_ms(nbytes, ops)
    print(f"kernel cache_probe partitioned calls={len(calls)} (all equal) largest keys="
          f"{a[4].shape[0]} cap={a[0].shape[0]} hits={int(hit.sum())} {fmt_us(t)} "
          f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B)", flush=True)

    largest, recent, n_calls, err = {}, {False: 0, True: 0}, {False: 0, True: 0}, 0
    for a, kw in capture.calls["block_gather"]:
        got = bg_ops.block_gather(*a, **kw)
        want = block_gather_filter_ref(*a, **kw)
        for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want):
            assert torch.equal(g, w), f"block_gather {name} disagrees with its plain version"
        if got[0].numel():
            err = max(err, int((got[0].long() - want[0].long()).abs().max()))
        incoming = a[1].data_ptr() in capture.inc_keys
        recent[incoming] += int(want[1][:, max_deg:].sum())
        n_calls[incoming] += 1
        if incoming not in largest or a[11].shape[0] > largest[incoming][0][11].shape[0]:
            largest[incoming] = (a, kw)
    print(f"block_gather partitioned calls out={n_calls[False]} in={n_calls[True]} (all equal); "
          f"recent-region lanes scanned out={recent[False]} in={recent[True]}", flush=True)
    assert set(largest) == {False, True}, "block_gather saw one orientation only"
    assert recent[False] > 0 and recent[True] > 0, \
        "an orientation's recent-region lanes scanned nothing on the card"

    rows = []
    for incoming, (a, kw) in sorted(largest.items()):
        want = block_gather_filter_ref(*a, **kw)
        t = timings(lambda: bg_ops.block_gather(*a, **kw),
                    lambda: block_gather_filter_ref(*a, **kw))
        nbytes, ops = block_gather_bound(a, kw, want)
        bms, by = bound_ms(nbytes, ops)
        B, W = want[0].shape
        side = "in" if incoming else "out"
        print(f"kernel block_gather {side} rows={B} lanes={W} EB={kw['e_blk_cap']} "
              f"scanned={int(want[1].sum())} recent_scanned={int(want[1][:, max_deg:].sum())} "
              f"qual={int(want[3].sum())} {fmt_us(t)} "
              f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B)", flush=True)
        rows.append((B, dict(
            name="block_gather", route="cuda", source="src/repro_torch/csrc/block_gather.cu",
            replaces="src/repro/kernels/block_gather/kernel.py:106", launches=launches,
            max_abs_err=err, **t, bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"{side}:rows={B},lanes={W}")))
    return max(rows, key=lambda r: r[0])[1]


# ------------------------------------------------------------ GNN serving
# Phase 8: cached neighbour sampling over a graph sized like Reddit, the
# dataset behind the minibatch_lg cell (src/repro/configs/gnn_shapes.py),
# and the PNA forward at FULL widths with that cell's override
# (src/repro/launch/steps.py: d_in 602, 41 classes).
GNN_V = 232_965  # Reddit's vertices
GNN_FEAT, GNN_CLASSES = 602, 41
GNN_SEEDS, GNN_FANOUTS = 1024, (15, 10)
GNN_DEG = 32  # Poisson mean out-degree, clipped to [1, max_deg]
GNN_GRW = 64  # new and deleted edges of the gRW-Tx between the epochs
SPMM_RTOL = SPMM_ATOL = 1e-5  # fp32: the same sums in another order
SPMM_BF16_TOL = 1e-1  # the JAX sweep's bf16 tolerance
LOGITS_TOL = 1e-4  # four PNA layers on top of those sums


def build_gnn_world(rng, device, n_vertices, max_deg=64):
    """One vertex label; out-degrees Poisson(GNN_DEG) clipped to [1,
    max_deg] with uniform destinations and no duplicate pairs; fp32 features
    and labels; the example's NBR template (all out-neighbours); a cache of
    ``v_cap`` slots (2^18 at Reddit's size)."""
    from repro_torch.core import (ANY_LABEL, DIR_OUT, CacheSpec, EngineSpec, Template,
                                  make_template_table)
    from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator
    from repro_torch.graphstore import StoreSpec, ingest

    V = n_vertices
    deg = np.clip(rng.poisson(GNN_DEG, V), 1, max_deg)
    src = np.repeat(np.arange(V, dtype=np.int64), deg)
    dst = rng.integers(0, V, len(src))
    _, first = np.unique(src * V + dst, return_index=True)
    keep = np.sort(first)
    src, dst = src[keep], dst[keep]
    v_cap = 1 << (V - 1).bit_length()
    spec = StoreSpec(v_cap=v_cap, e_cap=32 * v_cap, n_vprops=1, n_eprops=1, recent_cap=1024)
    store = ingest(spec, np.zeros(V, np.int32), np.full((V, 1), MISSING, np.int32), src, dst,
                   np.zeros(len(src), np.int32), np.full((len(src), 1), MISSING, np.int32),
                   device=device)
    cspec = CacheSpec(capacity=v_cap, probes=8, max_leaves=32, max_chunks=2)
    espec = EngineSpec(store=spec, cache=cspec, max_deg=max_deg, frontier=32)
    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    sc.register(0)
    sc.enable(0)
    nbr = Template("NBR", DIR_OUT, (ANY_LABEL, []), (ANY_LABEL, []), (ANY_LABEL, []))
    ttable = qp.ttable_masks(make_template_table([nbr]), 1)
    feats = rng.standard_normal((V, GNN_FEAT), dtype=np.float32)
    labels = rng.integers(0, GNN_CLASSES, V).astype(np.int32)
    return espec, store, ttable, feats, labels, src


class ServedLog:
    """Records every ``neighbors(v)`` call of a sampler: the vertex, the
    list it returned and whether the cache served it."""

    def __init__(self, sampler):
        self.sampler, self.inner, self.calls = sampler, sampler.neighbors, []
        sampler.neighbors = self.neighbors

    def neighbors(self, v):
        h = self.sampler.hits
        nb = self.inner(v)
        self.calls.append((v, nb, self.sampler.hits > h))
        return nb


def run_gnn(seed, dev, n_vertices=GNN_V):
    """Phase 8: two epochs of cached sampling and the PNA forward + loss,
    a gRW-Tx between them, the consistency gate on every list epoch 2
    served from the cache, and profile windows of the sampler and the
    forward. Returns the report, the capture of every ``segment_spmm``
    call the forwards made, and (config, params, epoch 2's batch)."""
    import dataclasses

    import repro_torch.core.cache as cache_mod
    from repro_torch.configs import pna
    from repro_torch.core import DIR_OUT, empty_cache
    from repro_torch.core.engine import run_grw_tx
    from repro_torch.core.population import CachePopulator
    from repro_torch.gnn import CachedNeighborSampler
    from repro_torch.gnn import graph as graph_mod
    from repro_torch.gnn.models import init_params, loss_fn
    from repro_torch.graphstore import gather_out, make_mutation_batch
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.segment_spmm import ops as ss_ops

    print("gnn: reduced: Reddit's mean degree of ~492 is cut to out-degrees Poisson(32) "
          "clipped to [1, 64], as one neighbour list is bounded by max_deg 64 and by one "
          "cache entry (32 x 2 leaves)", flush=True)
    rng = np.random.default_rng(seed + 31)
    t0 = time.perf_counter()
    espec, store, ttable, feats, labels, esrc = build_gnn_world(rng, dev, n_vertices)
    torch.cuda.synchronize()
    print(f"gnn world: {n_vertices} vertices, {len(esrc)} edges (v_cap {espec.store.v_cap}, "
          f"e_cap {espec.store.e_cap}), features {feats.shape} fp32 "
          f"({feats.nbytes / 2**20:.1f} MiB), store {tensor_bytes(store) / 2**20:.1f} MiB, "
          f"cache {espec.cache.capacity} slots; built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    cfg = dataclasses.replace(pna.FULL, d_in=GNN_FEAT, n_classes=max(GNN_CLASSES, 2))
    params = init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    pop = CachePopulator(espec, {0: (DIR_OUT, -1)}, device=dev)
    sampler = CachedNeighborSampler(espec, store, empty_cache(espec.cache, device=dev), ttable,
                                    0, pop, GNN_FANOUTS, seed=seed, device=dev)
    log = ServedLog(sampler)
    seeds = rng.choice(n_vertices, GNN_SEEDS, replace=False)
    capture = CallCapture((graph_mod, "segment_spmm"))
    report = {"segment_spmm_launches": 0, "cache_probe_launches": 0}

    def epoch(tag):
        c0, h0 = len(log.calls), sampler.hits
        cp_ops.launches = 0
        t = time.perf_counter()
        g = sampler.sample_store(seeds, feats, labels)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t
        report["cache_probe_launches"] += cp_ops.launches
        n_calls, hits = len(log.calls) - c0, sampler.hits - h0
        ss_ops.launches = 0
        with capture:
            t = time.perf_counter()
            loss = loss_fn(cfg, params, g)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t) * 1e3
        report["segment_spmm_launches"] += ss_ops.launches
        n_nodes, n_edges = int(g.node_mask.sum()), int(g.edge_mask.sum())
        report[tag] = dict(
            sample_s=sample_s, neighbors_calls=n_calls, s_per_neighbors_call=sample_s / n_calls,
            hits=hits, hit_rate=hits / n_calls, forward_loss_ms=fwd_ms, loss=float(loss),
            nodes=n_nodes, edges=n_edges, padded=(g.node_mask.shape[0], g.edge_mask.shape[0]),
            segment_spmm_launches=ss_ops.launches)
        print(f"gnn {tag}: " + json.dumps(report[tag]), flush=True)
        assert report[tag]["padded"] == (sampler._cap_nodes(GNN_SEEDS),
                                         sampler._cap_edges(GNN_SEEDS)), report[tag]["padded"]
        assert np.isfinite(float(loss)), f"{tag}: the loss is not finite"
        assert ss_ops.launches > 0, f"{tag}: the PNA forward never launched segment_spmm"
        return g

    # epoch 1: every list misses; then CP drains every queued miss
    epoch("epoch1")
    touched = np.unique([v for v, _, _ in log.calls])
    t = time.perf_counter()
    drains = 0
    while len(pop.queue):
        sampler.populate()
        drains += 1
    torch.cuda.synchronize()
    print(f"gnn populate: {drains} drains in {time.perf_counter() - t:.2f}s, committed "
          f"{pop.committed} aborted {pop.aborted}", flush=True)
    assert pop.committed > 0, "CP committed no neighbour list"

    # a gRW-Tx among the vertices epoch 1 touched: write-around invalidation
    spec = espec.store
    new = [(int(u), int(w), 0, [MISSING]) for u, w in
           zip(rng.choice(touched, GNN_GRW), rng.integers(0, n_vertices, GNN_GRW))]
    dele = rng.choice(np.flatnonzero(np.isin(esrc, touched)), GNN_GRW, replace=False)
    mb = make_mutation_batch(spec, new_edges=new, del_edges=[int(e) for e in dele],
                             caps=(8, GNN_GRW, GNN_GRW, 8, 32, 32), device=dev)
    sampler.store, sampler.cache, mw = run_grw_tx(espec, sampler.store, sampler.cache, ttable,
                                                  mb, device=dev)
    print(f"gnn gRW: {GNN_GRW} new + {GNN_GRW} deleted edges, {json.dumps(mw)}", flush=True)
    assert mw["impacted_keys"] > 0 and mw["op_overflow"] == 0, mw
    report["grw"] = mw

    # epoch 2: the same seeds; every list served from the cache must equal
    # the store's list after the gRW (one batched gather_out)
    c0 = len(log.calls)
    g2 = epoch("epoch2")
    served = [(v, nb) for v, nb, hit in log.calls[c0:] if hit]
    assert served, "epoch 2 had no cache hit"
    vs = np.unique([v for v, _ in served]).astype(np.int32)
    _, other, mask, _ = gather_out(spec, sampler.store, torch.as_tensor(vs, device=dev),
                                   espec.max_deg)
    other, mask = other.cpu().numpy(), mask.cpu().numpy()
    want = {int(v): np.unique(other[i][mask[i]]) for i, v in enumerate(vs)}
    for v, nb in served:
        assert np.array_equal(np.sort(nb), want[v]), f"vertex {v}: stale cached neighbour list"
    print(f"gnn consistency: {len(served)} lists served from the cache in epoch 2 "
          f"({len(vs)} vertices) equal the store's after the gRW", flush=True)
    report["consistency_checked"] = len(served)
    print(f"gnn launches: segment_spmm {report['segment_spmm_launches']} over the two "
          f"forwards, cache_probe {report['cache_probe_launches']} over the two samplings",
          flush=True)
    assert report["cache_probe_launches"] > 0, "the sampler never launched cache_probe"

    # the device's idle share over a sample and a forward. A whole sample
    # launches millions of small kernels, too many events to trace, so the
    # window holds every 16th neighbors() call of epoch 2, replayed on the
    # same cache (the same hits and misses), and one forward + loss; epoch
    # 2's share is estimated from their busy time per call. The sampler's
    # cache_probe calls in the window are kept for check_gnn_kernels
    ep = report["epoch2"]
    window = [v for v, _, _ in log.calls[c0:c0 + ep["neighbors_calls"]:16]]
    report["probe_capture"] = CallCapture((cache_mod, "cache_probe"))
    with report["probe_capture"]:
        s_wall, s_busy = profiled(" gnn sampling", f"{len(window)} neighbors() calls of epoch 2",
                                  lambda: [sampler.neighbors(v) for v in window], host_ops=False)
    f_wall, f_busy = profiled(" gnn forward", "one PNA forward + loss",
                              lambda: loss_fn(cfg, params, g2), host_ops=False)
    if s_busy is not None and f_busy is not None:
        busy = s_busy / len(window) * ep["neighbors_calls"] + f_busy
        report["idle_share"] = 1 - busy / (ep["sample_s"] * 1e3 + ep["forward_loss_ms"])
        print(f"gnn idle share over epoch 2's sample + forward (estimated from the two "
              f"windows): {report['idle_share']:.4f}", flush=True)
    return report, capture, (cfg, params, g2)


def spmm_bound(x, src, dst, n, mask):
    """Least bytes: the rows of x the kept edges read, src, dst, the mask,
    the CSR offsets and the output, each once; one add per value read."""
    keep = mask & (dst >= 0) & (dst < n)
    rows = int(torch.unique(src[keep]).numel())
    E, D, es = src.shape[0], x.shape[1], x.element_size()
    nbytes = rows * D * es + E * (4 + 4 + 1) + (n + 1) * 4 + n * D * es
    return nbytes, int(keep.sum()) * D


def check_gnn_kernels(capture, probe_capture, launches, model):
    """The sampler's ``cache_probe`` calls (batch 1) held equal to the plain
    version, with times and bound; every ``segment_spmm`` call of the
    forwards against its plain version (fp32 allclose), one bf16 call at the
    largest shape, the logits of the kernel forward against the plain
    forward's, then times at the largest call with its bound and
    ``torch.sparse.mm``'s time."""
    from repro_torch.gnn import graph as graph_mod
    from repro_torch.gnn.models import forward
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref
    from repro_torch.kernels.segment_spmm import ops as ss_ops
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

    probes = probe_capture.calls["cache_probe"]
    assert probes, "the sampler made no cache_probe call"
    for a, kw in probes:
        got, want = cp_ops.cache_probe(*a, **kw), cache_probe_ref(*a, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            "cache_probe disagrees with its plain version on a sampler lookup"
    a, kw = probes[0]
    hit, slot = cache_probe_ref(*a, **kw)
    t = timings(lambda: cp_ops.cache_probe(*a, **kw), lambda: cache_probe_ref(*a, **kw))
    nbytes, ops = probe_bound(a, hit, slot, kw["probes"])
    bms, by = bound_ms(nbytes, ops)
    print(f"kernel cache_probe gnn calls={len(probes)} (all equal) keys={a[4].shape[0]} "
          f"cap={a[0].shape[0]} {fmt_us(t)} bound_us={bms * 1e3:.6f} ({by}, {nbytes} B)",
          flush=True)

    calls = capture.calls["segment_spmm"]
    assert calls, "the PNA forwards made no segment_spmm call"
    err = 0.0
    for a, kw in calls:
        got, want = ss_ops.segment_spmm(*a, **kw), segment_spmm_ref(*a, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.allclose(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL), \
            f"segment_spmm disagrees with its plain version at x {tuple(a[0].shape)}"
        err = max(err, float((got - want).abs().max()))
    (x, src, dst, n, mask), kw = max(calls, key=lambda c: c[0][0].numel())
    xb = x.to(torch.bfloat16)
    gb, wb = ss_ops.segment_spmm(xb, src, dst, n, mask), segment_spmm_ref(xb, src, dst, n, mask)
    assert gb.dtype == torch.bfloat16 and torch.allclose(
        gb.float(), wb.float(), rtol=SPMM_BF16_TOL, atol=SPMM_BF16_TOL), "bf16 segment_spmm"
    bf16_err = float((gb.float() - wb.float()).abs().max())
    print(f"kernel segment_spmm calls={len(calls)} (all within rtol={SPMM_RTOL} "
          f"atol={SPMM_ATOL} of the plain version, max abs err {err:.3e}); bf16 at x "
          f"{tuple(x.shape)}: max abs err {bf16_err:.3e} (tol {SPMM_BF16_TOL})", flush=True)

    cfg, params, g = model
    logits = forward(cfg, params, g)
    graph_mod.segment_spmm = segment_spmm_ref
    try:
        plain = forward(cfg, params, g)
    finally:
        graph_mod.segment_spmm = ss_ops.segment_spmm
    diff = float((logits - plain).abs().max())
    print(f"gnn logits {tuple(logits.shape)}: kernel forward vs plain forward max abs diff "
          f"{diff:.3e} (rtol=atol={LOGITS_TOL})", flush=True)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert torch.allclose(logits, plain, rtol=LOGITS_TOL, atol=LOGITS_TOL), \
        "the kernel forward's logits disagree with the plain forward's"

    kern = lambda: ss_ops.segment_spmm(x, src, dst, n, mask)
    t = timings(kern, lambda: segment_spmm_ref(x, src, dst, n, mask))
    kernel_only = device_ms(kern, match="segment_spmm_kernel")
    # cuSPARSE on the same function: a CSR [n, rows of x] built once, untimed
    src_s, offs = ss_ops.prepare_edges(src, dst, n, x.shape[0], mask)
    nnz = int(offs[-1])
    A = torch.sparse_csr_tensor(offs.long(), src_s[:nnz].long(),
                                torch.ones(nnz, dtype=x.dtype, device=x.device),
                                size=(n, x.shape[0]), check_invariants=True)
    lib = lambda: torch.sparse.mm(A, x)
    assert torch.allclose(lib(), segment_spmm_ref(x, src, dst, n, mask),
                          rtol=SPMM_RTOL, atol=SPMM_ATOL), "torch.sparse.mm computes another sum"
    lib_ms, lib_dev = cuda_ms(lib), device_ms(lib)
    nbytes, ops = spmm_bound(x, src, dst, n, mask)
    bms, by = bound_ms(nbytes, ops)
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.3f}"
    print(f"kernel segment_spmm largest x={tuple(x.shape)} E={src.shape[0]} kept={nnz} n={n} "
          f"{fmt_us(t)} kernel_only_device_us={us(kernel_only)} "
          f"sparse_mm_us={us(lib_ms)} (device {us(lib_dev)}) "
          f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B)", flush=True)
    return dict(name="segment_spmm", route="cuda", source="src/repro_torch/csrc/segment_spmm.cu",
                replaces="src/repro/kernels/segment_spmm/kernel.py:49", launches=launches,
                max_abs_err=err, **t, kernel_only_device_ms=kernel_only, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev,
                shape=f"x={tuple(x.shape)},E={src.shape[0]},n={n}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = "cuda"
    t_all = time.perf_counter()
    torch.manual_seed(args.seed)

    # 1. the card
    card = card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # 2. build every kernel from the checkout's sources
    from repro_torch.kernels import _build
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.onehop_gather import ops as og_ops
    from repro_torch.kernels.segment_spmm import ops as ss_ops

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f}s -> {_build.build_dir()} "
          f"(compiled: {_build.BUILD_INFO.get('built')})", flush=True)
    for name, info in _build.BUILD_INFO.get("ptxas", {}).items():
        regs = [l.strip() for l in info.splitlines() if "registers" in l]
        print(f"build {name}: {regs}", flush=True)

    # 3. the world
    from repro_torch.core import empty_cache, make_template_table
    from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    espec, store, ranges, includes, n_edges = build_world(rng, dev, SCALE)
    templates, meta, plans = templates_and_plans()
    ttable = make_template_table(templates)
    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    for t in range(len(templates)):
        sc.register(t)
        sc.enable(t)
    assert sc.check_safety()
    ttable = qp.ttable_masks(ttable, len(templates))
    cache = empty_cache(espec.cache, device=dev)
    torch.cuda.synchronize()
    nv = ranges[L_LISTING][1]
    print(f"world: {nv} vertices ({ranges[L_USER][1]} users, "
          f"{ranges[L_WATCHLIST][1] - ranges[L_WATCHLIST][0]} watch-lists, "
          f"{nv - ranges[L_LISTING][0]} listings), {n_edges} edges "
          f"({len(includes)} includes); store {tensor_bytes(store) / 2**20:.1f} MiB, "
          f"cache {tensor_bytes(cache) / 2**20:.1f} MiB ({espec.cache.capacity} slots); "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)

    # 4. traffic: the main path, with the kernel counts zeroed around it
    cp_ops.launches = og_ops.launches = bg_ops.launches = ss_ops.launches = 0
    state, report, engines = run_traffic(
        args.seed, espec, (store, cache), ttable, plans, meta, ranges, includes, dev)
    launches = {"cache_probe": cp_ops.launches, "onehop_gather": og_ops.launches,
                "block_gather": bg_ops.launches, "segment_spmm": ss_ops.launches}
    print(f"launches on the main path: {launches}", flush=True)
    assert launches["cache_probe"] > 0, "the read path never launched cache_probe"
    assert report["R_hat"]["hit_rate"] > 0, "R-hat saw no cache hit"
    assert sum(r["committed"] for r in report.values()) > 0, "CP committed nothing"
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    profile_window("", args.seed, plans, ranges,
                   lambda name, r: engines[name].run(*state, ttable, r))

    # 5. each kernel against its plain version at the main path's shapes
    rows = check_kernels(espec, state, plans, ranges, launches, dev, args.seed)

    # 6. consistency of the final state
    check_consistency(espec, state, ttable, plans, ranges, engines, dev, args.seed)

    # 7. the partitioned tier on the final store, against the single host;
    # then block_gather against its plain version at the inputs it was given
    p_report, capture = run_partitioned(args.seed, espec, state[0], ttable, plans, meta, ranges,
                                        engines, dev)
    rows.append(check_partitioned_kernels(capture, p_report["block_gather_launches"],
                                          espec.max_deg))

    # 8. GNN serving: cached neighbour sampling + the PNA forward at the
    # minibatch_lg shape; segment_spmm counted around the forwards only
    from repro_torch.configs.gnn_shapes import GNN_SHAPES

    t0 = time.perf_counter()
    g_report, g_capture, model = run_gnn(args.seed, dev)
    lg = GNN_SHAPES["minibatch_lg"]
    assert g_report["epoch1"]["padded"] == (lg["n_nodes"], lg["n_edges"]), g_report["epoch1"]
    rows.append(check_gnn_kernels(g_capture, g_report.pop("probe_capture"),
                                  g_report["segment_spmm_launches"], model))
    print(f"gnn phase: {time.perf_counter() - t0:.1f}s", flush=True)

    print(f"total: {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
