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
   reference, and against the engine with the cache off.

Between 4 and 5 a short ``torch.profiler`` window over gR batches prints the
device's busy time by kernel and its idle share.

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
N_OPS = 200  # operations per traffic mix
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


def device_ms(fn, iters=20) -> float | None:
    """Device time per call of ``fn`` (the sum of the kernels it launches),
    from ``torch.profiler``; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
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


def profile_window(seed, espec, state, ttable, plans, ranges, engines):
    """Device time by kernel over a short steady window of gR batches
    (two of each cached read plan), with ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    store, cache = state
    rng = np.random.default_rng(seed + 5)
    batches = [(n, label) for n, _, label, _ in plans if n != "q_agg"] * 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for name, label in batches:
            engines[name].run(store, cache, ttable, zipf_pick(rng, *ranges[label], BATCH))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    if not events:
        print("profile: no device time recorded (not measured)", flush=True)
        return
    by_name: dict = {}
    for e in events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"profile: {len(batches)} gR batches, wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms in {len(events)} device events, idle share "
          f"{1 - busy_ms / wall_ms:.4f}", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"profile kernel: {name[:70]:70s} device_ms={us / 1e3:.3f} calls={n}",
              flush=True)


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
    from repro_torch.kernels.onehop_gather import ops as og_ops

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
    cp_ops.launches = og_ops.launches = 0
    state, report, engines = run_traffic(
        args.seed, espec, (store, cache), ttable, plans, meta, ranges, includes, dev)
    launches = {"cache_probe": cp_ops.launches, "onehop_gather": og_ops.launches}
    print(f"launches on the main path: {launches}", flush=True)
    assert launches["cache_probe"] > 0, "the read path never launched cache_probe"
    assert report["R_hat"]["hit_rate"] > 0, "R-hat saw no cache hit"
    assert sum(r["committed"] for r in report.values()) > 0, "CP committed nothing"
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    profile_window(args.seed, espec, state, ttable, plans, ranges, engines)

    # 5. each kernel against its plain version at the main path's shapes
    rows = check_kernels(espec, state, plans, ranges, launches, dev, args.seed)

    # 6. consistency of the final state
    check_consistency(espec, state, ttable, plans, ranges, engines, dev, args.seed)

    print(f"total: {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
