"""End-to-end serving example on PyTorch: the eCommerce workload's three mixes
against one Graph-QP with the cache and asynchronous population on,
interleaving gRW-Txs, reporting hit rates and latency percentiles per mix.

The twin of ``examples/serve_ecommerce.py`` over ``repro_torch.workload``:
the same flags (and ``--device``), the same per-mix seeds, the same lines.
Each mix's seed is ``seed + hash(mix_name) % 1000``, as in the reference;
Python salts ``str`` hashes per process, so a run repeats another only in
the same process (or under one ``PYTHONHASHSEED``).

Run:  PYTHONPATH=src python examples/serve_ecommerce_torch.py [--ops 200] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core import GraphEngine, build_grw_step, cache_stats, empty_cache
from repro_torch.core.population import CachePopulator
from repro_torch.workload import MIXES, TPL_META, WRITE_MIX, build_world, make_write, query_plans

ROOTS_PER_QUERY = 8


def serve_mixes(world, ops: int, seed: int) -> dict:
    """The example's loop over ``world`` (any ``World``): ``ops`` operations
    of each mix in ``MIXES``, a CP drain of 256 misses every 10. Returns
    ``{"mixes": {name: {"seed", "latency_s" (per query, one entry a read),
    "hits", "misses", "seconds"}}, "cache_stats", "committed", "aborted",
    "discarded", "store", "cache"}``."""
    dev = world.store.vlabel.device
    cache = empty_cache(world.espec.cache, device=dev)
    pop = CachePopulator(world.espec, TPL_META, device=dev)
    grw = build_grw_step(world.espec, device=dev)
    plans = query_plans()
    engines = {n: GraphEngine(world.espec, p, use_cache=True, device=dev)
               for (n, p, _, _, _) in plans}
    weights = np.array([w for (_, _, _, w, _) in plans])
    weights /= weights.sum()
    store = world.store

    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)

    out = {}
    for mix_name, mix in MIXES.items():
        lat = []
        t_mix = time.perf_counter()
        mix_seed = seed + hash(mix_name) % 1000
        world.rng = np.random.default_rng(mix_seed)
        h = m = 0
        for i in range(ops):
            if world.rng.random() < mix["read_frac"]:
                j = int(world.rng.choice(len(plans), p=weights))
                name, plan, label, _, _ = plans[j]
                lo, hi = world.vertex_range(label)
                roots = np.array([world.zipf_pick(lo, hi) for _ in range(ROOTS_PER_QUERY)],
                                 np.int32)
                t0 = time.perf_counter()
                _, misses, mm = engines[name].run(store, cache, world.ttable, roots)
                lat.append((time.perf_counter() - t0) / ROOTS_PER_QUERY)
                pop.queue.push(misses)
                h += mm["hits"]
                m += mm["misses"]
            else:
                wk = kinds[int(world.rng.choice(len(kinds), p=wweights))]
                _, mb = make_write(world, wk)
                if mb is not None:
                    store, cache, _, _ = grw(store, cache, world.ttable, mb)
            if i % 10 == 9:
                cache = pop.drain(store, store, cache, world.ttable, 256)
        out[mix_name] = dict(seed=mix_seed, latency_s=lat, hits=h, misses=m,
                             seconds=time.perf_counter() - t_mix)
    return dict(mixes=out, cache_stats=cache_stats(cache), committed=pop.committed,
                aborted=pop.aborted, discarded=pop.queue.discarded, store=store, cache=cache)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    world = build_world(seed=args.seed, device=args.device)
    run = serve_mixes(world, args.ops, args.seed)
    for mix_name, r in run["mixes"].items():
        lat_ms = np.array(r["latency_s"]) * 1e3
        h, m = r["hits"], r["misses"]
        print(
            f"{mix_name:6} ops={args.ops} "
            f"p50={np.percentile(lat_ms,50):6.2f}ms p95={np.percentile(lat_ms,95):6.2f}ms "
            f"p99={np.percentile(lat_ms,99):6.2f}ms hit_rate={h/max(h+m,1):.2%} "
            f"({r['seconds']:.1f}s)"
        )
    print("cache:", run["cache_stats"])
    print("population: committed=%d aborted=%d discarded=%d" % (
        run["committed"], run["aborted"], run["discarded"]))


if __name__ == "__main__":
    main()
