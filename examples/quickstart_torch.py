"""Quickstart on PyTorch: the paper's Figure 1 end to end with ``repro_torch``.

The twin of ``examples/quickstart.py``: builds the watch-list/listing world,
registers the SQ1 template through the Service Coordinator's two-phase
workflow, then shows miss -> asynchronous population -> hit -> gRW-Tx
write-around -> consistent. It prints the same result lines.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (
    ANY_LABEL, DIR_OUT, FINAL_IDS, OP_EQ, WILDCARD,
    CacheSpec, EngineSpec, GraphEngine, Hop, QueryPlan, Template,
    cache_stats, empty_cache, make_pred, make_template_table,
)
from repro_torch.core.engine import run_grw_tx
from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator
from repro_torch.core.population import CachePopulator
from repro_torch.graphstore import StoreSpec, ingest, make_mutation_batch
from repro_torch.utils import PROP_MISSING

M = int(PROP_MISSING)
WATCHLIST, LISTING, INCLUDES = 0, 1, 0
STATUS, ISACTIVE = 0, 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    # --- a tiny graph: watch-list 0 includes listings 1..5 ------------------
    spec = StoreSpec(v_cap=64, e_cap=256, n_vprops=1, n_eprops=1, recent_cap=32)
    vlabels = [WATCHLIST] + [LISTING] * 5
    vprops = np.full((6, 1), M)
    vprops[1:, STATUS] = [0, 0, 1, 0, 1]          # listings 1,2,4 are available
    eprops = [[1], [1], [1], [0], [0]]            # edges to 1,2,3 are active
    store = ingest(spec, vlabels, vprops, [0] * 5, [1, 2, 3, 4, 5], [INCLUDES] * 5,
                   np.array(eprops), device=dev)

    # --- register + enable the SQ1 template (two-phase, all QPs) ------------
    SQ1 = Template("SQ1", DIR_OUT, (WATCHLIST, []),
                   (ANY_LABEL, [(ISACTIVE, OP_EQ, WILDCARD)]),
                   (LISTING, [(STATUS, OP_EQ, WILDCARD)]), edge_label=INCLUDES)
    ttable = make_template_table([SQ1])
    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    sc.register(0)
    sc.enable(0)
    ttable = qp.ttable_masks(ttable, 1)
    print("template SQ1 state:", sc.states[0].value, "| safety:", sc.check_safety())

    # --- the Figure 1 gR-Tx --------------------------------------------------
    espec = EngineSpec(store=spec, cache=CacheSpec(capacity=256, max_leaves=8),
                       max_deg=16, frontier=8)
    fig1 = QueryPlan(hops=(Hop(
        DIR_OUT, INCLUDES, make_pred(WATCHLIST, []),
        make_pred(ANY_LABEL, [(ISACTIVE, OP_EQ, WILDCARD)]),
        make_pred(LISTING, [(STATUS, OP_EQ, WILDCARD)]),
        tpl_idx=0, params=np.array([1, M, M, 0, M, M], np.int32)),), final=FINAL_IDS)

    cache = empty_cache(espec.cache, device=dev)
    engine = GraphEngine(espec, fig1, use_cache=True, device=dev)
    pop = CachePopulator(espec, {0: (DIR_OUT, INCLUDES)}, device=dev)
    root = np.array([0], np.int32)

    res, misses, m1 = engine.run(store, cache, ttable, root)
    print(f"1) miss:  result={sorted(res[0][res[0]>=0].tolist())}  "
          f"phases={m1['phases']} (the paper's n+2 storage requests)")

    pop.queue.push(misses)
    cache = pop.drain(store, store, cache, ttable)       # async CP transaction
    print(f"2) populated asynchronously: {cache_stats(cache)['inserts']} entry")

    res, _, m2 = engine.run(store, cache, ttable, root)
    print(f"3) hit:   result={sorted(res[0][res[0]>=0].tolist())}  "
          f"phases={m2['phases']} (n+2 -> 2)")

    # --- a gRW-Tx flips listing 2's Status; write-around deletes the entry --
    mb = make_mutation_batch(spec, set_vprops=[(2, STATUS, 1)], device=dev)
    store, cache, mw = run_grw_tx(espec, store, cache, ttable, mb, device=dev)
    print(f"4) gRW-Tx impacted {mw['impacted_keys']} cache key(s)")

    res, misses, m3 = engine.run(store, cache, ttable, root)
    print(f"5) fresh: result={sorted(res[0][res[0]>=0].tolist())}  "
          f"hits={m3['hits']} (stale entry was invalidated -> recomputed)")
    assert sorted(res[0][res[0] >= 0].tolist()) == [1]
    print("strong consistency held.")


if __name__ == "__main__":
    main()
