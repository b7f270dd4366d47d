"""The paper's technique applied to GNN training, on PyTorch:

neighbor lists for fanout sampling are one-hop sub-query results — cache
them in the core cache over a *live* graphstore, populate asynchronously,
and let gRW-Txs write-around-invalidate so sampling stays consistent while
the graph mutates under training.

The twin of ``examples/gnn_cached_sampling.py`` on ``repro_torch``: the same
graph, seeds and mutations from the same numpy draws, the same PNA model
and AdamW. On the card the sampler's probes run the ``cache_probe`` kernel
and every segment sum of the PNA step the ``segment_spmm`` kernel, forward
and backward. ``run`` returns each epoch's loss, sampler hits and misses and
the gRW-Tx's invalidated keys.

Run:  PYTHONPATH=src python examples/gnn_cached_sampling_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    ANY_LABEL, DIR_OUT, CacheSpec, EngineSpec, Template, cache_stats, empty_cache,
    make_template_table,
)
from repro_torch.core.engine import run_grw_tx  # noqa: E402
from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator  # noqa: E402
from repro_torch.core.population import CachePopulator  # noqa: E402
from repro_torch.gnn import CachedNeighborSampler, GNNConfig  # noqa: E402
from repro_torch.gnn.models import init_params, train_step  # noqa: E402
from repro_torch.graphstore import StoreSpec, ingest, make_mutation_batch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils import PROP_MISSING, resolve_device  # noqa: E402

M = int(PROP_MISSING)
N, E_INIT, D_FEAT = 256, 1024, 16
CFG = GNNConfig(name="sage-demo", kind="pna", n_layers=2, d_hidden=16, d_in=D_FEAT, n_classes=4)


def run(device=None, epochs=4, params=None, log=print):
    """The example's loop on ``device`` (CUDA unless another is named):
    ``epochs`` rounds of sample 16 seeds, one PNA ``train_step``, a CP drain
    and a gRW-Tx of one new and one deleted edge. ``params`` (the
    reference's layout, e.g. carried across by ``interop``) replaces the
    seeded initialisation. Returns one dict an epoch: ``loss``, ``hits``
    and ``misses`` (the sampler's running counts) and ``impacted_keys``,
    then the sampler."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    # --- a mutable graph in the transactional store -------------------------
    spec = StoreSpec(v_cap=512, e_cap=4096, n_vprops=1, n_eprops=1, recent_cap=256)
    src = rng.integers(0, N, E_INIT)
    dst = rng.integers(0, N, E_INIT)
    store = ingest(spec, [0] * N, np.full((N, 1), M), src, dst, [0] * E_INIT,
                   np.full((E_INIT, 1), M), device=dev)
    feats = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)

    # --- the "all out-neighbors" template (empty predicates) ----------------
    nbr = Template("NBR", DIR_OUT, (ANY_LABEL, []), (ANY_LABEL, []), (ANY_LABEL, []))
    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    sc.register(0)
    sc.enable(0)
    ttable = qp.ttable_masks(make_template_table([nbr]), 1)

    espec = EngineSpec(store=spec, cache=CacheSpec(capacity=2048, max_leaves=32, max_chunks=2),
                       max_deg=64, frontier=32)
    pop = CachePopulator(espec, {0: (DIR_OUT, -1)}, device=dev)
    sampler = CachedNeighborSampler(espec, store, empty_cache(espec.cache, device=dev), ttable,
                                    tpl_idx=0, populator=pop, fanouts=(5, 3), device=dev)

    if params is None:
        params = init_params(CFG, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw(1e-3)
    state = opt.init(params)
    step = train_step(CFG, opt)

    out = []
    for epoch in range(epochs):
        seeds = rng.choice(N, size=16, replace=False)
        g = sampler.sample_store(seeds, feats, labels)
        params, state, m = step(params, state, g)
        sampler.populate()  # async CP drain between steps
        # a gRW-Tx mutates the graph: add + delete edges -> write-around
        mb = make_mutation_batch(
            spec,
            new_edges=[(int(rng.integers(0, N)), int(rng.integers(0, N)), 0, [M])],
            del_edges=[int(rng.integers(0, E_INIT))],
            device=dev,
        )
        sampler.store, sampler.cache, mw = run_grw_tx(espec, sampler.store, sampler.cache,
                                                      ttable, mb, device=dev)
        out.append(dict(loss=float(m["loss"]), hits=sampler.hits, misses=sampler.misses,
                        impacted_keys=int(mw["impacted_keys"])))
        log(f"epoch {epoch}: loss={out[-1]['loss']:.3f} sampler hits={sampler.hits} "
            f"misses={sampler.misses} invalidated={out[-1]['impacted_keys']}")
    return out, sampler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args()
    _, sampler = run(args.device, args.epochs)
    print("cache:", cache_stats(sampler.cache))
    assert sampler.hits > 0, "later epochs should hit the neighbor-list cache"
    print("cached neighbor sampling stayed consistent under graph mutations.")


if __name__ == "__main__":
    main()
