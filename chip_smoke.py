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
   times (``cache_probe`` also beside one fill kernel's time, and on
   windows that wrap at C);
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
   orientations), with times for the largest; then what binds
   ``block_gather``: the largest call as made, with ``rmask`` all false,
   with ``rvalid`` / ``cvalid`` all false and with no predicates, each on
   the kernel and on the per-lane design it replaced, beside its bound and
   ``zero_`` over the same outputs; then synthetic shapes the path does
   not reach. Between the reads and those checks, the gRW rounds: 40
   commits of the W-hat write mix per policy (write-around, then
   write-through, each round opened by an untimed commit) through
   ``run_grw_tx`` on both tiers, each followed by a read batch with CP on
   both; every commit held equal across the tiers (``impacted_keys``, the
   stores every 4th commit and the last, cache entries and reads while
   neither cache evicted), overflows 0, the recent regions within their
   windows, write-through's value edits taken on both tiers (from each
   commit's pre- and post-cache) and its hits no fewer than those of a
   write-around fork of the same commit on the same reads (run outside the
   launch counts), every ``block_gather`` / ``cache_probe`` call of the
   rounds equal to its plain version (with lanes a commit appended, and
   lanes whose edge a commit deleted, among those scanned), the launches
   counted per tier and stage, the single host's write-through cache held
   entry by entry to fresh executions and then to phase 6's check (a
   multi-hop result may differ from the cache-off engine only through an
   entry whose leaves write-through reordered); gRW p25 / p50 / p75 / p90
   / max per tier and policy, a profile window of one commit of each, and
   the rounds' largest kernel calls timed;
8. GNN serving at the ``minibatch_lg`` shape: a graph sized like Reddit
   (232,965 vertices, ~7.4M edges, 602 fp32 features, 41 classes) in the
   store, 1,024 seeds at fanouts (15, 10) through ``CachedNeighborSampler``
   (one batched lookup a fanout layer: one ``cache_probe`` launch over the
   frontier, one ``gather_out`` over its misses), the PNA forward and loss
   at FULL widths, CP of every miss, a gRW-Tx of 64 new and 64 deleted
   edges, and a second epoch whose cache-served lists must equal the
   store's. ``cache_probe`` launches are counted around the samplings (at
   most two a fanout layer) and every call held to its plain version; the
   idle share is measured over a replay of epoch 2's sampling and a forward.
   ``segment_spmm`` launches and ``prepare_edges`` calls are
   counted around the forwards only: one CSR a forward serves its 20
   sums. Every call they made is held to the per-call plain version over
   the batch's edges (fp32 allclose), one bf16 call too, and the kernel
   forward's logits to those of a forward whose sums all take the per-call
   plain version; times of the
   CSR-form call at the largest shape beside its bound and
   ``torch.sparse.mm`` on the same CSR, and the one-time prepare.

9. two-tower serving (``src/repro/configs/two_tower_retrieval.py`` FULL
   widths, user vocab cut to 50M) on 61.4 GB of fp32 tables made on the
   card: a 1M-item corpus embedded by ``item_tower``, then the
   retrieval_cand (1 user, top-100), serve_p99 (512 x 256) and serve_bulk
   (262,144 x 16) shapes, Zipf(1.1) ids in bags of 1-16. ``embedding_bag``
   launches are counted around the towers only; every call is held to the
   plain version (fp32 allclose), one bf16 call too, and the whole path to
   a run with the plain version in the kernel's place (scores, ``best`` and
   the top-100 ids under the tie rule); the tie rule itself on a corpus
   whose first 1,000 rows repeat others (ids equal a stable sort's), timed
   beside ``torch.topk``; latency per shape, and the kernel's times beside
   its bound and ``F.embedding_bag``, then at the same shape on three id
   sets (the path's Zipf ids, the same folded into 16,384 rows, uniform
   ids), each beside its bound;
10. Yi-6B (``src/repro/configs/yi_6b.py`` FULL, bf16) prefill of 8 x 4,000
   tokens, then 96 greedy decode steps in a 4,096 cache. The 32
   ``flash_attention`` launches of the prefill must all take the bf16
   tensor-core kernel and are held to the plain version, the prefill to
   one with plain attention (KV and logits), then synthetic cases the path
   does not reach (Gemma3's window and dh 256, dh 112 and 16, fp32,
   non-causal 48 x 96, ``q_offset``, the 128-row tiling's edges); prefill
   and decode times, the kernel's HGMMA / UTMALDG instruction counts, and
   its times beside its bound and SDPA;
11. block maintenance and durability, right after 7 on its partitioned
   store: 32 W-hat gRW-Txs through ``run_grw_tx`` with the maintenance gate
   at one lane of each 1,024-lane recent window and the write-behind
   journal (its flusher thread running), each followed by a read batch of
   512 Zipf roots with CP; commits 21-28 under write-through, incremental
   checkpoints every 8 commits on a full one at the start, then, after the
   last checkpoint (so that replay repeats them), one tombstone purge
   (commit 25) behind the epoch registry, a forced ``maintenance_tick``
   after commit 26 and ``grow_blocks`` to 2^24 + 2^22 lanes a block after
   28. A control runtime takes the same commits with no gate and no
   maintenance: each commit's ``impacted_keys`` must be equal on both, and
   so must each read batch (results, misses, metrics) unless a root it read
   crosses ``max_deg`` differently on the two stores (the one way
   compaction changes a read, in both packages; every other root's one-hop
   reads are held equal); every block's gate must have compacted it (the
   purge counted apart), and every ``block_gather`` / ``cache_probe`` call
   equal its plain version. Then the crash (runtime and journal objects
   dropped, torn bytes at the log's tail) and ``replay`` on a fresh
   runtime, through COMMIT, COMPACT and GROW records: the replayed store
   must equal the live one field for field, four more read batches the
   control's, and the recovered store's first incremental checkpoint falls
   back to full. Prints commit p50 / p90 gated and not, host reads a
   commit, the crossing roots, ``compact_step``'s device time, the growth's
   seconds, each checkpoint's seconds and bytes, replay seconds, the
   journal's metrics and the kernels' times over compacted and grown
   blocks;
12. the serve loop (``repro_torch.launch.serve.serve_loop``), right after
   11 on phase 7's store: 48 gR batches of 512 Zipf roots over the six read
   plans in turn, each followed by its per-owner CP drain, a W-hat commit
   every 2 batches through the gate at 0.5 with the write-behind journal
   (an incremental checkpoint every 8 commits on a full one), growth at
   0.85 occupancy, a telemetry snapshot every 8 batches and the trace to a
   temporary JSONL. Checks: the trace validates (meta first, 6 snapshots,
   1 report, one ``gr_dispatch`` / ``gr_sync`` / ``gr_unpack`` /
   ``cp_drain`` span a batch, one ``grw_step`` a commit, one
   ``checkpoint`` a checkpoint); the report's owner-stage columns sum to
   its counters; one batch with telemetry on and off gives the same
   results, metrics and collectives; the store equals the partition of a
   single-host control that took the same commits, and every cache entry a
   fresh execution of its key; every kernel call of the first two batches
   and the commit between them equals its plain version; the journal ends
   drained with no pin open. Prints requests, hits, misses, populated and
   overflow, latency per traffic class, hit locality per owner, the spans,
   the journal's metrics and the phase's seconds;
13. failover, right after 12 on phase 7's store: 16 gR batches of 512 Zipf
   roots through a ``FailoverController`` (the detector's fail_threshold 2,
   a 0.05 s hedge), each with its per-owner CP drain, a W-hat commit after
   every 2nd batch, the write-behind journal with a full checkpoint just
   before the crash, and a control runtime that takes the same commits
   with no fault. Owner 1 crashes at batch 4: batch 4 raises
   ``NodeFailure``; batches 5-8 serve degraded (every row not deferred
   held equal to a healthy read on the same store and cache, rows deferred
   and hits served, no miss record of owner 1) while their commits queue
   and the store stays as it was; after batch 8's reads ``recover``
   replays to the watermark, splices owner 1's blocks and drains the
   queued commits, and the store must equal the control's field for field,
   every later batch the control's read through the same cache. Owner 2
   straggles in batch 11 (2 s): the masked hedge must win and batch 12
   equal the control's, owner-stage block included. Every kernel call of
   the phase is held to its plain version. Then ``python -m
   repro_torch.launch.serve --inject-crash 1:3 --recover-after 2`` runs
   on the card and must recover once. Prints the unavailable, degraded and
   deferred counts, the queued and drained commits, the recovery's seconds
   (replay, splice, drain) and the degraded and healthy gR step p50;
14. hot-vertex migration, right after 13 on phase 7's store: 16 gR batches
   of 512 roots, half drawn Zipf(1.2) from 16 vertices of owner 1 in the
   plan's root range (the reference serve loop's ``--hot-frac`` rule at
   0.5), the rest Zipf(1.3), with a ``RoutingTableHost`` attached and a
   ``MigrationEngine`` (the reference's policy, the journal) stepping at
   each batch boundary from batch 5 on; a per-owner CP drain after each
   batch and a W-hat commit after every 2nd, aimed at a migrated vertex.
   In batch 6 two hot roots read through cache homes away from their rows
   (the locality retry and the CP split); one vertex moves away after
   batch 9, is edited, and moves home after batch 11. A control runtime
   with no table takes the same batches, drains and commits. Checks:
   results equal to the control's, misses equal as sets, the placement
   read back from the store equal to the table after every round, a round
   that moved a vertex, the read after the move home equal to a fresh
   execution, a crash and ``replay`` from the checkpoint taken before the
   rounds equal to the live store field for field, every kernel call equal
   to its plain version, and ``python -m repro_torch.launch.serve
   --migrate --hot-frac 0.5`` on the card reporting a round. Prints each
   round's moves and splice ms, the table epoch, the retry and CP-split
   counts, owner 1's share of frontier rows and the gR step p50 before and
   after the rounds, and ``block_gather`` timed at a post-migration call;
15. the replicated store tier, right after 14 on phase 7's stores: a ``ShardedTxnRuntime(store_tier="replicated")``
   over the single-host store serves 12 batches of 512 Zipf(1.3) roots of
   the six read plans, each followed by a CP drain of 512 misses an owner,
   beside phase 4's engine with the same cache history (results, and while
   no cache evicted metrics and miss multisets, equal), then 8 W-hat
   commits a policy beside the single host's (store field for field,
   entries with their leaf order, ``impacted_keys``); the partitioned
   runtime serves the same batches (results equal the replicated tier's);
   then ``python -m repro_torch.launch.serve --store-tier replicated`` on
   the card. Every kernel call of the phase is held to its plain version.
   Prints the gR step p50 of both tiers, the replicated gRW p50 a policy, a
   rank's replica bytes beside a partitioned shard's, the serve loop's
   total and the phase's seconds and peak memory;
16. training, right after 10 (its Yi-6B freed first): (a) the
   flash-attention backward kernels (``csrc/flash_attention_bwd.cu``):
   ptxas's registers and spill bytes for each (none for the bf16 ones), the
   HGMMA and UTMALDG counts of their SASS, then the kernels against their
   plain version on Gemma3-4B's global and local layers and on shapes the
   path does not reach, bf16 (against an fp32 yardstick) and fp32, two
   calls on the same inputs equal, with times beside the bound and SDPA's
   backward, and the with-lse forward timed beside SDPA's forward at the
   two Gemma shapes; (b) ``repro_torch.launch.train.main`` on Gemma3-4B
   FULL (34 layers, bf16, remat): 3 steps of 1 x 4,096 tokens, losses,
   grad norms and parameters finite, peak memory, the attention kernels'
   launches counted around the run (forward, remat's recompute and
   backward, one each a layer a step), and a fourth step under the
   profiler with the backward kernels' share of its device time; (c) the
   ~100M LM of
   ``examples/train_lm_100m_torch.py``: 60 steps with a checkpoint at 30
   (the loss over steps 51-60 below that over 1-10), a run resumed from it
   (its losses the uninterrupted run's within 1e-4 relative), then
   ``--compress-grads`` at ``--smoke`` for 20 steps; (d), after phase 8 on
   its batch: 5 PNA ``train_step``s at FULL widths, ``segment_spmm``
   counted forward and backward (the gradient is the same kernel over the
   transposed edge list), every backward call held to its plain version.

17. the model families, last: (a) Grok-1 FULL widths (d 6,144, 48 / 8
   heads, 8 experts top-2, d_ff 32,768, bf16) at 4 of its 64 layers, a
   prefill of 8 x 4,000 tokens through ``prefill_step`` and 32 greedy
   ``decode_step``s (capacity factor 4.0); (b) Kimi K2 FULL widths (d
   7,168, 64 / 8 heads, head dim 112, 384 experts top-8, d_ff 2,048, one
   shared expert) at 1 of its 61 layers, 1 x 4,096 tokens and 8 decode
   steps. In both every ``flash_attention`` launch of the prefill must take
   the bf16 tensor cores and equal its plain version, each layer's dropped
   pairs must equal the capacity formula's count from its routing, and
   layer 0's MoE on 512 of its tokens must be within 2e-2 (relative norm)
   of the same function in fp32 on the same routing; prefill ms, decode ms
   a step and peak memory. (c) ``launch.train.main --arch grok-1-314b /
   kimi-k2-1t-a32b --smoke``, 20 steps of 4 x 64: the losses fall, the aux
   is positive, the attention kernels launch forward, in the recompute and
   backward. (d) GAT (``full_graph_sm``), EGNN and NequIP (``molecule``)
   at FULL widths: a forward, then 5 clip + AdamW steps, ``segment_spmm``
   counted by kind forward and backward and every call held to its plain
   version; EGNN's and NequIP's energies unchanged (1e-4 relative) by a
   random rotation and translation. (e) two-tower training at FULL widths
   (user vocab 4,194,304, batch 16,384, bags of 1-16 Zipf(1.1) ids, fp32):
   3 steps, the loss falling; every call of the ``embedding_bag`` backward
   kernels (``csrc/embedding_bag_bwd.cu``: the row bounds, the chunk pass,
   the row pass) equal bit for bit to its plain version on the host and to
   a second call, and so four synthetic calls at a small table (every
   unmasked entry on one row, every entry masked, bf16, a width of 12);
   the row plan equal to the host's; one item-table call with no host sync
   (``torch.cuda.set_sync_debug_mode("error")``); its time at the item and
   user tables, ``prepare_rows`` split into its sort, its row bounds and
   its chunk table, each pass's launches (profiled) and device time beside
   the dense write alone, its bound and ``F.embedding_bag``'s backward. (f)
   the twin of ``examples/gnn_cached_sampling.py`` on the card (hits) and
   on the CPU (the same invalidated keys).
18. the dry-run, last: three cells no earlier phase runs are built
   with ``launch.steps.build_cell(..., device="cuda")`` and stepped once
   through the kernels, each build's device memory held to the dry-run's
   bytes for the same cut cell and its outputs to the meta run's; then
   ``launch.dryrun.main(["--all", ...])`` (every (architecture x shape)
   cell on the 16 x 16 and 2 x 16 x 16 meshes, built on ``meta``; a line a
   pair with its GiB a device, whether it fits the card, whether it traced
   and its TFLOP; all 78 must be ``ok``). The cells: (a)
   GLM4-9B ``prefill_32k`` at its 40 layers and 32,768 tokens, batch 2
   (GQA 16 on the bf16 tensor cores), the first and last 128 rows of every
   ``flash_attention`` call within 1e-2 of the plain version, the kernel
   timed beside SDPA and its bound; (b) GAT (FULL widths) at
   ``ogb_products``, 2,449,408 nodes and 1/8 of its 61,859,140 edges, one
   train step, every ``segment_spmm`` call within 1e-5 of its plain
   version, the largest timed beside its bound and ``torch.sparse.mm``;
   (c) the ecommerce-graph cells on 4 ranks of one chip's share of FULL
   (2^24 vertices, 2^27 edges, 2^20 cache slots; a seeded random graph):
   ``serve_low`` (1,024 Zipf roots), ``serve_peak`` (8,192) cold, a CP
   drain, ``serve_peak`` warm and ``serve_nocache``, every row equal to a
   numpy one-hop reference, ``serve_nocache``'s to ``serve_peak``'s, every
   ``cache_probe`` / ``block_gather`` call to its plain version.

Between 4 and 5, in 7, 8 and 10, a short ``torch.profiler`` window prints
the device's busy time by kernel and its idle share. Phase 8 runs last, after
10. Once a process has traced many device events the profiler drops some of
later windows, so each window opens with spin kernels that take that loss
and reports any kernel it still dropped; a device time is taken only from a
window that dropped none. Each phase
prints its peak device memory; each phase's world is freed before the next.
Phase 11 runs right after 7, on its store, then 12, 13, 14 and 15, before 9;
16 runs after 10, and its part (d) after 8; then 17 and 18.

Any failure raises (non-zero exit). The last stdout line is the device
JSON; the line before it the card, and before that the kernels JSON.

Run:  python3 chip_smoke.py [--seed 0]
"""

import argparse
import ctypes
import gc
import json
import os
import re
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
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak: the attention bound

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


def serving_ttable(templates):
    """The template table with every template registered and enabled for
    reads and writes through one query processor (the safe lifecycle)."""
    from repro_torch.core import make_template_table
    from repro_torch.core.lifecycle import GraphQP, ServiceCoordinator

    qp = GraphQP("qp0")
    sc = ServiceCoordinator([qp])
    for t in range(len(templates)):
        sc.register(t)
        sc.enable(t)
    assert sc.check_safety()
    return qp.ttable_masks(make_template_table(templates), len(templates))


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


LEAD_SPINS = 64  # spin kernels that open each profile window


def open_window():
    """Once a process has traced many device events, the profiler loses the
    first kernels of each later window, so a device time summed over the
    window reads low. Each window opens with LEAD_SPINS spin kernels,
    synchronised, which take most of that loss (a window may still lose one
    kernel elsewhere); ``window_events`` leaves them out."""
    for _ in range(LEAD_SPINS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def window_events(prof):
    """(the window's device events past its opening spin kernels, the
    kernels of them the profiler still dropped: launches seen on the host
    less kernels recorded on the device)."""
    from torch.autograd import DeviceType

    events = [e for e in device_events(prof) if "spin_kernel" not in e.name]
    launched = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
                   and "aunch" in e.name and "Kernel" in e.name) - LEAD_SPINS
    kernels = sum(1 for e in events if not e.name.startswith(("Memcpy", "Memset")))
    return events, max(launched - kernels, 0)


def device_ms(fn, iters=20, match=None, attempts=3, by_kernel=None) -> float | None:
    """Device time per call of ``fn`` (the sum of the kernels it launches,
    or of those whose name contains ``match``), from ``torch.profiler``,
    over the first of ``attempts`` windows that dropped no kernel; None
    when none is whole or none records such time. A ``by_kernel`` dict is
    filled from that window with {kernel name: (launches, device ms)} per
    call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events, lost = window_events(prof)
        if not lost:
            evs = [e for e in events if match is None or match in e.name]
            for name in {e.name for e in evs} if by_kernel is not None else ():
                mine = [e for e in evs if e.name == name]
                by_kernel[name] = (len(mine) / iters,
                                   sum(e.time_range.elapsed_us() for e in mine) / iters / 1e3)
            return sum(e.time_range.elapsed_us() for e in evs) / iters / 1e3 if evs else None
    print(f"device_ms: the profiler dropped kernels in each of {attempts} windows "
          f"({lost} in the last; not measured)", flush=True)
    return None


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def weighted_quantile(xs, weights, q):
    """The inverted-CDF quantile of ``xs`` each counted ``weights`` times,
    as ``LatencyHistogram.quantile`` takes it but on the exact values."""
    order = np.argsort(xs, kind="stable")
    cum = np.cumsum(np.asarray(weights, np.int64)[order])
    if not len(cum) or cum[-1] == 0:
        return float("nan")
    i = int(np.searchsorted(cum, max(q * cum[-1], 1), side="left"))
    return float(np.asarray(xs)[order][min(i, len(cum) - 1)])


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


def profiled(tag, what, body, host_ops=True, by_kernel=None):
    """Runs ``body()`` under ``torch.profiler`` and prints its wall time,
    the device's busy time by kernel and its idle share. ``host_ops=False``
    traces the device alone; a ``by_kernel`` dict is filled with {kernel
    name: (device us, calls)}. Returns ``(wall_ms, busy_ms)``; busy is None
    when no device time was recorded."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        open_window()
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, lost = window_events(prof)
    if not events:
        print(f"profile{tag}: no device time recorded (not measured)", flush=True)
        return wall_ms, None
    by_name: dict = {}
    for e in events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    if by_kernel is not None:
        by_kernel.update(by_name)
    print(f"profile{tag}: {what}, wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms in {len(events)} device events ({lost} kernels dropped), "
          f"idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
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
    """The read path's ``cache_probe`` arguments for ``hop`` over ``roots``:
    every chunk key of every root in one launch, as
    ``core.cache.cache_lookup_lean`` makes them (captured from it)."""
    import repro_torch.core.cache as cache_mod

    r = torch.as_tensor(roots, device=dev)
    params = torch.as_tensor(hop.params, device=dev).expand(len(roots), -1)
    with CallCapture((cache_mod, "cache_probe")) as cap:
        cache_mod.cache_lookup_lean(espec.cache, cache, hop.tpl_idx, r, params)
    (args_, _), = cap.calls["cache_probe"]
    return args_


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


def timings(kernel_fn, plain_fn, iters=(50, 20)) -> dict:
    """``ms`` / ``plain_ms``: CUDA-event time per call over back-to-back calls
    (what a caller pays, host work of the wrapper included), ``iters`` calls
    of each; ``device_ms`` / ``plain_device_ms``: device time per call from
    the profiler (the kernels alone)."""
    return dict(
        ms=cuda_ms(kernel_fn, iters=iters[0]), plain_ms=cuda_ms(plain_fn, iters=iters[1]),
        device_ms=device_ms(kernel_fn), plain_device_ms=device_ms(plain_fn),
    )


def fmt_us(t) -> str:
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.3f}"
    return (f"kernel_us={us(t['ms'])} (device {us(t['device_ms'])}) "
            f"plain_us={us(t['plain_ms'])} (device {us(t['plain_device_ms'])})")


def check_probe_calls(calls, where):
    """Every ``cache_probe`` call a path made (captured by ``CallCapture``),
    held ``torch.equal`` to the plain version on the same inputs."""
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref

    assert calls, f"{where} made no cache_probe call"
    for a, kw in calls:
        got, want = cp_ops.cache_probe(*a, **kw), cache_probe_ref(*a, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"cache_probe disagrees with its plain version at {a[4].shape[0]} keys ({where})"


def one_fill_us(like) -> str:
    """Device µs of one fill of a tensor like ``cache_probe``'s slot output:
    the least a kernel launch costs on the device, beside which its time
    is read."""
    fill = torch.empty_like(like)
    ms = device_ms(lambda: fill.fill_(-1))
    return f"one_fill_device_us={'not measured' if ms is None else f'{ms * 1e3:.3f}'}"


def check_probe_wrap(a, probes):
    """``cache_probe`` on windows that wrap at C, on a copy of the cache's
    slots and the path's keys: every key's window starts in the last 8
    slots. Key 0 is planted at slot C-1 (probe 0) and at slot 0 (probe 1,
    the lower index): the first match in probe order, C-1, must win. Key 1
    matches past the wrap alone (slot 2, probe 4); key 2 nowhere."""
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref

    c_tpl, c_root, c_fp, c_valid = (t.clone() for t in a[:4])
    tpl, root, h, fp = (t.clone() for t in a[4:])
    C, B = c_tpl.shape[0], tpl.shape[0]
    h.copy_(C - 1 - torch.arange(B, device=h.device, dtype=torch.int32) % 8)
    tpl[:3], root[:3], fp[:3] = 1, torch.tensor([-10, -11, -12]), 77  # no real root is negative
    h[:3] = torch.tensor([C - 1, C - 2, C - 3])
    c_valid[[C - 2, 1]] = False
    for i, slots in ((0, [C - 1, 0]), (1, [2])):
        c_tpl[slots], c_root[slots], c_fp[slots], c_valid[slots] = tpl[i], root[i], fp[i], True
    args_ = (c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp)
    got, want = cp_ops.cache_probe(*args_, probes=probes), cache_probe_ref(*args_, probes=probes)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        "cache_probe disagrees with its plain version on windows that wrap"
    assert got[1][:3].tolist() == [C - 1, 2, -1], f"wrapped windows: {got[1][:3].tolist()}"
    print(f"kernel cache_probe wrap keys={B} cap={C} hits={int(got[0].sum())} (equal; first match "
          f"in probe order: slots {got[1][:3].tolist()})", flush=True)


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
    # hop's flattened frontier (512 x 32 = 16,384 roots), each root's
    # max_chunks chunk keys in one launch, on the populated cache
    for n_roots in (512, 16384):
        roots = zipf_pick(rng, *ranges[L_WATCHLIST], n_roots)
        a = probe_inputs(espec, cache, sq1, roots, dev)
        n_keys = a[4].shape[0]
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
              f"({by}, {nbytes} B) {one_fill_us(want[1])}",
              flush=True)
        row = dict(name="cache_probe", route="cuda", source="src/repro_torch/csrc/cache_probe.cu",
                   replaces="src/repro/kernels/cache_probe/kernel.py:44",
                   launches=launches["cache_probe"], max_abs_err=err, **t,
                   bound_ms=bms, bound_by=by, library_ms=None, shape=f"keys={n_keys}")
    rows.append(row)  # the JSON row carries the larger (hop-2) shape
    check_probe_wrap(a, P)

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


def check_consistency(espec, state, ttable, plans, ranges, engines, dev, seed, explain=None):
    """Phase 6's check of ``state``. ``explain``, where given, is the same
    cache with the entries a write-through edit reordered put back in a
    fresh execution's order: a multi-hop result that differs from the
    cache-off engine must then equal it on ``explain``, so the difference
    goes through such an entry (the frontier truncated to F leaves keeps
    others). Without it every result must equal the cache-off engine's."""
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
    as_set = lambda r: set(r[r >= 0].tolist())
    for name in ("q_common", "q_sellers"):
        plan, label = byname[name]
        plain = GraphEngine(espec, plan, use_cache=False, device=dev)
        hits = explained = 0
        for _ in range(8):
            roots = zipf_pick(rng, *ranges[label], 512)
            a, _, m = engines[name].run(store, cache, ttable, roots)
            b, _, _ = plain.run(store, cache, ttable, roots)
            differ = [i for i in range(len(roots)) if as_set(a[i]) != as_set(b[i])]
            if differ:
                assert explain is not None, \
                    f"{name} root {roots[differ[0]]}: cached result differs from uncached"
                c, _, _ = engines[name].run(store, explain, ttable, roots)
                for i in differ:
                    assert as_set(c[i]) == as_set(b[i]), f"{name} root {roots[i]}: cached " \
                        "result differs from uncached, and not through a reordered entry"
                explained += len(differ)
            hits += m["hits"]
        print(f"consistency {name}: 8 batches of 512 equal the uncached engine "
              f"(hits={hits}; {explained} results differ only through entries a write-through "
              f"edit reordered)", flush=True)


# ---------------------------------------------------- partitioned tier
N_OWNERS = 4  # owner shards held in one process on the one card
P_ROUNDS = 2  # rounds over the six read plans in phase 7
# miss records each side populates after a phase-7 batch: the same records
# on both sides (the first by key), few enough that a 2^18-slot cache is
# unlikely to evict, which the entry comparison needs
P_CP_PER_BATCH = 512
# gRW-Txs of each policy's round in phase 7: what the time limit allows
# (each costs ~3 s of the script with its reads and checks; 64 until phase
# 18 took its place in the time: with 64 the script passed 1,050 s, with 48
# too); the recent regions would take hundreds
P_GRW_COMMITS = 40
# the watch-lists whose includes edges the rounds' del_edges draw from: the
# Zipf-hottest, which the read batches visit (upserts draw Zipf endpoints too)
P_HOT_WATCHLISTS = 64
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


def run_partitioned(seed, espec, store, ttable, plans, meta, ranges, includes, engines, dev):
    """Phase 7: the partitioned gR-Tx tier over N_OWNERS owner shards, with
    CP through ``ShardedMissDrain``, against the single-host engine on the
    same store and batches (both caches start empty; after every batch both
    populate the same ``P_CP_PER_BATCH`` miss records); then the gRW rounds
    (``run_partitioned_grw``) and phase 6's consistency check on the single
    host after them. Returns the report, the read calls' capture, the gRW
    rounds' kernel check and the (single-host, partitioned) stores after the
    rounds."""
    import repro_torch.core.cache as cache_mod
    from repro_torch.core import CachePopulator, empty_cache
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
        entries_equal = entries_equal_on_card(espec, hcache, pcache)
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

    # the gRW rounds, then the single host's state against the numpy one-hop
    # reference and the cache-off engine
    t0 = time.perf_counter()
    (hstore, hcache, pstore, pcache), report["grw"], gcheck, report["grw_launches"] = \
        run_partitioned_grw(seed, espec, rt, [store, hcache, pstore, pcache], ttable, plans,
                            ranges, includes, engines, (hpop, drain), dev)
    fresh_order, checked, reordered = hold_write_through_entries(espec, hstore, hcache, plans, dev)
    print(f"consistency write-through: {checked} entries equal a fresh execution of their key; "
          f"{reordered} of them list their leaves in another order", flush=True)
    check_consistency(espec, (hstore, hcache), ttable, plans, ranges, engines, dev, seed + 1,
                      explain=fresh_order if reordered else None)
    del fresh_order
    print(f"partitioned grw rounds: {time.perf_counter() - t0:.1f}s; peak device memory of "
          f"phase 7: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_window(" partitioned", seed, plans, ranges,
                   lambda name, r: rt.run_gr_tx_batch(pstore, pcache, ttable,
                                                      dict((n, p) for n, p, _, _ in plans)[name], r))
    return report, capture, gcheck, (hstore, pstore)


def entries_equal_on_card(espec, a, b) -> bool:
    """``cache_entries(a) == cache_entries(b)``, made on the card: one row
    per valid slot (tpl, root, fp, chunk, total_len, version, then the
    chunk's leaves with the lanes past its occupied prefix set to -2),
    sorted, then compared."""
    L = espec.cache.max_leaves

    def rows(cache):
        v = cache.valid
        seg = (cache.total_len[v] - cache.chunk[v] * L).clamp(0, L)
        vals = torch.where(torch.arange(L, device=v.device)[None, :] < seg[:, None],
                           cache.vals[v], -2)
        r = torch.cat([torch.stack([cache.tpl[v], cache.root[v], cache.fp[v], cache.chunk[v],
                                    cache.total_len[v], cache.version[v]], dim=1), vals], dim=1)
        r = r.cpu().numpy().astype(np.int64)
        return r[np.lexsort(r.T[::-1])]

    return np.array_equal(rows(a), rows(b))


def lane_slots(a, kw):
    """The block slot each lane of a ``block_gather`` call reads, and
    whether the call visits it (its row executes and the lane lies in the
    row's CSR window, or is a recent-region lane keyed by the root), made
    from the call's inputs as the plain version makes them."""
    from repro_torch.utils import jax_index

    indptr, key, csr_len, blk_len = a[0], a[1], a[9], a[10]
    roots, lroot, rvalid, cvalid, rmask = a[11:16]
    EB, R, D = kw["e_blk_cap"], kw["recent_cap"], kw["max_deg"]
    dev, B, Vp = roots.device, roots.shape[0], indptr.shape[0]
    start = indptr[jax_index(lroot, Vp)]
    deg = indptr[jax_index(lroot + 1, Vp)] - start
    lane = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    sid = csr_len.clamp(0, EB - R) + torch.arange(R, dtype=torch.int32, device=dev)
    rec = ((key[sid.long()][None, :] == roots[:, None])
           & ((sid >= csr_len) & (sid < blk_len))[None, :] & rvalid[:, None])
    slots = torch.cat([(start[:, None] + lane).clamp(0, EB - 1), sid[None, :].expand(B, R)], 1)
    visit = torch.cat([(lane < deg[:, None]) & cvalid[:, None], rec], 1) & rmask[:, None]
    return slots.long(), visit


class GrwKernelCheck:
    """Holds every ``block_gather`` and ``cache_probe`` call of phase 7's gRW
    rounds to its plain version, batch by batch (so no committed store
    outlives its batch, but for the largest call of each kernel, kept for
    timing), and counts from each ``block_gather`` call's inputs the
    recent-region lanes it scanned that a partitioned commit appended (slot
    past the block's length before the rounds) and the lanes it visited
    whose edge a partitioned delete cleared (alive before the rounds, dead
    now). The comparison launches are taken back off the kernels' counts."""

    def __init__(self, pspec, pstore0, max_deg):
        from repro_torch.graphstore.partition import local_shard

        self.pspec, self.max_deg = pspec, max_deg
        shards = [local_shard(pspec, pstore0, s) for s in range(pspec.n_shards)]
        self.blocks0 = {(inc, s): (blk.alive, int(blk.blk_len[0]))
                        for s, ps in enumerate(shards)
                        for inc, blk in ((False, ps.out), (True, ps.inc))}
        self.block_of = {}
        self.calls = {"cache_probe": 0, "block_gather": {False: 0, True: 0}}
        self.appended = self.deleted = 0
        self.largest = {}

    def map_store(self, pstore):
        """Learns which (orientation, shard) block each key tensor of a
        committed store is, by address."""
        from repro_torch.graphstore.partition import local_shard

        for s in range(self.pspec.n_shards):
            ps = local_shard(self.pspec, pstore, s)
            self.block_of[ps.out.key.data_ptr()] = (False, s)
            self.block_of[ps.inc.key.data_ptr()] = (True, s)

    def check(self, capture):
        from repro_torch.kernels.block_gather import ops as bg_ops
        from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
        from repro_torch.kernels.cache_probe import ops as cp_ops

        counts = (bg_ops.launches, cp_ops.launches)
        probes = capture.calls["cache_probe"]
        if probes:
            check_probe_calls(probes, "the gRW rounds")
        for a, kw in probes:
            self.calls["cache_probe"] += 1
            key = ("cache_probe", a[0].shape[0])  # the largest call per cache size
            if key not in self.largest or a[4].shape[0] > self.largest[key][0][4].shape[0]:
                self.largest[key] = (a, kw)
        D = self.max_deg
        for a, kw in capture.calls["block_gather"]:
            got, want = bg_ops.block_gather(*a, **kw), block_gather_filter_ref(*a, **kw)
            for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want):
                assert torch.equal(g, w), \
                    f"block_gather {name} disagrees with its plain version after a commit"
            incoming, s = self.block_of[a[1].data_ptr()]
            alive0, len0 = self.blocks0[(incoming, s)]
            slots, visit = lane_slots(a, kw)
            self.appended += int((want[1][:, D:] & (slots[:, D:] >= len0)).sum())
            self.deleted += int((visit & ~a[4][slots] & alive0[slots]).sum())
            self.calls["block_gather"][incoming] += 1
            big = self.largest.get(incoming)
            if big is None or a[11].shape[0] > big[0][11].shape[0]:
                self.largest[incoming] = (a, kw)
        for calls in capture.calls.values():
            calls.clear()
        bg_ops.launches, cp_ops.launches = counts


def value_edits(before, after):
    """The value-add and value-remove edits a write-through commit took:
    chunk-0 slots valid before and after it whose ``total_len`` rose, and
    those where it fell (a commit inserts nothing, so a slot valid in both
    holds the same key)."""
    both = before.valid & after.valid & (before.chunk == 0)
    d = after.total_len - before.total_len
    return int((both & (d > 0)).sum()), int((both & (d < 0)).sum())


def op_rounds(calls):
    """The rounds the captured ``apply_op_stream_segmented`` calls ran: per
    call, the most valid ops any one key has."""
    n = 0
    for a, _ in calls:
        ops = a[2]
        keys = torch.cat([ops.tpl[:, None], ops.root[:, None], ops.params], dim=1)[ops.ok]
        if keys.shape[0]:
            n += int(torch.unique(keys, dim=0, return_counts=True)[1].max())
    return n


def hold_write_through_entries(espec, store, cache, plans, dev):
    """Every cache entry after the write-through round against a fresh
    execution of its key on the store: the same leaf set, never truncated
    (the property of ``tests/test_write_through_convergence.py``, on every
    entry). Write-through appends a leaf at the end of its entry, where a
    fresh execution lists it in edge order; a multi-hop frontier truncated
    to F distinct leaves then keeps other leaves than the cache-off engine.
    Returns a copy of the cache whose entries hold their leaves in the fresh
    order, the order a write-around repopulation gives (phase 6's check
    holds a result that differs from the cache-off engine to it), the
    entries checked, and those whose order differed."""
    from repro_torch.core import cache_lookup, onehop_exec
    from repro_torch.utils import INT32_MAX

    hops = {}
    for _, plan, _, _ in plans:
        for hop in plan.hops:
            if hop.tpl_idx >= 0:
                assert hops.setdefault(hop.tpl_idx, hop).params.tolist() == hop.params.tolist()
    L = espec.cache.max_leaves
    head = cache.valid & (cache.chunk == 0)
    vals = cache.vals.clone()
    checked = reordered = 0
    for t, hop in sorted(hops.items()):
        slots = torch.nonzero(head & (cache.tpl == t)).reshape(-1)
        if not slots.numel():
            continue
        roots = cache.root[slots]
        params = torch.as_tensor(hop.params, device=dev).expand(len(roots), -1)
        hit, leaves, lmask, _ = cache_lookup(espec.cache, cache, t, roots, params)
        assert bool(hit.all()), f"template {t}: an entry's chain or key does not resolve"
        fresh, fmask, n_true, trunc, _ = onehop_exec(
            espec, store, hop.direction, hop.edge_label, hop.pr, hop.pe, hop.pl, roots, params,
            torch.ones_like(hit))
        assert not bool((trunc | (n_true > espec.result_width)).any()), \
            f"template {t}: a kept entry's key no longer has a cacheable result"
        sort = lambda x, m: torch.where(m, x, INT32_MAX).sort(dim=1).values
        assert torch.equal(sort(leaves, lmask), sort(fresh, fmask)), \
            f"template {t}: a kept entry differs from a fresh execution of its key"
        moved = ((leaves != fresh) & lmask).any(dim=1)
        assert bool((lmask[moved].sum(dim=1) <= L).all()), "a multi-chunk entry was edited"
        vals[slots[moved]] = fresh[moved, :L]
        checked += len(roots)
        reordered += int(moved.sum())
    return cache._replace(vals=vals), checked, reordered


def stores_equal(rt, pstore, hstore):
    """The partitioned store against ``partition_store`` of the single
    host's, field by field, ``gperm`` included."""
    from repro_torch.graphstore.partition import EdgeBlock

    want = rt.partition_store(hstore)
    for f in want._fields:
        a, b = getattr(pstore, f), getattr(want, f)
        for name, x, y in (zip(EdgeBlock._fields, a, b) if isinstance(b, EdgeBlock)
                           else [(f, a, b)]):
            assert torch.equal(x, y), f"partitioned store {f}.{name} differs from the " \
                "partition of the single host's"


def run_partitioned_grw(seed, espec, rt, tiers, ttable, plans, ranges, includes, engines,
                        pops, dev):
    """Phase 7's gRW rounds: one round of P_GRW_COMMITS commits per policy,
    write-around first, each opened by one untimed commit a tier whose
    result is dropped. Each commit is one ``make_write`` batch of WRITE_MIX
    through ``run_grw_tx`` on the single host and on the partitioned tier,
    followed by a 512-root read batch of the next plan through both tiers
    with CP on both. The kernels' launches are counted per tier and stage
    (commit, read, CP); write-through's write-around fork runs outside the
    count. ``tiers`` = [hstore, hcache, pstore, pcache]; ``pops`` =
    (single-host populator, ShardedMissDrain)."""
    import repro_torch.core.cache as cache_mod
    import repro_torch.core.invalidation as inv_mod
    import repro_torch.distributed.graph_serve as gs_mod
    from repro_torch.core import run_grw_tx
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.cache_probe import ops as cp_ops

    hstore, hcache, pstore, pcache = tiers
    hpop, drain = pops
    rng = np.random.default_rng(seed + 31)
    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)
    wl0 = ranges[L_WATCHLIST][0]
    hot = torch.as_tensor(includes, device=dev)
    hot = hot[hstore.esrc[hot] < wl0 + P_HOT_WATCHLISTS].cpu().numpy()
    gcheck = GrwKernelCheck(rt.pspec, pstore, espec.max_deg)
    capture = CallCapture((bg_ops, "block_gather"), (cache_mod, "cache_probe"))
    # the segmented applies of both tiers (for their round counts)
    seg = CallCapture((inv_mod, "apply_op_stream_segmented"),
                      (gs_mod, "apply_op_stream_segmented"))
    plan_cycle = [(n, p, label) for n, p, label, _ in plans]
    tally = {}  # (tier, stage) -> [block_gather, cache_probe] launches

    def counted(tier, stage, fn):
        c0 = (bg_ops.launches, cp_ops.launches)
        out = fn()
        t = tally.setdefault(f"{tier} {stage}", [0, 0])
        t[0] += bg_ops.launches - c0[0]
        t[1] += cp_ops.launches - c0[1]
        return out

    def write_batch():
        while True:
            kind = kinds[int(rng.choice(len(kinds), p=wweights))]
            mb = make_write(rng, espec, ranges, hot, kind, dev)
            if mb is not None:
                return mb

    commit = {"single": lambda mb, pol, hs, hc: run_grw_tx(espec, hs, hc, ttable, mb, pol,
                                                           device=dev),
              "partitioned": lambda mb, pol, ps, pc: rt.run_grw_tx(ps, pc, ttable, mb, pol)}
    reports, last = {}, {}
    cp_ops.launches = bg_ops.launches = 0
    for policy in ("write-around", "write-through"):
        through = policy == "write-through"
        lat = {"single": [], "partitioned": []}
        syncs = {"single": [], "partitioned": []}
        edits = {"single": [0, 0], "partitioned": [0, 0]}  # adds, removes
        rounds = {"single": 0, "partitioned": 0}
        hits = {"kept": 0, "write_around_fork": 0}
        impacted = equal_entries = equal_reads = 0
        warm = write_batch()  # first-call costs stay out of the percentiles
        commit["single"](warm, policy, hstore, hcache)
        commit["partitioned"](warm, policy, pstore, pcache)
        for i in range(P_GRW_COMMITS):
            mb = write_batch()
            name, plan, label = plan_cycle[i % len(plan_cycle)]
            roots = zipf_pick(rng, *ranges[label], BATCH)
            pre = (hstore, hcache, pstore, pcache)
            last[policy] = mb
            with seg:
                t = time.perf_counter()
                hstore, hcache, mh = counted("single", "commit",
                                             lambda: commit["single"](mb, policy, hstore, hcache))
                lat["single"].append((time.perf_counter() - t) * 1e3)
            rounds["single"] += op_rounds(seg.calls["apply_op_stream_segmented"])
            seg.calls["apply_op_stream_segmented"].clear()
            with seg:
                t = time.perf_counter()
                pstore, pcache, mp = counted(
                    "partitioned", "commit",
                    lambda: commit["partitioned"](mb, policy, pstore, pcache))
                lat["partitioned"].append((time.perf_counter() - t) * 1e3)
            rounds["partitioned"] += op_rounds(seg.calls["apply_op_stream_segmented"])
            seg.calls["apply_op_stream_segmented"].clear()
            gcheck.map_store(pstore)
            syncs["single"].append(mh["host_syncs"])
            syncs["partitioned"].append(mp["host_syncs"])
            assert mp["impacted_keys"] == mh["impacted_keys"], \
                f"{policy} commit {i}: impacted {mp['impacted_keys']} != {mh['impacted_keys']}"
            assert mh["op_overflow"] == mp["op_overflow"] == mp["store_append_overflow"] == 0, \
                f"{policy} commit {i}: overflow {mh} {mp}"
            impacted += mh["impacted_keys"]
            if through:
                for tier, before, after in (("single", pre[1], hcache),
                                            ("partitioned", pre[3], pcache)):
                    adds, removes = value_edits(before, after)
                    edits[tier][0] += adds
                    edits[tier][1] += removes
            if i % 4 == 3 or i == P_GRW_COMMITS - 1:
                stores_equal(rt, pstore, hstore)
            evicted = int(hcache.n_evict) or int(pcache.n_evict)
            if not evicted:
                assert entries_equal_on_card(espec, hcache, pcache), \
                    f"{policy} commit {i}: cache entries differ between the tiers"
                equal_entries += 1

            # the read batch after the commit, with CP on both tiers
            with capture:
                rh, ms_h, meth = counted(
                    "single", "read", lambda: engines[name].run(hstore, hcache, ttable, roots))
                rp, ms_p, metp = counted(
                    "partitioned", "read",
                    lambda: rt.run_gr_tx_batch(pstore, pcache, ttable, plan, roots))
                assert metp["route_overflow"] == 0, f"{policy} read {i}: route_overflow"
                assert np.array_equal(rh, rp), f"{policy} read {i} ({name}): result differs"
                hpop.queue.push(sorted(ms_h, key=lambda m: miss_key([m]))[:P_CP_PER_BATCH])
                hcache2 = counted("single", "CP",
                                  lambda: hpop.drain(hstore, hstore, hcache, ttable, 1 << 30))
                drain.push(sorted(ms_p, key=lambda m: miss_key([m]))[:P_CP_PER_BATCH])
                pcache2 = counted("partitioned", "CP",
                                  lambda: drain.drain(pstore, pstore, pcache, ttable, k=1 << 30))
            gcheck.check(capture)
            if through:
                # the same commit under write-around from the same state, and
                # the same reads: write-through keeps a superset of its
                # entries, so they hit at least as often. Outside the count.
                saved = (bg_ops.launches, cp_ops.launches)
                _, fh, _ = commit["single"](mb, "write-around", pre[0], pre[1])
                _, _, fm_h = engines[name].run(hstore, fh, ttable, roots)
                _, fp, _ = commit["partitioned"](mb, "write-around", pre[2], pre[3])
                _, _, fm_p = rt.run_gr_tx_batch(pstore, fp, ttable, plan, roots)
                bg_ops.launches, cp_ops.launches = saved
                assert meth["hits"] >= fm_h["hits"] and metp["hits"] >= fm_p["hits"], \
                    f"write-through commit {i} kept fewer hits than write-around"
                hits["kept"] += meth["hits"] + metp["hits"]
                hits["write_around_fork"] += fm_h["hits"] + fm_p["hits"]
                del fh, fp
            del pre
            hcache, pcache = hcache2, pcache2
            if not evicted:
                meth.pop("host_syncs")
                for k in SHARDED_ONLY:
                    metp.pop(k)
                assert metp == meth, f"{policy} read {i} ({name}): metrics {metp} != {meth}"
                assert miss_key(ms_p) == miss_key(ms_h), f"{policy} read {i}: misses differ"
                equal_reads += 1
        torch.cuda.synchronize()
        fill_p = torch.cat([pstore.out.blk_len - pstore.out.csr_len,
                            pstore.inc.blk_len - pstore.inc.csr_len]).tolist()
        fill_h = int(hstore.e_len) - int(hstore.csr_len)
        rep = dict(commits=P_GRW_COMMITS, impacted_keys=impacted)
        for tier in ("single", "partitioned"):
            for q in (25, 50, 75, 90):
                rep[f"{tier}_p{q}_ms"] = pct(lat[tier], q)
            rep[f"{tier}_max_ms"] = max(lat[tier])
        rep.update(
            single_host_reads_per_commit=float(np.mean(syncs["single"])),
            partitioned_host_reads_per_commit=float(np.mean(syncs["partitioned"])),
            commits_entries_equal=equal_entries, reads_metrics_equal=equal_reads,
            recent_fill_partitioned_out_in=fill_p, recent_blk_cap=rt.pspec.recent_blk_cap,
            recent_fill_single=fill_h, recent_cap=espec.store.recent_cap,
            n_evict_single=int(hcache.n_evict), n_evict_partitioned=int(pcache.n_evict),
        )
        if through:
            for tier in ("single", "partitioned"):
                rep[f"{tier}_value_adds"], rep[f"{tier}_value_removes"] = edits[tier]
                rep[f"{tier}_op_rounds_per_commit"] = rounds[tier] / P_GRW_COMMITS
                assert min(edits[tier]) > 0, \
                    f"write-through took no value-add or no value-remove edit on the {tier} tier"
            rep["hits_write_through"] = hits["kept"]
            rep["hits_write_around_same_reads"] = hits["write_around_fork"]
        print(f"partitioned grw {policy}: " + json.dumps(rep), flush=True)
        assert max(fill_p) <= rt.pspec.recent_blk_cap, f"a block's recent region overflowed: {fill_p}"
        assert fill_h <= espec.store.recent_cap, f"the single host's recent region overflowed"
        reports[policy] = rep
    launches = {tier: {"block_gather": sum(v[0] for k, v in tally.items() if k.startswith(tier)),
                       "cache_probe": sum(v[1] for k, v in tally.items() if k.startswith(tier))}
                for tier in ("single", "partitioned")}
    print(f"launches on the gRW rounds by tier and stage [block_gather, cache_probe]: {tally}",
          flush=True)
    # the device's share of a commit: each round's last batch again, on the
    # final state (commits are functional, so the results are dropped)
    for tier, (store, cache) in (("single", (hstore, hcache)), ("partitioned", (pstore, pcache))):
        profiled(f" grw {tier}", "one commit of each policy",
                 lambda: [commit[tier](mb, pol, store, cache) for pol, mb in last.items()])
    assert launches["partitioned"]["block_gather"] > 0, \
        "the gRW rounds' partitioned reads launched no block_gather"
    assert launches["single"]["cache_probe"] > 0 and launches["partitioned"]["cache_probe"] > 0, \
        "the gRW rounds' reads launched no cache_probe on a tier"
    calls = gcheck.calls
    print(f"kernel block_gather grw calls out={calls['block_gather'][False]} "
          f"in={calls['block_gather'][True]} (all equal); appended recent lanes scanned="
          f"{gcheck.appended}; lanes visited whose edge a partitioned delete cleared="
          f"{gcheck.deleted}", flush=True)
    print(f"kernel cache_probe grw calls={calls['cache_probe']} (all equal)", flush=True)
    assert gcheck.appended > 0, "no block_gather call scanned a lane a partitioned commit appended"
    assert gcheck.deleted > 0, "no block_gather call visited a lane a partitioned delete cleared"
    return (hstore, hcache, pstore, pcache), reports, gcheck, launches


def time_kernel_calls(tag, probe, gathers):
    """One ``cache_probe`` call and named ``block_gather`` calls a path made,
    each timed beside its bound (counted for its own inputs and
    ``e_blk_cap``); returns their timing rows."""
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref

    out = {}
    a, kw = probe
    hit, slot = cache_probe_ref(*a, **kw)
    t = timings(lambda: cp_ops.cache_probe(*a, **kw), lambda: cache_probe_ref(*a, **kw))
    bms, by = bound_ms(*probe_bound(a, hit, slot, kw["probes"]))
    print(f"kernel cache_probe {tag} largest keys={a[4].shape[0]} cap={a[0].shape[0]} "
          f"hits={int(hit.sum())} {fmt_us(t)} bound_us={bms * 1e3:.4f} ({by})", flush=True)
    out["cache_probe"] = dict(t, bound_ms=bms, shape=f"keys={a[4].shape[0]},cap={a[0].shape[0]}")
    for label, (a, kw) in gathers.items():
        want = block_gather_filter_ref(*a, **kw)
        t = timings(lambda: bg_ops.block_gather(*a, **kw),
                    lambda: block_gather_filter_ref(*a, **kw))
        nbytes, ops = block_gather_bound(a, kw, want)
        bms, by = bound_ms(nbytes, ops)
        B, W = want[0].shape
        shape = f"{label}:rows={B},lanes={W},EB={kw['e_blk_cap']}"
        print(f"kernel block_gather {tag} {shape} csr_len={int(a[9])} blk_len={int(a[10])} "
              f"scanned={int(want[1].sum())} recent_scanned={int(want[1][:, kw['max_deg']:].sum())} "
              f"{fmt_us(t)} bound_us={bms * 1e3:.4f} ({by}, {nbytes} B)", flush=True)
        out[f"block_gather_{label}"] = dict(t, bound_ms=bms, shape=shape)
    return out


BG_ARGS = ("indptr", "key", "other", "label", "alive", "props", "vlabel", "valive", "vprops",
           "csr_len", "blk_len", "roots", "lroot", "rvalid", "cvalid", "rmask", "r_ok",
           "pe_bound", "pl_bound")  # block_gather's positional arguments


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
    check_probe_calls(calls, "the partitioned path")
    a, kw = max(calls, key=lambda c: c[0][4].shape[0])
    hit, slot = cache_probe_ref(*a, **kw)
    t = timings(lambda: cp_ops.cache_probe(*a, **kw), lambda: cache_probe_ref(*a, **kw))
    nbytes, ops = probe_bound(a, hit, slot, kw["probes"])
    bms, by = bound_ms(nbytes, ops)
    print(f"kernel cache_probe partitioned calls={len(calls)} (all equal) largest keys="
          f"{a[4].shape[0]} cap={a[0].shape[0]} hits={int(hit.sum())} {fmt_us(t)} "
          f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B) {one_fill_us(slot)}",
          flush=True)

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
    row = max(rows, key=lambda r: r[0])[1]
    row["diagnosis"] = diagnose_block_gather(*max(largest.values(), key=lambda c: c[0][11].shape[0]))
    check_block_gather_shapes(a[0].device)
    return row


def synthetic_block(rng, B, max_deg, R, EB, csr_len, blk_len, dev, v_loc=4096, v_cap=1 << 14):
    """One orientation's operands, made from ``rng``: CSR windows of 0-12
    edges and some over max_deg, a recent region [csr_len, blk_len) whose
    keys hit the batch's roots, lroot values that wrap, clamp and overflow,
    literal and wildcard predicates over random properties."""
    deg = rng.integers(0, 13, v_loc)
    deg[rng.random(v_loc) < 0.02] = max_deg + 3
    indptr = np.minimum(np.concatenate([[0], np.cumsum(deg)]), csr_len).astype(np.int32)
    roots = rng.integers(0, v_cap, B).astype(np.int32)
    key = rng.integers(0, v_cap, EB).astype(np.int32)
    lo, hi = max(csr_len, 0), min(blk_len, EB)
    key[lo:hi] = roots[rng.integers(0, B, max(hi - lo, 0))]
    lroot = rng.integers(0, v_loc, B).astype(np.int32)
    lroot[:4] = [-1, -(v_loc + 3), v_loc, 2**31 - 1][:B]
    arrs = [indptr, key, rng.integers(-2, v_cap + 3, EB).astype(np.int32),
            rng.integers(0, 2, EB).astype(np.int32), rng.random(EB) < 0.9,
            rng.integers(0, 4, (EB, 2)).astype(np.int32), rng.integers(0, 2, v_cap).astype(np.int32),
            rng.random(v_cap) < 0.9, rng.integers(0, 4, (v_cap, 3)).astype(np.int32),
            np.array(csr_len, np.int32), np.array(blk_len, np.int32), roots, lroot,
            rng.random(B) < 0.9, rng.random(B) < 0.8, rng.random(B) < 0.9, rng.random(B) < 0.8,
            rng.integers(0, 4, (B, 3)).astype(np.int32), rng.integers(0, 4, (B, 3)).astype(np.int32)]
    kw = dict(max_deg=max_deg, recent_cap=R, e_blk_cap=EB, edge_label=0,
              pe=(-1, ((0, 0, 3, 2, False),)), pl=(1, ((0, 1, 0, 0, True),)))
    return [torch.as_tensor(x).to(dev) for x in arrs], kw


def check_block_gather_shapes(dev):
    """``block_gather`` on shapes the path does not give it, each held
    equal to the plain version: W off the 4-lane chunk (the lane-by-lane
    stores), ``max_deg`` off it (a chunk straddles the regions), a clamped
    window (``csr_len > EB - R``), a region shorter than the window, B = 1
    and B off the 16-row tile, a window that fits 48 KB of shared memory
    only without the kernel's static arrays (R = 5,820), and one wider than
    48 KB."""
    from repro_torch.kernels.block_gather.kernel import block_gather_cuda
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref

    rng = np.random.default_rng(17)
    cases = [(1000, 60, 1001, 1 << 20, 500_000, 500_900), (333, 62, 1026, 1 << 20, 400_000, 401_100),
             (17, 64, 1024, 1 << 16, (1 << 16) - 300, 1 << 16), (1, 20, 40, 4096, 2000, 2030),
             (4099, 64, 1024, 1 << 20, 300_000, 300_500), (40, 16, 8192, 1 << 20, 200_000, 205_000),
             (50, 64, 5820, 1 << 20, 100_000, 104_000)]
    scanned = 0
    for B, max_deg, R, EB, cl, bl in cases:
        x, kw = synthetic_block(rng, B, max_deg, R, EB, cl, bl, dev)
        got, want = block_gather_cuda(x[:11], x[11:], **kw), block_gather_filter_ref(*x, **kw)
        for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want):
            assert torch.equal(g, w), f"block_gather {name} disagrees at B={B} max_deg={max_deg} R={R}"
        scanned += int(want[1].sum())
    print(f"block_gather synthetic shapes: {len(cases)} equal (scanned lanes {scanned})", flush=True)


def diagnose_block_gather(a, kw):
    """What binds ``block_gather``: the path's largest call (a) as it was
    made, (b) with ``rmask`` all false (no filter work: liveness and writes
    alone), (c) with ``rvalid`` and ``cvalid`` all false (the leaf ids and
    zero masks alone), (d) as made but with no edge label and empty edge and
    leaf predicates (the executed rows' liveness without their filters).
    Each input is held equal to the plain version on the kernel and on the
    per-lane design it replaced (the yardstick), and both are timed on the
    device beside the input's bound and beside ``zero_`` over the same five
    outputs (the card's rate for writing those bytes)."""
    from repro_torch.kernels.block_gather.kernel import LANE_LAUNCH, block_gather_cuda
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref

    us = lambda ms: None if ms is None else ms * 1e3
    no_preds = dict(kw, edge_label=-1, pe=(-1, ()), pl=(-1, ()))
    variants = (("a", (), kw, "as made"), ("b", ("rmask",), kw, "rmask false"),
                ("c", ("rvalid", "cvalid"), kw, "rvalid, cvalid false"),
                ("d", (), no_preds, "no predicates"))
    out = {}
    for tag, zeroed, kwv, what in variants:
        x = list(a)
        for name in zeroed:
            i = BG_ARGS.index(name)
            x[i] = torch.zeros_like(x[i])
        want = block_gather_filter_ref(*x, **kwv)
        kernel = lambda: block_gather_cuda(x[:11], x[11:], **kwv)
        lane = lambda: block_gather_cuda(x[:11], x[11:], symbol=LANE_LAUNCH, **kwv)
        for fn in (kernel, lane):
            got = fn()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                f"block_gather diagnosis ({tag}) disagrees with the plain version"
        fill = [torch.empty_like(w) for w in want]
        d = dict(device_us=us(device_ms(kernel)), lane_device_us=us(device_ms(lane)),
                 zero_fill_us=us(device_ms(lambda: [f.zero_() for f in fill])),
                 bound_us=bound_ms(*block_gather_bound(x, kwv, want))[0] * 1e3,
                 executed_rows=int(x[BG_ARGS.index("rmask")].sum()), scanned=int(want[1].sum()))
        print(f"block_gather diagnosis ({tag}) rows={want[0].shape[0]} {what}: "
              + " ".join(f"{k}={'not measured' if v is None else round(v, 3)}" for k, v in d.items()),
              flush=True)
        out[tag] = d
    return out


# ------------------------------------------------------------ durability
# Phase 11: block maintenance and durability on the phase-7 store (4 owners,
# e_blk_cap 2^24, recent windows of 1,024), against a control runtime that
# takes the same commits with no gate and no maintenance.
D_COMMITS = 32  # W-hat gRW-Txs of the phase: what its ~300 s allow
# the gate compacts a block at its first recent lane (ceil(frac * 1,024) =
# 1), so each block's gate fires at every commit that appends to it
D_GATE_FRAC = 1 / 1024
D_CKPT_EVERY = 8  # the reference serve loop's --checkpoint-every default
D_FLUSH_S = 0.005  # the reference serve loop's flusher interval
# the one purge, the forced tick and the growth all come after the last
# checkpoint (commit 24), so replay repeats a COMMIT with purge, a COMPACT
# and a GROW record; the purge commit's gate compacts every block with purge
D_PURGE_AT = 25
D_TICK_AT = 26  # a host maintenance_tick forces a compaction after this commit
D_GROW_AT = 28  # grow_blocks after this commit, at the batch boundary
D_GROW_TO = (1 << 24) + (1 << 22)
# the write-through stretch (both runtimes): commits 21-28, across the last
# checkpoint, so replay repeats part of it
D_THROUGH = range(21, 29)
D_AFTER_READS = 4  # read batches on the replayed store


class MaintenanceKernelCheck:
    """Holds every ``block_gather`` and ``cache_probe`` call of phase 11 to
    its plain version, batch by batch, and keeps for timing the largest
    ``block_gather`` call over compacted blocks (an empty recent window) at
    the phase's first ``e_blk_cap``, the largest over grown blocks, and the
    largest ``cache_probe`` call. The comparison launches are taken back off
    the kernels' counts."""

    def __init__(self, eb0):
        self.eb0 = eb0
        self.calls = {"cache_probe": 0, "compacted": 0, "recent": 0, "grown": 0}
        self.largest = {}

    def _keep(self, kind, call, rows):
        if kind not in self.largest or rows > self.largest[kind][1]:
            self.largest[kind] = (call, rows)

    def check(self, capture, inc_keys):
        """Checks and clears the captured calls; returns the distinct roots
        the ``block_gather`` calls read (rows with ``rmask``), ``[out,
        inc]`` (a call reads ``inc`` where its ``key`` is in ``inc_keys``)."""
        from repro_torch.kernels.block_gather import ops as bg_ops
        from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
        from repro_torch.kernels.cache_probe import ops as cp_ops

        counts = (bg_ops.launches, cp_ops.launches)
        probes = capture.calls["cache_probe"]
        if probes:
            check_probe_calls(probes, "phase 11")
        for a, kw in probes:
            self.calls["cache_probe"] += 1
            self._keep("cache_probe", (a, kw), a[4].shape[0])
        roots = ([torch.empty(0, dtype=torch.int32)], [torch.empty(0, dtype=torch.int32)])
        for a, kw in capture.calls["block_gather"]:
            roots[a[BG_ARGS.index("key")].data_ptr() in inc_keys].append(
                a[BG_ARGS.index("roots")][a[BG_ARGS.index("rmask")]].to(torch.int32))
            got, want = bg_ops.block_gather(*a, **kw), block_gather_filter_ref(*a, **kw)
            for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want):
                assert torch.equal(g, w), f"block_gather {name} disagrees with its plain " \
                    "version in phase 11"
            if kw["e_blk_cap"] != self.eb0:
                kind = "grown"
            else:
                kind = "compacted" if bool(a[9] == a[10]) else "recent"
            self.calls[kind] += 1
            self._keep(kind, (a, kw), a[11].shape[0])
        for calls in capture.calls.values():
            calls.clear()
        bg_ops.launches, cp_ops.launches = counts
        return [torch.unique(torch.cat([x.to(r[-1].device) for x in r])) for r in roots]


def read_layout(pspec, ps):
    """Each vertex's CSR degree and recent lanes in both orientations (out,
    inc) of a partitioned store: ``[(deg [V], recent [V]), ...]``."""
    n, EB, V = pspec.n_shards, pspec.e_blk_cap, pspec.base.v_cap
    lanes = torch.arange(EB, device=ps.version.device)
    lay = []
    for b in (ps.out, ps.inc):
        ip = b.indptr.view(n, -1)
        deg = (ip[:, 1:] - ip[:, :-1]).t().reshape(-1)[:V]  # shard s, local l: v = l*n + s
        region = (lanes >= b.csr_len[:, None]) & (lanes < b.blk_len[:, None])
        lay.append((deg, torch.bincount(b.key.view(n, EB)[region].long(), minlength=V)[:V]))
    return lay


def crossing_masks(max_deg, lay_a, lay_b):
    """Per orientation, the vertices whose one-hop reads may differ between
    two layouts of the same edges, by the rule both packages share: a read
    truncates where the CSR degree alone passes ``max_deg``, so a vertex
    whose lanes the two layouts place apart (CSR degree or recent lanes)
    reads alike only while both degrees stay within ``max_deg``."""
    return [((da > max_deg) | (db > max_deg)) & ((da != db) | (ra != rb))
            for (da, ra), (db, rb) in zip(lay_a, lay_b)]


def one_hop_reads(pspec, ps, roots, max_deg, incoming):
    """Each root's one-hop reads in one orientation through the plain
    gather: its live lanes' (leaf, label, props) in read order, -1 past
    them, and its truncation flag; roots in shard order."""
    from repro_torch.graphstore.partition import BlockStoreView, local_shard

    out = []
    for s in range(pspec.n_shards):
        view = BlockStoreView(pspec, local_shard(pspec, ps, s), s)
        other, mask, trunc, elabel, eprops = view.adjacency(
            roots[roots % pspec.n_shards == s], max_deg, incoming=incoming)
        v = torch.where(mask[..., None], torch.cat([other[..., None], elabel[..., None], eprops],
                                                   -1), -1)
        order = torch.sort((~mask).to(torch.int8), dim=1, stable=True).indices
        out += [torch.take_along_dim(v, order[..., None], 1), trunc]
    return out


def crossing_roots(max_deg, runtimes, stores, roots_by_dir) -> int:
    """How many (root, orientation) reads of ``roots_by_dir`` (``[out,
    inc]``) may differ between the two stores (by ``crossing_masks``). Every other root's one-hop reads
    must be equal on both: so a read batch that differs between them
    differs through the crossing roots alone."""
    (ra, rb), (sa, sb) = runtimes, stores
    risks = crossing_masks(max_deg, read_layout(ra.pspec, sa), read_layout(rb.pspec, sb))
    n = 0
    for incoming, (roots, risk) in enumerate(zip(roots_by_dir, risks)):
        roots = roots.to(risk.device)
        roots = roots[roots >= 0]
        keep = roots[~risk[roots.long()]]
        n += roots.numel() - keep.numel()
        got = (one_hop_reads(r.pspec, st, keep, max_deg, bool(incoming))
               for r, st in zip(runtimes, stores))
        for x, y in zip(*got):
            assert torch.equal(x, y), "phase 11: a root within max_deg on both stores reads " \
                "differently on the gated store and the control"
    return n


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def run_durability(seed, espec, hstore, pstore, ttable, plans, meta, ranges, includes, dev):
    """Phase 11: D_COMMITS W-hat gRW-Txs on the phase-7 partitioned store
    through ``run_grw_tx(gate=DeviceGate(D_GATE_FRAC), journal=...)`` (the
    write-behind journal's flusher running), each followed by a 512-root
    read batch with CP; checkpoints every D_CKPT_EVERY commits (the first
    full), then one purge behind the epoch registry, a forced
    ``maintenance_tick`` and ``grow_blocks`` to D_GROW_TO lanes; the
    D_THROUGH commits under write-through. A control runtime takes the same
    commits with no gate and no maintenance: every commit's ``impacted_keys``
    must be equal on both, and so must every read batch (results, misses,
    metrics) unless a root it read crosses ``max_deg`` differently on the
    two stores (``crossing_roots``, which holds every other root's one-hop
    reads equal); every kernel call equal to its plain version. Then the
    crash (the runtime and journal objects dropped, torn bytes at the log's
    tail) and ``replay`` on a fresh runtime, through COMMIT, COMPACT and
    GROW records: the replayed store must equal the live one field for
    field, D_AFTER_READS read batches equal the control's as above, and the
    first incremental checkpoint after it falls back to full (the growth).
    Returns the phase's report and kernel timings."""
    import shutil
    import tempfile

    import repro_torch.core.cache as cache_mod
    from repro_torch.checkpoint import CODEC
    from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, flat_mesh
    from repro_torch.graphstore import (
        DeviceGate, EdgeBlock, MaintenancePolicy, WriteBehindJournal, local_shard,
        make_mutation_batch, replay,
    )
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.cache_probe import ops as cp_ops

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 41)
    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)
    # the deletes name live includes of the 64 Zipf-hottest watch-lists, and
    # never one deleted before: purge's contract (a purged geid would
    # resolve to "not found" where the control finds its tombstone)
    hot = torch.as_tensor(includes, device=dev)
    hot = hot[(hstore.esrc[hot] < ranges[L_WATCHLIST][0] + P_HOT_WATCHLISTS)
              & hstore.ealive[hot]].cpu().numpy()
    alive_hot = list(hot)

    def write_batch():
        while True:
            kind = kinds[int(rng.choice(len(kinds), p=wweights))]
            if kind == "del_edges":
                picks = sorted(rng.choice(len(alive_hot), size=int(rng.integers(1, 4)),
                                          replace=False), reverse=True)
                eids = [int(alive_hot.pop(i)) for i in picks]
                return make_mutation_batch(espec.store, del_edges=eids, device=dev)
            mb = make_write(rng, espec, ranges, None, kind, dev)
            if mb is not None:
                return mb

    mesh = flat_mesh(N_OWNERS)
    rt, ctl = (ShardedTxnRuntime(espec, mesh, device=dev) for _ in range(2))
    eb0 = rt.pspec.e_blk_cap
    # commits are functional: both runtimes start from the phase-7 store itself
    ps, cs = pstore, pstore
    caches = [rt.empty_cache(), ctl.empty_cache()]
    drains = [ShardedMissDrain(rt, meta), ShardedMissDrain(ctl, meta)]
    capture = CallCapture((bg_ops, "block_gather"), (cache_mod, "cache_probe"))
    kcheck = MaintenanceKernelCheck(eb0)
    root = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    free_gib = shutil.disk_usage(root).free / 2**30
    t0 = time.perf_counter()
    j = WriteBehindJournal(root, rt.n)
    j.start(interval=D_FLUSH_S)
    ckpts = []

    def checkpoint(kind_asked, j, rt, ps):
        t = time.perf_counter()
        fn = j.checkpoint if kind_asked == "full" else j.checkpoint_incremental
        path = fn(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                  store_version=int(ps.version))
        ckpts.append(dict(seq=j.checkpoint_seq, kind=j.checkpoint_meta(j.checkpoint_seq)["kind"],
                          seconds=time.perf_counter() - t, bytes=dir_bytes(path)))

    checkpoint("full", j, rt, ps)
    print(f"durability: journal in {root} ({free_gib:.1f} GiB free; codec {CODEC}), flusher "
          f"every {D_FLUSH_S}s, first checkpoint {ckpts[0]}", flush=True)

    def lens(store):
        return torch.stack([store.out.csr_len, store.out.blk_len, store.inc.csr_len,
                            store.inc.blk_len]).cpu().numpy()

    plan_cycle = [(n, p, label) for n, p, label, _ in plans]
    crossing, differing = [], []  # per read batch: crossing roots; batches that differed

    def read_both(i, runtimes, stores, caches_, drains_, epochs):
        """One read batch on both runtimes, each under a pinned epoch, with
        CP on both; the kernels' calls checked; every result, miss and
        metric equal unless a root read crosses ``max_deg`` differently on
        the two stores."""
        name, plan, label = plan_cycle[i % len(plan_cycle)]
        roots = zipf_pick(rng, *ranges[label], BATCH)
        outs = []
        with capture:
            for k, (r, s) in enumerate(zip(runtimes, stores)):
                with epochs.pin_scope():
                    res, ms, met = r.run_gr_tx_batch(s, caches_[k], ttable, plan, roots)
                assert met["route_overflow"] == 0, f"phase 11 read {i}: route_overflow"
                drains_[k].push(sorted(ms, key=lambda m: miss_key([m]))[:P_CP_PER_BATCH])
                caches_[k] = drains_[k].drain(s, s, caches_[k], ttable, k=1 << 30)
                met.pop("host_syncs")
                outs.append((res, miss_key(ms), met))
        inc_keys = {local_shard(r.pspec, st, sh).inc.key.data_ptr()
                    for r, st in zip(runtimes, stores) for sh in range(N_OWNERS)}
        cross = crossing_roots(espec.max_deg, runtimes, stores, kcheck.check(capture, inc_keys))
        crossing.append(cross)
        (ra, ma, ta), (rb, mb_, tb) = outs
        if not (np.array_equal(ra, rb) and ma == mb_ and ta == tb):
            # compaction changes a read only past max_deg (both packages
            # alike): a difference needs a crossing root to explain it
            assert cross > 0, f"phase 11 read {i} ({name}): differs from the control (metrics " \
                f"{ta} vs {tb}), and no root it read crosses max_deg differently"
            differing.append(dict(read=i, crossing_roots=cross))
        return ta["hits"]

    lat = {"gated": [], "gated_compacting": [], "gated_plain": [], "ungated": []}
    syncs = {"gated": [], "ungated": []}
    # the D_GATE_FRAC gate's compactions per (shard, out/in), the purge's apart
    compactions = np.zeros((N_OWNERS, 2), np.int64)
    device_compactions, purge_compactions, hits, grow, tick = 0, 0, 0, None, None
    cp_ops.launches = bg_ops.launches = 0
    for i in range(1, D_COMMITS + 1):
        mb = write_batch()
        purge = i == D_PURGE_AT
        if purge:
            assert j.epochs.safe_to_purge(j.epochs.current, j), \
                f"commit {i}: the epoch registry does not allow the purge"
        gate = DeviceGate(0.0, purge=True) if purge else DeviceGate(D_GATE_FRAC)
        policy = "write-through" if i in D_THROUGH else "write-around"
        before = lens(ps)
        t = time.perf_counter()
        ps, caches[0], mg = rt.run_grw_tx(ps, caches[0], ttable, mb, policy, gate=gate,
                                          journal=j)
        dt = (time.perf_counter() - t) * 1e3
        lat["gated"].append(dt)
        lat["gated_compacting" if mg["device_compactions"] else "gated_plain"].append(dt)
        t = time.perf_counter()
        cs, caches[1], mu = ctl.run_grw_tx(cs, caches[1], ttable, mb, policy)
        lat["ungated"].append((time.perf_counter() - t) * 1e3)
        syncs["gated"].append(mg["host_syncs"])
        syncs["ungated"].append(mu["host_syncs"])
        assert mg["impacted_keys"] == mu["impacted_keys"], \
            f"commit {i}: impacted {mg['impacted_keys']} != control {mu['impacted_keys']}"
        assert mg["op_overflow"] == mu["op_overflow"] == 0 and \
            mg["store_append_overflow"] == mu["store_append_overflow"] == 0, f"commit {i}: overflow"
        # which blocks the gate compacted: a compaction moves csr_len to the
        # block's length, and nothing else moves csr_len
        after = lens(ps)
        moved = np.stack([after[0] != before[0], after[2] != before[2]], axis=1)
        if purge:
            assert mg["device_compactions"] == 2 * N_OWNERS, f"commit {i}: purge {mg}"
            purge_compactions = mg["device_compactions"]
        else:
            assert int(moved.sum()) == mg["device_compactions"], \
                f"commit {i}: {mg['device_compactions']} compactions, {int(moved.sum())} moved"
            compactions += moved
        device_compactions += mg["device_compactions"]
        hits += read_both(i, (rt, ctl), (ps, cs), caches, drains, j.epochs)
        if i == D_TICK_AT:
            ps, tick = rt.maintenance_tick(ps, MaintenancePolicy(recent_fill_frac=0.0),
                                           journal=j)
            assert tick["compacted"] and tick["grown_to"] is None, tick
        if i == D_GROW_AT:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ps = rt.grow_blocks(ps, D_GROW_TO)
            torch.cuda.synchronize()
            grow = dict(seconds=time.perf_counter() - t, e_blk_cap=rt.pspec.e_blk_cap)
            j.append_grow(rt.pspec.e_blk_cap, rt.pspec.recent_blk_cap)
        if i % D_CKPT_EVERY == 0 and i < D_COMMITS:
            checkpoint("incremental", j, rt, ps)
    live_s = time.perf_counter() - t0
    launches = {"block_gather": bg_ops.launches, "cache_probe": cp_ops.launches}
    assert launches["block_gather"] > 0 and launches["cache_probe"] > 0, \
        f"phase 11 launched a kernel no time: {launches}"
    assert (compactions > 0).all(), f"a block's gate never compacted it: {compactions.tolist()}"
    # the first checkpoint is full, the rest chain on it (the growth comes after them)
    assert [c["kind"] for c in ckpts] == ["full"] + ["incremental"] * (
        (D_COMMITS - 1) // D_CKPT_EVERY), ckpts
    j.stop(final_flush=True)
    jm = j.metrics()
    assert jm["journal_lag_batches"] == 0 and jm["flush_failures"] == 0, jm
    occ = rt.store_occupancy(ps)
    assert occ["max_recent_fill"] == 0, occ  # the gate leaves no recent lane behind

    # the maintenance pass's device time at full size, on the live store
    compact_ms = device_ms(lambda: rt.compact_step(False)(ps), iters=3)

    # 4. the crash: runtime and journal objects dropped, torn bytes on the log
    with open(j.log_path, "ab") as f:
        f.write(b"GJL2" + b"\x01" * 9)
    log_bytes = os.path.getsize(j.log_path)
    live, pspec_live = ps, rt.pspec
    del rt, j, drains, caches

    # 5. recovery on a fresh runtime and journal
    gc.collect()
    torch.cuda.synchronize()
    rt2 = ShardedTxnRuntime(espec, mesh, device=dev)
    t = time.perf_counter()
    j2 = WriteBehindJournal(root, rt2.n)
    ps2, last, info = replay(j2, rt2, ttable)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t
    assert rt2.pspec == pspec_live, (rt2.pspec, pspec_live)
    assert info == dict(
        replayed_commits=D_COMMITS - D_CKPT_EVERY * ((D_COMMITS - 1) // D_CKPT_EVERY),
        replayed_compactions=1, replayed_growths=1, replayed_migrations=0), info
    for f in live._fields:
        a, b = getattr(ps2, f), getattr(live, f)
        for name, x, y in (zip(EdgeBlock._fields, a, b) if isinstance(b, EdgeBlock)
                           else [(f, a, b)]):
            assert torch.equal(x, y), f"the replayed store's {f}.{name} differs from the live one"
    del live
    caches = [rt2.empty_cache(), ctl.empty_cache()]
    drains = [ShardedMissDrain(rt2, meta), ShardedMissDrain(ctl, meta)]
    for i in range(D_AFTER_READS):
        hits += read_both(D_COMMITS + 1 + i, (rt2, ctl), (ps2, cs), caches, drains, j2.epochs)
    launches = {"block_gather": bg_ops.launches, "cache_probe": cp_ops.launches}
    # the recovered store's first checkpoint: the chain's layout predates the
    # growth, so the incremental one falls back to full
    checkpoint("incremental", j2, rt2, ps2)
    assert ckpts[-1]["kind"] == "full", ckpts[-1]

    # 6. clean up
    written = dir_bytes(root)
    shutil.rmtree(root)
    report = dict(
        commits=D_COMMITS, write_through_commits=[i for i in D_THROUGH if i <= D_COMMITS],
        gate_frac=D_GATE_FRAC, gate_lanes=int(np.ceil(D_GATE_FRAC * 1024)),
        codec=CODEC, live_seconds=live_s, device_compactions=device_compactions,
        gate_compactions_per_block_out_in=compactions.tolist(),
        purge_commit=dict(commit=D_PURGE_AT, compactions=purge_compactions),
        gated_p50_ms=pct(lat["gated"], 50), gated_p90_ms=pct(lat["gated"], 90),
        ungated_p50_ms=pct(lat["ungated"], 50), ungated_p90_ms=pct(lat["ungated"], 90),
        gated_compacting_p50_ms=pct(lat["gated_compacting"], 50),
        gated_compacting_commits=len(lat["gated_compacting"]),
        gated_plain_p50_ms=pct(lat["gated_plain"], 50),
        host_syncs_per_commit_gated=float(np.mean(syncs["gated"])),
        host_syncs_per_commit_ungated=float(np.mean(syncs["ungated"])),
        tick=dict(commit=D_TICK_AT, **tick), grow=dict(commit=D_GROW_AT, **grow),
        e_blk_cap=pspec_live.e_blk_cap, compact_step_device_ms=compact_ms,
        checkpoints=ckpts, replay_seconds=replay_s, replay=info, replay_last_seq=last,
        journal=jm, log_bytes=log_bytes, bytes_written=written, read_hits=hits,
        launches=launches, kernel_calls=kcheck.calls, crossing_roots_per_read=crossing,
        reads_differing_from_control=differing,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
        seconds=time.perf_counter() - t_phase,
    )
    print("durability: " + json.dumps(report), flush=True)
    print(f"durability commits ms, gated (journal, gate) p50 {report['gated_p50_ms']:.3f} p90 "
          f"{report['gated_p90_ms']:.3f} | ungated p50 {report['ungated_p50_ms']:.3f} p90 "
          f"{report['ungated_p90_ms']:.3f}; host_syncs a commit gated "
          f"{report['host_syncs_per_commit_gated']:.3f} ungated "
          f"{report['host_syncs_per_commit_ungated']:.3f}", flush=True)
    print(f"durability gate: compactions per block (out, in) {compactions.tolist()} "
          f"({int(compactions.sum())} in all); the purge at commit {D_PURGE_AT} compacted "
          f"{purge_compactions} blocks; the tick at {D_TICK_AT}, grow_blocks at {D_GROW_AT} "
          f"{grow['seconds']:.6f}s", flush=True)
    print(f"durability reads vs control: {len(crossing)} batches, roots crossing max_deg "
          f"differently {sum(crossing)} (per batch {crossing}), batches differing "
          f"{len(differing)} {differing}", flush=True)
    print(f"durability recovery: replay {replay_s:.3f}s ({info}), checkpoints "
          f"{[(c['kind'], round(c['seconds'], 3), c['bytes']) for c in ckpts]}, "
          f"bytes written {written}", flush=True)
    print(f"kernel block_gather durability calls over compacted blocks={kcheck.calls['compacted']} "
          f"recent={kcheck.calls['recent']} grown={kcheck.calls['grown']}; cache_probe "
          f"calls={kcheck.calls['cache_probe']} (all equal)", flush=True)
    assert kcheck.calls["compacted"] > 0 and kcheck.calls["grown"] > 0, kcheck.calls
    return report, time_kernel_calls(
        "durability", kcheck.largest["cache_probe"][0],
        {kind: kcheck.largest[kind][0] for kind in ("compacted", "grown")})


# Phase 12: the serve loop (repro_torch.launch.serve.serve_loop) on the
# phase-7 store (4 owners), with telemetry, the maintenance gate and the
# write-behind journal at the reference serve loop's settings.
S_BATCHES = 48  # gR batches of the loop (a serving loop runs thousands)
S_WRITE_EVERY = 2  # a W-hat commit every 2 batches: 24 commits
S_CKPT_EVERY = 8  # the reference serve loop's --checkpoint-every default
S_SNAPSHOT_EVERY = 8  # a telemetry snapshot every 8 batches: 6 snapshots
S_SPAN_PER_BATCH = ("gr_dispatch", "gr_sync", "gr_unpack", "cp_drain")
# a column of the owner-stage block and the report counter it sums to
S_COLUMN_SUMS = {"probe_hits": "hits", "miss_rows": "misses", "edges_scanned": "edges_scanned",
                 "leaf_fetches": "leaf_fetches", "route_overflow": "route_overflow",
                 "deferred_rows": "deferred"}


def hold_partitioned_entries(rt, hstore, pcache, plans, dev):
    """Every valid entry of the partitioned cache, owner block by owner
    block, against a fresh one-hop execution of its key on the single-host
    store; under write-around the leaves must come in the fresh order too.
    Returns the entries checked."""
    from repro_torch.core.cache import cache_shard

    checked = 0
    for s in range(rt.n):
        _, n, reordered = hold_write_through_entries(
            rt.lspec, hstore, cache_shard(pcache, rt.n, s), plans, dev)
        assert reordered == 0, f"phase 12: {reordered} entries of owner {s} list their leaves " \
            "in another order than a fresh execution"
        checked += n
    return checked


def run_serve(seed, espec, hstore, pstore, ttable, plans, meta, ranges, includes, dev):
    """Phase 12: S_BATCHES gR batches of BATCH Zipf roots over the six read
    plans in turn, each followed by its per-owner CP drain, and a W-hat
    commit every S_WRITE_EVERY batches, through the port's serve loop
    (``launch.serve.serve_loop``) on the phase-7 partitioned store, with
    the reference serve loop's settings (gate 0.5, growth at 0.85 occupancy,
    an incremental checkpoint every S_CKPT_EVERY commits on a full one, the
    flusher behind the loop), a snapshot every S_SNAPSHOT_EVERY batches and
    the trace to a temporary JSONL. The same commits go to the single-host
    control store. Checks: (a) the trace validates, with its snapshots,
    report and spans; (b) the report's owner-stage columns sum to its
    counters; (c) one batch run with telemetry on and off gives the same
    results, metrics and collectives; (d) neither the gate nor the growth
    fired, the partitioned store equals the control's partition and every
    cache entry a fresh execution; (e) every
    kernel call of the first two batches and of the commit between them
    equals its plain version; (f) the journal is drained and no pin open.
    Returns the phase's report."""
    import shutil
    import tempfile

    import repro_torch.core.cache as cache_mod
    from repro_torch.core import run_grw_tx
    from repro_torch.distributed import ShardedTxnRuntime, flat_mesh
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.launch import serve
    from repro_torch.obs.metrics import OWNER_STAGE_FIELDS
    from repro_torch.obs.schema import LATENCY_CLASSES
    from repro_torch.obs.telemetry import ServeTelemetry
    from repro_torch.obs.validate import validate_file

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 51)
    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)
    hot = torch.as_tensor(includes, device=dev)
    hot = hot[hstore.esrc[hot] < ranges[L_WATCHLIST][0] + P_HOT_WATCHLISTS].cpu().numpy()
    plan_cycle = [(p, label) for _, p, label, _ in plans]

    # (c) one batch with telemetry on and off, on runtimes of their own: the
    # same results, metrics (host reads included) and collectives, and no
    # block when off. It also makes the loop's first batch a warm one.
    roots = zipf_pick(rng, *ranges[L_WATCHLIST], BATCH)
    seen = {}
    for on in (True, False):
        r = ShardedTxnRuntime(espec, flat_mesh(N_OWNERS), device=dev, telemetry=on)
        res, ms, met = r.run_gr_tx_batch(pstore, r.empty_cache(), ttable, plans[0][1], roots)
        seen[on] = (res, miss_key(ms), met, dict(r.mesh.counts), r.last_owner_stage)
    assert np.array_equal(seen[True][0], seen[False][0]) and seen[True][1:4] == seen[False][1:4], \
        f"phase 12: telemetry changes a batch: {seen[True][2:4]} vs {seen[False][2:4]}"
    assert seen[False][4] is None and seen[True][4].shape == (N_OWNERS, len(OWNER_STAGE_FIELDS))

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    trace = os.path.join(root, "trace.jsonl")
    args = serve.parse_args([
        "--shards", str(N_OWNERS), "--batches", str(S_BATCHES), "--batch", str(BATCH),
        "--write-every", str(S_WRITE_EVERY), "--checkpoint-every", str(S_CKPT_EVERY),
        "--snapshot-every", str(S_SNAPSHOT_EVERY), "--trace", trace,
        "--journal-dir", os.path.join(root, "journal"), "--device", dev])
    telemetry = ServeTelemetry(N_OWNERS, trace_path=trace)
    rt = ShardedTxnRuntime(espec, flat_mesh(N_OWNERS), device=dev, tracer=telemetry.tracer)
    capture = CallCapture((bg_ops, "block_gather"), (cache_mod, "cache_probe"))
    marks, commits = {}, []
    # every loop batch's exact gR step seconds, hits and misses, which the
    # class histograms keep only as log-bucket midpoints
    steps, record_gr = [], telemetry.record_gr

    def record_exact(step_seconds, m, owner_stage=None):
        steps.append((step_seconds, int(m.get("hits", 0)), int(m.get("misses", 0))))
        return record_gr(step_seconds, m, owner_stage=owner_stage)

    telemetry.record_gr = record_exact

    def next_batch(b):
        # (e) the kernels' calls of batches 0 and 1 and of the commit after
        # batch 1 are kept, their stages marked
        if b == 0:
            capture.__enter__()
        elif b == 2:
            marks["commit_end"] = {k: len(v) for k, v in capture.calls.items()}
            capture.__exit__(None, None, None)
        plan, label = plan_cycle[b % len(plan_cycle)]
        return plan, zipf_pick(rng, *ranges[label], BATCH)

    def next_commit(b):
        if b == 1:
            marks["commit_start"] = {k: len(v) for k, v in capture.calls.items()}
        while True:
            kind = kinds[int(rng.choice(len(kinds), p=wweights))]
            mb = make_write(rng, espec, ranges, hot, kind, dev)
            if mb is not None:
                commits.append(mb)
                return mb

    cp_ops.launches = bg_ops.launches = 0
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    out = serve.serve_loop(args, rt, pstore, ttable, meta, next_batch, next_commit, telemetry,
                           log=lambda s: print(f"serve loop: {s}", flush=True))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    launches = {"block_gather": bg_ops.launches, "cache_probe": cp_ops.launches}
    assert len(steps) == S_BATCHES, len(steps)
    assert launches["block_gather"] > 0 and launches["cache_probe"] > 0, \
        f"phase 12 launched a kernel no time: {launches}"
    total, rep = out.total, out.report

    # (a) the trace: meta first, the snapshots and the report, the spans
    counts = validate_file(trace, expect_snapshots=S_BATCHES // S_SNAPSHOT_EVERY,
                           expect_report=True)
    assert counts["snapshot"] == S_BATCHES // S_SNAPSHOT_EVERY and counts["report"] == 1, counts
    spans = {}
    with open(trace) as f:
        for line in f:
            ev = json.loads(line)
            if ev["type"] == "span":
                spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    n_commits = S_BATCHES // S_WRITE_EVERY
    want = {**{k: S_BATCHES for k in S_SPAN_PER_BATCH}, "grw_step": n_commits,
            "checkpoint": 1 + n_commits // S_CKPT_EVERY}
    assert {k: spans.get(k, 0) for k in want} == want, f"phase 12 spans {spans} != {want}"
    # (b) the owner-stage columns sum to the report's counters
    cols = {f: sum(row[f] for row in rep["owner_stage"]) for f in OWNER_STAGE_FIELDS}
    for field, counter in S_COLUMN_SUMS.items():
        assert cols[field] == rep["counters"][counter], \
            f"phase 12: owner_stage {field} sums to {cols[field]}, {counter} is " \
            f"{rep['counters'][counter]}"
    assert total["route_overflow"] == 0, f"phase 12: route_overflow {total['route_overflow']}"
    # (f) the journal drained, no pin left open
    for k in ("journal_lag_batches", "flush_queue_depth", "open_pins", "leaked_pin_releases"):
        assert total[k] == 0, f"phase 12: {k} = {total[k]} after the final flush"
    # (d) consistency: neither the gate nor the growth fired (the recent
    # windows stay under half full, occupancy under 0.85), so the store
    # equals the partition of the control's, which takes the same commits;
    # every entry equals a fresh execution
    occ = rt.store_occupancy(out.pstore)
    assert out.maint["device_compactions"] == 0 and out.maint["growths"] == 0, \
        f"phase 12: the gate or the growth fired: {out.maint}"
    hs, hc = hstore, None
    for mb in commits:
        hs, hc, _ = run_grw_tx(espec, hs, cache_mod.empty_cache(espec.cache, device=dev), ttable,
                               mb, "write-around", device=dev)
    stores_equal(rt, out.pstore, hs)
    checked = hold_partitioned_entries(rt, hs, out.cache, plans, dev)
    # (e) every kept kernel call against its plain version
    calls = {k: len(v) for k, v in capture.calls.items()}
    if capture.calls["cache_probe"]:
        check_probe_calls(capture.calls["cache_probe"], "phase 12")
    for a, kw in capture.calls["block_gather"]:
        got, want_ = bg_ops.block_gather(*a, **kw), block_gather_filter_ref(*a, **kw)
        for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want_):
            assert torch.equal(g, w), f"block_gather {name} disagrees with its plain version " \
                "in phase 12"
    stage_calls = {k: dict(reads_and_cp=marks["commit_start"][k],
                           commit=marks["commit_end"][k] - marks["commit_start"][k])
                   for k in calls}
    assert min(calls.values()) > 0, f"phase 12 kept no call of a kernel: {calls}"
    capture.calls.clear()
    shutil.rmtree(root)

    card = card_line()
    step_ms = [s * 1e3 for s, _, _ in steps]
    # the classes' exact quantiles: each batch's step weighted by its hits
    # (gr_cached) or misses (gr_uncached), inverted CDF as the histograms
    exact = {cls: {name: weighted_quantile(step_ms, [x[i] for x in steps], q)
                   for name, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99),
                                   ("p999", 0.999))}
             for cls, i in (("gr_cached", 1), ("gr_uncached", 2))}
    report = dict(
        batches=S_BATCHES, batch=BATCH, commits=n_commits, total=total,
        populated=out.drain.committed, aborted=out.drain.aborted, pending=out.drain.pending(),
        step_p50_ms=pct(step_ms, 50), step_p95_ms=pct(step_ms, 95),
        step_p99_ms=pct(step_ms, 99), step_max_ms=max(step_ms), class_exact_ms=exact,
        maint=out.maint,
        loop_seconds=loop_s, wall_ms_per_batch=loop_s / S_BATCHES * 1e3,
        launches=launches, kernel_calls_checked=stage_calls, entries_checked=checked,
        trace_events=counts, spans=spans, journal=out.journal_metrics,
        occupancy_max=occ["max_occupancy"], recent_fill_max=occ["max_recent_fill"],
        telemetry_off_equal=True, seconds=time.perf_counter() - t_phase,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("serve report: " + json.dumps(report), flush=True)
    print(f"serve: requests={total['requests']} hits={total['hits']} misses={total['misses']} "
          f"populated={out.drain.committed} route_overflow={total['route_overflow']}; gR step "
          f"ms p50 {report['step_p50_ms']:.3f} p95 {report['step_p95_ms']:.3f} p99 "
          f"{report['step_p99_ms']:.3f} max {report['step_max_ms']:.3f}; device compactions "
          f"{out.maint['device_compactions']}, growths {out.maint['growths']}; "
          f"{report['wall_ms_per_batch']:.3f} ms a batch of the loop (CP, commits and "
          f"checkpoints in) | {card}", flush=True)
    for cls in LATENCY_CLASSES:
        p = rep["latency"][cls]
        ms = lambda v: "n/a" if v is None else f"{v * 1e3:.3f}"
        ex = "".join(f" {k} {v:.3f}" for k, v in exact[cls].items()) if cls in exact else ""
        print(f"serve latency[{cls}] ms (bucket midpoints, +-7.5 %): p50 {ms(p['p50'])} p95 "
              f"{ms(p['p95'])} p99 {ms(p['p99'])} p99.9 {ms(p['p999'])} n={p['count']}"
              f"{'; exact' + ex if ex else ''} | {card}", flush=True)
    print(f"serve hit_locality per owner: {[round(v, 4) for v in rep['hit_locality']]}; "
          f"owner_stage {rep['owner_stage']}", flush=True)
    print("serve spans (count, total s): " + json.dumps(
        {k: (v["count"], round(v["total_s"], 6)) for k, v in telemetry.tracer.snapshot().items()}),
        flush=True)
    print(f"serve durability: {json.dumps(out.journal_metrics)}", flush=True)
    print(f"serve checks: trace {counts}, spans {spans}, owner_stage sums equal, telemetry "
          f"off equal, store equal, {checked} entries equal a fresh execution, kernel calls "
          f"{stage_calls} (all equal); phase {report['seconds']:.1f}s, loop {loop_s:.1f}s, "
          f"peak device memory {report['peak_device_gib']:.2f} GiB | {card}", flush=True)
    return report


# ------------------------------------------------------------- failover
# Phase 13: degraded mode, queued writes and recovery on the phase-7 store
# (4 owners, EB 2^24, recent 1,024, cache 4 x 2^16), the reference serve
# loop's failover settings (a detector of fail_threshold 2, a 0.05 s hedge).
F_BATCHES = 16  # gR batches of BATCH Zipf roots over the six plans in turn
F_WRITE_EVERY = 2  # a W-hat commit after every 2nd batch: 8 commits
F_CRASH_OWNER, F_CRASH_AT = 1, 4  # owner 1's storage is lost from batch 4 on
F_RECOVER_AFTER = 4  # degraded batches 5-8, recovery after batch 8's reads
F_HANG_OWNER, F_HANG_AT, F_HANG_S = 2, 11, 2.0  # owner 2 straggles in batch 11
F_STRAGGLE_AFTER, F_HEDGE_AFTER = 1.0, 0.05


def pstores_equal(a, b, where):
    """Two partitioned stores field for field, ``gperm`` included."""
    from repro_torch.graphstore.partition import EdgeBlock

    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        for name, u, v in (zip(EdgeBlock._fields, x, y) if isinstance(x, EdgeBlock)
                           else [(f, x, y)]):
            assert torch.equal(u, v), f"{where}: {f}.{name} differs"


def run_failover(seed, espec, hstore, pstore, ttable, plans, meta, ranges, includes, dev):
    """Phase 13: F_BATCHES gR batches through a ``FailoverController`` on the
    phase-7 partitioned store, each followed by its per-owner CP drain, a
    W-hat commit after every F_WRITE_EVERY-th batch, and owner F_CRASH_OWNER
    crashing at batch F_CRASH_AT, with the write-behind journal (a full
    checkpoint just before the crash). A control runtime takes the same
    commits with no fault. Checks: the crash batch raises ``NodeFailure``;
    on every degraded batch each row not deferred equals a healthy call on
    the same store and cache, rows defer and hits serve, and no miss record
    names a root of the down owner; the store does not move while commits
    queue; after ``recover`` the store equals the control's field for
    field, and every later batch's results, misses and metrics equal the
    control's read on the same cache. Owner F_HANG_OWNER straggles in batch
    F_HANG_AT: the masked hedge wins and the batch after it equals the
    control's, owner-stage block included. Every kernel call of the phase
    equals its plain version. Then ``python -m repro_torch.launch.serve
    --inject-crash 1:3 --recover-after 2`` runs on the card as a subprocess
    and must recover once. Returns the phase's report."""
    import contextlib
    import shutil
    import tempfile

    import repro_torch.core.cache as cache_mod
    from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, base_owner, flat_mesh
    from repro_torch.distributed.failover import FailoverController
    from repro_torch.distributed.fault import (
        FailureDetector, HedgedCalls, NodeFailure, ShardFaultPlan,
    )
    from repro_torch.graphstore import WriteBehindJournal
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.launch.serve import CP_DRAIN_K

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 61)
    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)
    # the deletes draw from the includes of the Zipf-hottest watch-lists, as
    # in phase 12, so that the reads meet them
    hot = torch.as_tensor(includes, device=dev)
    hot = hot[hstore.esrc[hot] < ranges[L_WATCHLIST][0] + P_HOT_WATCHLISTS].cpu().numpy()
    plan_cycle = [(name, p, label) for name, p, label, _ in plans]
    root = tempfile.mkdtemp(prefix="chip_smoke_failover_")
    # rt serves through the controller; rt_c is the control (the same
    # commits, no fault); rt_h makes the healthy reads held against the
    # degraded ones
    rt, rt_c, rt_h = (ShardedTxnRuntime(espec, flat_mesh(N_OWNERS), device=dev) for _ in range(3))
    ps = ps_c = pstore  # commits are functional: all start from the phase-7 store
    cache, cache_c = rt.empty_cache(), rt_c.empty_cache()
    drain = ShardedMissDrain(rt, meta)
    j = WriteBehindJournal(os.path.join(root, "journal"), rt.n)
    j.start(interval=D_FLUSH_S)
    ctl = FailoverController(
        rt, j, ttable,
        plan=ShardFaultPlan(crash={F_CRASH_OWNER: F_CRASH_AT},
                            hang={F_HANG_OWNER: (F_HANG_AT, F_HANG_AT + 1, F_HANG_S)}),
        detector=FailureDetector(n=N_OWNERS, fail_threshold=2, straggle_after=F_STRAGGLE_AFTER),
        hedge=HedgedCalls(), hedge_after=F_HEDGE_AFTER)
    capture = CallCapture((bg_ops, "block_gather"), (cache_mod, "cache_probe"))
    checked = {"cache_probe": 0, "block_gather": 0}

    @contextlib.contextmanager
    def uncounted():
        # the checks' own launches (control, healthy reads, plain-version
        # comparisons) stay out of the main path's counts and captures
        capture.__exit__(None, None, None)
        saved = cp_ops.launches, bg_ops.launches
        try:
            yield
        finally:
            cp_ops.launches, bg_ops.launches = saved
            capture.__enter__()

    def check_calls(where):
        with uncounted():
            if capture.calls["cache_probe"]:
                check_probe_calls(capture.calls["cache_probe"], where)
            for a, kw in capture.calls["block_gather"]:
                got, want = bg_ops.block_gather(*a, **kw), block_gather_filter_ref(*a, **kw)
                for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want):
                    assert torch.equal(g, w), f"block_gather {name} disagrees with its plain " \
                        f"version ({where})"
            for k in checked:
                checked[k] += len(capture.calls[k])
                capture.calls[k].clear()

    def write_batch():
        while True:
            kind = kinds[int(rng.choice(len(kinds), p=wweights))]
            mb = make_write(rng, espec, ranges, hot, kind, dev)
            if mb is not None:
                return mb

    def healthy_read(ps, cache, plan, roots):
        # the same batch on the same store and cache with no owner down,
        # outside the main path's counts: the degraded read is held against
        # its rows, and its step time pairs with the degraded one's
        with uncounted():
            torch.cuda.synchronize()
            res_h, _, _ = rt_h.run_gr_tx_batch(ps, cache, ttable, plan, roots)
        return res_h, rt_h.last_step_seconds * 1e3

    rows = {"unavailable": 0, "degraded": 0, "deferred": 0, "degraded_hits": 0,
            "queued": 0, "compared_after_recovery": 0}
    step_ms = {"healthy": [], "degraded": []}
    paired = []  # each degraded batch's step time beside its healthy read's
    rinfo, hedge_info, recovered_at = None, None, None
    torch.cuda.synchronize()
    cp_ops.launches = bg_ops.launches = 0
    capture.__enter__()
    t_loop = time.perf_counter()
    for b in range(F_BATCHES):
        name, plan, label = plan_cycle[b % len(plan_cycle)]
        roots = zipf_pick(rng, *ranges[label], BATCH)
        ctl.probe(b)
        # on every other degraded batch the healthy read goes first, so that
        # the order of the pair does not bias its ratio
        healthy = (healthy_read(ps, cache, plan, roots)
                   if ctl.detector.down() and b % 2 == 0 else None)
        try:
            res, deferred, misses, m = ctl.run_gr(ps, cache, plan, roots, b)
        except NodeFailure:
            # the detection gap: one failed probe of fail_threshold 2
            assert b == F_CRASH_AT and not ctl.detector.down(), b
            rows["unavailable"] += 1
            continue
        assert m["route_overflow"] == 0, f"phase 13 batch {b}: route_overflow"
        down = ctl.detector.down()
        (step_ms["degraded"] if down else step_ms["healthy"]).append(rt.last_step_seconds * 1e3)
        if down or m["hedged"]:
            first = healthy is not None
            healthy, healthy_ms = healthy if first else healthy_read(ps, cache, plan, roots)
            keep = ~deferred
            assert np.array_equal(res[keep], healthy[keep]), \
                f"phase 13 batch {b}: a row not deferred differs from the healthy read"
            gone = down | ({F_HANG_OWNER} if m["hedged"] else set())
            bad = [x.root for x in misses if int(base_owner(x.root, N_OWNERS)) in gone]
            assert not bad, f"phase 13 batch {b}: miss records of down owners {bad[:8]}"
            if down:
                deg_ms = rt.last_step_seconds * 1e3
                paired.append(dict(batch=b, plan=name, degraded_ms=deg_ms,
                                   healthy_ms=healthy_ms, healthy_first=first,
                                   ratio=deg_ms / healthy_ms))
        if down:
            assert b in range(F_CRASH_AT + 1, F_CRASH_AT + F_RECOVER_AFTER + 1), b
            rows["degraded"] += 1
            rows["deferred"] += m["deferred_rows"]
            rows["degraded_hits"] += m["hits"]
        if b == F_HANG_AT:
            assert m["hedged"] == 1 and ctl.hedge.hedge_wins == 1 and deferred.any(), \
                f"phase 13: the straggler's batch did not hedge: {m['hedged']}"
            hedge_info = dict(deferred_rows=m["deferred_rows"],
                              step_ms=rt.last_step_seconds * 1e3)
        elif recovered_at is not None:
            # after recovery: the control's read of its store through the
            # same cache gives the same batch
            with uncounted():
                want = rt_c.run_gr_tx_batch(ps_c, cache, ttable, plan, roots,
                                            return_deferred=True)
            assert np.array_equal(res, want[0]) and not deferred.any() and \
                miss_key(misses) == miss_key(want[1]), \
                f"phase 13 batch {b}: differs from the control after recovery"
            got_m = {k: v for k, v in m.items() if k in want[2] and k != "host_syncs"}
            assert got_m == {k: v for k, v in want[2].items() if k != "host_syncs"}, \
                f"phase 13 batch {b}: metrics {got_m} != the control's {want[2]}"
            if b == F_HANG_AT + 1:
                assert np.array_equal(rt.last_owner_stage, rt_c.last_owner_stage), \
                    "phase 13: the batch after the hedge has another owner-stage block"
            rows["compared_after_recovery"] += 1
        drain.push(misses)
        cache = drain.drain(ps, ps, cache, ttable, CP_DRAIN_K)
        if F_CRASH_OWNER in ctl.detector.down() and b >= F_CRASH_AT + F_RECOVER_AFTER:
            ps, cache, rinfo = ctl.recover(ps, cache, F_CRASH_OWNER)
            recovered_at = b
            with uncounted():
                pstores_equal(ps, ps_c, "phase 13: the recovered store against the control's")
        if (b + 1) % F_WRITE_EVERY == 0:
            mb = write_batch()
            before = ps
            ps, cache, wm = ctl.run_grw(ps, cache, mb)
            if wm["queued"]:
                assert ps is before and ctl.detector.down(), "phase 13: a queued commit moved"
                rows["queued"] += 1
            else:
                assert wm["op_overflow"] == 0 and wm["store_append_overflow"] == 0, wm
            with uncounted():
                ps_c, cache_c, _ = rt_c.run_grw_tx(ps_c, cache_c, ttable, mb)
            if b == F_CRASH_AT - 1:
                # the checkpoint just before the crash: replay reads no record
                t = time.perf_counter()
                j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap,
                             recent_blk_cap=rt.pspec.recent_blk_cap,
                             store_version=int(ps.version))
                ckpt_s = time.perf_counter() - t
        check_calls(f"phase 13 batch {b}")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    capture.__exit__(None, None, None)
    launches = {"block_gather": bg_ops.launches, "cache_probe": cp_ops.launches}
    assert min(launches.values()) > 0, f"phase 13 launched a kernel no time: {launches}"
    assert min(checked.values()) > 0, f"phase 13 checked no call of a kernel: {checked}"
    assert rows["unavailable"] == 1 and rows["degraded"] == F_RECOVER_AFTER, rows
    assert rows["deferred"] > 0 and rows["degraded_hits"] > 0, rows
    assert rinfo is not None and rinfo["drained_commits"] == rows["queued"] > 0, (rinfo, rows)
    assert rinfo["replayed_commits"] == 0 and hedge_info is not None
    assert rows["compared_after_recovery"] == F_BATCHES - recovered_at - 2, rows
    j.stop(final_flush=True)
    jm = j.metrics()
    assert jm["queued_commits"] == 0 and jm["applied_seq"] == jm["durable_seq"], jm
    fm = ctl.metrics()
    shutil.rmtree(root)

    # the serve loop's chaos flags at their defaults, on the card
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--inject-crash",
                           "1:3", "--recover-after", "2"], capture_output=True, text=True,
                          env=env, timeout=300)
    serve_s = time.perf_counter() - t
    assert proc.returncode == 0, f"phase 13 serve loop failed: {proc.stderr[-3000:]}"
    fo = next(l for l in proc.stdout.splitlines() if l.startswith("failover: "))
    kv = dict(w.split("=") for w in fo[len("failover: "):].split())
    assert kv["recoveries"] == "1" and kv["unavailable_batches"] == "1", fo

    card = card_line()
    report = dict(
        batches=F_BATCHES, batch=BATCH, commits=F_BATCHES // F_WRITE_EVERY, rows=rows,
        failover=fm, recovery={k: v for k, v in rinfo.items()}, hedge=hedge_info,
        checkpoint_seconds=ckpt_s, degraded_step_p50_ms=pct(step_ms["degraded"], 50),
        healthy_step_p50_ms=pct(step_ms["healthy"], 50), step_ms=step_ms, paired=paired,
        paired_ratio_p50=pct([x["ratio"] for x in paired], 50),
        launches=launches, kernel_calls_checked=checked, loop_seconds=loop_s,
        serve_subprocess=dict(seconds=serve_s, failover_line=fo), journal=jm,
        seconds=time.perf_counter() - t_phase,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("failover report: " + json.dumps(report), flush=True)
    print(f"failover: unavailable_batches={rows['unavailable']} degraded_batches="
          f"{rows['degraded']} deferred_rows={rows['deferred']} degraded_hits="
          f"{rows['degraded_hits']} queued_commits={rows['queued']} drained_commits="
          f"{rinfo['drained_commits']} | {card}", flush=True)
    print(f"failover recovery: recovery_seconds={rinfo['recovery_seconds']:.3f} (replay "
          f"{rinfo['replay_seconds']:.3f}, splice {rinfo['splice_seconds']:.3f}, drain "
          f"{rinfo['drain_seconds']:.3f}); checkpoint before the crash {ckpt_s:.3f} s | {card}",
          flush=True)
    print("failover gR step, each degraded batch and a healthy read of it on the same store "
          "and cache: " + ", ".join(
              f"batch {x['batch']} ({x['plan']}) {x['degraded_ms']:.3f} / {x['healthy_ms']:.3f} "
              f"ms = {x['ratio']:.4f}" for x in paired)
          + f"; paired ratio p50 {report['paired_ratio_p50']:.4f} | {card}", flush=True)
    print(f"failover gR step p50 ms over different batches: degraded "
          f"{report['degraded_step_p50_ms']:.3f} (n={len(step_ms['degraded'])}), healthy "
          f"{report['healthy_step_p50_ms']:.3f} (n={len(step_ms['healthy'])}); hedged batch "
          f"{hedge_info['step_ms']:.3f} ms, "
          f"{hedge_info['deferred_rows']} rows deferred | {card}", flush=True)
    print(f"failover checks: crash batch unavailable, {rows['degraded']} degraded batches held "
          f"to healthy reads, no miss record of the down owner, queued commits left the store, "
          f"recovered store equal to the control's, {rows['compared_after_recovery']} batches "
          f"after recovery equal to the control's, the hedge won and the next batch equals the "
          f"control's, kernel calls {checked} (all equal); serve loop --inject-crash 1:3 "
          f"--recover-after 2: {fo} ({serve_s:.1f} s); phase {report['seconds']:.1f}s, peak "
          f"device memory {report['peak_device_gib']:.2f} GiB", flush=True)
    return report


# Phase 14: hot-vertex migration and the routing overlays on the phase-7 store
# (4 owners, EB 2^24, recent 1,024, cache 4 x 2^16) at the reference serve
# loop's migration settings: MigrationPolicy() defaults, a table of 64, the
# write-behind journal.
M_BATCHES = 16  # gR batches of BATCH roots over the six plans in turn
M_HOT_FRAC = 0.5  # the reference's --hot-frac rule: half the roots from a hot set
M_HOT = 16  # the hot set: the first 16 vertices of owner 1 in each plan's root range
M_WRITE_EVERY = 2  # a W-hat commit after every 2nd batch, aimed at a migrated vertex
M_ROUNDS_AFTER = 5  # the engine steps from the boundary after batch 5: 6 batches before
M_SPLIT_AT = 6  # two hot roots get a cache home away from their rows for this batch
M_AWAY_AT, M_HOME_AT = 9, 11  # one vertex moved away (and edited) after batch 9, home after 11
M_CP_PER_OWNER = 512  # each owner's CP drain after a batch


def migration_write(rng, espec, hstore, mv, dev):
    """A W-hat commit aimed at migrated vertex ``mv``: each kind of the write
    mix on it at once, an append from it (to a Zipf listing), an edit of its
    last_seen and the delete of one of its original edges."""
    from repro_torch.graphstore import make_mutation_batch

    e_len = int(hstore.e_len)
    own = torch.nonzero(hstore.esrc[:e_len] == mv).flatten()
    listing = int(hstore.edst[int(own[0])]) if own.numel() else mv
    return make_mutation_batch(
        espec.store, new_edges=[(mv, listing, E_INCLUDES, [1])],
        set_vprops=[(mv, P_LAST_SEEN, int(rng.integers(1, 1 << 30)))],
        del_edges=[int(own[-1])] if own.numel() else [], device=dev)


def run_migration(seed, espec, hstore, pstore, ttable, plans, meta, ranges, includes, dev):
    """Phase 14: M_BATCHES gR batches on the phase-7 partitioned store with
    a ``RoutingTableHost`` attached and a ``MigrationEngine`` (the
    reference serve loop's policy, the journal) stepping at each batch
    boundary on the owner-stage block's ``frontier_rows``, half of each
    batch's roots drawn Zipf(1.2) from 16 vertices of owner 1; each batch
    followed by its per-owner CP drain and, every M_WRITE_EVERY batches, a
    W-hat commit aimed at a migrated vertex. At batch M_SPLIT_AT two hot
    roots read through cache homes away from their rows (the locality
    retry, the CP split); one vertex moves away after batch M_AWAY_AT, is
    edited, and moves home after M_HOME_AT. A control runtime with no table
    takes the same batches, drains and commits, and drops the same
    vertices' entries whenever a home changes. Checks: every batch's
    results equal the control's and its misses the control's as sets; the
    placement read back from the store equals the table after every round;
    a round moved a vertex, the retry and the CP split ran; the first read
    after the move home equals a fresh execution; a crash and ``replay``
    from the checkpoint taken before the first round rebuild the live
    store field for field; every kernel call equals its plain version;
    ``python -m repro_torch.launch.serve --migrate --hot-frac 0.5`` on the
    card reports a round. Returns the phase's report."""
    import contextlib
    import shutil
    import tempfile

    import repro_torch.core.cache as cache_mod
    import repro_torch.graphstore.migration as mig
    from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, base_owner, flat_mesh
    from repro_torch.distributed.routing import RoutingTableHost
    from repro_torch.graphstore import WriteBehindJournal, replay
    from repro_torch.graphstore.migration import (
        MigrationEngine, drop_cached_roots, infer_storage_exceptions, moved_away,
    )
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.obs.metrics import OWNER_STAGE_FIELDS

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 71)
    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)
    hot_incl = torch.as_tensor(includes, device=dev)
    hot_incl = hot_incl[hstore.esrc[hot_incl] < ranges[L_WATCHLIST][0] + P_HOT_WATCHLISTS]
    hot_incl = hot_incl.cpu().numpy()
    plan_cycle = [(name, p, label) for name, p, label, _ in plans]
    hot = {label: np.array([v for v in range(lo, min(hi, lo + 8 * M_HOT))
                            if v % N_OWNERS == 1][:M_HOT], np.int64)
           for label, (lo, hi) in ranges.items()}
    FR = OWNER_STAGE_FIELDS.index("frontier_rows")
    root = tempfile.mkdtemp(prefix="chip_smoke_migration_")
    # rt serves with the table; rt_c is the control (no table); rt_f reads
    # with an empty cache (a fresh execution)
    rt, rt_c, rt_f = (ShardedTxnRuntime(espec, flat_mesh(N_OWNERS), device=dev)
                      for _ in range(3))
    rhost = rt.attach_routing(RoutingTableHost(N_OWNERS, device=rt.device))
    ps = ps_c = pstore  # commits and moves are functional: all start from the phase-7 store
    cache, cache_c = rt.empty_cache(), rt_c.empty_cache()
    drain, drain_c = ShardedMissDrain(rt, meta), ShardedMissDrain(rt_c, meta)
    j = WriteBehindJournal(os.path.join(root, "journal"), rt.n)
    t = time.perf_counter()
    j.checkpoint(ps, e_blk_cap=rt.pspec.e_blk_cap, recent_blk_cap=rt.pspec.recent_blk_cap,
                 store_version=int(ps.version))
    ckpt_s = time.perf_counter() - t
    j.start(interval=D_FLUSH_S)
    engine = MigrationEngine(rt.pspec, rhost, journal=j)
    capture = CallCapture((bg_ops, "block_gather"), (cache_mod, "cache_probe"))
    checked = {"cache_probe": 0, "block_gather": 0}
    largest_after = None  # (foreign roots, rows, call): the largest post-migration call

    @contextlib.contextmanager
    def uncounted():
        # the checks' own launches stay out of the main path's counts
        capture.__exit__(None, None, None)
        saved = cp_ops.launches, bg_ops.launches
        try:
            yield
        finally:
            cp_ops.launches, bg_ops.launches = saved
            capture.__enter__()

    def check_calls(where):
        nonlocal largest_after
        with uncounted():
            if capture.calls["cache_probe"]:
                check_probe_calls(capture.calls["cache_probe"], where)
            for a, kw in capture.calls["block_gather"]:
                got, want = bg_ops.block_gather(*a, **kw), block_gather_filter_ref(*a, **kw)
                for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want):
                    assert torch.equal(g, w), f"block_gather {name} disagrees with its plain " \
                        f"version ({where})"
                if rhost.storage_exceptions:
                    # rvalid and not cvalid: roots migrated into this block
                    rank = (int((a[13] & ~a[14]).sum()) > 0, a[11].shape[0])
                    if largest_after is None or rank > largest_after[:2]:
                        largest_after = (*rank, (a, kw))
            for k in checked:
                checked[k] += len(capture.calls[k])
                capture.calls[k].clear()

    def moved(vids):
        # a home changed: the control drops the same vertices' entries at
        # theirs (the base owner), so that both caches miss them alike
        nonlocal cache_c
        vids = np.asarray(vids, np.int64)
        with uncounted():
            cache_c = drop_cached_roots(cache_c, N_OWNERS, vids, base_owner(vids, N_OWNERS))

    def write_batch():
        exc = sorted(rhost.storage_exceptions)
        if exc:
            mv = exc[int(rng.integers(0, len(exc)))]
            return migration_write(rng, espec, hstore, mv, dev), mv
        while True:
            mb = make_write(rng, espec, ranges, hot_incl,
                            kinds[int(rng.choice(len(kinds), p=wweights))], dev)
            if mb is not None:
                return mb, None

    rounds, step_ms, share = [], {"before": [], "after": []}, {"before": [], "after": []}
    split, away, edited = None, None, []
    fresh_checked = 0
    locality = {"locality_routed": 0, "locality_retry_rows": 0}
    # each round's splice (migrate_vertex_rows) timed apart from the round
    splice_ms, splice = [], mig.migrate_vertex_rows

    def timed_splice(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = splice(*a, **kw)
        torch.cuda.synchronize()
        splice_ms.append((time.perf_counter() - t) * 1e3)
        return out

    mig.migrate_vertex_rows = timed_splice
    torch.cuda.synchronize()
    cp_ops.launches = bg_ops.launches = 0
    capture.__enter__()
    t_loop = time.perf_counter()
    for b in range(M_BATCHES):
        name, plan, label = plan_cycle[b % len(plan_cycle)]
        roots = zipf_pick(rng, *ranges[label], BATCH)
        pick = rng.random(BATCH) < M_HOT_FRAC
        roots = np.where(pick, hot[label][np.minimum(rng.zipf(1.2, BATCH) - 1, M_HOT - 1)],
                         roots).astype(np.int32)
        if away is not None and b == M_HOME_AT + 1:
            roots[0] = away  # the vertex moved away, edited and moved home
        if b == M_SPLIT_AT:
            # two hot roots that kept their rows read through another home
            cands = [int(v) for v in hot[label] if int(v) not in rhost.storage_exceptions]
            split = cands[:2]
            for v in split:
                cache = drop_cached_roots(cache, N_OWNERS, [v], [rhost.cache_owner(v)])
                rhost.set_cache_owner(v, (rhost.storage_owner(v) + 1) % N_OWNERS)
            moved(split)
        res, misses, m = rt.run_gr_tx_batch(ps, cache, ttable, plan, roots)
        with uncounted():
            res_c, misses_c, m_c = rt_c.run_gr_tx_batch(ps_c, cache_c, ttable, plan, roots)
        assert np.array_equal(res, res_c), f"phase 14 batch {b}: results differ from the control"
        assert set(miss_key(misses)) == set(miss_key(misses_c)), \
            f"phase 14 batch {b}: misses differ from the control"
        assert m["route_overflow"] == 0, f"phase 14 batch {b}: route_overflow"
        for k in locality:
            locality[k] += m[k]
        fr = rt.last_owner_stage[:, FR]
        # one batch of each plan before the rounds, and the last six
        when = ("before" if b <= M_ROUNDS_AFTER
                else "after" if b >= M_BATCHES - len(plan_cycle) else None)
        if when is not None:
            share[when].append(fr.tolist())
            step_ms[when].append(rt.last_step_seconds * 1e3)
        if b == M_SPLIT_AT:
            assert m["locality_retry_rows"] > 0, f"phase 14: the split roots never retried {m}"
        if away is not None and b == M_HOME_AT + 1:
            # the first read after the move home: a fresh execution's rows
            with uncounted():
                res_f, _, _ = rt_f.run_gr_tx_batch(ps, rt_f.empty_cache(), ttable, plan, roots,
                                                   rtable=rhost)
            assert np.array_equal(res, res_f), "phase 14: the read after the move home " \
                "differs from a fresh execution"
            fresh_checked += 1
        drain.push(misses)
        cache = drain.drain(ps, ps, cache, ttable, M_CP_PER_OWNER)
        with uncounted():
            drain_c.push(misses_c)
            cache_c = drain_c.drain(ps_c, ps_c, cache_c, ttable, M_CP_PER_OWNER)
        if b == M_SPLIT_AT:
            for v in split:
                cache = drop_cached_roots(cache, N_OWNERS, [v], [rhost.cache_owner(v)])
                rhost.clear_cache_owner(v)
            moved(split)
        # the batch boundary: the engine's round, then the forced away / home
        engine.observe(roots)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mv = []
        if b >= M_ROUNDS_AFTER:
            ps, cache, mv = engine.step(ps, fr, cache=cache)
        torch.cuda.synchronize()
        if mv:
            rounds.append(dict(batch=b, moves=mv, round_ms=(time.perf_counter() - t) * 1e3,
                               splice_ms=splice_ms[-1], epoch=rhost.epoch))
            moved([v for v, _ in mv])
        if b in (M_AWAY_AT, M_HOME_AT):
            if b == M_AWAY_AT:
                cands = [int(v) for v in hot[L_WATCHLIST][::-1]
                         if int(v) not in rhost.storage_exceptions]
                away = cands[0]
                force = [(away, (rhost.storage_owner(away) + 1) % N_OWNERS)]
            else:
                force = [(away, int(base_owner(away, N_OWNERS)))]
            t = time.perf_counter()
            ps, cache, _ = engine.apply(ps, force, cache=cache)
            torch.cuda.synchronize()
            rounds.append(dict(batch=b, moves=force, round_ms=(time.perf_counter() - t) * 1e3,
                               splice_ms=splice_ms[-1], epoch=rhost.epoch, forced=True))
            moved([away])
        with uncounted():
            assert infer_storage_exceptions(rt.pspec, ps) == rhost.storage_exceptions, \
                f"phase 14 batch {b}: the store's placement is not the table's"
        if (b + 1) % M_WRITE_EVERY == 0:
            mb, mv_edit = write_batch()
            if b == M_AWAY_AT:
                mb, mv_edit = migration_write(rng, espec, hstore, away, dev), away
            edited.append(mv_edit)
            ps, cache, wm = rt.run_grw_tx(ps, cache, ttable, mb, journal=j)
            assert wm["op_overflow"] == 0 and wm["store_append_overflow"] == 0, wm
            with uncounted():
                ps_c, cache_c, wm_c = rt_c.run_grw_tx(ps_c, cache_c, ttable, mb)
            assert wm["impacted_keys"] == wm_c["impacted_keys"], (wm, wm_c)
        check_calls(f"phase 14 batch {b}")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    capture.__exit__(None, None, None)
    mig.migrate_vertex_rows = splice
    launches = {"block_gather": bg_ops.launches, "cache_probe": cp_ops.launches}
    assert min(launches.values()) > 0, f"phase 14 launched a kernel no time: {launches}"
    assert min(checked.values()) > 0, f"phase 14 checked no call of a kernel: {checked}"
    policy_rounds = [r for r in rounds if not r.get("forced")]
    assert policy_rounds and all(r["moves"] for r in policy_rounds), \
        f"phase 14: no migration round moved a vertex: {rounds}"
    assert rt.locality_retries > 0 and rt.cp_splits > 0, (rt.locality_retries, rt.cp_splits)
    assert fresh_checked == 1 and away in edited, (fresh_checked, away, edited)
    assert any(e is not None and e != away for e in edited), edited

    # a crash: the live runtime and journal dropped, replay from the
    # checkpoint taken before the first round on a fresh runtime
    j.stop(final_flush=True)
    jm = j.metrics()
    t = time.perf_counter()
    rt_r = ShardedTxnRuntime(espec, flat_mesh(N_OWNERS), device=dev)
    ps_r, _, info = replay(WriteBehindJournal(os.path.join(root, "journal"), N_OWNERS), rt_r,
                           ttable)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t
    pstores_equal(ps_r, ps, "phase 14: the replayed store against the live one")
    assert info["replayed_migrations"] == len(rounds), (info, len(rounds))
    assert rt_r.rhost is not None and rt_r.rhost.storage_exceptions == rhost.storage_exceptions
    del ps_r, rt_r
    shutil.rmtree(root)

    # the post-migration block_gather call, timed beside its plain version
    a, kw = largest_after[2]
    want = block_gather_filter_ref(*a, **kw)
    bg_t = timings(lambda: bg_ops.block_gather(*a, **kw),
                   lambda: block_gather_filter_ref(*a, **kw))
    nbytes, ops = block_gather_bound(a, kw, want)
    bg_bound, bg_by = bound_ms(nbytes, ops)
    B_, W_ = want[0].shape
    foreign = int((a[13] & ~a[14]).sum())  # rvalid, not cvalid: migrated-in roots
    bg_shape = f"rows={B_},lanes={W_},EB={kw['e_blk_cap']},foreign_roots={foreign}"

    # the serve loop's migration flags, on the card
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--migrate",
                           "--hot-frac", str(M_HOT_FRAC)], capture_output=True, text=True,
                          env=env, timeout=300)
    serve_s = time.perf_counter() - t
    assert proc.returncode == 0, f"phase 14 serve loop failed: {proc.stderr[-3000:]}"
    line = next(l for l in proc.stdout.splitlines() if l.startswith("routing: migration_rounds="))
    kv = dict(w.split("=") for w in line[len("routing: "):].split())
    assert int(kv["migration_rounds"]) >= 1, line

    hot_share = lambda rows: float(np.asarray(rows)[:, 1].sum() / max(np.asarray(rows).sum(), 1))
    card = card_line()
    report = dict(
        batches=M_BATCHES, batch=BATCH, hot_frac=M_HOT_FRAC, rounds=rounds,
        engine=engine.metrics(), locality_retries=rt.locality_retries, cp_splits=rt.cp_splits,
        **locality,
        split_roots=split, away_vertex=away, edited=edited,
        hot_owner_frontier_share=dict(before=hot_share(share["before"]),
                                      after=hot_share(share["after"])),
        step_p50_ms=dict(before=pct(step_ms["before"], 50), after=pct(step_ms["after"], 50)),
        step_ms=step_ms, checkpoint_seconds=ckpt_s, replay_seconds=replay_s, replay=info,
        launches=launches, kernel_calls_checked=checked, loop_seconds=loop_s,
        block_gather_post_migration=dict(bg_t, bound_ms=bg_bound, bound_by=bg_by, shape=bg_shape,
                                         nbytes=nbytes),
        serve_subprocess=dict(seconds=serve_s, routing_line=line), journal=jm,
        seconds=time.perf_counter() - t_phase,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("migration report: " + json.dumps(report), flush=True)
    print("migration rounds: " + "; ".join(
        f"after batch {r['batch']}{' (forced)' if r.get('forced') else ''} {r['moves']} "
        f"round {r['round_ms']:.3f} ms (splice {r['splice_ms']:.3f}) -> epoch {r['epoch']}"
        for r in rounds)
          + f" | {card}", flush=True)
    em = engine.metrics()
    print(f"migration: rounds={em['migration_rounds']} moved_vertices={em['migrated_vertices']} "
          f"moved_rows={em['migrated_rows']} table_epoch={em['table_epoch']} "
          f"storage_exceptions={em['storage_exceptions']} locality_routed="
          f"{locality['locality_routed']} locality_retry_rows={locality['locality_retry_rows']} "
          f"locality_retries={rt.locality_retries} cp_splits={rt.cp_splits}; owner 1's share "
          f"of frontier rows "
          f"{report['hot_owner_frontier_share']['before']:.4f} over the 6 batches before the "
          f"rounds, {report['hot_owner_frontier_share']['after']:.4f} over the last 6; gR step p50 "
          f"{report['step_p50_ms']['before']:.3f} ms before (n={len(step_ms['before'])}), "
          f"{report['step_p50_ms']['after']:.3f} ms after (n={len(step_ms['after'])}) | {card}",
          flush=True)
    print(f"kernel block_gather phase 14 post-migration {bg_shape} {fmt_us(bg_t)} "
          f"bound_us={bg_bound * 1e3:.4f} ({bg_by}, {nbytes} B) launches={launches['block_gather']}"
          f" | {card}", flush=True)
    print(f"migration checks: {M_BATCHES} batches equal the control's (misses as sets), the "
          f"placement read back equals the table after every round, the split batch retried "
          f"{split}, the read after moving {away} home equals a fresh execution, replay "
          f"({replay_s:.3f} s, {info}) equals the live store, kernel calls {checked} (all "
          f"equal); serve loop --migrate --hot-frac {M_HOT_FRAC}: {line} ({serve_s:.1f} s); "
          f"phase {report['seconds']:.1f}s, peak device memory "
          f"{report['peak_device_gib']:.2f} GiB", flush=True)
    return report


# Phase 15: the replicated store tier on the phase-7 stores (one chip's share of ecommerce_graph FULL: v_cap 2^22, e_cap
# 2^25, max_deg 64, the cache in 4 blocks of 2^16, 4 owner ranks).
R_BATCHES = 12  # gR batches of BATCH Zipf(1.3) roots, the six read plans twice
R_CP_PER_OWNER = 512  # each owner's CP drain after a batch
R_GRW_COMMITS = 8  # W-hat gRW-Txs of each policy on the replicated tier


def run_replicated(seed, espec, hstore, pstore, ttable, plans, meta, ranges, includes, dev):
    """Phase 15. (a) ``ShardedTxnRuntime(store_tier="replicated")`` over the
    single-host store ``hstore``, cold: R_BATCHES batches, each followed by
    a CP drain of R_CP_PER_OWNER misses an owner, beside phase 4's
    single-host engine on the same store with the same cache history (its
    populators drain the same misses an owner, pushed in key order on both
    sides). Each batch's results must equal, and while neither cache
    evicted its metrics (but the sharded-only keys and ``host_syncs``) and
    miss multisets too. Then R_GRW_COMMITS W-hat commits a policy through
    ``run_grw_tx`` on the replicated tier beside the single host's: the
    store equal field for field after every commit, the cache entries
    equal with their leaf order, ``impacted_keys`` equal. (b) The
    partitioned runtime over ``pstore``, with its own cache and the same
    drains: the same batches must give the replicated tier's results; its
    step is the one the replicated baseline is held against. (c) ``python
    -m repro_torch.launch.serve --store-tier replicated`` at its defaults
    must exit 0 with the reference's lines. The replicated runtime is the
    phase's main path (its misses run the full-store exec, so it launches
    no ``block_gather``); the single host and the partitioned runtime are
    its controls, their launches left out of the counts. Every kernel call of the phase, the controls'
    too, is held to its plain version. Returns the phase's report."""
    import contextlib

    import repro_torch.core.cache as cache_mod
    from repro_torch.core import CachePopulator, GraphEngine, empty_cache, run_grw_tx
    from repro_torch.distributed import ShardedMissDrain, ShardedTxnRuntime, base_owner, flat_mesh
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
    from repro_torch.kernels.cache_probe import ops as cp_ops

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 81)
    plan_cycle = [(name, p, label) for name, p, label, _ in plans]
    mkey = lambda m: miss_key([m])
    # rt_r: the replicated tier; rt_d: the partitioned one (a control)
    rt_r = ShardedTxnRuntime(espec, flat_mesh(N_OWNERS), store_tier="replicated", device=dev)
    rt_d = ShardedTxnRuntime(espec, flat_mesh(N_OWNERS), device=dev)
    engines = {name: GraphEngine(espec, p, use_cache=True, device=dev)
               for name, p, _ in plan_cycle}
    hcache = empty_cache(espec.cache, device=dev)
    hpops = [CachePopulator(espec, meta, device=dev) for _ in range(N_OWNERS)]
    caches = {k: rt.empty_cache() for k, rt in (("r", rt_r), ("d", rt_d))}
    drains = {k: ShardedMissDrain(rt, meta) for k, rt in (("r", rt_r), ("d", rt_d))}
    capture = CallCapture((bg_ops, "block_gather"), (cache_mod, "cache_probe"))
    checked = {"cache_probe": 0, "block_gather": 0}

    @contextlib.contextmanager
    def uncounted():
        # a control's launches stay out of the main path's counts (its
        # calls are still kept and checked)
        saved = cp_ops.launches, bg_ops.launches
        try:
            yield
        finally:
            cp_ops.launches, bg_ops.launches = saved

    def check_calls(where):
        # the checks' own calls are neither kept nor counted
        capture.__exit__(None, None, None)
        with uncounted():
            if capture.calls["cache_probe"]:
                check_probe_calls(capture.calls["cache_probe"], where)
            for a, kw in capture.calls["block_gather"]:
                got, want = bg_ops.block_gather(*a, **kw), block_gather_filter_ref(*a, **kw)
                for name, g, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, want):
                    assert torch.equal(g, w), f"block_gather {name} disagrees with its plain " \
                        f"version ({where})"
            for k in checked:
                checked[k] += len(capture.calls[k])
                capture.calls[k].clear()
        capture.__enter__()

    def no_evict(*cs):
        return all(int(c.n_evict) == 0 for c in cs)

    def strip(m):
        return {k: v for k, v in m.items() if k not in SHARDED_ONLY}

    def drain_single(misses):
        # the single host's CP, per owner as the runtime's: the same
        # misses in the same order reach the same owner's queue
        nonlocal hcache
        for mrec in sorted(misses, key=mkey):
            hpops[int(base_owner(mrec.root, N_OWNERS))].queue.push([mrec])
        for pop in hpops:
            hcache = pop.drain(hstore, hstore, hcache, ttable, R_CP_PER_OWNER)

    step_ms = {"replicated": [], "partitioned": []}
    batches, equal_metrics = [], 0
    torch.cuda.synchronize()
    cp_ops.launches = bg_ops.launches = 0
    capture.__enter__()
    # (a) the replicated tier against the single host
    for b in range(R_BATCHES):
        name, plan, label = plan_cycle[b % len(plan_cycle)]
        roots = zipf_pick(rng, *ranges[label], BATCH)
        res, misses, m = rt_r.run_gr_tx_batch(hstore, caches["r"], ttable, plan, roots)
        batches.append((name, plan, roots, res))
        step_ms["replicated"].append(rt_r.last_step_seconds * 1e3)
        with uncounted():
            rh, mh, meth = engines[name].run(hstore, hcache, ttable, roots)
        assert np.array_equal(res, rh), f"phase 15 replicated batch {b} ({name}): result differs"
        assert m["route_overflow"] == 0, f"phase 15 replicated batch {b}: route_overflow"
        if no_evict(hcache, caches["r"]):
            meth.pop("host_syncs")
            assert strip(m) == meth, f"phase 15 replicated batch {b}: metrics {m} != {meth}"
            assert miss_key(misses) == miss_key(mh), f"phase 15 replicated batch {b}: misses"
            equal_metrics += 1
        drains["r"].push(sorted(misses, key=mkey))
        caches["r"] = drains["r"].drain(hstore, hstore, caches["r"], ttable, R_CP_PER_OWNER)
        with uncounted():
            drain_single(mh)
        check_calls(f"phase 15 replicated batch {b}")
    assert (drains["r"].committed, drains["r"].aborted) == (
        sum(p.committed for p in hpops), sum(p.aborted for p in hpops)), "phase 15: CP outcomes"
    entries_equal = None
    if no_evict(hcache, caches["r"]):
        entries_equal = entries_equal_on_card(espec, hcache, caches["r"])
        assert entries_equal, "phase 15: replicated cache entries differ from the single host's"

    # the replicated commits beside the single host's
    kinds, wweights = zip(*WRITE_MIX)
    wweights = np.array(wweights) / sum(wweights)
    hot = torch.as_tensor(includes, device=dev)
    hot = hot[hstore.esrc[hot] < ranges[L_WATCHLIST][0] + P_HOT_WATCHLISTS].cpu().numpy()

    def write_batch():
        while True:
            mb = make_write(rng, espec, ranges, hot,
                            kinds[int(rng.choice(len(kinds), p=wweights))], dev)
            if mb is not None:
                return mb

    rs, rc, hs, hc = hstore, caches["r"], hstore, hcache
    grw_ms, grw_equal, impacted = {}, {}, {}
    for policy in ("write-around", "write-through"):
        grw_ms[policy], grw_equal[policy], impacted[policy] = [], 0, 0
        for i in range(R_GRW_COMMITS):
            mb = write_batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rs, rc, mr = rt_r.run_grw_tx(rs, rc, ttable, mb, policy)
            grw_ms[policy].append((time.perf_counter() - t) * 1e3)
            with uncounted():
                hs, hc, mh = run_grw_tx(espec, hs, hc, ttable, mb, policy, device=dev)
            assert mr["impacted_keys"] == mh["impacted_keys"], \
                f"phase 15 {policy} commit {i}: impacted {mr} != {mh}"
            assert mr["op_overflow"] == mh["op_overflow"] == 0, f"phase 15 {policy} commit {i}"
            for f in hs._fields:
                assert torch.equal(getattr(rs, f), getattr(hs, f)), \
                    f"phase 15 {policy} commit {i}: store field {f} differs"
            if no_evict(rc, hc):
                assert entries_equal_on_card(espec, hc, rc), \
                    f"phase 15 {policy} commit {i}: cache entries differ"
                grw_equal[policy] += 1
            impacted[policy] += mr["impacted_keys"]
            check_calls(f"phase 15 {policy} commit {i}")
    del rs, rc, hs, hc

    # (b) the partitioned tier on the same batches, the step the replicated
    # baseline is held against
    for b, (name, plan, roots, res) in enumerate(batches):
        with uncounted():
            rd, md, _ = rt_d.run_gr_tx_batch(pstore, caches["d"], ttable, plan, roots)
            step_ms["partitioned"].append(rt_d.last_step_seconds * 1e3)
            assert np.array_equal(rd, res), \
                f"phase 15 partitioned batch {b} ({name}): result differs from the replicated tier's"
            drains["d"].push(sorted(md, key=mkey))
            caches["d"] = drains["d"].drain(pstore, pstore, caches["d"], ttable, R_CP_PER_OWNER)
        check_calls(f"phase 15 partitioned batch {b}")
    torch.cuda.synchronize()
    capture.__exit__(None, None, None)
    launches = {"block_gather": bg_ops.launches, "cache_probe": cp_ops.launches}
    assert launches["cache_probe"] > 0 and launches["block_gather"] == 0, \
        f"phase 15: the replicated tier's launches {launches}"
    assert min(checked.values()) > 0, f"phase 15 checked no call of a kernel: {checked}"
    rep = rt_d.store_bytes(pstore)

    # (c) the serve loop on the replicated tier, on the card
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "src"))
    code = ("import json, sys; from repro_torch.launch.serve import main; "
            "print(json.dumps(main(sys.argv[1:])))")
    proc = subprocess.run([sys.executable, "-c", code, "--store-tier", "replicated"],
                          capture_output=True, text=True, env=env, timeout=300)
    serve_s = time.perf_counter() - t
    assert proc.returncode == 0, f"phase 15 serve loop failed: {proc.stderr[-3000:]}"
    lines = proc.stdout.splitlines()
    summary = next(l for l in lines if " gR-Txs on " in l)
    assert "[replicated]" in summary and "route_overflow=0" in summary, summary
    for head in ("store tier:", "journal:", "maintenance:", "durability:"):
        assert not any(l.startswith(head) for l in lines), f"phase 15 serve loop printed {head}"
    assert sum(l.startswith("latency[") for l in lines) == 4 and any(
        l.startswith("hit_locality per shard:") for l in lines), proc.stdout[-2000:]
    serve_total = json.loads(lines[-1])

    card = card_line()
    p50 = {k: pct(v, 50) for k, v in step_ms.items()}
    report = dict(
        batches=R_BATCHES, batch=BATCH, cp_per_owner=R_CP_PER_OWNER, step_p50_ms=p50,
        step_ms=step_ms, batches_metrics_equal=equal_metrics, entries_equal=entries_equal,
        cp=dict(committed=drains["r"].committed, aborted=drains["r"].aborted),
        n_evict=dict(single=int(hcache.n_evict), replicated=int(caches["r"].n_evict)),
        grw_commits=R_GRW_COMMITS, grw_p50_ms={k: pct(v, 50) for k, v in grw_ms.items()},
        grw_ms=grw_ms, grw_entries_equal=grw_equal, grw_impacted=impacted,
        per_shard_bytes=rep["per_shard_bytes"],
        replicated_per_shard_bytes=rep["replicated_per_shard_bytes"], bytes_ratio=rep["ratio"],
        launches=launches, kernel_calls_checked=checked,
        serve_subprocess=dict(seconds=serve_s, summary=summary, total=serve_total),
        seconds=time.perf_counter() - t_phase,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("replicated report: " + json.dumps(report), flush=True)
    print(f"replicated: gR step p50 replicated {p50['replicated']:.3f} ms, partitioned "
          f"{p50['partitioned']:.3f} ms (n={R_BATCHES} each); replicated gRW p50 "
          f"write-around {report['grw_p50_ms']['write-around']:.3f} ms, write-through "
          f"{report['grw_p50_ms']['write-through']:.3f} ms (n={R_GRW_COMMITS} each); a rank's "
          f"replica {rep['replicated_per_shard_bytes'] / 2**20:.1f} MiB against "
          f"{rep['per_shard_bytes'] / 2**20:.1f} MiB a partitioned shard | {card}", flush=True)
    print(f"replicated serve loop --store-tier replicated ({serve_s:.1f} s): {summary}; total "
          f"{json.dumps(serve_total)}", flush=True)
    print(f"replicated checks: {R_BATCHES} batches equal the single host ("
          f"{equal_metrics} with metrics and misses) and the partitioned tier, "
          f"{R_GRW_COMMITS} commits a policy with the store field for field and the entries "
          f"{grw_equal}, kernel calls {checked} (all "
          f"equal), launches {launches}; phase {report['seconds']:.1f}s, peak device memory "
          f"{report['peak_device_gib']:.2f} GiB", flush=True)
    return report


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
    from repro_torch.core import ANY_LABEL, DIR_OUT, CacheSpec, EngineSpec, Template
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
    ttable = serving_ttable(
        [Template("NBR", DIR_OUT, (ANY_LABEL, []), (ANY_LABEL, []), (ANY_LABEL, []))])
    feats = rng.standard_normal((V, GNN_FEAT), dtype=np.float32)
    labels = rng.integers(0, GNN_CLASSES, V).astype(np.int32)
    return espec, store, ttable, feats, labels, src


class ServedLog:
    """Records every neighbour list a sampler's batched lookups return: the
    vertex, the list and whether the cache served it, one entry per
    occurrence in frontier order."""

    def __init__(self, sampler):
        self.inner, self.calls = sampler.lookup, []
        sampler.lookup = self.lookup

    def lookup(self, vs):
        out, hit = self.inner(vs)
        self.calls.extend(zip(np.asarray(vs).tolist(), out, hit.tolist()))
        return out, hit


def run_gnn(seed, dev, n_vertices=GNN_V):
    """Phase 8: two epochs of cached sampling and the PNA forward + loss,
    a gRW-Tx between them, the consistency gate on every list epoch 2
    served from the cache. Returns the report, the capture of every
    ``segment_spmm`` call the forwards made, (config, params, epoch 2's
    batch), and a function that runs the profile windows of the sampler
    and the forward."""
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
    capture = CallCapture((graph_mod, "segment_spmm"), (graph_mod, "prepare_edges"))
    # every cache_probe call of the samplings (one a fanout layer), for
    # check_gnn_kernels
    probe_capture = CallCapture((cache_mod, "cache_probe"))
    # (batch, its forward's first and last segment_spmm call in the capture)
    report = {"segment_spmm_launches": 0, "cache_probe_launches": 0, "spmm_batches": [],
              "probe_capture": probe_capture}

    def epoch(tag):
        c0, h0 = len(log.calls), sampler.hits
        cp_ops.launches = 0
        with probe_capture:
            t = time.perf_counter()
            g = sampler.sample_store(seeds, feats, labels)
            torch.cuda.synchronize()
            sample_s = time.perf_counter() - t
        lookups = cp_ops.launches
        report["cache_probe_launches"] += lookups
        n_lists, hits = len(log.calls) - c0, sampler.hits - h0
        ss_ops.launches = 0
        lo, prepared = len(capture.calls["segment_spmm"]), len(capture.calls["prepare_edges"])
        with capture:
            t = time.perf_counter()
            loss = loss_fn(cfg, params, g)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t) * 1e3
        report["segment_spmm_launches"] += ss_ops.launches
        report["spmm_batches"].append((g, lo, len(capture.calls["segment_spmm"])))
        prepared = len(capture.calls["prepare_edges"]) - prepared
        sums = 5 * cfg.n_layers  # scatter_mean x 2 (sum, count) and degrees, a PNA layer
        assert prepared == 1 and ss_ops.launches == sums, (
            f"{tag}: {prepared} prepare_edges calls and {ss_ops.launches} segment_spmm "
            f"launches in one forward (want 1 and {sums})")
        n_nodes, n_edges = int(g.node_mask.sum()), int(g.edge_mask.sum())
        report[tag] = dict(
            sample_s=sample_s, neighbor_lists=n_lists, cache_probe_launches=lookups,
            hits=hits, hit_rate=hits / n_lists, forward_loss_ms=fwd_ms, loss=float(loss),
            nodes=n_nodes, edges=n_edges, padded=(g.node_mask.shape[0], g.edge_mask.shape[0]),
            segment_spmm_launches=ss_ops.launches, prepare_edges_calls=prepared)
        print(f"gnn {tag}: " + json.dumps(report[tag]), flush=True)
        # one batched lookup a fanout layer: one launch, two at most
        assert 0 < lookups <= 2 * len(GNN_FANOUTS), f"{tag}: {lookups} cache_probe launches"
        assert report[tag]["padded"] == (sampler._cap_nodes(GNN_SEEDS),
                                         sampler._cap_edges(GNN_SEEDS)), report[tag]["padded"]
        assert np.isfinite(float(loss)), f"{tag}: the loss is not finite"
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
    draws = sampler.rng.bit_generator.state
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

    # the device's idle share over epoch 2's sample + forward, measured: the
    # window replays epoch 2's whole sampling from the same draws on the same
    # cache and store (so the same lists and hits), then one forward + loss
    ep = report["epoch2"]

    def replay():
        sampler.rng.bit_generator.state = draws
        h = sampler.hits
        sampler.sample_store(seeds, feats, labels)
        assert sampler.hits - h == ep["hits"], "the replayed sampling hit another set"

    def profile_windows():
        s_wall, s_busy = profiled(" gnn sampling", "epoch 2's batched sampling, replayed",
                                  replay, host_ops=False)
        f_wall, f_busy = profiled(" gnn forward", "one PNA forward + loss",
                                  lambda: loss_fn(cfg, params, g2), host_ops=False)
        if s_busy is not None and f_busy is not None:
            report["idle_share"] = 1 - (s_busy + f_busy) / (s_wall + f_wall)
            print(f"gnn idle share over epoch 2's sample + forward (the two windows): "
                  f"{report['idle_share']:.4f}", flush=True)

    return report, capture, (cfg, params, g2), profile_windows


def spmm_bound(x, src, dst, n, mask):
    """Least bytes: the rows of x the kept edges read, src, dst, the mask,
    the CSR offsets and the output, each once; one add per value read."""
    keep = mask & (dst >= 0) & (dst < n)
    rows = int(torch.unique(src[keep]).numel())
    E, D, es = src.shape[0], x.shape[1], x.element_size()
    nbytes = rows * D * es + E * (4 + 4 + 1) + (n + 1) * 4 + n * D * es
    return nbytes, int(keep.sum()) * D


def check_gnn_kernels(capture, batches, probe_capture, launches, model):
    """The samplings' ``cache_probe`` calls (one a fanout layer) held equal
    to the plain version, the largest timed beside its bound; every
    ``segment_spmm`` call of the forwards (``batches``: each forward's batch
    and its span of the capture) against the per-call plain version over
    the batch's edges (fp32 allclose), one bf16 call at the largest shape,
    the logits of the kernel forward against the plain forward's, then
    times of the CSR-form call at the largest shape with its bound and
    ``torch.sparse.mm``'s time on the same CSR, and the one-time
    ``prepare_edges``."""
    from repro_torch.gnn import graph as graph_mod
    from repro_torch.gnn.layers import mlp, pna_layer
    from repro_torch.gnn.models import forward
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.cache_probe.ref import cache_probe_ref
    from repro_torch.kernels.segment_spmm import ops as ss_ops
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

    probes = probe_capture.calls["cache_probe"]
    assert probes, "the sampler made no cache_probe call"
    hits = []
    for a, kw in probes:
        got, want = cp_ops.cache_probe(*a, **kw), cache_probe_ref(*a, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            "cache_probe disagrees with its plain version on a sampler lookup"
        hits.append(int(want[0].sum()))
    # timed: the largest call on the populated cache (epoch 2's last layer)
    a, kw = max((c for c, n in zip(probes, hits) if n), key=lambda c: c[0][4].shape[0])
    hit, slot = cache_probe_ref(*a, **kw)
    t = timings(lambda: cp_ops.cache_probe(*a, **kw), lambda: cache_probe_ref(*a, **kw))
    nbytes, ops = probe_bound(a, hit, slot, kw["probes"])
    bms, by = bound_ms(nbytes, ops)
    print(f"kernel cache_probe gnn calls={len(probes)} (all equal) largest keys="
          f"{a[4].shape[0]} cap={a[0].shape[0]} hits={int(hit.sum())} {fmt_us(t)} "
          f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B) {one_fill_us(slot)}",
          flush=True)

    # every CSR-form call of the forwards against the per-call plain version
    # over its batch's edges, which never sees the CSR
    calls = capture.calls["segment_spmm"]
    assert calls, "the PNA forwards made no segment_spmm call"
    err, plain_args = 0.0, []
    for g, lo, hi in batches:
        n, E = g.node_mask.shape[0], g.edge_mask.shape[0]
        ids = torch.arange(E, dtype=torch.int32, device=g.edge_dst.device)
        csr = calls[lo][1]["csr"]
        assert csr.n_nodes == n and all(kw["csr"] is csr for _, kw in calls[lo:hi]), \
            "a forward's segment sums did not share its one CSR"
        for a, kw in calls[lo:hi]:
            got = ss_ops.segment_spmm(*a, **kw)
            want = segment_spmm_ref(a[0], ids, g.edge_dst, n, g.edge_mask)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.allclose(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL), \
                f"segment_spmm disagrees with its plain version at x {tuple(a[0].shape)}"
            err = max(err, float((got - want).abs().max()))
            plain_args.append(((a[0], ids, g.edge_dst, n, g.edge_mask), csr))
    (x, src, dst, n, mask), csr = max(plain_args, key=lambda c: c[0][0].numel())
    xb = x.to(torch.bfloat16)
    gb, wb = ss_ops.segment_spmm(xb, csr=csr), segment_spmm_ref(xb, src, dst, n, mask)
    assert gb.dtype == torch.bfloat16 and torch.allclose(
        gb.float(), wb.float(), rtol=SPMM_BF16_TOL, atol=SPMM_BF16_TOL), "bf16 segment_spmm"
    bf16_err = float((gb.float() - wb.float()).abs().max())
    print(f"kernel segment_spmm calls={len(calls)} (all within rtol={SPMM_RTOL} "
          f"atol={SPMM_ATOL} of the per-call plain version, max abs err {err:.3e}); bf16 at x "
          f"{tuple(x.shape)}: max abs err {bf16_err:.3e} (tol {SPMM_BF16_TOL})", flush=True)

    # the plain forward: every layer's sums through the per-call plain
    # version (segment_spmm_ref takes no CSR: no sum can reach one)
    cfg, params, g = model
    logits = forward(cfg, params, g)
    graph_mod.segment_spmm = segment_spmm_ref
    try:
        h = g.node_feat
        for lp in params["layers"]:
            h = pna_layer(lp, cfg, h, g.edge_src, g.edge_dst, g.edge_mask, g.node_mask)
        plain = mlp(params["head"], h)
    finally:
        graph_mod.segment_spmm = ss_ops.segment_spmm
    diff = float((logits - plain).abs().max())
    print(f"gnn logits {tuple(logits.shape)}: kernel forward vs plain forward max abs diff "
          f"{diff:.3e} (rtol=atol={LOGITS_TOL})", flush=True)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert torch.allclose(logits, plain, rtol=LOGITS_TOL, atol=LOGITS_TOL), \
        "the kernel forward's logits disagree with the plain forward's"

    # the CSR-form call at the largest shape; the one-time prepare on its own
    kern = lambda: ss_ops.segment_spmm(x, csr=csr)
    t = timings(kern, lambda: segment_spmm_ref(x, src, dst, n, mask))
    kernel_only = device_ms(kern, match="segment_spmm_kernel")
    prep = lambda: ss_ops.prepare_edges(src, dst, n, x.shape[0], mask)
    prep_ms, prep_dev = cuda_ms(prep), device_ms(prep)
    # cuSPARSE on the same function over the same CSR
    nnz = int(csr.offsets[-1])
    A = torch.sparse_csr_tensor(csr.offsets.long(), csr.src_sorted[:nnz].long(),
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
          f"(CSR form) {fmt_us(t)} kernel_only_device_us={us(kernel_only)} "
          f"sparse_mm_us={us(lib_ms)} (device {us(lib_dev)}) "
          f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B); prepare_edges once a forward: "
          f"{us(prep_ms)} us (device {us(prep_dev)})", flush=True)
    return dict(name="segment_spmm", route="cuda", source="src/repro_torch/csrc/segment_spmm.cu",
                replaces="src/repro/kernels/segment_spmm/kernel.py:49", launches=launches,
                max_abs_err=err, **t, kernel_only_device_ms=kernel_only, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev,
                prepare_ms=prep_ms, prepare_device_ms=prep_dev,
                shape=f"x={tuple(x.shape)},E={src.shape[0]},n={n}")


# ------------------------------------------------------- two-tower serving
# Phase 9: the two-tower retrieval model of src/repro/configs/two_tower_retrieval.py
# at FULL widths, serving its SHAPES (training left out) on tables resident on
# the card.
TT_USER_VOCAB = 50_000_000  # reduced from 100M: a 102.4 GB fp32 table does not fit 80 GB
TT_ZIPF = 1.1  # popularity law of the ids over a seeded permutation of each vocab
TT_CORPUS_CHUNK = 262_144  # items per item_tower call over the corpus
TT_TOPK = 100
BAG_TOL = 1e-5  # fp32, tests/test_kernels.py:120: the same sums in another order
BAG_BF16_TOL = 5e-2  # the same test's bf16 tolerance, for tables of values ~1
# bf16 on the path's item table, whose values are ~3e-4 (vocab**-0.5), held
# relative to them: both sides sum in fp32 and round once to bf16, so they
# differ by at most one bf16 step (2^-8 relative) where the sums round apart;
# 1e-2 is above that and far below a wrong or missing row (~1/8 of a bag of 8)
BAG_BF16_REL = 1e-2
SERVE_TOL = 1e-5  # scores of the kernel path against the plain path


def rel_norm(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def zipf_ids(gen, perm, shape, a=TT_ZIPF):
    """int32 ids of ``shape``: Zipf(a) popularity ranks truncated to the
    vocab (the inverse CDF of the continuous law on [1, V + 1), floored),
    mapped through ``perm``, a seeded permutation of the vocab. Drawn on
    the card."""
    V = perm.shape[0]
    u = torch.rand(shape, generator=gen, device=perm.device, dtype=torch.float64)
    r = (1 - u * (1 - (V + 1.0) ** (1 - a))) ** (1 / (1 - a))
    return perm[(r.floor().long() - 1).clamp_(0, V - 1)].to(torch.int32)


def make_bags(gen, perm, n, fields, k):
    """Bags [n, fields, k]: Zipf ids, lengths uniform in [1, k]."""
    ids = zipf_ids(gen, perm, (n, fields, k))
    lengths = torch.randint(1, k + 1, (n, fields, 1), generator=gen, device=perm.device)
    return ids, torch.arange(k, device=perm.device) < lengths


def separated(scores, k, tol):
    """(ranks < k of each row's descending scores that lie more than
    ``tol`` from both neighbours, the sorted scores)."""
    s = torch.sort(scores, dim=-1, descending=True).values
    gap = (s[..., :-1] - s[..., 1:]) > tol
    edge = torch.ones_like(gap[..., :1])
    return (torch.cat([edge, gap], -1) & torch.cat([gap, edge], -1))[..., :k], s


def run_twotower(seed, dev):
    """Phase 9: the corpus embedded by ``item_tower``, then retrieval_cand,
    serve_p99 and serve_bulk through ``retrieval_step`` / ``serve_step``,
    with ``embedding_bag`` counted and captured around those calls only;
    then every captured call against the plain version, one bf16 call, the
    whole path with the plain version in the kernel's place, latency per
    shape and the kernel's row."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.configs import two_tower_retrieval as ttc
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.recsys import embedding as emb_mod
    from repro_torch.recsys import twotower as tt

    cfg = dataclasses.replace(ttc.FULL, user_vocab=TT_USER_VOCAB)
    print(f"recsys: reduced: user_vocab {ttc.FULL.user_vocab:,} -> {cfg.user_vocab:,} (a "
          f"{ttc.FULL.user_vocab * cfg.embed_dim * 4 / 1e9:.1f} GB fp32 table does not fit one "
          f"80 GB card); item_vocab {cfg.item_vocab:,}; training shape left out", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    t0 = time.perf_counter()
    params = tt.init_params(cfg, gen, device=dev)
    uperm = torch.randperm(cfg.user_vocab, generator=gen, device=dev)
    iperm = torch.randperm(cfg.item_vocab, generator=gen, device=dev)
    torch.cuda.synchronize()
    table_gb = sum(params[t].numel() * 4 for t in ("user_table", "item_table")) / 1e9
    print(f"recsys world: {table_gb:.1f} GB of tables, {cfg.param_count():,} parameters, "
          f"made in {time.perf_counter() - t0:.1f}s", flush=True)
    D, K, S = cfg.embed_dim, cfg.bag_size, ttc.SHAPES
    n_items = S["retrieval_cand"]["n_candidates"]
    users = {n: make_bags(gen, uperm, S[n]["batch"], cfg.user_fields, K)
             for n in ("retrieval_cand", "serve_p99", "serve_bulk")}
    cands = {n: torch.randint(0, n_items, (S[n]["batch"], S[n]["n_candidates"]),
                              generator=gen, device=dev) for n in ("serve_p99", "serve_bulk")}
    item_bags = [make_bags(gen, iperm, min(TT_CORPUS_CHUNK, n_items - s), cfg.item_fields, K)
                 for s in range(0, n_items, TT_CORPUS_CHUNK)]

    def corpus_of():
        return torch.cat([tt.item_tower(cfg, params, *b) for b in item_bags])

    def serve(name, corpus):
        ub, um = users[name]
        if name == "retrieval_cand":
            return tt.retrieval_step(cfg, params, ub, um, corpus, k=TT_TOPK)
        return tt.serve_step(cfg, params, ub, um, corpus[cands[name]])

    # the main path, counted and captured
    capture = CallCapture((emb_mod, "bag_op"))
    report = {}
    eb_ops.launches = 0
    with capture:
        t0 = time.perf_counter()
        corpus = corpus_of()
        torch.cuda.synchronize()
        report["corpus_s"] = time.perf_counter() - t0
        out = {n: serve(n, corpus) for n in users}
        torch.cuda.synchronize()
    report["embedding_bag_launches"] = launches = eb_ops.launches
    print(f"recsys launches: embedding_bag {launches} (corpus of {n_items:,} items in "
          f"{len(item_bags)} chunks, {report['corpus_s']:.3f}s; then "
          f"{', '.join(users)})", flush=True)
    assert launches > 0, "the towers never launched embedding_bag"
    for n, (a, b) in out.items():
        assert bool(torch.isfinite(a).all()), f"{n}: non-finite scores"

    # every call the towers made, against the plain version
    calls = capture.calls["bag_op"]
    err = 0.0
    for a, kw in calls:
        got, want = eb_ops.embedding_bag(*a, **kw), embedding_bag_ref(*a, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.allclose(got, want, rtol=BAG_TOL, atol=BAG_TOL), \
            f"embedding_bag disagrees with its plain version at ids {tuple(a[1].shape)}"
        err = max(err, float((got - want).abs().max()))
        del got, want
    (table, ids, mask), kw = max(calls, key=lambda c: c[0][1].shape[0])
    a0, kw0 = calls[0]  # a corpus chunk, on the item table
    tb = a0[0].to(torch.bfloat16)
    gb, wb = eb_ops.embedding_bag(tb, *a0[1:], **kw0), embedding_bag_ref(tb, *a0[1:], **kw0)
    bf16_rel = rel_norm(gb, wb)
    bf16_err, scale = float((gb.float() - wb.float()).abs().max()), float(wb.float().abs().max())
    print(f"kernel embedding_bag calls={len(calls)} (all within rtol=atol={BAG_TOL} of the "
          f"plain version, max abs err {err:.3e}); bf16 item table at ids "
          f"{tuple(a0[1].shape)}: relative norm {bf16_rel:.3e}, max abs err {bf16_err:.3e} of "
          f"max |want| {scale:.3e} (tol {BAG_BF16_REL} of each)", flush=True)
    assert gb.dtype == torch.bfloat16 and bf16_rel <= BAG_BF16_REL \
        and bf16_err <= BAG_BF16_REL * scale, "bf16 embedding_bag on the item table"
    del tb, gb, wb

    # the kernel on shapes the path does not reach (tables of values ~1,
    # widths off 256 and one off 8, the scalar kernel's, K up to 40, ids
    # past both ends, an empty bag)
    shapes = ((1000, 256, 4096, 16), (500, 40, 300, 5), (300, 16, 77, 1), (200, 264, 50, 40),
              (100, 8, 10, 33), (60, 20, 30, 7))
    for dt, tol in ((torch.float32, BAG_TOL), (torch.bfloat16, BAG_BF16_TOL)):
        worst = 0.0
        for V, Dc, Bc, Kc in shapes:
            t = torch.randn(V, Dc, generator=gen, device=dev).to(dt)
            ii = torch.randint(-5, V + 5, (Bc, Kc), generator=gen, device=dev, dtype=torch.int32)
            mm = torch.rand(Bc, Kc, generator=gen, device=dev) < 0.7
            mm[0] = False
            for mode in ("sum", "mean"):
                got, want = (eb_ops.embedding_bag(t, ii, mm, mode=mode),
                             embedding_bag_ref(t, ii, mm, mode=mode))
                assert got.dtype == dt and torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol), \
                    f"embedding_bag {str(dt)[6:]} V{V} D{Dc} B{Bc} K{Kc} {mode}"
                worst = max(worst, float((got.float() - want.float()).abs().max()))
        print(f"kernel embedding_bag synthetic {str(dt)[6:]}: {2 * len(shapes)} cases, max abs "
              f"err {worst:.3e} (tol {tol})", flush=True)

    # the whole path with the plain version in the kernel's place
    emb_mod.bag_op = embedding_bag_ref
    try:
        plain_corpus = corpus_of()
        plain = {n: serve(n, corpus) for n in users}
    finally:
        emb_mod.bag_op = eb_ops.embedding_bag
    cdiff = float((plain_corpus - corpus).abs().max())
    assert torch.allclose(corpus, plain_corpus, rtol=SERVE_TOL, atol=SERVE_TOL), "corpus"
    del plain_corpus
    for n in ("serve_p99", "serve_bulk"):
        (scores, best), (ps, pb) = out[n], plain[n]
        diff = float((scores - ps).abs().max())
        assert torch.allclose(scores, ps, rtol=SERVE_TOL, atol=SERVE_TOL), f"{n} scores"
        sep, _ = separated(ps, 1, SERVE_TOL)
        sep = sep[:, 0]
        assert torch.equal(best[sep], pb[sep]), f"{n}: best differs where the top two differ"
        report[n] = dict(max_abs_diff=diff, best_checked=int(sep.sum()), rows=int(sep.numel()))
    (vals, idx), (pv, pi) = out["retrieval_cand"], plain["retrieval_cand"]
    assert torch.allclose(vals, pv, rtol=SERVE_TOL, atol=SERVE_TOL), "retrieval scores"
    ub, um = users["retrieval_cand"]
    all_scores = tt.user_tower(cfg, params, ub, um) @ corpus.T
    sep, s = separated(all_scores, TT_TOPK, SERVE_TOL)
    assert torch.equal(idx[sep], pi[sep]), "top-100 ids differ at a separated rank"
    boundary = bool(s[0, TT_TOPK - 1] - s[0, TT_TOPK] > SERVE_TOL)
    if boundary:
        assert set(idx[0].tolist()) == set(pi[0].tolist()), "the top-100 sets differ"
    report["retrieval_cand"] = dict(max_abs_diff=float((vals - pv).abs().max()),
                                    ranks_checked=int(sep.sum()), set_checked=boundary)
    del plain, all_scores
    print(f"recsys vs plain path: corpus max abs diff {cdiff:.3e}; " + json.dumps(
        {n: report[n] for n in users}) + f" (tol {SERVE_TOL})", flush=True)

    # the tie rule on the card: the first 1,000 corpus rows repeat the 2nd
    # to 1,001st best other rows for this user, so every score but the best
    # comes twice and a pair straddles rank 100; the ids must be a stable
    # descending sort's (the lower index first among equal scores)
    u = tt.user_tower(cfg, params, ub, um)
    n_dup = 1_000
    best = n_dup + torch.topk((u @ corpus[n_dup:].T)[0], n_dup + 1).indices[1:]
    dup = corpus.clone()
    dup[:n_dup] = corpus[best]
    vals, idx = tt.retrieval_step(cfg, params, ub, um, dup, k=TT_TOPK)
    scores = u @ dup.T
    sv, si = torch.sort(scores, dim=-1, descending=True, stable=True)
    ties = int((sv[0, :TT_TOPK] == sv[0, 1:TT_TOPK + 1]).sum())
    straddle = bool(sv[0, TT_TOPK - 1] == sv[0, TT_TOPK])
    topk_equal = torch.equal(torch.topk(scores, TT_TOPK).indices, si[:, :TT_TOPK])
    assert torch.equal(idx, si[:, :TT_TOPK]) and torch.equal(vals, sv[:, :TT_TOPK]), \
        "retrieval_step's top-100 is not the stable sort's on tied scores"
    assert ties > 0 and straddle, f"the repeated rows gave no tie at rank 100 ({ties} ties)"
    topk_ms = {
        "top_k": cuda_ms(lambda: tt.top_k(scores, TT_TOPK)),
        "torch.topk": cuda_ms(lambda: torch.topk(scores, TT_TOPK)),
        "stable_sort": cuda_ms(lambda: torch.sort(scores, dim=-1, descending=True, stable=True)),
    }
    report["top_k"] = dict(ties_in_top=ties, straddles_rank_k=straddle,
                           torch_topk_ids_equal=topk_equal, **topk_ms)
    print(f"recsys top_k ties: {n_dup} repeated rows, {ties} equal neighbours in the top "
          f"{TT_TOPK} (one pair across rank {TT_TOPK}: {straddle}): ids equal a stable "
          f"sort's; torch.topk's ids equal: {topk_equal}", flush=True)
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.3f}"
    print(f"recsys top_k over {scores.shape[1]:,} items, k={TT_TOPK}: "
          + ", ".join(f"{n} {us(v)} us" for n, v in topk_ms.items()), flush=True)
    del dup, scores, sv, si

    # latency per shape, CUDA events around the entry point, warm
    for n, reps in (("retrieval_cand", 20), ("serve_p99", 20), ("serve_bulk", 5)):
        report[n]["ms"] = cuda_ms(lambda: serve(n, corpus), iters=reps, warmup=1)
    report["corpus_ms"] = cuda_ms(corpus_of, iters=2, warmup=0)
    print("recsys latency: " + json.dumps({n: report[n]["ms"] for n in users})
          + f", corpus of {n_items:,} items {report['corpus_ms']:.3f} ms", flush=True)

    # the kernel's row at the largest call, serve_bulk's user tower
    kern = lambda: eb_ops.embedding_bag(table, ids, mask, **kw)
    t = timings(kern, lambda: embedding_bag_ref(table, ids, mask, **kw), iters=(20, 5))
    ids64, w = ids.long(), mask.to(table.dtype)
    cnt = mask.sum(-1, keepdim=True).clamp(min=1).to(table.dtype)
    lib = lambda: F.embedding_bag(ids64, table, per_sample_weights=w, mode="sum") / cnt
    assert torch.allclose(lib(), embedding_bag_ref(table, ids, mask, **kw), rtol=BAG_TOL,
                          atol=BAG_TOL), "F.embedding_bag computes another function"
    lib_ms, lib_dev = cuda_ms(lib, iters=20), device_ms(lib)
    live = mask.sum()
    rows = int(torch.unique(ids[mask]).numel())
    B = ids.shape[0]
    nbytes = rows * D * table.element_size() + B * K * (4 + 1) + B * D * table.element_size()
    bms, by = bound_ms(nbytes, int(live) * D)
    print(f"kernel embedding_bag largest bags={B} K={K} D={D} unmasked={int(live)} "
          f"distinct_rows={rows} {fmt_us(t)} F.embedding_bag_us={us(lib_ms)} (device "
          f"{us(lib_dev)}) bound_us={bms * 1e3:.4f} ({by}, {nbytes} B; every lookup's row: "
          f"{int(live) * D * 4} B)", flush=True)
    # what bounds it: the same masks over three id sets, each beside its
    # bound (distinct rows once): the path's Zipf ids, the same ids folded
    # into 16,384 rows (16 MiB, L2-resident), uniform ids over the table
    # (every lookup from DRAM). If Zipf ~ uniform the hot rows are not
    # reused from L2; folded against Zipf separates latency from DRAM rate;
    # all three alike point at neither. Then the Zipf ids in sum mode (the
    # path's mode is mean), which leaves out the epilogue's division
    ub_ids = {"zipf": ids, "folded_16384": ids % 16_384,
              "uniform": torch.randint(0, table.shape[0], ids.shape, generator=gen,
                                       device=dev, dtype=torch.int32)}
    runs = [(n, ii, kw["mode"]) for n, ii in ub_ids.items()] + [("zipf", ids, "sum")]
    for name, ii, mode in runs:
        dev_ms = device_ms(lambda: eb_ops.embedding_bag(table, ii, mask, mode=mode))
        n_rows = int(torch.unique(ii[mask]).numel())
        nb = n_rows * D * table.element_size() + B * K * (4 + 1) + B * D * table.element_size()
        b_ms, _ = bound_ms(nb, int(live) * D)
        report.setdefault("bag_ids", {})[f"{name}_{mode}"] = dict(
            device_ms=dev_ms, bound_ms=b_ms, distinct_rows=n_rows)
        print(f"kernel embedding_bag ids={name} mode={mode} bags={B} K={K} D={D} "
              f"device_us={us(dev_ms)} bound_us={b_ms * 1e3:.4f} (distinct_rows={n_rows}, "
              f"{nb} B)", flush=True)
    del ub_ids
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    occ = _build.load("embedding_bag").embedding_bag_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for is_bf16, dt in ((0, "fp32"), (1, "bf16")):
        _build.check("embedding_bag occupancy", occ(is_bf16, ctypes.byref(regs),
                                                      ctypes.byref(blocks)))
        print(f"kernel embedding_bag occupancy {dt}: {regs.value} registers a thread, "
              f"{blocks.value} blocks of 256 threads an SM", flush=True)
    row = dict(name="embedding_bag", route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
               replaces="src/repro/kernels/embedding_bag/kernel.py:34", launches=launches,
               max_abs_err=err, **t, bound_ms=bms, bound_by=by, library_ms=lib_ms,
               library_device_ms=lib_dev, shape=f"bags={B},K={K},D={D}")
    return report, row


# ---------------------------------------------------------- LM serving
# Phase 10: Yi-6B (src/repro/configs/yi_6b.py FULL, bf16) prefill + decode.
LM_BATCH = 8  # reduced from prefill_32k's 32, to fit the time limit
LM_PROMPT = 4_000  # not a multiple of 64: the kernel's ragged tile runs on the path
LM_DECODE = 96  # the cache ends at 4,096, Yi-6B's published context
FLASH_TOL = 2e-2  # bf16, tests/test_kernels.py:51, for inputs of values ~1
FLASH_F32_TOL = 2e-5  # fp32, the same test
# The path's outputs are ~0.18 / sqrt(row + 1) (the reference's init gives
# near-uniform softmaxes), mostly below FLASH_TOL, so each launch is held
# relative to its own values: the relative norm of the difference over each
# 64-row band (one consumer warpgroup of the bf16 kernel's 128-row CTA; the
# fp32 kernel's query tile) of each sequence and head. Both sides round the
# same fp32 values to bf16, so they differ by at most one bf16 step (2^-8
# relative, below 8e-3 even were every element to round apart; measured
# ~1e-3); a dropped, repeated or misweighted key tile, or a warpgroup's
# stale running max, moves a band's mean of v by ~1e-1 of its norm or more
# (tests/test_torch_chip_checks.py).
FLASH_REL_TOL = 1e-2
# Prefill with the kernel against prefill with the plain version: each of
# the 32 layers' attention outputs may round to another bf16 neighbour
# (2^-9 = 2e-3 relative, from the online softmax's other rounding points),
# and independent roundings over 32 layers add to about sqrt(32) x 2e-3 =
# 1.1e-2 of the norm; 5e-2 leaves four times that.
PREFILL_REL_TOL = 5e-2


def band_rel(got, want, rows=64):
    """The largest relative norm of ``got - want`` over the ``rows``-row
    bands of each sequence and head of [B, S, H, dh] outputs."""
    d2 = (got.float() - want.float()).pow(2).sum(-1)  # [B, S, H]
    w2 = want.float().pow(2).sum(-1)
    pad = (-d2.shape[1]) % rows
    d2, w2 = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (d2, w2))
    B, S, H = d2.shape
    d2, w2 = (x.view(B, S // rows, rows, H).sum(2) for x in (d2, w2))
    return float((d2 / w2.clamp(min=1e-30)).sqrt().max())


def check_flash_calls(calls, where):
    """Every captured ``flash_attention`` call of a prefill against the
    plain version: within ``FLASH_REL_TOL`` relative norm, whole and per
    64-row band of each sequence and head. Returns (max abs err, worst
    relative norm, worst band)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    err = whole = band = 0.0
    for i, (a, kwa) in enumerate(calls):
        got, want = fa_ops.flash_attention(*a, **kwa), flash_attention_ref(*a, **kwa)
        assert got.dtype == want.dtype and got.shape == want.shape
        r, rb = rel_norm(got, want), band_rel(got, want)
        assert r <= FLASH_REL_TOL and rb <= FLASH_REL_TOL, (
            f"flash_attention launch {i}{where} disagrees with its plain version at q "
            f"{tuple(a[0].shape)}: relative norm {r:.3e}, worst 64-row band {rb:.3e}")
        err, whole, band = (max(err, float((got.float() - want.float()).abs().max())),
                            max(whole, r), max(band, rb))
        del got, want
    print(f"kernel flash_attention{where} calls={len(calls)} (each within a relative norm of "
          f"{FLASH_REL_TOL} of the plain version, whole and per 64-row band of each sequence "
          f"and head): worst relative norm {whole:.3e}, worst band {band:.3e}, max abs err "
          f"{err:.3e}", flush=True)
    return err, whole, band


def run_lm(seed, dev):
    """Phase 10: prefill 8 x 4,000 tokens, copy the KV into a 4,096 cache,
    decode 96 tokens greedily; ``flash_attention`` counted and captured
    around the prefill only. Then every captured call against the plain
    version, the prefill with the plain version in the kernel's place, a
    profile window over one prefill, the kernel on shapes the path does
    not reach, and the kernel's row."""
    import torch.nn.functional as F
    from repro_torch.configs import yi_6b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.lm import model as lm_model

    cfg = yi_6b.FULL
    B, S, T = LM_BATCH, LM_PROMPT, LM_DECODE
    print(f"lm: reduced: prefill_32k's batch 32 x 32,768 -> a prompt of {B} x {S:,} and "
          f"{T} decode steps (cache {S + T:,}, Yi-6B's published context)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 53)
    t0 = time.perf_counter()
    params = lm_model.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in
                  [params[k] for k in ("embed", "unembed", "final_norm")]
                  + list(params["layers"].values()))
    print(f"lm world: {cfg.name} {cfg.param_count():,} parameters, {n_bytes / 1e9:.2f} GB "
          f"bf16, made in {time.perf_counter() - t0:.1f}s", flush=True)

    capture = CallCapture((lm_model, "flash_attention"))
    report = {}
    fa_ops.launches = fa_ops.launches_bf16_tc = fa_ops.launches_f32_simt = 0
    with capture:
        t0 = time.perf_counter()
        logits, kv = lm_model.prefill_logits(cfg, params, tokens)
        torch.cuda.synchronize()
        report["prefill_first_s"] = time.perf_counter() - t0
    report["flash_attention_launches"] = launches = fa_ops.launches
    assert launches == cfg.n_layers, f"{launches} flash_attention launches in one prefill"
    tc_launches = fa_ops.launches_bf16_tc
    assert tc_launches == launches and fa_ops.launches_f32_simt == 0, (
        f"prefill launches: {fa_ops.launches_bf16_tc} bf16 tensor-core, "
        f"{fa_ops.launches_f32_simt} fp32 SIMT; all {launches} must take the tensor cores")
    print(f"lm flash_attention routes: {tc_launches} of {launches} prefill "
          f"launches on the bf16 tensor-core kernel", flush=True)
    tok = torch.argmax(logits, -1).to(torch.int32)
    cache = lm_model.init_kv_cache(cfg, B, S + T, device=dev)
    cache.k[:, :, :S], cache.v[:, :, :S] = kv.k, kv.v
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(T):
        tok, cache = lm_model.decode_step(cfg, params, cache, tok, S + i)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    out = torch.cat(out, 1)
    assert out.shape == (B, T) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab, \
        "decode tokens out of range"
    assert torch.equal(cache.k[:, :, :S], kv.k) and torch.equal(cache.v[:, :, :S], kv.v), \
        "decode changed the prompt's cache"
    written = cache.k[:, :, S:].abs().amax(dim=(0, 1, 3, 4)) > 0
    assert bool(written.all()) and bool((cache.v[:, :, S:].abs().amax(dim=(0, 1, 3, 4)) > 0).all()), \
        f"cache positions {S}..{S + T - 1} not all written"
    report.update(decode_ms_per_step=decode_s * 1e3 / T, decode_tokens_per_s=B * T / decode_s)

    # every launch of the prefill against the plain version
    calls = capture.calls["flash_attention"]
    err, whole, band = check_flash_calls(calls, "")
    (q, k, v), kw = calls[-1]
    del calls, capture

    # the prefill with the plain version in the kernel's place
    lm_model.flash_attention = flash_attention_ref
    try:
        p_logits, p_kv = lm_model.prefill_logits(cfg, params, tokens)
    finally:
        lm_model.flash_attention = fa_ops.flash_attention
    diffs = dict(logits=rel_norm(logits, p_logits), k=rel_norm(kv.k, p_kv.k),
                 v=rel_norm(kv.v, p_kv.v),
                 logits_max_abs=float((logits - p_logits).abs().max()),
                 kv_max_abs=max(float((kv.k.float() - p_kv.k.float()).abs().max()),
                                float((kv.v.float() - p_kv.v.float()).abs().max())),
                 next_token_equal=float((torch.argmax(logits, -1) == torch.argmax(p_logits, -1))
                                        .float().mean()))
    print(f"lm prefill vs plain-attention prefill: " + json.dumps(diffs)
          + f" (relative-norm tol {PREFILL_REL_TOL})", flush=True)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    for n in ("logits", "k", "v"):
        assert diffs[n] <= PREFILL_REL_TOL, f"prefill {n} differs from the plain prefill's"
    report["vs_plain"] = diffs
    del p_logits, p_kv

    # a warm prefill, timed, then one under the profiler
    prefill = lambda: lm_model.prefill_logits(cfg, params, tokens)
    report["prefill_ms"] = cuda_ms(prefill, iters=1, warmup=0)
    report["prefill_tokens_per_s"] = B * S / report["prefill_ms"] * 1e3
    wall, busy = profiled(" lm prefill", f"one {cfg.name} prefill ({B} x {S:,})", prefill,
                          host_ops=False)
    if busy is not None:
        report["prefill_idle_share"] = 1 - busy / wall
    # one more decode step, at the last position again (the checks are done)
    last = out[:, -2:-1].contiguous()
    wall, busy = profiled(" lm decode", f"one decode step ({B} tokens, cache {S + T:,})",
                          lambda: lm_model.decode_step(cfg, params, cache, last, S + T - 1),
                          host_ops=False)
    if busy is not None:
        report["decode_idle_share"] = 1 - busy / wall
    print("lm: " + json.dumps(report), flush=True)

    # the kernel on shapes the path does not reach, each against its plain version
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, Sq, Sk, H, KV, dh, dtype, causal, window, q_offset
        ("gemma3 window", 1, 2048, 2048, 8, 4, 256, bf, True, 1024, 0),
        ("dh 112", 2, 1000, 1000, 8, 2, 112, bf, True, None, 0),
        ("dh 16", 2, 513, 513, 4, 4, 16, bf, True, None, 0),
        ("fp32 GQA", 2, 1000, 1000, 32, 4, 128, f32, True, None, 0),
        ("q_offset 3996", 2, 100, 4096, 32, 4, 128, bf, True, None, 3996),
        # the bf16 kernel's tiling: 128-row CTAs of two 64-row warpgroups,
        # 128-key tiles (64 at dh 256)
        ("GQA G 8", 2, 1000, 1000, 32, 4, 128, bf, True, None, 0),
        ("129 causal", 2, 129, 129, 8, 2, 128, bf, True, None, 0),
        ("129 non-causal", 2, 129, 129, 8, 2, 128, bf, False, None, 0),
        ("q_offset 3996 window, G 8", 1, 100, 4096, 8, 1, 128, bf, True, 1000, 3996),
        ("q_offset window, empty rows", 1, 100, 64, 4, 2, 32, f32, True, 8, 30),
    ] + [(name, *shape, dt, *mask) for dt in (bf, f32) for name, shape, mask in (
        ("non-causal 48x96", (1, 48, 96, 2, 2, 64), (False, None, 0)),
        ("non-causal window", (1, 100, 96, 4, 2, 32), (False, 20, 0)),
        ("negative q_offset, empty rows", (1, 70, 64, 2, 1, 32), (True, None, -5)),
        ("dh 24 window", (1, 65, 65, 2, 1, 24), (True, 7, 0)),
        ("one tile", (1, 32, 32, 1, 1, 16), (True, None, 0)),
    )]
    for name, b, sq, sk, h, nkv, dh, dt, causal, window, off in cases:
        qq = torch.randn(b, sq, h, dh, generator=gen, device=dev).to(dt)
        kk = torch.randn(b, sk, nkv, dh, generator=gen, device=dev).to(dt)
        vv = torch.randn(b, sk, nkv, dh, generator=gen, device=dev).to(dt)
        kwc = dict(causal=causal, window=window, q_offset=off)
        got, want = fa_ops.flash_attention(qq, kk, vv, **kwc), flash_attention_ref(qq, kk, vv, **kwc)
        tol, rel = (FLASH_TOL, FLASH_REL_TOL) if dt == bf else (FLASH_F32_TOL, FLASH_F32_TOL)
        e, rb = float((got.float() - want.float()).abs().max()), band_rel(got, want)
        print(f"kernel flash_attention case {name}: q {tuple(qq.shape)} k {tuple(kk.shape)} "
              f"{str(dt)[6:]} causal={causal} window={window} q_offset={off} max abs err "
              f"{e:.3e} (tol {tol}), worst 64-row band relative norm {rb:.3e} (tol {rel})",
              flush=True)
        assert got.dtype == dt and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol) \
            and rb <= rel, f"flash_attention disagrees with its plain version: {name}"

    # the kernel's row at the path's call (every layer has this shape)
    t = timings(lambda: fa_ops.flash_attention(q, k, v, **kw),
                lambda: flash_attention_ref(q, k, v, **kw), iters=(5, 2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # untimed
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - flash_attention_ref(q, k, v, **kw).float())
                    .abs().max())
    lib_ms, lib_dev = cuda_ms(lib, iters=20), device_ms(lib)
    vs_sdpa = None if t["device_ms"] is None or lib_dev is None else t["device_ms"] / lib_dev
    Bq, Sq, H, dh = q.shape
    allowed = Sq * (Sq + 1) // 2  # causal, no window, q_offset 0
    flops = 4 * Bq * H * allowed * dh
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3
    bms, by = (tb, "bytes") if tb >= to else (to, "operations")
    us = lambda x: "not measured" if x is None else f"{x * 1e3:.3f}"
    print(f"kernel flash_attention largest q={tuple(q.shape)} k={tuple(k.shape)} {fmt_us(t)} "
          f"sdpa_us={us(lib_ms)} (device {us(lib_dev)}, max abs diff {lib_err:.3e}; kernel / "
          f"sdpa device {'not measured' if vs_sdpa is None else f'{vs_sdpa:.3f}'}) "
          f"bound_us={bms * 1e3:.4f} ({by}: {flops:.4e} FLOP at the bf16 tensor peak; "
          f"{nbytes} B)", flush=True)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/kernel.py:68", launches=launches,
               max_abs_err=err, **t, bound_ms=bms, bound_by=by, library_ms=lib_ms,
               library_device_ms=lib_dev, device_vs_library=vs_sdpa,
               launches_bf16_tc=tc_launches, sass=flash_sass_counts(),
               shape=f"q={tuple(q.shape)},k={tuple(k.shape)}")
    return report, row


def flash_sass_counts(name="flash_attention"):
    """The counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions in
    the built library of ``csrc/<name>.cu``'s SASS, or None where the
    toolkit has no cuobjdump."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = _build.build_dir() / f"lib{name}.so"
    if not os.path.exists(tool):
        print(f"kernel {name} sass: not available (no cuobjdump)", flush=True)
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    print(f"kernel {name} sass: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG "
          f"instructions in {lib.name}", flush=True)
    return counts


def ptxas_kernels(name):
    """{kernel: {"registers", "spill_bytes"}} for each entry function of
    ``csrc/<name>.cu`` from the build's ``ptxas -v`` report (kernel as
    ``<function><DHP>``, e.g. ``flash_attention_bwd_dq_tc_kernel<256>``),
    or None where this process found the libraries built and compiled
    nothing."""
    from repro_torch.kernels import _build

    report = _build.BUILD_INFO.get("ptxas", {}).get(name)
    if report is None:
        return None
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym = m.group(1)
            i, name = 3, sym  # _ZN, then length-prefixed names: the last is the kernel
            while i < len(sym) and sym[i].isdigit():
                j = re.match(r"\d+", sym[i:]).end() + i
                name, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
            dhp = re.match(r"ILi(\d+)E(f?)", sym[i:])
            cur = name + (f"<{dhp.group(1)}>" + ("<float>" if dhp.group(2) else "") if dhp else "")
            out[cur] = {"registers": None, "spill_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------- 16. training
TRAIN_SEQ = 4096  # train_4k's sequence
TRAIN_ARGV = ["--arch", "gemma3-4b", "--steps", "3", "--batch", "1", "--seq", str(TRAIN_SEQ),
              "--log-every", "1"]
FA_BWD_CASES = [  # name, B, Sq, Sk, H, KV, dh, causal, window, q_offset, timed
    ("gemma3 global", 1, 4096, 4096, 8, 4, 256, True, None, 0, True),
    ("gemma3 local", 1, 4096, 4096, 8, 4, 256, True, 1024, 0, True),
    ("GQA dh 128", 2, 1000, 1000, 32, 4, 128, True, None, 0, False),
    ("ragged non-causal", 1, 333, 517, 4, 2, 64, False, None, 0, False),
    ("q_offset window", 1, 100, 700, 8, 2, 128, True, 256, 600, False),
    ("negative q_offset, empty rows", 1, 130, 80, 2, 1, 32, True, None, -70, False),
]
# the backward kernels against their plain version on the same inputs: fp32
# max-abs within 1e-4 of the largest plain value (fp32 sums in another
# order over up to 4,096 keys); bf16 (accumulated in fp32, rounded once to
# bf16 at the end, as the plain version) within 2e-2 relative norm of the
# fp32 yardstick: the plain backward of the same values in fp32
FA_BWD_F32_TOL = 1e-4
FA_BWD_BF16_REL = 2e-2
# the with-lse forward's row lse against the plain one's: both sum the same
# fp32 scores, and the lse is ~ln(Sk) + 1 (8-12 here), where one fp32 step is
# 9.5e-7; measured on an H100 at most 1.9e-6 bf16 and 9.5e-7 fp32 over these
# cases. A row with no allowed key is -1e30 on both sides. Its output o is
# held to phase 10's FLASH_TOL / FLASH_F32_TOL.
FA_LSE_TOL = 1e-5
LM100M_STEPS, LM100M_CKPT_AT = 60, 30
RESUME_REL_TOL = 1e-4  # a resumed run's losses against the uninterrupted run's
COMPRESS_STEPS = 20
PNA_TRAIN_STEPS = 5
PNA_BWD_TOL = 1e-5  # fp32 segment sums in another order, as phase 8's


def attn_bwd_cost(b, sq, sk, h, kv, dh, es, causal, window, q_offset, dev, forward=False):
    """(FLOPs, bytes) the backward needs: 5 products over the allowed
    scores (recompute s, dp = do v^T, dv, dk, dq); q, k, v, o, do and lse
    read once, dq, dk, dv written once. With ``forward``, those of the
    with-lse forward: 2 products (s, p v); q, k, v read once, o and lse
    written once."""
    from repro_torch.kernels.flash_attention.ref import band_mask

    allowed = int(band_mask(sq, sk, causal=causal, window=window, q_offset=q_offset,
                            device=dev).sum())
    if forward:
        return (4 * b * h * allowed * dh,
                2 * b * sq * h * dh * es + 2 * b * sk * kv * dh * es + 4 * b * h * sq)
    flops = 10 * b * h * allowed * dh
    nbytes = 4 * b * sq * h * dh * es + 4 * b * sk * kv * dh * es + 4 * b * h * sq
    return flops, nbytes


def check_bwd_build():
    """ptxas's registers and spill bytes for each backward kernel, printed;
    none of the bf16 tensor-core instantiations may spill. Returns them, or
    None where this process compiled nothing."""
    regs = ptxas_kernels("flash_attention_bwd")
    if regs is None:
        print("kernel flash_attention_bwd ptxas: not available (the libraries were built "
              "before this process)", flush=True)
        return None
    for name, r in regs.items():
        print(f"kernel flash_attention_bwd ptxas {name}: {r['registers']} registers, "
              f"{r['spill_bytes']} spill bytes", flush=True)
    tc = {k: r for k, r in regs.items() if "_tc_" in k}
    assert len(tc) == 6, f"expected the dq and dk / dv kernels at DHP 64, 128, 256: {sorted(tc)}"
    assert not any(r["spill_bytes"] for r in tc.values()), f"a bf16 backward kernel spills: {tc}"
    return regs


def check_attention_backward(seed, dev):
    """Phase 16 (a): the backward kernels against their plain version on
    the path's shapes (Gemma3-4B's global and local layers) and on shapes
    it does not reach, bf16 and fp32; times at the path's two shapes beside
    the bound and SDPA's backward. Returns (worst max abs error, timed rows)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import (band_mask, flash_attention_bwd_ref,
                                                         flash_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(seed + 71)
    bf, f32 = torch.bfloat16, torch.float32
    worst, rows, fwd_rows = 0.0, [], []
    for name, b, sq, sk, h, nkv, dh, causal, window, off, timed in FA_BWD_CASES:
        for dt in (bf, f32):
            q = torch.randn(b, sq, h, dh, generator=gen, device=dev).to(dt)
            k = torch.randn(b, sk, nkv, dh, generator=gen, device=dev).to(dt)
            v = torch.randn(b, sk, nkv, dh, generator=gen, device=dev).to(dt)
            do = torch.randn(b, sq, h, dh, generator=gen, device=dev).to(dt)
            kw = dict(causal=causal, window=window, q_offset=off)
            o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window or 0,
                                          q_offset=off, with_lse=True)
            p_o, p_lse = flash_attention_ref(q, k, v, with_lse=True, **kw)
            lse_err = float((lse - p_lse).abs().max())
            o_tol = FLASH_F32_TOL if dt == f32 else FLASH_TOL
            o_err = float((o.float() - p_o.float()).abs().max())
            got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            want = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            # no atomics: a second call repeats the first bit for bit
            again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            same = all(torch.equal(a, x) for a, x in zip(got, again))
            del again
            torch.cuda.synchronize()
            err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
            worst = max(worst, err)
            if dt == f32:
                # and from the plain forward's o and lse, so that a wrong
                # forward lse cannot pass through both sides alike
                p_err = max(float((a - w).abs().max()) for a, w in
                            zip(got, flash_attention_bwd_ref(q, k, v, p_o, do, p_lse, **kw)))
                worst = max(worst, p_err)
                scale = max(float(w.abs().max()) for w in want)
                ok = max(err, p_err) <= FA_BWD_F32_TOL * scale
                what = (f"max abs err {err:.3e}, {p_err:.3e} from the plain forward's o and lse "
                        f"(tol {FA_BWD_F32_TOL} x {scale:.3e})")
            else:
                x32 = [t.float() for t in (q, k, v)]
                o32, lse32 = flash_attention_ref(*x32, with_lse=True, **kw)
                yard = flash_attention_bwd_ref(*x32, o32, do.float(), lse32, **kw)
                rels = [rel_norm(a, w) for a, w in zip(got, yard)]
                ok = max(rels) <= FA_BWD_BF16_REL
                what = (f"relative norm vs fp32 yardstick dq/dk/dv {rels[0]:.3e} / {rels[1]:.3e}"
                        f" / {rels[2]:.3e} (tol {FA_BWD_BF16_REL}); max abs err vs bf16 plain "
                        f"{err:.3e}")
                del o32, lse32, yard, x32
            print(f"kernel flash_attention_bwd case {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                  f"{str(dt)[6:]} causal={causal} window={window} q_offset={off}: {what}; "
                  f"a second call {'equal' if same else 'DIFFERS'}; "
                  f"forward with lse: lse max abs err {lse_err:.3e} (tol {FA_LSE_TOL}), o max "
                  f"abs err {o_err:.3e} (tol {o_tol})", flush=True)
            assert lse.dtype == f32 and lse.shape == p_lse.shape and lse_err <= FA_LSE_TOL, \
                f"the forward's lse disagrees with its plain version: {name} {dt}"
            assert o.dtype == dt and torch.allclose(o.float(), p_o.float(), rtol=o_tol,
                                                    atol=o_tol), \
                f"the with-lse forward's o disagrees with its plain version: {name} {dt}"
            assert all(a.dtype == dt and a.shape == w.shape for a, w in zip(got, want))
            assert ok, f"flash_attention_bwd disagrees with its plain version: {name} {dt}"
            assert same, f"two flash_attention_bwd calls differ: {name} {dt}"
            del got, want, p_o, p_lse
            if timed and dt == bf:
                t = timings(lambda: fa_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw),
                            lambda: flash_attention_bwd_ref(q, k, v, o, do, lse, **kw),
                            iters=(5, 2))
                qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                              for x in (q, k, v))
                mask = None
                if window:
                    mask = band_mask(sq, sk, causal=True, window=window, q_offset=0, device=dev)
                lo = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                    is_causal=mask is None, enable_gqa=True)
                dot = do.transpose(1, 2).contiguous()
                lib = lambda: torch.autograd.grad(lo, (qt, kt, vt), dot, retain_graph=True)
                lib_ms, lib_dev = cuda_ms(lib, iters=5, warmup=2), device_ms(lib, iters=5)
                flops, nbytes = attn_bwd_cost(b, sq, sk, h, nkv, dh, 2, causal, window, off, dev)
                tb, to = nbytes / HBM_BYTES_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3
                bms, by = (tb, "bytes") if tb >= to else (to, "operations")
                us = lambda x: "not measured" if x is None else f"{x * 1e3:.3f}"
                print(f"kernel flash_attention_bwd {name} q={tuple(q.shape)} k={tuple(k.shape)} "
                      f"bf16 {fmt_us(t)} sdpa_backward_us={us(lib_ms)} (device {us(lib_dev)}"
                      f"{', boolean band mask' if mask is not None else ''}) "
                      f"bound_us={bms * 1e3:.4f} ({by}: {flops:.4e} FLOP at the bf16 tensor "
                      f"peak; {nbytes} B)", flush=True)
                rows.append(dict(shape=name, **t, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                 library_device_ms=lib_dev, flops=flops, bytes=nbytes))
                # the with-lse forward that training runs, at the same shape
                ft = timings(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                          window=window or 0, q_offset=off,
                                                          with_lse=True),
                             lambda: flash_attention_ref(q, k, v, with_lse=True, **kw),
                             iters=(20, 2))
                qd, kd, vd = (x.detach() for x in (qt, kt, vt))
                flib = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                              is_causal=mask is None,
                                                              enable_gqa=True)
                flib_ms, flib_dev = cuda_ms(flib, iters=20), device_ms(flib)
                fflops, fbytes = attn_bwd_cost(b, sq, sk, h, nkv, dh, 2, causal, window, off, dev,
                                               forward=True)
                ftb, fto = fbytes / HBM_BYTES_S * 1e3, fflops / BF16_TENSOR_FLOPS * 1e3
                fbms, fby = (ftb, "bytes") if ftb >= fto else (fto, "operations")
                print(f"kernel flash_attention with lse {name} q={tuple(q.shape)} "
                      f"k={tuple(k.shape)} bf16 {fmt_us(ft)} sdpa_forward_us={us(flib_ms)} "
                      f"(device {us(flib_dev)}) bound_us={fbms * 1e3:.4f} ({fby}: {fflops:.4e} "
                      f"FLOP at the bf16 tensor peak; {fbytes} B)", flush=True)
                fwd_rows.append(dict(shape=name, **ft, bound_ms=fbms, bound_by=fby,
                                     library_ms=flib_ms, library_device_ms=flib_dev,
                                     flops=fflops, bytes=fbytes))
                del qt, kt, vt, qd, kd, vd, lo, dot
            del q, k, v, do, o, lse
    return worst, rows, fwd_rows


REMAT_AB_STEPS = 3  # a policy's steps in each of its two turns; the first is left out


def compare_remat_policies(step, params, opt_state, tokens, labels):
    """The port's remat (each block recomputed whole, its GEMMs included)
    against the reference's policy, ``dots_with_no_batch_dims_saveable``,
    written in torch as a selective checkpoint that keeps every ``aten.mm``
    output of a block: ms a step and peak memory, in the order port,
    reference, reference, port. Returns {policy: (median ms, peak GiB)}."""
    import functools

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    from repro_torch.lm import model as lm_model

    keep_mm = functools.partial(create_selective_checkpoint_contexts, [torch.ops.aten.mm.default])

    def saving_mm(fn, *a, **kw):
        if fn is lm_model._block:
            kw["context_fn"] = keep_mm
        return checkpoint(fn, *a, **kw)

    ms, peak = {"port": [], "keep_mm": []}, {}
    for name in ("port", "keep_mm", "keep_mm", "port"):
        lm_model.checkpoint = saving_mm if name == "keep_mm" else checkpoint
        torch.cuda.reset_peak_memory_stats()
        try:
            for i in range(REMAT_AB_STEPS):
                t = time.perf_counter()
                step(params, opt_state, tokens, labels)
                torch.cuda.synchronize()
                if i:
                    ms[name].append((time.perf_counter() - t) * 1e3)
        finally:
            lm_model.checkpoint = checkpoint
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    out = {k: (float(np.median(v)), peak[k]) for k, v in ms.items()}
    print(f"train remat policy (port, keep_mm, keep_mm, port; {REMAT_AB_STEPS - 1} timed steps "
          f"a turn): whole blocks {out['port'][0]:.3f} ms a step, peak {out['port'][1]:.2f} GiB; "
          f"keeping the GEMM outputs {out['keep_mm'][0]:.3f} ms, peak {out['keep_mm'][1]:.2f} "
          f"GiB; steps {json.dumps(ms)}", flush=True)
    return out


def run_train(seed, dev):
    """Phase 16: (a) the attention backward kernels; (b) Gemma3-4B FULL,
    3 training steps of 1 x 4,096 tokens through ``launch.train.main``, the
    attention kernels' launches counted around it, then one more step
    under the profiler; (c) the ~100M LM of
    ``examples/train_lm_100m_torch.py``, 60 steps with a checkpoint at 30,
    a run resumed from it, and ``--compress-grads`` at ``--smoke``.
    Returns the backward kernel's row, the flash_attention forward's
    launches in training and its times at Gemma3-4B's shapes."""
    import importlib.util
    import shutil
    import tempfile

    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.configs import gemma3_4b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.lm import model as lm_model

    t_phase = time.perf_counter()
    regs = check_bwd_build()
    sass = flash_sass_counts("flash_attention_bwd")
    assert sass is None or min(sass.values()) > 0, sass
    err, timed, fwd_timed = check_attention_backward(seed, dev)
    free_device()

    # (b) Gemma3-4B FULL through the training entry point, counted
    cfg = gemma3_4b.FULL
    print(f"train: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} KV, head dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab:,}, window {cfg.sliding_window} in a {cfg.local_global_pattern}:1 "
          f"local:global pattern), {cfg.dtype}, remat; reduced: train_4k's global batch 256 "
          f"-> 1 sequence of {TRAIN_SEQ:,}, 3 steps", flush=True)
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = fa_ops.launches_bf16_tc = fa_ops.launches_f32_simt = 0
    fa_ops.launches_fwd_lse = fa_ops.launches_bwd = 0
    keep = {}
    t0 = time.perf_counter()
    losses = train_mod.main(TRAIN_ARGV, keep=keep)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    steps = len(losses)
    counts = dict(forward=fa_ops.launches, forward_with_lse=fa_ops.launches_fwd_lse,
                  backward=fa_ops.launches_bwd, bf16_tc=fa_ops.launches_bf16_tc)
    peak = torch.cuda.max_memory_allocated()
    params, opt_state = keep["params"], keep["opt_state"]
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    report = dict(losses=losses, grad_norm=keep["grad_norm"],
                  step_ms=[x * 1e3 for x in keep["step_s"]], run_s=run_s, peak_gib=peak / 2**30, launches=counts,
                  launches_per_step={k: v / steps for k, v in counts.items()},
                  params_finite=finite)
    print("train gemma3-4b: " + json.dumps(report), flush=True)
    assert steps == 3 and all(np.isfinite(losses)) and all(np.isfinite(keep["grad_norm"])), report
    assert finite, "non-finite parameters after the steps"
    assert counts["backward"] == steps * cfg.n_layers, counts
    assert counts["forward_with_lse"] == 2 * steps * cfg.n_layers == counts["forward"] == \
        counts["bf16_tc"], counts  # the forward and remat's recompute, all on the tensor cores

    # one more step under the profiler; the forward's launches split from
    # the recompute's by a count taken as the loss returns
    _, step = train_mod.build(cfg, 3e-3, 3, compress=False)
    tokens, labels = next(train_mod.synthetic_batches(cfg.vocab, 1, TRAIN_SEQ, seed=seed + 1,
                                                      device=dev))
    split = {}
    inner = lm_model.loss_fn

    def loss_counted(*a, **kw):
        out = inner(*a, **kw)
        split["forward"] = fa_ops.launches_fwd_lse
        return out

    fa_ops.launches_fwd_lse = fa_ops.launches_bwd = 0
    lm_model.loss_fn = loss_counted
    kernels = {}
    try:
        wall, busy = profiled(" train", "one gemma3-4b training step (1 x 4,096)",
                              lambda: step(params, opt_state, tokens, labels), host_ops=False,
                              by_kernel=kernels)
    finally:
        lm_model.loss_fn = inner
    split.update(recompute=fa_ops.launches_fwd_lse - split["forward"], backward=fa_ops.launches_bwd)
    # the attention backward's share of the step: its two kernels' device time
    bwd = {}
    for name, (us_, n) in kernels.items():
        m = re.search(r"flash_attention_bwd_\w+", name)
        if m:
            bwd[m.group(0)] = (bwd.get(m.group(0), (0.0, 0))[0] + us_ / 1e3,
                               bwd.get(m.group(0), (0.0, 0))[1] + n)
    bwd_ms = sum(ms for ms, _ in bwd.values())
    report["profiled_step"] = dict(wall_ms=wall, busy_ms=busy, launches=split,
                                   idle_share=None if busy is None else 1 - busy / wall,
                                   attention_backward_ms=bwd_ms,
                                   attention_backward_share=None if not busy else bwd_ms / busy,
                                   attention_backward_kernels=bwd)
    print(f"train step attention backward: {bwd_ms:.3f} ms device of the step's "
          f"{'not measured' if busy is None else f'{busy:.3f}'} ms busy / {wall:.3f} ms wall ("
          f"{'not measured' if not busy else f'{bwd_ms / busy:.2%}'} of busy); "
          + ", ".join(f"{k} {ms:.3f} ms in {n} calls" for k, (ms, n) in sorted(bwd.items())),
          flush=True)
    print(f"train step launches: forward {split['forward']}, recompute {split['recompute']}, "
          f"backward {split['backward']} (flash_attention / its backward kernels, "
          f"{cfg.n_layers} layers)", flush=True)
    assert split == {"forward": cfg.n_layers, "recompute": cfg.n_layers,
                     "backward": cfg.n_layers}, split
    report["remat_policy"] = compare_remat_policies(step, params, opt_state, tokens, labels)
    del params, opt_state, keep, step, tokens, labels
    free_device()

    # (c) the ~100M LM: the loss falls, a resume repeats the losses
    spec = importlib.util.spec_from_file_location(
        "train_lm_100m_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "examples", "train_lm_100m_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    tmp = tempfile.mkdtemp(prefix="lm100m_")
    try:
        t0 = time.perf_counter()
        full = ex.run(LM100M_STEPS, ckpt=os.path.join(tmp, "a"), ckpt_every=LM100M_CKPT_AT,
                      device=dev, log_every=10)
        full_s = time.perf_counter() - t0
        shutil.copytree(os.path.join(tmp, "a", f"step_{LM100M_CKPT_AT}"),
                        os.path.join(tmp, "b", f"step_{LM100M_CKPT_AT}"))
        resumed = ex.run(LM100M_STEPS, ckpt=os.path.join(tmp, "b"), ckpt_every=LM100M_CKPT_AT,
                         resume=True, device=dev, log_every=10)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    head, tail = float(np.mean(full[:10])), float(np.mean(full[-10:]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[LM100M_CKPT_AT:]))
    report["lm100m"] = dict(loss_first10=head, loss_last10=tail, resume_max_rel=rel,
                            s=full_s, ms_per_step=full_s * 1e3 / LM100M_STEPS)
    print(f"train lm-100m: {LM100M_STEPS} steps in {full_s:.1f}s, mean loss steps 1-10 "
          f"{head:.4f} -> {LM100M_STEPS - 9}-{LM100M_STEPS} {tail:.4f}; resumed from step "
          f"{LM100M_CKPT_AT}: steps "
          f"{LM100M_CKPT_AT + 1}-{LM100M_STEPS} within {rel:.3e} relative of the uninterrupted "
          f"run (tol {RESUME_REL_TOL})", flush=True)
    assert len(full) == LM100M_STEPS and all(np.isfinite(full)) and tail < head, report["lm100m"]
    assert len(resumed) == LM100M_STEPS - LM100M_CKPT_AT and rel <= RESUME_REL_TOL, rel
    comp = train_mod.main(["--arch", "gemma3-4b", "--smoke", "--steps", str(COMPRESS_STEPS),
                           "--compress-grads", "--log-every", "10"])
    print(f"train --compress-grads --smoke: {len(comp)} steps, losses {comp[0]:.4f} -> "
          f"{comp[-1]:.4f}", flush=True)
    assert len(comp) == COMPRESS_STEPS and all(np.isfinite(comp)), comp
    report["compress_losses"] = comp
    print(f"train phase: {time.perf_counter() - t_phase:.1f}s", flush=True)

    big = timed[0]
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="none: the JAX package differentiates the plain-JAX "
                        "src/repro/lm/attention.py:33",
               launches=counts["backward"], max_abs_err=err,
               **{k: big[k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "library_device_ms")},
               library="SDPA backward (flash, is_causal, enable_gqa)",
               shape="gemma3 global: q=(1, 4096, 8, 256), k=(1, 4096, 4, 256), causal",
               timed_shapes=timed, kernels_per_launch=2, ptxas=regs, sass=sass,
               step_share=report["profiled_step"]["attention_backward_share"])
    return report, row, counts["forward"], fwd_timed


def run_pna_train(cfg, params, g):
    """Phase 16 (d): PNA ``train_step``s on phase 8's minibatch_lg batch at
    FULL widths (d_in 602, 41 classes), ``segment_spmm``'s launches
    counted forward and backward around them; every backward call held to
    its plain version over the transposed CSR. Returns the launches."""
    from repro_torch.gnn.models import train_step
    from repro_torch.kernels.segment_spmm import ops as ss_ops
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref
    from repro_torch.optim import adamw, chain, clip_by_global_norm
    from repro_torch.optim.adamw import tree_map

    params = tree_map(torch.clone, params)  # phase 8's stay as they were
    opt = chain(clip_by_global_norm(1.0), adamw(1e-3))
    state, step = opt.init(params), train_step(cfg, opt)
    capture = CallCapture((ss_ops, "csr_sum"))
    ss_ops.launches = ss_ops.launches_backward = 0
    losses, ms = [], []
    with capture:
        for _ in range(PNA_TRAIN_STEPS):
            t = time.perf_counter()
            params, state, m = step(params, state, g)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t) * 1e3)
    bwd, fwd = ss_ops.launches_backward, ss_ops.launches - ss_ops.launches_backward
    calls = [(a, kw) for a, kw in capture.calls["csr_sum"] if kw.get("backward")]
    err = 0.0
    for (x, csr, *_), _ in calls:
        got, want = ss_ops.csr_sum(x, csr), segment_spmm_csr_ref(x, csr.src_sorted, csr.offsets)
        assert torch.allclose(got, want, rtol=PNA_BWD_TOL, atol=PNA_BWD_TOL), \
            "segment_spmm backward call disagrees with its plain version"
        err = max(err, float((got - want).abs().max()))
    report = dict(losses=losses, step_ms=ms, segment_spmm_forward=fwd, segment_spmm_backward=bwd,
                  backward_calls_checked=len(calls), backward_max_abs_err=err)
    print("gnn train (phase 16 d): " + json.dumps(report), flush=True)
    per_step = 5 * cfg.n_layers, 2 * cfg.n_layers  # every sum forward; m and m^2 backward
    assert all(np.isfinite(losses)) and len(losses) == PNA_TRAIN_STEPS, losses
    assert (fwd, bwd) == (PNA_TRAIN_STEPS * per_step[0], PNA_TRAIN_STEPS * per_step[1]), (fwd, bwd)
    assert len(calls) == bwd, (len(calls), bwd)
    return report


# --------------------------------------------------- 17. the model families
# (a) / (b): each MoE config at FULL widths, cut in depth to fit the card:
# layers kept, batch, prompt, decode steps (the cache ends at prompt + decode)
MOE_SERVE = {
    "grok-1-314b": (4, 8, 4_000, 32),  # 4 of 64 layers: 38.7 GB of experts
    "kimi-k2-1t-a32b": (1, 1, 4_096, 8),  # 1 of 61 layers: 33.8 GB of experts
}
MOE_CHECK_TOKENS = 512  # one layer's tokens, bf16 against a dense fp32 reference
# bf16 products with fp32 accumulation and bf16 rounding of each expert's
# hidden (F wide) and output, against the same routing in fp32 with no
# dispatch (``moe_dense_ref``): ~5e-3 of the norm at these widths (4.444e-03
# Grok-1, 5.220e-03 Kimi K2 against moe_apply in fp32 on an H100); a
# dropped, misrouted or misweighted pair moves a token's output by its
# whole gate share (~1/k of its norm)
MOE_REL_TOL = 2e-2
MOE_TRAIN_ARGV = ["--smoke", "--steps", "20", "--batch", "4", "--seq", "64", "--log-every", "10"]
# (d): each GNN kind at FULL widths on its own GNN_SHAPES shape
GNN_KINDS = {"gat": ("gat-cora", "full_graph_sm"), "egnn": ("egnn", "molecule"),
             "nequip": ("nequip", "molecule")}
GNN_KIND_STEPS = 5
# segment sums a step (forward, backward): a layer's, those the last layer's
# output feeds no loss through (EGNN's positions, NequIP's vectors and
# matrices: no backward), and the energy pooling's; read through
# gnn_kind_sums, here and by tests/test_torch_gnn_kinds.py
GNN_KIND_SUMS = {"gat": ((2, 2), 0, (0, 0)), "egnn": ((3, 2), 1, (1, 1)),
                 "nequip": ((3, 3), 2, (1, 1))}
INVARIANCE_TOL = 1e-4  # energies after a rotation and translation, relative
# (e): two-tower training at FULL widths
TT_TRAIN_USER_VOCAB = 4_194_304  # reduced from 100M: 4 KB a row with grad and moments
TT_TRAIN_BATCH = 16_384  # reduced from train_batch's 65,536: the [B, B] fp32 logits
TT_TRAIN_STEPS = 3
TT_TRAIN_LR = 1e-3
# F.embedding_bag's backward (the library yardstick) is held to the plain
# version on the rows that at most this many entries read: both sum fp32
# terms, in other orders, so a long run (the Zipf head's has ~10^5 terms)
# differs by rounding; a short one shows whether the library computes the
# same function
EB_LIB_SHORT_RUN = 8
EB_LIB_TOL = 1e-5
# the backward's synthetic calls: the item call's bags on a small table
EB_SYNTH_ROWS = 65_536
EB_SYNTH_ROW = 12_345


def moe_dropped_by_formula(expert, n_experts, capacity):
    """Pairs the capacity drops, from the routing alone: over the experts,
    max(0, pairs routed to it - C)."""
    counts = torch.bincount(expert.reshape(-1), minlength=n_experts)
    return int((counts - capacity).clamp(min=0).sum())


def moe_layer_drops(lm_layers, x, router, kw):
    """One layer's ``moe_ffn`` call: its capacity, the pairs its dispatch
    dropped and those the formula gives from its routing."""
    k, E = kw["top_k"], router.shape[-1]
    C = lm_layers.moe_capacity(x.shape[0], k, E, kw["capacity_factor"])
    _, _, expert = lm_layers.moe_route(x, router, k)
    _, _, keep = lm_layers.moe_dispatch(expert, E, C)
    return dict(capacity=C, dropped=x.shape[0] * k - int(keep.sum()),
                dropped_by_formula=moe_dropped_by_formula(expert, E, C))


def gnn_kind_sums(kind, n_layers):
    """The segment sums one training step of a GNN ``kind`` with
    ``n_layers`` layers makes: (forward, backward)."""
    (fl, bl), unread, (fp, bp) = GNN_KIND_SUMS[kind]
    return fl * n_layers + fp, bl * n_layers - unread + bp


def moe_kept_pairs(expert, n_experts, capacity):
    """Which routed (token, k) pairs the capacity keeps, from the routing
    alone: those among their expert's first C pairs in token-major order,
    each pair's rank a running count of one-hot rows (no sort, no
    ``searchsorted``). [N, k] bool."""
    oh = torch.nn.functional.one_hot(expert.reshape(-1), n_experts)  # [N*k, E]
    rank = (oh.cumsum(0) * oh).sum(1) - 1
    return (rank < capacity).reshape(expert.shape)


def moe_dense_ref(x, gate, expert, we1, we3, we2, capacity):
    """The MoE output in fp32 for a routing (gate, expert [N, k]), with no
    dispatch buffer, slot or combine of ``moe_apply``'s: out[t] = the sum
    over t's kept pairs (``moe_kept_pairs``) of gate x swiglu(x[t]) under
    the pair's expert, one expert at a time over the tokens it takes."""
    N, E = x.shape[0], we1.shape[0]
    keep = moe_kept_pairs(expert, E, capacity)
    w = torch.zeros(N, E, dtype=torch.float32, device=x.device)
    w.scatter_add_(1, expert, torch.where(keep, gate.float(), 0.0))
    out = torch.zeros(N, x.shape[1], dtype=torch.float32, device=x.device)
    xf = x.float()
    for e in range(E):
        rows = torch.nonzero(w[:, e]).squeeze(1)
        if rows.numel() == 0:
            continue
        xr = xf[rows]
        h = torch.nn.functional.silu(xr @ we1[e].float()) * (xr @ we3[e].float())
        out[rows] += w[rows, e, None] * (h @ we2[e].float())
    return out


def moe_dense_rel(lm_layers, args, kw, n_tokens):
    """The relative norm of ``moe_apply`` over a layer's first ``n_tokens``
    tokens (in the layer's dtype) against ``moe_dense_ref`` on the same
    routing."""
    x, router, we1, we3, we2 = args
    xs, k = x[:n_tokens], kw["top_k"]
    C = lm_layers.moe_capacity(n_tokens, k, router.shape[-1], kw["capacity_factor"])
    _, gate, expert = lm_layers.moe_route(xs, router, k)
    got = lm_layers.moe_apply(xs, gate, expert, we1, we3, we2, C)
    want = moe_dense_ref(xs, gate, expert, we1, we3, we2, C)
    assert got.dtype == x.dtype and want.dtype == torch.float32
    return rel_norm(got, want)


def run_moe_serving(arch, seed, dev):
    """Phase 17 (a) / (b): ``arch`` FULL at the depth ``MOE_SERVE`` keeps,
    a prefill through ``prefill_step`` then greedy ``decode_step``s;
    ``flash_attention`` counted and captured around the prefill, every
    launch on the bf16 tensor cores and held to its plain version, each
    layer's dropped pairs held to the capacity formula, layer 0's MoE on
    ``MOE_CHECK_TOKENS`` tokens held to its dense fp32 reference. Returns
    its report."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.lm import layers as lm_layers, model as lm_model

    L, B, S, T = MOE_SERVE[arch]
    full = get_arch(arch).FULL
    cfg = dataclasses.replace(full, n_layers=L)
    expert_gb = L * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * 2 / 1e9
    print(f"moe {arch}: d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, head dim "
          f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, "
          f"{cfg.n_shared_experts} shared, vocab {cfg.vocab:,}, {cfg.dtype}; reduced: "
          f"{L} of {full.n_layers} layers ({expert_gb:.1f} GB of experts), a prompt of "
          f"{B} x {S:,}, {T} decode steps", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 71)
    t0 = time.perf_counter()
    params = lm_model.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    torch.cuda.synchronize()
    report = dict(made_s=time.perf_counter() - t0)
    capture = CallCapture((lm_model, "flash_attention"), (lm_model, "moe_ffn"))
    fa_ops.launches = fa_ops.launches_bf16_tc = fa_ops.launches_f32_simt = 0
    with capture:
        t0 = time.perf_counter()
        tok, kv = lm_model.prefill_step(cfg, params, tokens)
        torch.cuda.synchronize()
        report["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    report["flash_attention_launches"] = launches = fa_ops.launches
    assert launches == L and fa_ops.launches_bf16_tc == L and fa_ops.launches_f32_simt == 0, (
        f"{arch} prefill: {launches} flash_attention launches, {fa_ops.launches_bf16_tc} on "
        f"the bf16 tensor cores; all {L} must take them")
    assert len(capture.calls["moe_ffn"]) == L
    assert tok.shape == (B, 1) and 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab

    cache = lm_model.init_kv_cache(cfg, B, S + T, device=dev)
    cache.k[:, :, :S], cache.v[:, :, :S] = kv.k, kv.v
    del kv
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for i in range(T):
        tok, cache = lm_model.decode_step(cfg, params, cache, tok, S + i)
        out.append(tok)
    torch.cuda.synchronize()
    report["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / T
    out = torch.cat(out, 1)
    assert out.shape == (B, T) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    assert bool((cache.k[:, :, S:].abs().amax(dim=(0, 1, 3, 4)) > 0).all()), \
        "decode left cache positions unwritten"
    report["decode_capacity"] = lm_layers.moe_capacity(B, cfg.top_k, cfg.n_experts, 4.0)
    report["profiled_decode_wall_busy_ms"] = profiled(
        f" moe {arch} decode", f"one decode step ({B} tokens)",
        lambda: lm_model.decode_step(cfg, params, cache, tok, S + T - 1), host_ops=False)
    del cache, out
    report["profiled_prefill_wall_busy_ms"] = profiled(
        f" moe {arch} prefill", f"one prefill ({B} x {S:,})",
        lambda: lm_model.prefill_step(cfg, params, tokens), host_ops=False)

    _, report["flash_worst_rel_norm"], report["flash_worst_band"] = check_flash_calls(
        capture.calls["flash_attention"], f" {arch}")
    moe_calls = capture.calls["moe_ffn"]
    report["layers"] = [moe_layer_drops(lm_layers, a[0], a[1], kw) for a, kw in moe_calls]
    for i, r in enumerate(report["layers"]):
        assert r["dropped"] == r["dropped_by_formula"], (arch, i, r)
    report["dense_ref_rel_norm"] = rel = moe_dense_rel(lm_layers, *moe_calls[0],
                                                       MOE_CHECK_TOKENS)
    assert rel <= MOE_REL_TOL, f"{arch}: layer 0's MoE is {rel:.3e} from its dense reference"
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"moe {arch}: " + json.dumps(report), flush=True)
    del capture, params, tokens
    return report


def check_train_attention_calls(fwd_calls, bwd_calls, where):
    """Every attention call of a training run (captured by ``CallCapture``
    around ``fa_ops._forward`` and ``fa_ops.flash_attention_bwd``) against
    the plain version on the same inputs, at phase 10's and 16's limits:
    the with-lse forward's o within ``FLASH_REL_TOL`` relative norm, whole
    and per 64-row band, and its lse within ``FA_LSE_TOL``; each of dq, dk
    and dv within ``FA_BWD_BF16_REL`` relative norm of the plain backward
    of the same q, k, v, o, do and lse (both sum the same fp32 terms; the
    kernel rounds p and ds to bf16 for its products). Returns the worst
    figures."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)

    assert fwd_calls and bwd_calls, f"{where}: no attention call captured"
    worst = dict(o_rel=0.0, o_band=0.0, lse_err=0.0, grad_rel=0.0)
    with torch.no_grad():
        for (q, k, v, causal, window, q_offset), kw in fwd_calls:
            mask = dict(causal=causal, window=window, q_offset=q_offset)
            o, lse = fa_ops._forward(q, k, v, causal, window, q_offset, **kw)
            p_o, p_lse = flash_attention_ref(q, k, v, with_lse=True, **mask)
            r, rb = rel_norm(o, p_o), band_rel(o, p_o)
            e = float((lse - p_lse).abs().max()) if kw.get("with_lse") else 0.0
            assert o.dtype == p_o.dtype and r <= FLASH_REL_TOL and rb <= FLASH_REL_TOL \
                and e <= FA_LSE_TOL, (f"{where}: a training flash_attention call at q "
                                      f"{tuple(q.shape)} disagrees with its plain version: "
                                      f"o {r:.3e} / band {rb:.3e}, lse {e:.3e}")
            worst.update(o_rel=max(worst["o_rel"], r), o_band=max(worst["o_band"], rb),
                         lse_err=max(worst["lse_err"], e))
        for (q, k, v, o, do, lse), kw in bwd_calls:
            got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            want = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            rels = [rel_norm(a, w) for a, w in zip(got, want)]
            assert all(a.dtype == w.dtype and a.shape == w.shape for a, w in zip(got, want))
            assert max(rels) <= FA_BWD_BF16_REL, (
                f"{where}: a training flash_attention_bwd call at q {tuple(q.shape)} "
                f"disagrees with its plain version: dq / dk / dv {rels}")
            worst["grad_rel"] = max(worst["grad_rel"], *rels)
    print(f"kernel flash_attention{where} forward with lse calls={len(fwd_calls)} (o within "
          f"{FLASH_REL_TOL} relative norm, whole and per band, lse within {FA_LSE_TOL}): worst "
          f"o {worst['o_rel']:.3e} / band {worst['o_band']:.3e}, lse {worst['lse_err']:.3e}; "
          f"flash_attention_bwd calls={len(bwd_calls)} (dq / dk / dv within {FA_BWD_BF16_REL} "
          f"relative norm): worst {worst['grad_rel']:.3e}", flush=True)
    return worst


def run_moe_training(arch, dev):
    """Phase 17 (c): ``launch.train.main --arch <arch> --smoke`` for 20
    steps of 4 x 64 tokens, the attention kernels counted and captured
    around it; the losses must fall, the final parameters' aux be
    positive, every attention launch take the bf16 tensor cores (head dim
    16, padded to 64) and every call, forward and backward, equal its
    plain version (``check_train_attention_calls``)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.lm import model as lm_model

    cfg = get_arch(arch).SMOKE
    fa_ops.launches = fa_ops.launches_bf16_tc = fa_ops.launches_bwd = 0
    keep = {}
    capture = CallCapture((fa_ops, "_forward"), (fa_ops, "flash_attention_bwd"))
    t0 = time.perf_counter()
    with capture:
        losses = train_mod.main(["--arch", arch, "--device", dev] + MOE_TRAIN_ARGV, keep=keep)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(forward=fa_ops.launches, backward=fa_ops.launches_bwd)
    tensor_core = fa_ops.launches_bf16_tc
    tokens, _ = next(train_mod.synthetic_batches(cfg.vocab, 4, 64, seed=1, device=dev))
    with torch.no_grad():
        aux = float(lm_model.forward(cfg, keep["params"], tokens)[1])
    steps = len(losses)
    report = dict(losses=losses, aux=aux, launches=counts, run_s=run_s,
                  step_ms_median=float(np.median(keep["step_s"][1:])) * 1e3)
    print(f"moe train {arch}: " + json.dumps(report), flush=True)
    assert steps == 20 and all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), f"{arch}: the loss did not fall"
    assert aux > 0, f"{arch}: aux {aux}"
    # remat: each layer's attention forward twice a step (forward and
    # recompute), its backward once
    assert counts == dict(forward=2 * cfg.n_layers * steps, backward=cfg.n_layers * steps), \
        counts
    assert cfg.dtype == "bfloat16" and tensor_core == counts["forward"], (cfg.dtype, tensor_core)
    assert (len(capture.calls["_forward"]), len(capture.calls["flash_attention_bwd"])) == \
        (counts["forward"], counts["backward"])
    report["attention_check"] = check_train_attention_calls(
        capture.calls["_forward"], capture.calls["flash_attention_bwd"], f" {arch} training")
    return report


def random_rotation(gen):
    """A uniformly random proper rotation [3, 3] (QR of a Gaussian, signs
    fixed, det +1), fp32, from ``gen``."""
    q, r = torch.linalg.qr(torch.randn((3, 3), generator=gen, dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r))
    if torch.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.to(torch.float32)


def run_gnn_kinds(seed, dev):
    """Phase 17 (d): GAT, EGNN and NequIP at FULL widths, each on its own
    ``GNN_SHAPES`` shape: a forward, then ``GNN_KIND_STEPS`` clip + AdamW
    steps, ``segment_spmm`` counted and captured around the steps by kind,
    forward and backward; every call held to its plain version, and the
    EGNN / NequIP energies to those of the positions rotated and
    translated. Returns (per-kind reports, launches by kind)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_shapes import GNN_SHAPES
    from repro_torch.gnn.graph import random_graph_batch
    from repro_torch.gnn.models import forward, init_params, train_step
    from repro_torch.kernels.segment_spmm import ops as ss_ops
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref
    from repro_torch.optim import adamw, chain, clip_by_global_norm

    reports, by_kind = {}, {}
    for kind, (arch, shape_name) in GNN_KINDS.items():
        cfg, shp = get_arch(arch).FULL, GNN_SHAPES[shape_name]
        eq = cfg.kind in ("egnn", "nequip")
        assert cfg.kind == kind and cfg.d_in == shp["d_feat"], (cfg, shp)
        gen = torch.Generator(device=dev).manual_seed(seed + 83)
        params = init_params(cfg, gen, device=dev)
        g = random_graph_batch(gen, shp["n_nodes"], shp["n_edges"], cfg.d_in,
                               n_classes=cfg.n_classes, positions=eq,
                               n_graphs=shp["n_graphs"], device=dev)
        targets = torch.randn(shp["n_graphs"], generator=gen, device=dev) if eq else None
        with torch.no_grad():
            out0 = forward(cfg, params, g)
        r = dict(shape=shape_name, out_shape=list(out0.shape))
        if eq:
            rot = random_rotation(torch.Generator().manual_seed(seed + 89)).to(dev)
            shift = torch.randn(3, generator=gen, device=dev) * 4.0
            with torch.no_grad():
                out1 = forward(cfg, params, g._replace(positions=g.positions @ rot.T + shift))
            r["invariance_rel"] = rel = float((out1 - out0).abs().max()
                                              / out0.abs().max().clamp(min=1e-30))
            assert rel <= INVARIANCE_TOL, f"{kind}: energies moved {rel:.3e} under a rotation"
        opt = chain(clip_by_global_norm(1.0), adamw(1e-3))
        state, step = opt.init(params), train_step(cfg, opt)
        capture = CallCapture((ss_ops, "csr_sum"))
        ss_ops.launches = ss_ops.launches_backward = 0
        losses, ms = [], []
        with capture:
            for _ in range(GNN_KIND_STEPS):
                t0 = time.perf_counter()
                params, state, m = step(params, state, g, targets)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
        bwd = ss_ops.launches_backward
        by_kind[kind] = dict(forward=ss_ops.launches - bwd, backward=bwd)
        err = 0.0
        with torch.no_grad():
            for (x, csr, *_), _ in capture.calls["csr_sum"]:
                got = ss_ops.csr_sum(x, csr)
                want = segment_spmm_csr_ref(x, csr.src_sorted, csr.offsets)
                assert torch.allclose(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL), \
                    f"{kind}: a segment_spmm call disagrees with its plain version"
                err = max(err, float((got - want).abs().max()))
        r.update(losses=losses, step_ms=ms, launches=by_kind[kind],
                 calls_checked=len(capture.calls["csr_sum"]), max_abs_err=err)
        print(f"gnn kind {kind} (phase 17 d): " + json.dumps(r), flush=True)
        fs, bs = gnn_kind_sums(kind, cfg.n_layers)
        assert all(np.isfinite(losses)), r
        assert by_kind[kind] == dict(forward=GNN_KIND_STEPS * fs, backward=GNN_KIND_STEPS * bs), r
        assert len(capture.calls["csr_sum"]) == sum(by_kind[kind].values())
        reports[kind] = r
        del capture, params, state, g
    return reports, by_kind


def zipf_logq(ids, perm_inv, a=TT_ZIPF):
    """The log probability of each id under ``zipf_ids``'s law: rank r =
    ``perm_inv[id] + 1`` has mass (r^(1-a) - (r+1)^(1-a)) / (1 - (V+1)^(1-a))."""
    V = perm_inv.shape[0]
    r = perm_inv[ids.long()].double() + 1
    mass = (r ** (1 - a) - (r + 1) ** (1 - a)) / (1 - (V + 1.0) ** (1 - a))
    return torch.log(mass).to(torch.float32)


def eb_bwd_bound(dout, ids, mask, n_rows):
    """Least bytes of the table gradient: dout, ids and mask each read once,
    the dense [n_rows, D] gradient written once; one add per unmasked
    value."""
    D, es = dout.shape[1], dout.element_size()
    nbytes = dout.numel() * es + ids.numel() * 4 + mask.numel() + n_rows * D * es
    return nbytes, int(mask.sum()) * D


def eb_bwd_passes(by_kernel):
    """{pass: {"launches", "device_ms"}} a call, of the ``embedding_bag``
    backward's kernels (``embedding_bag_bwd_<pass>_kernel``) in a
    ``device_ms`` window's ``by_kernel`` tally."""
    passes = {}
    for name, (n, ms) in by_kernel.items():
        m = re.search(r"embedding_bag_bwd_(\w+?)_kernel", name)
        if m:
            passes[m[1]] = dict(launches=n, device_ms=ms)
    return passes


def check_eb_backward(dout, ids, mask, n_rows, kw, what):
    """One ``embedding_bag`` backward call on the card, equal bit for bit
    to a second call and to the plain version on the host."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    got = eb_ops.embedding_bag_backward(dout, ids, mask, n_rows, **kw)
    again = eb_ops.embedding_bag_backward(dout, ids, mask, n_rows, **kw)
    assert torch.equal(got, again), f"two embedding_bag backward calls differ ({what})"
    del again
    want = eb_ops.embedding_bag_backward(dout.cpu(), ids.cpu(), mask.cpu(), n_rows, **kw)
    assert torch.equal(got.cpu(), want), \
        f"embedding_bag backward differs from its plain version ({what})"


def run_twotower_train(seed, dev):
    """Phase 17 (e): two-tower training at FULL widths (user vocab and batch
    cut), ``TT_TRAIN_STEPS`` clip + AdamW steps on one Zipf(1.1) batch,
    ``embedding_bag`` counted forward and backward and its calls captured,
    each step's forward calls held to their plain version after the step;
    then every backward call against its plain version and
    twice against itself, and the kernel timed at the step's item-table
    call beside its bound and ``F.embedding_bag``'s backward. Returns (its
    report, the backward kernel's row, the forward's launches)."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.configs import two_tower_retrieval as ttc
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import (RUN_CHUNK, embedding_bag_backward_ref,
                                                      embedding_bag_ref)
    from repro_torch.optim import adamw, chain, clip_by_global_norm
    from repro_torch.recsys import embedding as emb_mod, twotower as tt

    cfg = dataclasses.replace(ttc.FULL, user_vocab=TT_TRAIN_USER_VOCAB)
    B, K, D = TT_TRAIN_BATCH, cfg.bag_size, cfg.embed_dim
    print(f"recsys train: reduced: user_vocab {ttc.FULL.user_vocab:,} -> {cfg.user_vocab:,} "
          f"(parameters, the dense gradient and two AdamW moments: 4 KB a row); item_vocab "
          f"{cfg.item_vocab:,}; train_batch {ttc.SHAPES['train_batch']['batch']:,} -> {B:,} "
          f"(the [B, B] fp32 logits and their gradient); {TT_TRAIN_STEPS} steps", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 97)
    t0 = time.perf_counter()
    params = tt.init_params(cfg, gen, device=dev)
    uperm = torch.randperm(cfg.user_vocab, generator=gen, device=dev)
    iperm = torch.randperm(cfg.item_vocab, generator=gen, device=dev)
    ub, um = make_bags(gen, uperm, B, cfg.user_fields, K)
    ib, im = make_bags(gen, iperm, B, cfg.item_fields, K)
    iperm_inv = torch.empty_like(iperm)
    iperm_inv[iperm] = torch.arange(cfg.item_vocab, device=dev)
    batch = dict(user_bags=ub, user_mask=um, item_bags=ib, item_mask=im,
                 item_logq=zipf_logq(ib[:, 0, 0], iperm_inv))
    del iperm_inv, uperm, iperm
    opt = chain(clip_by_global_norm(1.0), adamw(TT_TRAIN_LR))
    state, step = opt.init(params), tt.train_step(cfg, opt)
    torch.cuda.synchronize()
    report = dict(made_s=time.perf_counter() - t0)
    capture = CallCapture((eb_ops, "embedding_bag_backward"), (emb_mod, "bag_op"))
    eb_ops.launches = eb_ops.launches_backward = 0
    losses, ms, fwd_checked, fwd_err, fwd, bwd = [], [], 0, 0.0, 0, 0
    torch.cuda.reset_peak_memory_stats()
    with capture:
        for _ in range(TT_TRAIN_STEPS):
            n, nb = eb_ops.launches, eb_ops.launches_backward
            t0 = time.perf_counter()
            new_params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            bwd += eb_ops.launches_backward - nb
            fwd += eb_ops.launches - n - (eb_ops.launches_backward - nb)
            # the step's forward bag calls, on the tables it read (this
            # step's parameters, let go before the next), against the plain
            # version, outside the timed step and its counts
            for (table, ids, mask), kw in capture.calls["bag_op"]:
                with torch.no_grad():
                    got = eb_ops.embedding_bag(table, ids, mask, **kw)
                    want = embedding_bag_ref(table, ids, mask, **kw)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.allclose(got, want, rtol=BAG_TOL, atol=BAG_TOL), \
                    f"a training embedding_bag call at ids {tuple(ids.shape)} disagrees"
                fwd_err = max(fwd_err, float((got - want).abs().max()))
                fwd_checked += 1
                del got, want
            capture.calls["bag_op"].clear()
            params = new_params
            del new_params
    report.update(losses=losses, step_ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  launches=dict(forward=fwd, backward=bwd), forward_calls_checked=fwd_checked,
                  forward_max_abs_err=fwd_err)
    print("recsys train: " + json.dumps(report), flush=True)
    print(f"kernel embedding_bag two-tower training calls={fwd_checked} (each within "
          f"rtol=atol={BAG_TOL} of the plain version, max abs err {fwd_err:.3e})", flush=True)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert (fwd, bwd) == (2 * TT_TRAIN_STEPS, 2 * TT_TRAIN_STEPS), (fwd, bwd)
    assert fwd_checked == fwd, (fwd_checked, fwd)
    report["profiled_step_wall_busy_ms"] = profiled(
        " recsys train", "one more two-tower training step",
        lambda: step(params, state, batch), host_ops=False)
    del state, opt, step  # the moments: room for the checks' dense gradients

    # every call against its plain version on the host, bit for bit: on CPU
    # tensors the wrapper takes the plain version, which adds a row's terms
    # (scaled_rows, on both sides) in chunks of RUN_CHUNK in flat (bag, slot)
    # order, then the chunks' partials in order, as the kernels do
    calls = capture.calls["embedding_bag_backward"]
    assert len(calls) == bwd
    table_calls = {}
    for (dout, ids, mask, n_rows), kw in calls:
        check_eb_backward(dout, ids, mask, n_rows, kw, f"V={n_rows:,}")
        table_calls[n_rows] = ((dout, ids, mask, n_rows), kw)
    print(f"kernel embedding_bag_backward calls={len(calls)} (each equal bit for bit to its "
          f"plain version on the host and to a second call on the card)", flush=True)

    # timed at the step's two calls: the item table's, then the user table's
    (dout, ids, mask, n_rows), kw = table_calls[cfg.item_vocab]
    del calls, capture
    # the hot path at a small table: one row read by every unmasked entry
    # (a run of ~8 x 10^5, thousands of chunks), and a batch all masked;
    # then what no training call takes: bf16, and a width off the 8-column
    # vectors (the scalar loads and stores)
    one_row = torch.full_like(ids, EB_SYNTH_ROW)
    synthetic = (("every unmasked entry on one row", dout, one_row, mask),
                 ("every entry masked", dout, ids % EB_SYNTH_ROWS, torch.zeros_like(mask)),
                 ("one row, bf16", dout.to(torch.bfloat16), one_row, mask),
                 ("D 12", dout[:, :12].contiguous(), ids % EB_SYNTH_ROWS, mask))
    for what, sdout, sids, smask in synthetic:
        check_eb_backward(sdout, sids, smask, EB_SYNTH_ROWS, kw, f"synthetic: {what}")
    print(f"kernel embedding_bag_backward synthetic calls={len(synthetic)} at "
          f"V={EB_SYNTH_ROWS:,} ({'; '.join(w for w, *_ in synthetic)}): each equal bit for "
          f"bit to its plain version on the host and to a second call", flush=True)
    del one_row, synthetic
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host read in the wrapper raises
    try:
        eb_ops.embedding_bag_backward(dout, ids, mask, n_rows, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("kernel embedding_bag_backward item-table call under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync", flush=True)

    kern = lambda: eb_ops.embedding_bag_backward(dout, ids, mask, n_rows, **kw)
    plain = lambda: embedding_bag_backward_ref(dout, ids, mask, n_rows, **kw)
    by_kernel = {}
    t = dict(ms=cuda_ms(kern, iters=10), plain_ms=cuda_ms(plain, iters=5),
             device_ms=device_ms(kern, iters=3, by_kernel=by_kernel),
             plain_device_ms=device_ms(plain, iters=3))
    # the kernels of the wrapper's window, by pass, beside the dense write alone
    passes = eb_bwd_passes(by_kernel)
    per_call = sum(p["launches"] for p in passes.values())
    assert per_call == eb_ops.BWD_KERNELS, \
        f"the backward launched {per_call} kernels a call ({passes}), not {eb_ops.BWD_KERNELS}"
    dense_ms = device_ms(lambda: torch.zeros((n_rows, D), dtype=dout.dtype, device=dout.device),
                         iters=3)
    table = params["item_table"].detach().requires_grad_(True)
    cnt = mask.sum(-1, keepdim=True).clamp(min=1).to(table.dtype)
    lib_out = F.embedding_bag(ids.long().clamp(0, n_rows - 1), table,
                              per_sample_weights=mask.to(table.dtype) / cnt, mode="sum")
    lib = lambda: torch.autograd.grad(lib_out, table, dout, retain_graph=True)[0]
    # the plan on the card (the bounds kernel) equals the host's (plain)
    plan = eb_ops.prepare_rows(ids, mask, n_rows)
    host_plan = eb_ops.prepare_rows(ids.cpu(), mask.cpu(), n_rows)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(plan, host_plan)), \
        "the backward's row plan on the card differs from the host's"
    del host_plan
    runs = (plan.bounds[:, 1] - plan.bounds[:, 0]).cpu()
    slots_used, slots = int((plan.slot_row < n_rows).sum()), plan.slot_row.numel()
    short = (runs > 0) & (runs <= EB_LIB_SHORT_RUN)
    want = embedding_bag_backward_ref(dout.cpu(), ids.cpu(), mask.cpu(), n_rows, **kw)
    assert torch.allclose(lib().cpu()[short], want[short], rtol=EB_LIB_TOL, atol=EB_LIB_TOL), \
        "F.embedding_bag's backward computes another gradient"
    del want, plan
    lib_ms, lib_dev = cuda_ms(lib, iters=5), device_ms(lib, iters=3)
    nbytes, ops = eb_bwd_bound(dout, ids, mask, n_rows)
    bms, by = bound_ms(nbytes, ops)
    longest = int(runs.max())
    key_sorted, _ = eb_ops.sorted_keys(ids, mask, n_rows)
    bounds = eb_ops.row_bounds(key_sorted, n_rows)
    prep_fns = dict(sort=lambda: eb_ops.sorted_keys(ids, mask, n_rows),
                    bounds=lambda: eb_ops.row_bounds(key_sorted, n_rows),
                    chunk_table=lambda: eb_ops.chunk_table(key_sorted, bounds, n_rows, RUN_CHUNK))
    prep = {k: cuda_ms(f, iters=5) for k, f in prep_fns.items()}
    prep.update({f"{k}_device": device_ms(f, iters=3) for k, f in prep_fns.items()})
    del key_sorted, bounds, prep_fns
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.3f}"
    print(f"kernel embedding_bag_backward item table V={n_rows:,} D={D} bags={ids.shape[0]:,} "
          f"K={K} unmasked={int(mask.sum()):,} rows read={int((runs > 0).sum()):,} longest "
          f"run={longest:,} chunk={RUN_CHUNK} slots used={slots_used:,} of {slots:,} launched "
          f"launches a call={per_call:g} (profiled) {fmt_us(t)} prepare_rows_us (device): sort="
          f"{us(prep['sort'])} ({us(prep['sort_device'])}) bounds kernel={us(prep['bounds'])} "
          f"({us(prep['bounds_device'])}) chunk table={us(prep['chunk_table'])} "
          f"({us(prep['chunk_table_device'])}) F.embedding_bag backward_us={us(lib_ms)} (device "
          f"{us(lib_dev)}) bound_us={bms * 1e3:.4f} ({by}, {nbytes} B)", flush=True)
    print(f"kernel embedding_bag_backward item table by kernel, a call (chunk {RUN_CHUNK}): "
          + "; ".join(f"{p} launches={v['launches']:g} device_us={us(v['device_ms'])}"
                      for p, v in passes.items())
          + f"; the dense write alone (torch.zeros) device_us={us(dense_ms)}", flush=True)
    shape = f"V={n_rows},D={D},bags={ids.shape[0]},K={K}"
    del lib_out, table, dout, ids, mask
    (dout, ids, mask, n_rows), kw = table_calls.pop(TT_TRAIN_USER_VOCAB)
    del table_calls
    kern = lambda: eb_ops.embedding_bag_backward(dout, ids, mask, n_rows, **kw)
    user = dict(ms=cuda_ms(kern, iters=10), device_ms=device_ms(kern, iters=3))
    ubound, _ = bound_ms(*eb_bwd_bound(dout, ids, mask, n_rows))
    print(f"kernel embedding_bag_backward user table V={n_rows:,} bags={ids.shape[0]:,} "
          f"unmasked={int(mask.sum()):,} kernel_us={us(user['ms'])} (device "
          f"{us(user['device_ms'])}) bound_us={ubound * 1e3:.4f}", flush=True)
    row = dict(name="embedding_bag_backward", route="cuda",
               source="src/repro_torch/csrc/embedding_bag_bwd.cu",
               replaces="none: the JAX package differentiates jnp.take in "
                        "src/repro/recsys/embedding.py:22",
               launches=bwd, max_abs_err=0.0, **t, bound_ms=bms, bound_by=by,
               library_ms=lib_ms, library_device_ms=lib_dev,
               prepare_rows_ms=prep, chunk=RUN_CHUNK, slots_used=slots_used,
               slots_launched=slots, launches_per_call=per_call,
               user_table_ms=user["ms"], user_table_device_ms=user["device_ms"],
               user_table_bound_ms=ubound, by_pass=passes,
               dense_write_device_ms=dense_ms, longest_run=longest, shape=shape,
               launches_by_path={"phase 17 (e) two-tower training": bwd})
    del params, batch
    return report, row, fwd


def run_example_twin(dev):
    """Phase 17 (f): ``examples/gnn_cached_sampling_torch.py`` on ``dev``
    (the card) and on the CPU: hits on the card, the same invalidated keys
    an epoch on both, and every ``cache_probe`` and ``segment_spmm`` call
    of the card run held to its plain version."""
    import importlib.util

    import repro_torch.core.cache as cache_mod
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.segment_spmm import ops as ss_ops
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "gnn_cached_sampling_torch.py")
    spec = importlib.util.spec_from_file_location("gnn_cached_sampling_torch", path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    capture = CallCapture((cache_mod, "cache_probe"), (ss_ops, "csr_sum"))
    cp_ops.launches = ss_ops.launches = 0
    t0 = time.perf_counter()
    with capture:
        card, sampler = twin.run(device=dev, log=lambda *_: None)
    card_s = time.perf_counter() - t0
    launches = dict(cache_probe=cp_ops.launches, segment_spmm=ss_ops.launches)
    cpu, _ = twin.run(device="cpu", log=lambda *_: None)
    report = dict(card=card, cpu=cpu, card_s=card_s, launches=launches)
    print("example twin (phase 17 f): " + json.dumps(report), flush=True)
    assert sampler.hits > 0, "the twin's sampler never hit on the card"
    assert [e["impacted_keys"] for e in card] == [e["impacted_keys"] for e in cpu], report
    # every kernel call of the card run against its plain version
    probes, sums = capture.calls["cache_probe"], capture.calls["csr_sum"]
    assert (len(probes), len(sums)) == (launches["cache_probe"], launches["segment_spmm"]) \
        and sums, launches
    check_probe_calls(probes, "the example twin")
    err = 0.0
    with torch.no_grad():
        for (x, csr, *_), _ in sums:
            got = ss_ops.csr_sum(x, csr)
            want = segment_spmm_csr_ref(x, csr.src_sorted, csr.offsets)
            assert torch.allclose(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL), \
                "a segment_spmm call of the example twin disagrees with its plain version"
            err = max(err, float((got - want).abs().max()))
    print(f"kernel cache_probe example twin calls={len(probes)} (each equal to its plain "
          f"version); kernel segment_spmm example twin calls={len(sums)} (each within "
          f"rtol=atol={SPMM_RTOL} of its plain version, max abs err {err:.3e})", flush=True)
    return report


def run_families(seed, dev, rows):
    """Phase 17: the model families, (a)-(f); the kernels' launches added
    to their rows by path, and the embedding_bag backward's row appended."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    t_phase = time.perf_counter()
    added = {"flash_attention": {}, "flash_attention_bwd": {}, "segment_spmm": {},
             "embedding_bag": {}, "cache_probe": {}}
    for part, arch in (("a", "grok-1-314b"), ("b", "kimi-k2-1t-a32b")):
        t0 = time.perf_counter()
        r = run_moe_serving(arch, seed, dev)
        added["flash_attention"][f"phase 17 ({part}) {arch} prefill"] = \
            r["flash_attention_launches"]
        print(f"moe {arch} phase: {time.perf_counter() - t0:.1f}s", flush=True)
        phase_memory(f"phase 17 {part}")
        free_device()
    t0 = time.perf_counter()
    for arch in ("grok-1-314b", "kimi-k2-1t-a32b"):
        r = run_moe_training(arch, dev)
        added["flash_attention"][f"phase 17 (c) {arch} training"] = r["launches"]["forward"]
        added["flash_attention_bwd"][f"phase 17 (c) {arch} training"] = r["launches"]["backward"]
    print(f"moe train phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 17 c")
    t0 = time.perf_counter()
    _, by_kind = run_gnn_kinds(seed, dev)
    for kind, c in by_kind.items():
        added["segment_spmm"][f"phase 17 (d) {kind} forwards"] = c["forward"]
        added["segment_spmm"][f"phase 17 (d) {kind} backwards"] = c["backward"]
    print(f"gnn kinds phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 17 d")
    free_device()
    t0 = time.perf_counter()
    _, bwd_row, fwd = run_twotower_train(seed, dev)
    added["embedding_bag"]["phase 17 (e) two-tower training"] = fwd
    print(f"recsys train phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 17 e")
    free_device()
    t0 = time.perf_counter()
    twin = run_example_twin(dev)
    added["cache_probe"]["phase 17 (f) example twin"] = twin["launches"]["cache_probe"]
    added["segment_spmm"]["phase 17 (f) example twin"] = twin["launches"]["segment_spmm"]
    print(f"example twin phase: {time.perf_counter() - t0:.1f}s", flush=True)
    for row in rows:
        if row["name"] in added:
            row["launches_by_path"].update(added[row["name"]])
            row["launches"] += sum(added[row["name"]].values())
    rows.append(bwd_row)
    print(f"families phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    assert eb_ops.launches_backward >= bwd_row["launches"]


def phase_memory(tag):
    """Prints the phase's peak device memory and starts the next phase's count."""
    print(f"peak device memory {tag}: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()


def run_graph(seed, dev):
    """Phases 3-7 and 11-15, the graph-cache paths; returns their kernel
    rows. Their worlds are locals, freed when it returns."""
    import repro_torch.core.cache as cache_mod
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.onehop_gather import ops as og_ops
    from repro_torch.kernels.segment_spmm import ops as ss_ops

    # 3. the world
    from repro_torch.core import empty_cache

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    espec, store, ranges, includes, n_edges = build_world(rng, dev, SCALE)
    templates, meta, plans = templates_and_plans()
    ttable = serving_ttable(templates)
    cache = empty_cache(espec.cache, device=dev)
    torch.cuda.synchronize()
    nv = ranges[L_LISTING][1]
    print(f"world: {nv} vertices ({ranges[L_USER][1]} users, "
          f"{ranges[L_WATCHLIST][1] - ranges[L_WATCHLIST][0]} watch-lists, "
          f"{nv - ranges[L_LISTING][0]} listings), {n_edges} edges "
          f"({len(includes)} includes); store {tensor_bytes(store) / 2**20:.1f} MiB, "
          f"cache {tensor_bytes(cache) / 2**20:.1f} MiB ({espec.cache.capacity} slots); "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)

    # 4. traffic: the main path, with the kernel counts zeroed around it and
    # every cache_probe call kept (the cache is never written in place, so
    # each call's arguments stay as they were)
    probes = CallCapture((cache_mod, "cache_probe"))
    cp_ops.launches = og_ops.launches = bg_ops.launches = ss_ops.launches = 0
    with probes:
        state, report, engines = run_traffic(
            seed, espec, (store, cache), ttable, plans, meta, ranges, includes, dev)
    launches = {"cache_probe": cp_ops.launches, "onehop_gather": og_ops.launches,
                "block_gather": bg_ops.launches, "segment_spmm": ss_ops.launches}
    print(f"launches on the main path: {launches}", flush=True)
    assert launches["cache_probe"] > 0, "the read path never launched cache_probe"
    assert report["R_hat"]["hit_rate"] > 0, "R-hat saw no cache hit"
    assert sum(r["committed"] for r in report.values()) > 0, "CP committed nothing"
    phase_memory("phases 3-4")

    profile_window("", seed, plans, ranges,
                   lambda name, r: engines[name].run(*state, ttable, r))

    # 5. each kernel against its plain version at the main path's shapes
    rows = check_kernels(espec, state, plans, ranges, launches, dev, seed)

    # 6. consistency of the final state; then every cache_probe call of
    # phases 4 and 6 against its plain version
    with probes:
        check_consistency(espec, state, ttable, plans, ranges, engines, dev, seed)
    check_probe_calls(probes.calls["cache_probe"], "phases 4 and 6")
    print(f"kernel cache_probe phases 4 and 6: calls={len(probes.calls['cache_probe'])} "
          f"(all equal)", flush=True)

    # 7. the partitioned tier on the final store, against the single host;
    # then block_gather against its plain version at the inputs it was given
    p_report, capture, gcheck, (hstore, pstore) = run_partitioned(
        seed, espec, state[0], ttable, plans, meta, ranges, includes, engines, dev)
    rows.append(check_partitioned_kernels(capture, p_report["block_gather_launches"],
                                          espec.max_deg))
    # both kernels' launches on each path that ran them, and their times at
    # the gRW rounds' largest calls (over blocks the commits changed)
    # the partitioned tier's largest probe (the owner blocks are the smaller caches)
    after = time_kernel_calls(
        "grw", gcheck.largest[min(k for k in gcheck.largest if isinstance(k, tuple))],
        {side: gcheck.largest[incoming] for side, incoming in (("out", False), ("in", True))})
    for row in rows:
        if row["name"] in ("cache_probe", "block_gather"):
            grw = p_report["grw_launches"]
            row["launches_by_path"] = {
                **({"phase 4": launches["cache_probe"]} if row["name"] == "cache_probe" else {}),
                "phase 7 reads": p_report[f"{row['name']}_launches"],
                "phase 7 gRW rounds, single host": grw["single"][row["name"]],
                "phase 7 gRW rounds, partitioned": grw["partitioned"][row["name"]],
            }
            row["after_commits"] = {k: v for k, v in after.items() if k.startswith(row["name"])}
    phase_memory("phases 5-7")
    del capture, gcheck, state, engines, probes

    # 11. block maintenance and durability on the phase-7 store; the two
    # kernels' launches counted around it (zeroed inside, just before)
    d_report, d_times = run_durability(seed, espec, hstore, pstore, ttable, plans, meta, ranges,
                                       includes, dev)
    for row in rows:
        if row["name"] in ("cache_probe", "block_gather"):
            row["launches"] += d_report["launches"][row["name"]]
            row["launches_by_path"]["phase 11"] = d_report["launches"][row["name"]]
            row["after_maintenance"] = {k: v for k, v in d_times.items()
                                        if k.startswith(row["name"])}
    phase_memory("phase 11")

    # 12. the serve loop on the phase-7 store; the two kernels' launches
    # counted around the loop (zeroed inside, just before)
    s_report = run_serve(seed, espec, hstore, pstore, ttable, plans, meta, ranges, includes, dev)
    for row in rows:
        if row["name"] in ("cache_probe", "block_gather"):
            row["launches"] += s_report["launches"][row["name"]]
            row["launches_by_path"]["phase 12"] = s_report["launches"][row["name"]]
    phase_memory("phase 12")

    # 13. failover on the phase-7 store; the two kernels' launches counted
    # around the phase's batches, commits and recovery (zeroed inside, just
    # before; its checks' launches left out)
    f_report = run_failover(seed, espec, hstore, pstore, ttable, plans, meta, ranges, includes,
                            dev)
    for row in rows:
        if row["name"] in ("cache_probe", "block_gather"):
            row["launches"] += f_report["launches"][row["name"]]
            row["launches_by_path"]["phase 13"] = f_report["launches"][row["name"]]
    phase_memory("phase 13")

    # 14. migration and the routing overlays on the phase-7 store; the two
    # kernels' launches counted around the phase's batches, drains, rounds
    # and commits (zeroed inside, just before; its checks' launches left out)
    m_report = run_migration(seed, espec, hstore, pstore, ttable, plans, meta, ranges,
                             includes, dev)
    for row in rows:
        if row["name"] in ("cache_probe", "block_gather"):
            row["launches"] += m_report["launches"][row["name"]]
            row["launches_by_path"]["phase 14"] = m_report["launches"][row["name"]]
        if row["name"] == "block_gather":
            row["post_migration"] = m_report["block_gather_post_migration"]
    phase_memory("phase 14")

    # 15. the replicated tier on the phase-7 stores; the two kernels'
    # launches counted around the replicated runtime (zeroed inside, just
    # before; the controls' left out)
    r_report = run_replicated(seed, espec, hstore, pstore, ttable, plans, meta, ranges,
                              includes, dev)
    for row in rows:
        if row["name"] in ("cache_probe", "block_gather"):
            row["launches"] += r_report["launches"][row["name"]]
            row["launches_by_path"]["phase 15"] = r_report["launches"][row["name"]]
    phase_memory("phase 15")
    return rows


def run_gnn_phase(seed, dev):
    """Phase 8: GNN serving, cached neighbour sampling + the PNA forward at
    the minibatch_lg shape, segment_spmm counted around the forwards only;
    its kernel row."""
    from repro_torch.configs.gnn_shapes import GNN_SHAPES

    t0 = time.perf_counter()
    g_report, g_capture, model, profile_windows = run_gnn(seed, dev)
    lg = GNN_SHAPES["minibatch_lg"]
    assert g_report["epoch1"]["padded"] == (lg["n_nodes"], lg["n_edges"]), g_report["epoch1"]
    row = check_gnn_kernels(g_capture, g_report.pop("spmm_batches"),
                            g_report.pop("probe_capture"), g_report["segment_spmm_launches"],
                            model)
    profile_windows()
    print(f"gnn phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 8")
    # 16 (d). PNA training on the same batch
    t0 = time.perf_counter()
    tr = run_pna_train(*model)
    row["launches_by_path"] = {"phase 8 forwards": row["launches"],
                               "phase 16 training forwards": tr["segment_spmm_forward"],
                               "phase 16 training backwards": tr["segment_spmm_backward"]}
    row["launches"] += tr["segment_spmm_forward"] + tr["segment_spmm_backward"]
    row["backward_max_abs_err"] = tr["backward_max_abs_err"]
    print(f"gnn train phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 16 d")
    return row


def free_device():
    """Returns what the last phase held to the card before the next one."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory held between phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)


# ------------------------------------------------------------- the dry-run
# Phase 18: three cells no earlier phase runs, built on the card with
# ``launch.steps.build_cell`` and stepped once through the kernels: GLM4-9B
# prefill_32k, GAT at ogb_products and the ecommerce-graph serving cells;
# then the dry-run twin (``launch.dryrun.main(["--all", ...])``) over every
# (architecture x shape) cell on both production meshes. Each card cell is
# held to the same cut cell built on ``meta``: the device memory its build
# allocated against the dry-run's argument bytes
# (the caching allocator rounds each tensor up to 512 bytes), and the
# shapes and dtypes of its outputs against its step run on ``meta`` (the
# graph step reads the host at every hop, so its meta run stops; its
# outputs are held to the step's contract instead).
DRYRUN_PAIRS = 78
DRYRUN_SKIPS = 4
ALLOC_ROUND = 512
ALLOC_LARGE_TAIL = 1 << 20
GLM_BATCH = 2  # prefill_32k's global batch 32, reduced
GLM_BAND = 128  # query rows of each band held to the plain version: the first and the last
GAT_EDGE_CUT = 8  # ogb_products' edges / 8: the last layer's [E, 8 x 47] messages fit the card
GRAPH_RANKS = 4
GRAPH_FIT = 0.6  # the share of the card the graph cell's arguments may take at 4 ranks
GRAPH_SLACK = 1.01  # block capacity over the uniform share: a random graph's in-blocks vary
GRAPH_ZIPF = 1.3
GRAPH_CHIPS = 256  # the pod FULL is spread over: a rank holds one chip's share


def alloc_matches(allocated, requested, sizes):
    """Whether a build's device memory matches the ``sizes`` (bytes) of the
    tensors the dry-run counts for it: the bytes it requested equal their
    sum, and the bytes the caching allocator holds for them lie between
    that sum with each tensor rounded up to 512 bytes and the same plus
    1 MiB for each tensor above 1 MiB (the allocator leaves a large block's
    tail of up to 1 MiB unsplit)."""
    lo = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in sizes)
    hi = lo + sum(ALLOC_LARGE_TAIL for n in sizes if n > ALLOC_LARGE_TAIL)
    return requested == sum(sizes) and lo <= allocated <= hi


def output_leaves(tree):
    """``(shape, dtype)`` of every tensor of a step's output, in order
    (dicts by sorted key)."""
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), str(tree.dtype))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in output_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in output_leaves(t)]
    return []


def one_hop_sets(roots, dst, eprop, vprop, edge_val, leaf_val):
    """The numpy one-hop reference of the served template over a store
    whose vertex r owns the out-edge slots ``[r * d, (r + 1) * d)``:
    ``dst`` / ``eprop`` [B, d] the slots' destinations and edge property 0
    for each root, ``vprop`` [B, d] the destinations' vertex property 0.
    Each root's set of leaves: edges with ``eprop == edge_val`` to
    vertices with ``vprop == leaf_val``."""
    keep = (eprop == edge_val) & (vprop == leaf_val)
    return [set(dst[i][keep[i]].tolist()) for i in range(len(roots))]


def dryrun_line(rec) -> str:
    """One printed line of a dry-run record."""
    mem, flops = rec["memory"], rec["cost"]["flops_global"]
    return (f"dryrun {rec['arch']} {rec['shape']} {rec['mesh']}: "
            f"{mem['argument_bytes'] / 2**30:.3f} GiB/device fits_card={rec['fits_card']} "
            f"traced={rec['traced']} "
            f"tflop={'-' if flops is None else f'{flops / 1e12:.3f}'}")


def meta_cell(arch, shape, mesh, run=True, **kw):
    """The cut cell on ``meta``: (the dry-run's argument bytes on one card,
    the bytes of its distinct tensors, the output leaves of its step's
    meta run, or None without ``run``: a step that reads the host cannot
    run on ``meta``). The two byte counts differ by the template table,
    which stays on the host, and by a tensor that stands at two leaves."""
    from repro_torch.kernels import shapes_only
    from repro_torch.launch.steps import arg_tensors, argument_bytes, build_cell

    step, specs, args = build_cell(arch, shape, mesh, **kw)
    out = None
    if run:
        with shapes_only():
            out = output_leaves(step(*args))
    sizes = [t.numel() * t.element_size() for t in arg_tensors(args)]
    return argument_bytes(args, specs), sizes, out


def build_on_card(arch, shape, mesh, gen, dev, want, sizes, **kw):
    """``build_cell`` on the card; its allocation held to the meta cell's."""
    from repro_torch.launch.steps import build_cell

    requested = lambda: torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.synchronize()
    base, base_req = torch.cuda.memory_allocated(), requested()
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, device=dev, generator=gen, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    delta, req = torch.cuda.memory_allocated() - base, requested() - base_req
    print(f"dryrun card cell {arch} {shape}: built in {build_s:.1f}s; allocated {delta} B, "
          f"requested {req} B for {len(sizes)} tensors of {sum(sizes)} B; the dry-run's "
          f"argument bytes {want}", flush=True)
    assert alloc_matches(delta, req, sizes), \
        f"{arch} {shape}: the build allocated {delta} B ({req} requested), its tensors hold " \
        f"{sum(sizes)}"
    return cell, delta


class FlashBandCheck:
    """Replaces ``lm.model.flash_attention`` while open: each call launches
    the kernel, then holds the first and the last ``GLM_BAND`` query rows of
    its output to the plain version over those rows (``q_offset`` at the
    band), within ``FLASH_REL_TOL`` of the band's relative norm per 64 rows.
    The plain version of a whole 32,768-token sequence would hold 128 GiB of
    scores. Keeps the last call's inputs for timing."""

    def __init__(self, lm_model):
        self.mod, self.inner = lm_model, lm_model.flash_attention
        self.calls, self.worst, self.err, self.last = 0, 0.0, 0.0, None

    def __enter__(self):
        self.mod.flash_attention = self._check
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.inner

    def _check(self, q, k, v, **kw):
        from repro_torch.kernels.flash_attention.ref import flash_attention_ref

        out = self.inner(q, k, v, **kw)
        assert kw.get("causal", True) and not kw.get("window") and not kw.get("q_offset")
        S = q.shape[1]
        for r0 in (0, S - GLM_BAND):
            want = flash_attention_ref(q[:, r0:r0 + GLM_BAND], k[:, :r0 + GLM_BAND],
                                       v[:, :r0 + GLM_BAND], causal=True, q_offset=r0)
            got = out[:, r0:r0 + GLM_BAND]
            rb = band_rel(got, want)
            assert rb <= FLASH_REL_TOL, f"flash_attention call {self.calls}: rows {r0}.. " \
                f"{r0 + GLM_BAND - 1} differ from the plain version by {rb:.3e}"
            self.worst = max(self.worst, rb)
            self.err = max(self.err, float((got.float() - want.float()).abs().max()))
        self.calls += 1
        self.last = (q, k, v)
        return out


def attention_bound(q, k):
    """(bound ms, bound by, FLOPs, bytes) of causal attention over q / k."""
    B, S, H, dh = q.shape
    flops = 4 * B * H * (S * (S + 1) // 2) * dh
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3
    return (tb, "bytes", flops, nbytes) if tb >= to else (to, "operations", flops, nbytes)


def run_glm_cell(seed, dev, mesh):
    """Phase 18 (b): GLM4-9B prefill_32k at its 40 layers, batch 2."""
    import torch.nn.functional as F
    from repro_torch.configs import glm4_9b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.lm import model as lm_model

    cfg, info = glm4_9b.FULL, dict(global_batch=GLM_BATCH)
    want, sizes, meta_out = meta_cell("glm4-9b", "prefill_32k", mesh, info=info)
    gen = torch.Generator(device=dev).manual_seed(seed + 103)
    (step, _, args), _ = build_on_card("glm4-9b", "prefill_32k", mesh, gen, dev, want, sizes,
                                       info=info)
    fa_ops.launches = fa_ops.launches_bf16_tc = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, kv = step(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches, tc = fa_ops.launches, fa_ops.launches_bf16_tc
    assert launches == tc == cfg.n_layers, f"glm4-9b prefill: {launches} launches, {tc} bf16"
    assert output_leaves((tok, kv)) == meta_out, "glm4-9b: outputs differ from the meta run's"
    assert bool(torch.isfinite(kv.k).all()) and bool(torch.isfinite(kv.v).all())
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab
    peak = torch.cuda.max_memory_allocated() / 2**30
    # every layer's attention again, each held to the plain version on its
    # bands (these launches compare, and are taken back off the count)
    with FlashBandCheck(lm_model) as chk:
        step(*args)
    fa_ops.launches = fa_ops.launches_bf16_tc = launches
    q, k, v = chk.last
    del tok, kv, args
    # the kernel at the path's call, beside SDPA on the same (expanded) k / v
    kern = lambda: fa_ops.flash_attention(q, k, v, causal=True)
    t = dict(ms=cuda_ms(kern, iters=3, warmup=1), device_ms=device_ms(kern, iters=3),
             plain_ms=None, plain_device_ms=None)
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_diff = float((lib().transpose(1, 2).float() - kern().float()).abs().max())
    lib_ms, lib_dev = cuda_ms(lib, iters=3, warmup=1), device_ms(lib, iters=3)
    bms, by, flops, nbytes = attention_bound(q, k)
    us = lambda x: "not measured" if x is None else f"{x * 1e3:.3f}"
    print(f"dryrun glm4-9b prefill_32k ({cfg.n_layers} layers, batch {GLM_BATCH}, "
          f"{q.shape[1]:,} tokens): step {step_ms:.3f} ms, "
          f"peak {peak:.2f} GiB; flash_attention launches {launches} (bf16 tensor cores), every "
          f"call's first and last {GLM_BAND} rows within {FLASH_REL_TOL} of the plain version "
          f"(worst band {chk.worst:.3e}, max abs err {chk.err:.3e})", flush=True)
    print(f"kernel flash_attention glm4-9b q={tuple(q.shape)} k={tuple(k.shape)} GQA {G}: "
          f"{fmt_us(t)} (the plain version's scores, "
          f"{q.shape[2] * q.shape[1] ** 2 * 4 / 2**30:.0f} GiB a sequence, fit no card) "
          f"sdpa_us={us(lib_ms)} (device {us(lib_dev)}, k / v expanded untimed; max abs diff "
          f"{lib_diff:.3e}) bound_us={bms * 1e3:.4f} ({by}: {flops:.4e} FLOP, {nbytes} B)",
          flush=True)
    return dict(launches=launches, step_ms=step_ms, peak_gib=peak, worst_band=chk.worst,
                max_abs_err=chk.err, **t, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                library_device_ms=lib_dev, shape=f"q={tuple(q.shape)},k={tuple(k.shape)}")


class SpmmCheck:
    """Replaces ``segment_spmm.ops.csr_sum`` while open: each call launches
    the kernel, then its output is held, a slice of rows at a time, to the
    plain version over the same CSR (``SPMM_RTOL`` / ``SPMM_ATOL``), the
    check's seconds counted apart. Keeps the largest forward call's shape
    and CSR."""

    def __init__(self, ss_ops, slices=16):
        self.ops, self.inner, self.slices = ss_ops, ss_ops.csr_sum, slices
        self.calls, self.err, self.seconds, self.largest = 0, 0.0, 0.0, None

    def __enter__(self):
        self.ops.csr_sum = self._check
        return self

    def __exit__(self, *exc):
        self.ops.csr_sum = self.inner

    def _check(self, x, csr, backward=False):
        from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref

        out = self.inner(x, csr, backward)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = csr.n_nodes
        off = csr.offsets.cpu().numpy()
        with torch.no_grad():
            for v0 in range(0, n, -(-n // self.slices)):
                v1 = min(n, v0 - (-n // self.slices))
                e0, e1 = int(off[v0]), int(off[v1])
                want = segment_spmm_csr_ref(x, csr.src_sorted[e0:e1], csr.offsets[v0:v1 + 1] - e0)
                got = out[v0:v1]
                assert torch.allclose(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL), \
                    f"segment_spmm call {self.calls} disagrees with its plain version at rows " \
                    f"{v0}..{v1 - 1} of x {tuple(x.shape)}"
                self.err = max(self.err, float((got - want).abs().max()) if e1 > e0 else 0.0)
        if not backward and (self.largest is None
                             or x.numel() > self.largest[0][0] * self.largest[0][1]):
            self.largest = (tuple(x.shape), csr)
        self.calls += 1
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out


def run_gat_cell(seed, dev, mesh):
    """Phase 18 (b): GAT (gat-cora FULL widths) at ogb_products, one train
    step; every segment_spmm call held to its plain version."""
    from repro_torch.configs.gnn_shapes import GNN_SHAPES
    from repro_torch.kernels.segment_spmm import ops as ss_ops
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref

    shp = GNN_SHAPES["ogb_products"]
    info = dict(n_edges=shp["n_edges"] // GAT_EDGE_CUT)
    want, sizes, meta_out = meta_cell("gat-cora", "ogb_products", mesh, info=info)
    gen = torch.Generator(device=dev).manual_seed(seed + 107)
    (step, _, args), _ = build_on_card("gat-cora", "ogb_products", mesh, gen, dev, want, sizes,
                                       info=info)
    g = args[2]
    ss_ops.launches = ss_ops.launches_backward = 0
    with SpmmCheck(ss_ops) as chk:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_ms = (wall - chk.seconds) * 1e3
    bwd = ss_ops.launches_backward
    fwd = ss_ops.launches - bwd
    assert chk.calls == fwd + bwd and fwd > 0 and bwd > 0, (chk.calls, fwd, bwd)
    assert output_leaves(out) == meta_out, "gat ogb_products: outputs differ from the meta run's"
    loss = float(out[2]["loss"])
    assert np.isfinite(loss), f"gat ogb_products: loss {loss}"
    peak = torch.cuda.max_memory_allocated() / 2**30
    N, E = g.node_feat.shape[0], g.edge_src.shape[0]
    (xe, D), csr = chk.largest
    del out, args, g
    free_device()
    # the largest forward call's shape and CSR, on fresh values
    x = torch.randn((xe, D), device=dev)
    kern = lambda: ss_ops.csr_sum(x, csr)
    plain = lambda: segment_spmm_csr_ref(x, csr.src_sorted, csr.offsets)
    t = dict(ms=cuda_ms(kern, iters=5, warmup=1), device_ms=device_ms(kern, iters=5),
             plain_ms=cuda_ms(plain, iters=2, warmup=1), plain_device_ms=device_ms(plain, iters=2))
    n, nnz = csr.n_nodes, int(csr.offsets[-1])
    A = torch.sparse_csr_tensor(csr.offsets.long(), csr.src_sorted[:nnz].long(),
                                torch.ones(nnz, dtype=x.dtype, device=dev), size=(n, xe))
    lib = lambda: torch.sparse.mm(A, x)
    lib_diff = float((lib() - kern()).abs().max())
    lib_ms, lib_dev = cuda_ms(lib, iters=3, warmup=1), device_ms(lib, iters=3)
    nbytes = nnz * D * 4 + xe * 4 + (n + 1) * 4 + n * D * 4
    bms, by = bound_ms(nbytes, nnz * D)
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.3f}"
    print(f"dryrun gat-cora ogb_products (N {N:,}, E {E:,} of {shp['n_edges']:,}): step "
          f"{step_ms:.3f} ms (the checks' {chk.seconds:.1f}s taken out), loss {loss:.4f}, peak "
          f"{peak:.2f} GiB; segment_spmm launches {fwd} forward / {bwd} backward, every call "
          f"within rtol=atol={SPMM_RTOL} of its plain version (max abs err {chk.err:.3e})",
          flush=True)
    print(f"kernel segment_spmm gat ogb_products x=({xe}, {D}) n={n} nnz={nnz}: {fmt_us(t)} "
          f"sparse_mm_us={us(lib_ms)} (device {us(lib_dev)}, max abs diff {lib_diff:.3e}) "
          f"bound_us={bms * 1e3:.4f} ({by}, {nbytes} B)", flush=True)
    del x, A, csr
    return dict(launches=fwd + bwd, forward=fwd, backward=bwd, step_ms=step_ms, peak_gib=peak,
                max_abs_err=chk.err, **t, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                library_device_ms=lib_dev, shape=f"x=({xe},{D}),n={n},nnz={nnz}")


def run_graph_cells(seed, dev):
    """Phase 18 (b): the ecommerce-graph serving cells, one chip's share of
    FULL a rank on GRAPH_RANKS ranks: serve_low, serve_peak cold, a CP
    drain, serve_peak, serve_nocache, on the same Zipf roots."""
    import dataclasses

    import repro_torch.core.cache as cache_mod
    from repro_torch.configs import ecommerce_graph
    from repro_torch.core.templates import ANY_LABEL, DIR_OUT
    from repro_torch.distributed import ShardedMissDrain
    from repro_torch.distributed import graph_serve as gs
    from repro_torch.kernels.block_gather import ops as bg_ops
    from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
    from repro_torch.kernels.cache_probe import ops as cp_ops
    from repro_torch.launch.mesh import ShapeMesh

    full = ecommerce_graph.FULL
    card = torch.cuda.get_device_properties(0).total_memory
    for n in (GRAPH_RANKS, GRAPH_RANKS // 2):
        cfg = dataclasses.replace(full, v_total=full.v_total // GRAPH_CHIPS * n,
                                  cache_slots_total=full.cache_slots_total // GRAPH_CHIPS * n)
        mesh = ShapeMesh((n,), ("shard",))
        want, sizes, _ = meta_cell("ecommerce-graph", "serve_peak", mesh, run=False, cfg=cfg,
                                 blk_slack=GRAPH_SLACK)
        if want <= GRAPH_FIT * card:
            break
    print(f"dryrun ecommerce-graph: {n} ranks, v_total {cfg.v_total:,}, e_cap "
          f"{cfg.e_total():,}, cache {cfg.cache_slots_total:,} slots (the dry-run's "
          f"{want / 2**30:.2f} GiB of the card's {card / 2**30:.1f})", flush=True)
    gen_seed = seed + 109
    kw = dict(cfg=cfg, blk_slack=GRAPH_SLACK)
    (step, _, args), _ = build_on_card("ecommerce-graph", "serve_peak", mesh,
                                       torch.Generator(device=dev).manual_seed(gen_seed), dev,
                                       want, sizes, **kw)
    pstore = args[0]
    cells = {"serve_peak": (step, args)}
    for shape in ("serve_low", "serve_nocache"):
        s, _, a = build_cell_on(shape, mesh, dev, pstore, **kw)
        cells[shape] = (s, a)
    rt = step.runtime
    plan, _ = gs.config_plan_and_ttable(cfg)
    # the roots: Zipf(1.3) over the vertices, the same for every shape
    rng = np.random.default_rng(seed + 113)
    roots = {s: zipf_pick(rng, 0, cfg.v_total, ecommerce_graph.SHAPES[s]["batch"], a=GRAPH_ZIPF)
             for s in ("serve_low", "serve_peak")}
    roots["serve_nocache"] = roots["serve_peak"]
    for s, (_, a) in cells.items():
        a[3].copy_(torch.as_tensor(roots[s], device=dev))
    # the numpy one-hop reference, from the generator's graph drawn again
    ref_store = gs.random_config_store(cfg, torch.Generator(device=dev).manual_seed(gen_seed), dev)
    d = cfg.e_per_vertex
    ref = {}
    for s in ("serve_low", "serve_peak"):
        r = torch.as_tensor(roots[s], device=dev).long()
        slots = r[:, None] * d + torch.arange(d, device=dev)
        dst = ref_store.edst[slots]
        ref[s] = one_hop_sets(roots[s], dst.cpu().numpy(), ref_store.eprops[slots, 0].cpu().numpy(),
                              ref_store.vprops[dst.long(), 0].cpu().numpy(), cfg.edge_val,
                              cfg.leaf_val)
    del ref_store
    ref["serve_nocache"] = ref["serve_peak"]

    capture = CallCapture((cache_mod, "cache_probe"), (bg_ops, "block_gather"))
    cp_ops.launches = bg_ops.launches = 0
    report, rows_of = {}, {}

    def serve(name, cache=None):
        s, a = cells[name]
        a = a if cache is None else (a[0], cache, *a[2:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture:
            res, mroots, mcounts, m = s(*a)
            res = res.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        assert res.shape == (len(roots[name]), rt.espec.result_width) and res.dtype == np.int32
        assert all(x.dtype == torch.int32 for x in mroots + mcounts)
        m = {k: int(v) for k, v in m.items() if k in ("hits", "misses", "route_overflow")}
        got = [set(row[row >= 0].tolist()) for row in res]
        bad = [i for i in range(len(got)) if got[i] != ref[name][i]]
        assert not bad, f"{name} root {roots[name][bad[0]]}: {sorted(got[bad[0]])} != " \
            f"{sorted(ref[name][bad[0]])}"
        assert m["route_overflow"] == 0, (name, m)
        return res, dict(step_ms=ms, **m)

    _, report["serve_low"] = serve("serve_low")
    _, report["serve_peak_cold"] = serve("serve_peak")
    # CP: the cold batch's misses drained into serve_peak's cache
    s, a = cells["serve_peak"]
    _, misses, _ = rt.run_gr_tx_batch(a[0], a[1], a[2], plan, roots["serve_peak"])
    drain = ShardedMissDrain(rt, {0: (DIR_OUT, ANY_LABEL)})
    drain.push(misses)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = drain.drain(a[0], a[0], a[1], a[2], k=1 << 30)
    torch.cuda.synchronize()
    report["cp_drain"] = dict(ms=(time.perf_counter() - t0) * 1e3, misses=len(misses),
                              committed=drain.committed, aborted=drain.aborted)
    assert drain.committed > 0 and drain.pending() == 0, report["cp_drain"]
    peak_rows, report["serve_peak"] = serve("serve_peak", cache)
    nocache_rows, report["serve_nocache"] = serve("serve_nocache")
    assert report["serve_peak"]["hits"] > 0 and report["serve_nocache"]["hits"] == 0, report
    assert np.array_equal(peak_rows, nocache_rows) or all(
        set(a_[a_ >= 0].tolist()) == set(b_[b_ >= 0].tolist())
        for a_, b_ in zip(peak_rows, nocache_rows)), "serve_nocache's rows differ from serve_peak's"
    launches = {"cache_probe": cp_ops.launches, "block_gather": bg_ops.launches}
    assert min(launches.values()) > 0, f"the graph cells launched a kernel no time: {launches}"
    # every kernel call of the cells against its plain version (the checks'
    # launches taken back off the counts)
    check_probe_calls(capture.calls["cache_probe"], "phase 18")
    for a_, kw_ in capture.calls["block_gather"]:
        got, want_ = bg_ops.block_gather(*a_, **kw_), block_gather_filter_ref(*a_, **kw_)
        assert all(torch.equal(x, y) for x, y in zip(got, want_)), \
            "block_gather disagrees with its plain version in phase 18"
    cp_ops.launches, bg_ops.launches = launches["cache_probe"], launches["block_gather"]
    report["launches"] = launches
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"dryrun ecommerce-graph cells: " + json.dumps(report)
          + f" (rows equal the numpy one-hop reference; serve_nocache's equal serve_peak's; "
          f"{len(capture.calls['cache_probe'])} cache_probe and "
          f"{len(capture.calls['block_gather'])} block_gather calls equal their plain versions)",
          flush=True)
    return report


def build_cell_on(shape, mesh, dev, pstore, **kw):
    """Another ecommerce-graph serving cell over an already built store."""
    from repro_torch.launch.steps import build_cell

    return build_cell("ecommerce-graph", shape, mesh, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0), pstore=pstore, **kw)


def run_dryrun_phase(seed, dev, rows):
    """Phase 18: the three card cells, then the dry-run over every cell
    (``launch.dryrun.main``, its records in a temporary folder, its own
    lines kept apart and its summary printed). Adds phase 18's launches to
    the kernels' rows."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShapeMesh

    t_phase = time.perf_counter()
    one = ShapeMesh((1,), ("shard",))
    t0 = time.perf_counter()
    glm = run_glm_cell(seed, dev, one)
    print(f"dryrun glm phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 18 glm4-9b")
    free_device()
    t0 = time.perf_counter()
    gat = run_gat_cell(seed, dev, one)
    print(f"dryrun gat phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 18 gat")
    free_device()
    t0 = time.perf_counter()
    graph = run_graph_cells(seed, dev)
    print(f"dryrun graph phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 18 ecommerce-graph")
    free_device()
    # 18 (a): every (cell, mesh) on meta, held against this card
    out_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = dryrun.main(["--all", "--out", out_dir, "--device", dev])
    dry_s = time.perf_counter() - t0
    log = log.getvalue()
    assert rc == 0, f"the dry-run failed: {log[-3000:]}"
    recs = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            recs.append(json.load(f))
    shutil.rmtree(out_dir)
    pairs = [r for r in recs if "skipped" not in r]
    assert len(pairs) == DRYRUN_PAIRS and len(recs) == DRYRUN_PAIRS + DRYRUN_SKIPS, len(recs)
    assert all(r["ok"] for r in recs), [r for r in recs if not r["ok"]][:1]
    for r in pairs:
        print(dryrun_line(r), flush=True)
    untraced = sorted({(r["arch"], r["shape"], r["trace_error"].split(":")[0] + ":"
                        + r["trace_error"].split(":")[1]) for r in pairs if not r["traced"]})
    fits = sum(bool(r["fits_card"]) for r in pairs)
    print(f"dryrun: {len(pairs)} pairs ok, {len(recs) - len(pairs)} skipped, {fits} fit the card, "
          f"not traced: {untraced}; {dry_s:.1f}s ({log.strip().splitlines()[-1]})", flush=True)
    added = {"flash_attention": {"phase 18 glm4-9b prefill_32k": glm["launches"]},
             "segment_spmm": {"phase 18 gat ogb_products forward": gat["forward"],
                              "phase 18 gat ogb_products backward": gat["backward"]},
             "cache_probe": {"phase 18 ecommerce-graph": graph["launches"]["cache_probe"]},
             "block_gather": {"phase 18 ecommerce-graph": graph["launches"]["block_gather"]}}
    for row in rows:
        if row["name"] in added:
            row["launches_by_path"].update(added[row["name"]])
            row["launches"] += sum(added[row["name"]].values())
        if row["name"] == "flash_attention":
            row["phase18_glm4_9b"] = glm
        if row["name"] == "segment_spmm":
            row["phase18_gat_ogb_products"] = gat
    print(f"dryrun phase: {time.perf_counter() - t_phase:.1f}s", flush=True)


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
    # fp32 matmuls in full fp32 (the defaults, stated): the plain versions
    # and the fp32 checks rely on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # 2. build every kernel from the checkout's sources
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f}s -> {_build.build_dir()} "
          f"(compiled: {_build.BUILD_INFO.get('built')})", flush=True)
    for name, info in _build.BUILD_INFO.get("ptxas", {}).items():
        regs = [l.strip() for l in info.splitlines() if "registers" in l]
        print(f"build {name}: {regs}", flush=True)

    rows = run_phases(args.seed, dev)

    print(f"total: {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def run_phases(seed, dev):
    """Phases 3-18 in their order; returns the kernels' rows."""
    # 3-7. the graph-cache paths
    rows = run_graph(seed, dev)
    free_device()

    # 9. two-tower serving at FULL widths; embedding_bag counted around the
    # towers only
    t0 = time.perf_counter()
    _, row = run_twotower(seed, dev)
    row["launches_by_path"] = {"phase 9 towers": row["launches"]}
    rows.append(row)
    print(f"recsys phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 9")
    free_device()

    # 10. Yi-6B prefill + decode; flash_attention counted around the prefill
    t0 = time.perf_counter()
    _, row = run_lm(seed, dev)
    rows.append(row)
    print(f"lm phase: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_memory("phase 10")
    free_device()

    # 16. training: the attention backward, Gemma3-4B FULL steps through
    # launch.train (flash_attention and its backward counted around them),
    # the 100M LM's checkpoint and resume
    _, bwd_row, train_fwd, fwd_timed = run_train(seed, dev)
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches_by_path"] = {"phase 10 prefill": row["launches"],
                                       "phase 16 training (forward and recompute)": train_fwd}
            row["launches"] += train_fwd
            row["training_timed_shapes"] = fwd_timed
    bwd_row["launches_by_path"] = {"phase 16 training": bwd_row["launches"]}
    rows.append(bwd_row)
    phase_memory("phase 16")
    free_device()

    # 8. GNN serving, then 16 (d), PNA training on its batch
    rows.append(run_gnn_phase(seed, dev))
    free_device()

    # 17. the model families: MoE serving and training, the GNN kinds,
    # two-tower training, the GNN example's twin; last
    run_families(seed, dev, rows)
    free_device()

    # 18. GLM4-9B prefill_32k, GAT at ogb_products and the ecommerce-graph
    # serving cells on the card, then the dry-run over every cell
    run_dryrun_phase(seed, dev, rows)
    return rows


if __name__ == "__main__":
    main()
