"""Hot-vertex block migration for the partitioned dual-CSR storage tier.

PyTorch twin of ``repro.graphstore.migration``. The base ownership rule
``v mod n`` fixes which shard serves vertex v's misses; under Zipfian roots
the shard that owns the hot set bounds throughput while its peers idle.
This module moves the hottest vertices' dual-CSR rows between owners,
journals each round as a ``MIGRATE`` record, and publishes the new
placement through the routing table (``distributed.routing``) at a batch
boundary.

- ``migrate_vertex_rows`` moves every allocated row of a vertex (live and
  tombstoned) out of the shard that holds them, compacts the source block
  in slot order and appends the rows to the destination block's recent
  region in ascending-geid order. At the destination the rows are foreign
  (``key mod n != dst``): the CSR window cannot index them, and the
  recent-region key-compare scan serves them. It runs in torch on the
  store's device and writes only the source and destination shards' rows
  (one host read of a few scalars a move finds the source); its output is
  the reference's numpy splice byte for byte: the appended run in
  ascending-geid order, the kept rows compacted in slot order, ``indptr``
  by ``searchsorted`` over ``key // n`` and ``gperm`` by a stable sort of
  the masked geids.
- ``infer_storage_exceptions`` reads the placement back from the bytes
  (foreign rows name their table owner): how replay resumes the table.
- ``HotSetTracker`` keeps exponentially decayed heat per root;
  ``select_migrations`` turns heat, per-owner load and the table into a
  bounded move list.
- ``MigrationEngine`` runs a round: it waits while any owner is down,
  journals first, then moves the rows, then publishes the table.

One deliberate difference from the reference: a round also drops the moved
vertices' cache entries from the block of their old cache home
(``drop_cached_roots``). The reference leaves them there, unreachable
while the vertex is away and stale once it moves home, since a write's
invalidation goes to the vertex's cache home of the moment.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.routing import base_owner
from repro_torch.graphstore.partition import (
    BlockCapacityError,
    EdgeBlock,
    PartitionedGraphStore,
    PartitionedStoreSpec,
    rebuild_geid_index,
)
from repro_torch.utils import INT32_MAX, PROP_MISSING

# each moved column and what a vacated lane holds (partition._build_block's fills)
_FILLS = (("key", INT32_MAX), ("other", -1), ("label", -1), ("alive", False),
          ("props", PROP_MISSING), ("geid", -1))


# ------------------------------------------------------------ row movement
def _allocated(blk: EdgeBlock, n: int, EB: int):
    """``[n, EB]`` mask of each shard's allocated lanes."""
    lanes = torch.arange(EB, dtype=torch.int32, device=blk.key.device)
    return lanes[None, :] < blk.blk_len[:, None]


def _migrate_block(pspec: PartitionedStoreSpec, blk: EdgeBlock,
                   moves: Sequence[Tuple[int, int]]) -> EdgeBlock:
    """One orientation: move every allocated row keyed by each ``vid`` to
    its ``dst`` shard's recent region. The block's tensors are copied on
    the first move that finds rows (the caller's store stays as it was)."""
    n, EB, Vloc = pspec.n_shards, pspec.e_blk_cap, pspec.v_loc
    dev = blk.key.device
    blk_len, csr_len = blk.blk_len.tolist(), blk.csr_len.tolist()
    cols = None  # the copied columns, [n, EB(, P)]
    touched: set[int] = set()
    bounds = torch.arange(Vloc + 1, dtype=torch.int32, device=dev)
    for vid, dst in moves:
        vid, dst = int(vid), int(dst)
        key = (cols["key"] if cols is not None else blk.key.view(n, EB))
        lens = torch.tensor(blk_len, dtype=torch.int32, device=dev)
        lanes = torch.arange(EB, dtype=torch.int32, device=dev)
        counts = ((key == vid) & (lanes[None, :] < lens[:, None])).sum(1).tolist()
        # a vertex's rows live on exactly one shard; its rows at dst stay
        s = next((s for s in range(n) if s != dst and counts[s]), None)
        if s is None:
            continue
        k = counts[s]
        if blk_len[dst] + k > EB:
            raise BlockCapacityError(
                f"migration of v{vid} needs {k} rows at shard {dst} ({blk_len[dst]}/{EB} used)",
                needed=blk_len[dst] + k)
        if cols is None:
            cols = {f: getattr(blk, f).clone().view(n, EB, *getattr(blk, f).shape[1:])
                    for f, _ in _FILLS}
            cols["gperm"] = blk.gperm.clone().view(n, EB)
            cols["indptr"] = blk.indptr.clone().view(n, Vloc + 1)
        L = blk_len[s]
        sel = torch.nonzero(cols["key"][s, :L] == vid).flatten()  # ascending slots
        # ascending-geid order for the appended run: independent of the
        # source block's layout
        order = sel[torch.sort(cols["geid"][s, sel], stable=True).indices]
        keep = torch.ones(L, dtype=torch.bool, device=dev)
        keep[sel] = False
        kept = torch.nonzero(keep).flatten()
        pos = blk_len[dst]
        for f, fill in _FILLS:
            arr = cols[f]
            moved = arr[s, order]
            arr[s, :L - k] = arr[s, kept]
            arr[s, L - k:L] = fill
            arr[dst, pos:pos + k] = moved
        csr_len[s] -= int((sel < csr_len[s]).sum())
        blk_len[s] = L - k
        blk_len[dst] += k
        lk = torch.div(cols["key"][s, :csr_len[s]], n, rounding_mode="floor").contiguous()
        cols["indptr"][s] = torch.searchsorted(lk, bounds, right=False).to(torch.int32)
        touched.update((s, dst))
    if cols is None:
        return blk
    for s in sorted(touched):
        cols["gperm"][s] = rebuild_geid_index(blk_len[s], cols["geid"][s])
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    flat = {f: t.reshape(n * EB, *t.shape[2:]) for f, t in cols.items() if f != "indptr"}
    return EdgeBlock(**flat, indptr=cols["indptr"].reshape(-1), blk_len=i32(blk_len),
                     csr_len=i32(csr_len))


def migrate_vertex_rows(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore,
                        moves: Sequence[Tuple[int, int]]) -> PartitionedGraphStore:
    """Move each ``(vid, dst)``'s dual-CSR rows (both orientations, live and
    dead) to shard ``dst``'s recent region, in move order. Deterministic, so
    replaying the same MIGRATE record rebuilds the same bytes; functional
    (``ps`` is left as it was). Raises ``BlockCapacityError`` when a
    destination block cannot hold the rows. The replicated vertex tier and
    the scalars pass through: migration moves copies, never content."""
    if not moves:
        return ps
    return ps._replace(out=_migrate_block(pspec, ps.out, moves),
                       inc=_migrate_block(pspec, ps.inc, moves))


def infer_storage_exceptions(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore) -> dict:
    """The routing table's storage exceptions, read back from the store's
    bytes: an allocated row whose key is foreign to its shard
    (``key mod n != s``) names the exception ``vid -> s``. Replay resumes
    the table's trajectory from a checkpoint taken after migrations this
    way, with no table snapshot."""
    n, EB = pspec.n_shards, pspec.e_blk_cap
    exc: dict[int, int] = {}
    for blk in (ps.out, ps.inc):
        key = blk.key.view(n, EB)
        shard = torch.arange(n, dtype=torch.int32, device=key.device)[:, None].expand(n, EB)
        foreign = _allocated(blk, n, EB) & (torch.remainder(key, n) != shard)
        pairs = torch.unique(torch.stack([shard[foreign], key[foreign]]), dim=1)
        for s, v in pairs.T.tolist():  # ascending (s, v), the reference's order
            exc[int(v)] = int(s)
    return exc


def vertex_row_counts(pspec: PartitionedStoreSpec, ps: PartitionedGraphStore,
                      vids: Sequence[int]) -> np.ndarray:
    """Allocated rows (live and dead, out and inc) keyed by each vid: the
    migration cost of a vertex. One pass over each orientation's keys."""
    n, EB = pspec.n_shards, pspec.e_blk_cap
    out = np.zeros(len(vids), np.int64)
    if not len(vids):
        return out
    dev = ps.out.key.device
    uniq, inv = torch.unique(torch.as_tensor(np.asarray(vids, np.int64), device=dev),
                             return_inverse=True)
    uniq = uniq.to(torch.int32)
    counts = torch.zeros(uniq.shape[0], dtype=torch.int64, device=dev)
    for blk in (ps.out, ps.inc):
        key = blk.key.view(n, EB)
        pos = torch.searchsorted(uniq, key.contiguous()).clamp(max=uniq.shape[0] - 1)
        hit = (uniq[pos] == key) & _allocated(blk, n, EB)
        counts += torch.bincount(pos[hit], minlength=uniq.shape[0])
    return counts[inv].cpu().numpy().astype(np.int64)


def drop_cached_roots(cache, n: int, vids, homes):
    """Sweep the cache entries of each root ``vids[i]``, whatever its
    template and parameters, from the block of owner ``homes[i]`` only:
    the write path's sweep by root (``core.cache.sweep_root``) for every
    template at once, counted in ``n_delete``. A round calls it with the
    moved vertices' old cache homes."""
    vids = np.asarray(vids, np.int64).reshape(-1)
    if not vids.size:
        return cache
    dev = cache.root.device
    C = cache.root.shape[0]
    block = torch.arange(C, device=dev) // (C // n)
    v = torch.as_tensor(vids, dtype=torch.int32, device=dev)
    h = torch.as_tensor(np.asarray(homes, np.int64).reshape(-1), device=dev)
    kill = ((cache.root[:, None] == v[None, :]) & (block[:, None] == h[None, :])).any(dim=1)
    gone = (kill & cache.valid).sum(dtype=torch.int32)
    return cache._replace(valid=cache.valid & ~kill, n_delete=cache.n_delete + gone)


def moved_away(n: int, rhost, moves) -> tuple:
    """``(vids, old homes)`` of the moves that change a vertex's cache home:
    its cache owner before the round (``rhost``'s, not yet updated; the
    base rule without a table) against the move's destination."""
    vids = np.asarray([v for v, _ in moves], np.int64)
    dsts = np.asarray([d for _, d in moves], np.int64)
    old = np.asarray(rhost.cache_owner(vids) if rhost is not None else base_owner(vids, n))
    away = old != dsts
    return vids[away], old[away]


# ------------------------------------------------------------- heat signal
class HotSetTracker:
    """Exponentially decayed heat per root from the served batches.

    ``observe(roots)`` decays all heat by ``decay`` and adds one unit per
    root occurrence (host numpy). The map is pruned to the ``cap`` hottest
    entries, so its memory stays bounded."""

    def __init__(self, decay: float = 0.9, cap: int = 4096):
        self.decay = float(decay)
        self.cap = int(cap)
        self._heat: dict[int, float] = {}

    def observe(self, roots) -> None:
        r = np.asarray(roots).reshape(-1)
        r = r[r >= 0]
        if self.decay < 1.0 and self._heat:
            self._heat = {v: h * self.decay for v, h in self._heat.items()}
        vals, cnt = np.unique(r, return_counts=True)
        for v, c in zip(vals.tolist(), cnt.tolist()):
            self._heat[int(v)] = self._heat.get(int(v), 0.0) + float(c)
        if len(self._heat) > self.cap:
            keep = sorted(self._heat.items(), key=lambda kv: -kv[1])
            self._heat = dict(keep[: self.cap])

    def hottest(self, k: int) -> list:
        """Top-k ``(vid, heat)`` pairs, hottest first (ties by vid)."""
        return sorted(self._heat.items(), key=lambda kv: (-kv[1], kv[0]))[: int(k)]

    def heat(self, vid: int) -> float:
        return self._heat.get(int(vid), 0.0)

    def total_heat(self) -> float:
        return float(sum(self._heat.values()))


# ------------------------------------------------------------------ policy
class MigrationPolicy(NamedTuple):
    """When and what to migrate.

    ``load_share_trigger``: act only when the hottest owner's share of
    frontier rows exceeds this multiple of the fair share ``1/n``.
    ``max_moves_per_round``: the bound on a round's moves (each a journal
    record and a splice). ``min_heat``: ignore colder roots.
    ``max_rows_per_vertex``: skip vertices with more dual-CSR rows (they
    must keep fitting in the destination's recent-scan window).
    ``dst_recent_headroom_frac``: keep the destination's recent fill under
    this fraction of ``recent_blk_cap``, since a migrated vertex occupies
    the window for good. ``move_cooldown_rounds``: a vertex just moved is
    no candidate for this many rounds (a vertex whose load alone exceeds
    the fair share would otherwise bounce between owners).
    """

    load_share_trigger: float = 1.25
    max_moves_per_round: int = 4
    min_heat: float = 1.0
    max_rows_per_vertex: int = 64
    dst_recent_headroom_frac: float = 0.5
    move_cooldown_rounds: int = 8


def select_migrations(policy: MigrationPolicy, tracker: HotSetTracker, rhost,
                      pspec: PartitionedStoreSpec, ps: PartitionedGraphStore, owner_rows, *,
                      cooldown=frozenset()) -> list:
    """This round's moves ``[(vid, dst), ...]``: the hottest vertices the
    most-loaded owner serves, spread over the least-loaded owners, within
    the policy's fit bounds and the table's capacity.

    ``owner_rows`` is the per-owner frontier-row load ([n], the
    ``frontier_rows`` column of the owner-stage block). Destinations are
    chosen greedily against a working copy of the load: a move's estimate
    (the vertex's share of the tracked heat, capped at the hot owner's
    excess over the fair share) lands on the projected-coldest owner, and a
    move is taken only while that owner stays below the hot owner's load.
    ``cooldown`` vertices are skipped."""
    n = pspec.n_shards
    rows = np.asarray(owner_rows, np.float64).reshape(-1).copy()
    assert rows.shape[0] == n, (rows.shape, n)
    total = float(rows.sum())
    if total <= 0:
        return []
    hot_owner = int(rows.argmax())
    trigger = policy.load_share_trigger * total / n
    if float(rows[hot_owner]) < trigger:
        return []
    budget = min(policy.max_moves_per_round, max(rhost.cap - len(rhost.storage_exceptions), 0))
    if budget <= 0:
        return []

    # per-destination recent-window headroom: the larger fill of the two
    # orientations, since both receive the vertex's rows
    cap = int(policy.dst_recent_headroom_frac * pspec.recent_blk_cap)
    fill = np.maximum(*[(b.blk_len - b.csr_len).cpu().numpy().astype(np.int64)
                        for b in (ps.out, ps.inc)])
    headroom = cap - fill

    total_heat = max(tracker.total_heat(), 1e-12)
    moves = []
    for vid, heat in tracker.hottest(4 * policy.max_moves_per_round):
        if heat < policy.min_heat or len(moves) >= budget:
            break
        if float(rows[hot_owner]) < trigger:
            break  # balanced enough: leave the tail alone
        if int(vid) in cooldown or rhost.storage_owner(vid) != hot_owner:
            continue
        cost = int(vertex_row_counts(pspec, ps, [vid])[0])
        if cost == 0 or cost > policy.max_rows_per_vertex:
            continue
        excess = float(rows[hot_owner]) - total / n
        est = min(heat / total_heat * total, excess)
        order = np.argsort(rows, kind="stable")
        dst = next((int(o) for o in order
                    if int(o) != hot_owner and headroom[int(o)] >= cost
                    and float(rows[int(o)]) + est < float(rows[hot_owner])), None)
        if dst is None:
            continue
        headroom[dst] -= cost
        rows[hot_owner] -= est
        rows[dst] += est
        moves.append((int(vid), dst))
    return moves


# ------------------------------------------------------------------ engine
class MigrationEngine:
    """The migration sequencer: journal, move, publish.

    ``step`` runs at most one round. It refuses to act while ``detector``
    reports any owner down (recovery replays the journal in order; a move
    interleaved with an outage would replay against a store the dead owner
    never saw): the round waits for a step after recovery. The caller
    installs the returned store at the batch boundary, with the bumped
    table, so no batch sees a torn layout."""

    def __init__(self, pspec: PartitionedStoreSpec, rhost, *,
                 policy: Optional[MigrationPolicy] = None,
                 tracker: Optional[HotSetTracker] = None, journal=None, detector=None):
        self.pspec = pspec
        self.rhost = rhost
        self.policy = policy or MigrationPolicy()
        self.tracker = tracker or HotSetTracker()
        self.journal = journal
        self.detector = detector
        self.rounds = 0
        self.moved_vertices = 0
        self.moved_rows = 0
        self.deferred_rounds = 0
        self._steps = 0
        self._cooldown: dict = {}  # vid -> the step its cooldown ends at

    def observe(self, roots) -> None:
        self.tracker.observe(roots)

    def step(self, ps: PartitionedGraphStore, owner_rows, *, cache=None):
        """Maybe run one round: the policy's moves (none while an owner is
        down) through ``apply``. Returns what ``apply`` returns."""
        return self.apply(ps, self._select(ps, owner_rows), cache=cache)

    def apply(self, ps: PartitionedGraphStore, moves, *, cache=None):
        """Run one round of ``moves`` (none: nothing happens): journal first,
        then the splice, then the table. Returns ``(store, moves)``. Given
        the live ``cache``, the round also drops the moved vertices' entries
        from their old cache homes' blocks (``drop_cached_roots``) and
        returns ``(store, cache, moves)``."""
        moves = [(int(v), int(d)) for v, d in moves]
        if moves:
            rows = int(vertex_row_counts(self.pspec, ps, [v for v, _ in moves]).sum())
            # journal first: a crash after the append replays the move, one
            # before it replays none of it; either way the recovered store
            # is one of the two states, never torn
            if self.journal is not None:
                self.journal.append_migrate(moves)
            ps = migrate_vertex_rows(self.pspec, ps, moves)
            if cache is not None:
                cache = drop_cached_roots(cache, self.pspec.n_shards,
                                          *moved_away(self.pspec.n_shards, self.rhost, moves))
            self.rhost.apply_moves(moves)
            self.rounds += 1
            self.moved_vertices += len(moves)
            self.moved_rows += rows
        return (ps, moves) if cache is None else (ps, cache, moves)

    def _select(self, ps, owner_rows) -> list:
        """This step's moves: none while an owner is down (the round waits),
        else the policy's, each then cooling down."""
        if self.detector is not None and bool(np.asarray(self.detector.down_mask()).any()):
            self.deferred_rounds += 1
            return []
        self._steps += 1
        self._cooldown = {v: e for v, e in self._cooldown.items() if e > self._steps}
        moves = select_migrations(self.policy, self.tracker, self.rhost, self.pspec, ps,
                                  owner_rows, cooldown=self._cooldown.keys())
        for v, _ in moves:
            self._cooldown[v] = self._steps + self.policy.move_cooldown_rounds
        return moves

    def metrics(self) -> dict:
        return {"migration_rounds": self.rounds, "migrated_vertices": self.moved_vertices,
                "migrated_rows": self.moved_rows,
                "migration_deferred_rounds": self.deferred_rounds, **self.rhost.metrics()}
