"""The replicated vertex-routing table of the partitioned tier.

PyTorch twin of ``repro.distributed.routing``. Ownership is interleaved:
shard ``v mod n`` owns vertex ``v``. The table stores *exceptions* to that
base rule as two small sorted overlays:

- storage (``svid/sowner``): vertex v's dual-CSR rows were migrated to
  ``sowner`` (``graphstore.migration``); its reads and writes go there;
- cache (``cvid/cowner``): v's cache entries live at ``cowner`` although
  its rows did not move. gR routes v there, so a hit is served at the
  caching shard; a miss comes back deferred and the runtime retries it
  through ``storage_view`` of the same table (the locality retry).

The identity table holds no exception and routes every vertex exactly like
the base rule. The runtime threads it through every step unless a
``RoutingTableHost`` is attached, as the reference does by default, so the
miss executor takes the same table-driven branch as the reference.

``RoutingTableHost`` owns the placement: numpy dicts on the host, which
answer the host lookups of the drain and journal paths, and a table of
tensors on the runtime's device stamped once per epoch. Every mutation
bumps the epoch; a batch reads the table as one input, so the host swaps it
only between batches. The overlays have a fixed capacity ``cap``; a
mutation past it raises.

The base rule is spelled ``torch.remainder`` / ``np.mod`` here and nowhere
else hand-codes it: callers go through ``base_owner`` or the lookups below.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils import resolve_device

# sorts after every real vertex id: the overlay fill, so a lookup never
# matches a real root
_FILL = 2**31 - 1

DEFAULT_TABLE_CAP = 64


class RoutingTable(NamedTuple):
    """Device-resident replicated routing state (all shapes static).

    ``epoch``  int32 []  — table version
    ``svid``   int32 [M] — sorted storage-exception vids (fill 2^31-1)
    ``sowner`` int32 [M] — owner per storage exception (fill -1)
    ``cvid``   int32 [M] — sorted cache-exception vids (fill 2^31-1)
    ``cowner`` int32 [M] — owner per cache exception (fill -1)
    """

    epoch: torch.Tensor
    svid: torch.Tensor
    sowner: torch.Tensor
    cvid: torch.Tensor
    cowner: torch.Tensor

    @property
    def cap(self) -> int:
        return self.svid.shape[0]


def _overlay_lookup(vid_sorted, owner, v, base):
    """Override ``base`` where ``v`` appears in the sorted overlay."""
    pos = torch.searchsorted(vid_sorted, v.contiguous())
    posc = pos.clamp(0, vid_sorted.shape[0] - 1)
    hit = vid_sorted[posc] == v
    return torch.where(hit, owner[posc], base)


def storage_owner_of(rtable: Optional[RoutingTable], vids, n: int):
    """Where vertex ``vids``' dual-CSR rows physically live: the base rule
    (``partition.owner_of``) overridden by the storage exceptions. Negative
    and out-of-range ids map through the base rule; callers gate validity."""
    v = torch.as_tensor(vids).to(torch.int32)
    base = torch.remainder(v, n)
    if rtable is None:
        return base
    return _overlay_lookup(rtable.svid, rtable.sowner, v, base)


def cache_owner_of(rtable: Optional[RoutingTable], vids, n: int):
    """Where vertex ``vids``' cache entries live — the gR routing rule.
    Cache exceptions override storage exceptions override the base rule."""
    v = torch.as_tensor(vids).to(torch.int32)
    base = storage_owner_of(rtable, v, n)
    if rtable is None:
        return base
    return _overlay_lookup(rtable.cvid, rtable.cowner, v, base)


def base_owner(vids, n: int):
    """The base ownership rule on the host (numpy): interleaved ``v mod n``."""
    return np.mod(np.asarray(vids), n)


def identity_table(n_shards: int, cap: int = DEFAULT_TABLE_CAP, device=None) -> RoutingTable:
    """The empty table: routes exactly like ``owner_of(v, n)``."""
    del n_shards  # the base rule needs n only at lookup time
    dev = resolve_device(device)
    full = lambda v: torch.full((cap,), v, dtype=torch.int32, device=dev)
    return RoutingTable(
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        svid=full(_FILL), sowner=full(-1), cvid=full(_FILL), cowner=full(-1),
    )


def storage_view(rtable: RoutingTable) -> RoutingTable:
    """The same table with the cache exceptions stripped: it routes every
    vertex to its storage owner (the locality retry's table)."""
    return rtable._replace(cvid=torch.full_like(rtable.cvid, _FILL),
                           cowner=torch.full_like(rtable.cowner, -1))


def _sorted_lookup(overlay: dict, v, base):
    """``base`` overridden where ``v`` is a key of ``overlay`` (host numpy)."""
    if not overlay:
        return base
    keys = np.fromiter(overlay.keys(), np.int64, len(overlay))
    vals = np.fromiter(overlay.values(), np.int64, len(overlay))
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    pos = np.clip(np.searchsorted(keys, v), 0, len(keys) - 1)
    return np.where(keys[pos] == v, vals[pos], base)


class RoutingTableHost:
    """The host's mutable placement and the device tables stamped from it.

    The host lookups (``storage_owner`` / ``cache_owner``) take numpy ids; a
    scalar in gives a python int out. ``device_table()`` stamps the full
    table on ``device`` and ``storage_table()`` its storage view, each cached
    until the next mutation, so an unchanged table costs a dict hit a batch.
    A mutation that would hold more than ``cap`` exceptions of a kind
    raises."""

    def __init__(self, n_shards: int, cap: int = DEFAULT_TABLE_CAP, device=None):
        self.n = int(n_shards)
        self.cap = int(cap)
        self.device = resolve_device(device)
        self.epoch = 0
        self._storage: dict[int, int] = {}
        self._cache: dict[int, int] = {}
        self._stamped: dict[bool, RoutingTable] = {}

    # ------------------------------------------------------------ mutation
    def _bump(self) -> None:
        self.epoch += 1
        self._stamped = {}

    def _check_owner(self, owner: int) -> None:
        if not 0 <= owner < self.n:
            raise ValueError(f"owner {owner} out of range [0, {self.n})")

    def _set(self, overlay: dict, vid: int, owner: int, kind: str) -> None:
        if vid not in overlay and len(overlay) >= self.cap:
            raise ValueError(f"routing table full ({self.cap} {kind} exceptions)")
        overlay[vid] = owner

    def set_storage_owner(self, vid: int, owner: int) -> None:
        """Record that ``vid``'s rows now live at ``owner``; its native owner
        deletes the exception (the table stores deviations only)."""
        vid, owner = int(vid), int(owner)
        self._check_owner(owner)
        if owner == base_owner(vid, self.n):
            self._storage.pop(vid, None)
        else:
            self._set(self._storage, vid, owner, "storage")
        self._bump()

    def set_cache_owner(self, vid: int, owner: int) -> None:
        """Point ``vid``'s cache home at ``owner`` without moving its rows;
        its storage owner clears the exception."""
        vid, owner = int(vid), int(owner)
        self._check_owner(owner)
        if owner == self.storage_owner(vid):
            self._cache.pop(vid, None)
        else:
            self._set(self._cache, vid, owner, "cache")
        self._bump()

    def clear_cache_owner(self, vid: int) -> None:
        if self._cache.pop(int(vid), None) is not None:
            self._bump()

    def apply_moves(self, moves) -> None:
        """Apply a round of storage moves ``[(vid, dst), ...]`` as one epoch
        bump (a MIGRATE record replays through here). A moved vertex's cache
        home follows its rows."""
        for vid, dst in moves:
            vid, dst = int(vid), int(dst)
            if dst == base_owner(vid, self.n):
                self._storage.pop(vid, None)
            else:
                self._set(self._storage, vid, dst, "storage")
            self._cache.pop(vid, None)
        self._bump()

    # ------------------------------------------------------------- lookups
    def storage_owner(self, vids):
        v = np.asarray(vids)
        out = _sorted_lookup(self._storage, v, np.mod(v, self.n))
        return int(out) if np.ndim(vids) == 0 else np.asarray(out).astype(np.int32)

    def cache_owner(self, vids):
        v = np.asarray(vids)
        out = _sorted_lookup(self._cache, v, np.asarray(self.storage_owner(v)))
        return int(out) if np.ndim(vids) == 0 else np.asarray(out).astype(np.int32)

    def is_split(self, vids):
        """True where the cache home differs from the storage home: the rows
        whose misses come back deferred and retry through
        ``storage_table()``."""
        return np.asarray(self.cache_owner(vids)) != np.asarray(self.storage_owner(vids))

    @property
    def storage_exceptions(self) -> dict:
        return dict(self._storage)

    @property
    def cache_exceptions(self) -> dict:
        return dict(self._cache)

    def has_exceptions(self) -> bool:
        return bool(self._storage or self._cache)

    # ------------------------------------------------------- device tables
    def _stamp(self, with_cache: bool) -> RoutingTable:
        def overlay(d: dict):
            vid = np.full(self.cap, _FILL, np.int32)
            own = np.full(self.cap, -1, np.int32)
            items = sorted(d.items())
            vid[:len(items)] = [v for v, _ in items]
            own[:len(items)] = [o for _, o in items]
            return (torch.as_tensor(vid, device=self.device),
                    torch.as_tensor(own, device=self.device))

        svid, sown = overlay(self._storage)
        cvid, cown = overlay(self._cache if with_cache else {})
        return RoutingTable(epoch=torch.tensor(self.epoch, dtype=torch.int32, device=self.device),
                            svid=svid, sowner=sown, cvid=cvid, cowner=cown)

    def device_table(self) -> RoutingTable:
        """The full table (storage and cache overlays), cached per epoch."""
        if True not in self._stamped:
            self._stamped[True] = self._stamp(True)
        return self._stamped[True]

    def storage_table(self) -> RoutingTable:
        """The storage view, the locality retry's table, cached per epoch."""
        if False not in self._stamped:
            self._stamped[False] = self._stamp(False)
        return self._stamped[False]

    def metrics(self) -> dict:
        return {"table_epoch": self.epoch, "storage_exceptions": len(self._storage),
                "cache_exceptions": len(self._cache)}
