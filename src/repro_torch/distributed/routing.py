"""The replicated vertex-routing table of the partitioned tier.

PyTorch twin of ``repro.distributed.routing`` (the part the serving path
reads; ``RoutingTableHost`` and its overlays are not ported yet).
Ownership is interleaved: shard ``v mod n`` owns vertex ``v``. The table
stores *exceptions* to that base rule as two small sorted overlays, storage
(``svid/sowner``) and cache (``cvid/cowner``); the identity table holds none
and routes every vertex exactly like the base rule. The runtime threads the
identity table through every step, as the reference does by default, so the
miss executor takes the same table-driven branch as the reference.

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
