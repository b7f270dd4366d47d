"""The one-hop sub-query result cache (§4), as a tensor hash table.

PyTorch twin of ``repro.core.cache``; every function returns the reference's
bits. Physical design:

- Open-addressing table of ``capacity`` slots (power of two), linear probe
  window of ``probes`` slots. Template id and root vertex id are stored
  explicitly per slot; the parameter vector is fingerprinted (``fp`` is an
  int32 tensor holding the uint32 fingerprint's bits, so a probe reads 4 B
  of it; the hash itself is computed in int64).
- Values are padded leaf-id rows of ``max_leaves``; larger results spill
  into continuation chunks at independent hashes; results larger than
  ``max_chunks * max_leaves`` are not cached (counted).
- **The read-path probe always runs through the ``cache_probe`` kernel**
  (``repro_torch.kernels.cache_probe``) with the chunk folded into the tpl
  channel; there is no switch that turns it off. On CPU tensors the kernel
  wrapper runs its plain version.
- Inserts commit a batch in batch-order priority rounds, byte-identical to
  walking it sequentially (``cache_insert_sequential``).

State is functional: inserts, deletes and sweeps return new tensors for the
fields they change and never write into a tensor the caller holds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.keys import PARAM_LEN
from repro_torch.kernels.cache_probe.ops import cache_probe
from repro_torch.utils import (
    NULL_ID, SyncCount, hash_rows, resolve_device, scatter_drop, u32_bits,
)

_SEED_SLOT = 0x51ED5EED
_SEED_FP = 0xF1A9F00D

# cap on virtual rows (B * max_chunks) per vectorized-insert slab: bounds the
# O(N^2) collision masks
_INSERT_SLAB = 2048
# root-sweep compare is [capacity, S]; walk S in blocks of this many
_SWEEP_BLOCK = 64


class CacheSpec(NamedTuple):
    capacity: int = 4096  # power of two
    probes: int = 8
    max_leaves: int = 32  # leaf ids per slot (one FDB value chunk)
    max_chunks: int = 2  # continuation chunks per key


class CacheState(NamedTuple):
    tpl: torch.Tensor  # int32 [cap] (-1 = never used)
    root: torch.Tensor  # int32 [cap]
    fp: torch.Tensor  # int32 [cap], the uint32 fingerprint's bits
    chunk: torch.Tensor  # int32 [cap]
    total_len: torch.Tensor  # int32 [cap] (authoritative on chunk 0)
    vals: torch.Tensor  # int32 [cap, max_leaves]
    version: torch.Tensor  # int32 [cap] commit version of the populating txn
    valid: torch.Tensor  # bool [cap]
    # stats (0-d int32): read hits / read misses / inserts / evictions /
    # deletes / oversize results skipped
    n_hit: torch.Tensor
    n_miss: torch.Tensor
    n_insert: torch.Tensor
    n_evict: torch.Tensor
    n_delete: torch.Tensor
    n_oversize: torch.Tensor


_SLOT_FIELDS = ("tpl", "root", "fp", "chunk", "total_len", "vals", "version", "valid")


def empty_cache(spec: CacheSpec, device=None) -> CacheState:
    dev = resolve_device(device)
    cap = spec.capacity
    assert cap & (cap - 1) == 0, "capacity must be a power of two"
    i32 = dict(dtype=torch.int32, device=dev)
    z = torch.zeros((), **i32)
    return CacheState(
        tpl=torch.full((cap,), -1, **i32),
        root=torch.full((cap,), -1, **i32),
        fp=torch.zeros((cap,), **i32),
        chunk=torch.zeros((cap,), **i32),
        total_len=torch.zeros((cap,), **i32),
        vals=torch.full((cap, spec.max_leaves), NULL_ID, **i32),
        version=torch.zeros((cap,), **i32),
        valid=torch.zeros((cap,), dtype=torch.bool, device=dev),
        n_hit=z, n_miss=z, n_insert=z, n_evict=z, n_delete=z, n_oversize=z,
    )


def cache_shard(cache: CacheState, n: int, s: int) -> CacheState:
    """Shard ``s`` of a global cache co-partitioned over ``n`` owners: views
    of its block of ``capacity // n`` slots, which it probes with that local
    capacity; the 0-d stats counters are the global ones."""
    cloc = cache.tpl.shape[0] // n
    rows = slice(s * cloc, (s + 1) * cloc)
    return cache._replace(**{f: getattr(cache, f)[rows] for f in _SLOT_FIELDS})


def _key_cols(tpl_id, root, params, chunk):
    root = torch.as_tensor(root).to(torch.int32)
    dev = root.device
    tpl = torch.broadcast_to(torch.as_tensor(tpl_id, dtype=torch.int32, device=dev), root.shape)
    ch = torch.broadcast_to(torch.as_tensor(chunk, dtype=torch.int32, device=dev), root.shape)
    return [tpl, root] + [params[..., i] for i in range(PARAM_LEN)] + [ch]


def _first_true(m):
    """argmax over the last axis of a bool mask: the first True (0 if none)."""
    return m.to(torch.uint8).argmax(dim=-1)


def _probe(spec: CacheSpec, cache: CacheState, tpl_id, root, params, chunk):
    """Find the slot holding (tpl, root, params, chunk) with plain tensor ops.
    Returns (found, slot, slots [..., P], fp). The write path's probe."""
    cols = _key_cols(tpl_id, root, params, chunk)
    tpl, root_t, ch = cols[0], cols[1], cols[-1]
    h = hash_rows(cols, _SEED_SLOT)
    fp = u32_bits(hash_rows(cols, _SEED_FP))
    mask = spec.capacity - 1
    offs = torch.arange(spec.probes, dtype=torch.int64, device=h.device)
    slots = ((h & mask)[..., None] + offs) & mask  # [..., P]
    match = (
        cache.valid[slots]
        & (cache.tpl[slots] == tpl[..., None])
        & (cache.root[slots] == root_t[..., None])
        & (cache.fp[slots] == fp[..., None])
        & (cache.chunk[slots] == ch[..., None])
    )
    found = match.any(dim=-1)
    first = slots.gather(-1, _first_true(match)[..., None])[..., 0]
    slot = torch.where(found, first, -1).to(torch.int32)
    return found, slot, slots, fp


def _chunk_hashes(tpl_id, root, params, n_chunks):
    """Slot hash and fingerprint (int32 bits, each [..., n_chunks]) of the
    keys of chunks ``0 .. n_chunks - 1``, equal to ``hash_rows`` of each
    key under each seed. One pass: the chunk is the last key column, so the
    columns before it are mixed once for both seeds and every chunk."""
    cols = _key_cols(tpl_id, root, params, 0)[:-1]
    chunks = torch.arange(n_chunks, dtype=torch.int32, device=cols[1].device)
    h = hash_rows([c[..., None, None] for c in cols] + [chunks[:, None]],
                  (_SEED_SLOT, _SEED_FP))
    return u32_bits(h[..., 0]), u32_bits(h[..., 1])


def cache_lookup_lean(spec: CacheSpec, cache: CacheState, tpl_id, root, params):
    """Chain lookup returning ``(hit, leaves_raw, count, version)``.

    ``leaves_raw`` [B, max_chunks*max_leaves] holds the cached values
    left-packed: positions ``[0, count)`` are valid; the tail is whatever the
    slots carry, so callers consume only the counted prefix. A hit requires
    chunk 0 plus every continuation chunk implied by ``total_len``. Stats are
    not updated (pure read).

    Unlike the reference, which skips the continuation probes behind a
    ``lax.cond`` when no row spills, the port always probes them: a branch
    would cost a host read per lookup, and the counted prefix, the hit mask
    and the version are the same either way.

    All ``max_chunks`` chunk keys of every row go through one launch of
    the ``cache_probe`` kernel, as ``B * max_chunks`` keys in row-major
    (row, chunk) order; each (found, slot) equals ``_probe``'s for that
    chunk, since the probes are independent reads of one cache. The kernel
    matches on (valid, tpl, root, fp), so the chunk is folded into the tpl
    channel (``tpl * max_chunks + chunk``, with ``tpl_eff`` the cache side
    of the fold); never-used slots carry tpl = -1, whose folded value is
    negative and matches no real key. The slot hash and the fingerprint go
    to the kernel as int32 bits: it needs only the hash's low bits and an
    equality test on the fingerprint.
    """
    L, C = spec.max_leaves, spec.max_chunks
    tpl_eff = (cache.tpl * C + cache.chunk).contiguous()
    root = torch.as_tensor(root).to(torch.int32)
    shape = root.shape
    tpl = torch.broadcast_to(torch.as_tensor(tpl_id, dtype=torch.int32, device=root.device),
                             shape)
    h, fp = _chunk_hashes(tpl, root, params, C)
    chunks = torch.arange(C, dtype=torch.int32, device=root.device)
    flat = lambda t: t.reshape(-1).contiguous()
    found, slot = cache_probe(
        tpl_eff, cache.root, cache.fp, cache.valid, flat(tpl[..., None] * C + chunks),
        flat(root[..., None].expand(*shape, C)), flat(h), flat(fp), probes=spec.probes,
    )
    found, slot = found.reshape(*shape, C), slot.reshape(*shape, C).clamp(min=0).long()
    s0 = slot[..., 0]
    tlen = torch.where(found[..., 0], cache.total_len[s0], 0)
    need = ((tlen + L - 1) // L).clamp(1, C)
    ok = found[..., 0]
    for c in range(1, C):
        sc = slot[..., c]
        ok = ok & ((need <= c) | found[..., c])
        # chain consistency: continuation chunks carry the same total_len
        ok = ok & ((need <= c) | (cache.total_len[sc] == tlen))
    leaves_raw = cache.vals[slot].reshape(*shape, C * L)
    version = torch.where(ok, cache.version[s0], -1)
    count = torch.where(ok, tlen, 0)
    return ok, leaves_raw, count, version


def cache_lookup(spec: CacheSpec, cache: CacheState, tpl_id, root, params):
    """Batched read-path lookup (§3.1).

    Returns ``(hit [B], leaves [B, max_chunks*max_leaves], lmask, version)``
    with invalid positions masked to NULL_ID.
    """
    ok, leaves_raw, count, version = cache_lookup_lean(spec, cache, tpl_id, root, params)
    pos = torch.arange(spec.max_leaves * spec.max_chunks, dtype=torch.int32,
                       device=leaves_raw.device)
    lmask = pos < count[..., None]
    leaves = torch.where(lmask, leaves_raw, NULL_ID)
    return ok, leaves, lmask, version


def _fit_width(spec: CacheSpec, leaves):
    L, C = spec.max_leaves, spec.max_chunks
    B, width = leaves.shape
    assert width >= L, "leaves row narrower than one chunk"
    if width < L * C:  # pad so the chunk reshape stays in range
        pad = torch.full((B, L * C - width), NULL_ID, dtype=leaves.dtype, device=leaves.device)
        return torch.cat([leaves, pad], dim=1)
    return leaves[:, : L * C]


def _insert_slab(spec: CacheSpec, work: dict, tpl, root, params, leaves, tlen,
                 ver, active_rows, syncs: SyncCount):
    """Commit one slab of rows into the working slot arrays ``work`` (private
    copies with a trash row at index ``capacity``); returns evictions."""
    L, C = spec.max_leaves, spec.max_chunks
    P, cap = spec.probes, spec.capacity
    dev = leaves.device
    B = leaves.shape[0]
    nchunks = ((tlen + L - 1) // L).clamp(1, C)

    # ---- virtual rows: order o = b * C + c (sequential execution order) ----
    N = B * C
    rep = lambda x: x.repeat_interleave(C, dim=0)
    tpl_v, root_v, tlen_v = rep(tpl), rep(root), rep(tlen)
    params_v, ver_v = rep(params), rep(ver)
    chunk_v = torch.arange(C, dtype=torch.int32, device=dev).repeat(B)
    active = rep(active_rows) & (chunk_v < rep(nchunks))
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    segs = leaves.to(torch.int32).reshape(N, L)
    segs = torch.where(chunk_v[:, None] * L + lane[None, :] < tlen_v[:, None], segs, NULL_ID)

    cols = _key_cols(tpl_v, root_v, params_v, chunk_v)
    base = hash_rows(cols, _SEED_SLOT) & (cap - 1)
    fp_v = u32_bits(hash_rows(cols, _SEED_FP))

    # probe windows overlap iff the circular distance between bases is < P
    d = torch.remainder(base[None, :] - base[:, None], cap)
    overlap = (d < P) | (d > cap - P)
    earlier = torch.tril(torch.ones((N, N), dtype=torch.bool, device=dev), -1)
    hazard = overlap & earlier  # [i, j]: j precedes i and shares its window
    slots = (base[:, None] + torch.arange(P, dtype=torch.int64, device=dev)) & (cap - 1)
    committed = torch.zeros(N, dtype=torch.bool, device=dev)
    n_evict = torch.zeros((), dtype=torch.int32, device=dev)
    while syncs.read((active & ~committed).any()):
        pending = active & ~committed
        ready = pending & ~(hazard & pending[None, :]).any(dim=1)
        valid = work["valid"]
        match = (
            valid[slots]
            & (work["tpl"][slots] == tpl_v[:, None])
            & (work["root"][slots] == root_v[:, None])
            & (work["fp"][slots] == fp_v[:, None])
            & (work["chunk"][slots] == chunk_v[:, None])
        )
        found = match.any(dim=-1)
        mslot = slots.gather(1, _first_true(match)[:, None])[:, 0]
        empty = ~valid[slots]
        has_empty = empty.any(dim=-1)
        first_empty = slots.gather(1, _first_true(empty)[:, None])[:, 0]
        # reuse matching slot, else first empty, else evict last probe slot
        target = torch.where(found, mslot, torch.where(has_empty, first_empty, slots[:, -1]))
        evict = ~found & ~has_empty & valid[target]
        t = torch.where(ready, target, cap)  # not ready -> trash row
        for f, v in (("tpl", tpl_v), ("root", root_v), ("fp", fp_v),
                     ("chunk", chunk_v), ("total_len", tlen_v), ("vals", segs),
                     ("version", ver_v)):
            work[f][t] = v
        work["valid"][t] = True
        n_evict += (ready & evict).sum(dtype=torch.int32)
        committed |= ready
    return n_evict


def cache_insert(spec: CacheSpec, cache: CacheState, tpl_id, root, params,
                 leaves, lens, commit_version, mask, syncs: SyncCount | None = None):
    """Vectorized write-path insert of B results (CP population) —
    byte-identical to ``cache_insert_sequential``.

    ``leaves``: int32 [B, >= max_leaves] compacted leaf ids. Oversize results
    are skipped and counted. Every (row, chunk) is a virtual row whose
    priority is its sequential order; each round commits the rows none of
    whose earlier window-overlapping peers is still pending, so each row sees
    the state its sequential turn would see. Rounds loop on a host read
    (counted in ``syncs``); batches are slabbed to ``_INSERT_SLAB`` virtual
    rows to bound the O(N^2) collision masks.
    """
    syncs = syncs if syncs is not None else SyncCount()
    L, C = spec.max_leaves, spec.max_chunks
    cap = spec.capacity
    dev = cache.tpl.device
    B = leaves.shape[0]
    as_i32 = lambda x: torch.as_tensor(x).to(device=dev, dtype=torch.int32)
    tpl_id = torch.broadcast_to(as_i32(tpl_id), (B,))
    root = as_i32(root)
    params = as_i32(params)
    lens = as_i32(lens)
    commit_version = torch.broadcast_to(as_i32(commit_version), (B,))
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.bool)
    leaves = _fit_width(spec, leaves)
    oversize = lens > L * C
    do = mask & ~oversize
    tlen = lens.clamp(max=L * C)

    # private working copies with one trash row at index ``cap``
    work = {}
    for f in _SLOT_FIELDS:
        a = getattr(cache, f)
        w = torch.empty((cap + 1,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        w[:cap] = a
        work[f] = w
    n_evict = torch.zeros((), dtype=torch.int32, device=dev)
    max_b = max(1, _INSERT_SLAB // C)
    for lo in range(0, B, max_b):
        hi = min(lo + max_b, B)
        n_evict = n_evict + _insert_slab(
            spec, work, tpl_id[lo:hi], root[lo:hi], params[lo:hi], leaves[lo:hi],
            tlen[lo:hi], commit_version[lo:hi], do[lo:hi], syncs,
        )
    return cache._replace(
        **{f: work[f][:cap] for f in _SLOT_FIELDS},
        n_evict=cache.n_evict + n_evict,
        n_insert=cache.n_insert + do.sum(dtype=torch.int32),
        n_oversize=cache.n_oversize + (mask & oversize).sum(dtype=torch.int32),
    )


def cache_insert_sequential(spec: CacheSpec, cache: CacheState, tpl_id, root,
                            params, leaves, lens, commit_version, mask):
    """Reference insert: walks the batch row by row, chunk by chunk (the
    original write path). Kept as the oracle ``cache_insert`` is held to."""
    L, C = spec.max_leaves, spec.max_chunks
    B = leaves.shape[0]
    leaves = _fit_width(spec, leaves) if leaves.shape[1] < L * C else leaves
    lane = torch.arange(L, device=leaves.device)
    for i in range(B):
        do = bool(mask[i]) and not int(lens[i]) > L * C
        tlen = min(int(lens[i]), L * C)
        nchunks = min(max((tlen + L - 1) // L, 1), C)
        for c in range(C):
            found, slot, slots, fp = _probe(spec, cache, int(tpl_id[i]), root[i], params[i], c)
            empty = ~cache.valid[slots]
            first_empty = slots[_first_true(empty)]
            target = slot if bool(found) else (first_empty if bool(empty.any()) else slots[-1])
            evict = not bool(found) and not bool(empty.any()) and bool(cache.valid[target])
            if not (do and c < nchunks):
                continue
            seg = leaves[i, c * L:(c + 1) * L]
            seg = torch.where(lane < tlen - c * L, seg, NULL_ID)
            t = torch.as_tensor(target).reshape(1)
            keep = torch.ones(1, dtype=torch.bool, device=t.device)
            cache = cache._replace(
                tpl=scatter_drop(cache.tpl, t, int(tpl_id[i]), keep),
                root=scatter_drop(cache.root, t, root[i], keep),
                fp=scatter_drop(cache.fp, t, fp, keep),
                chunk=scatter_drop(cache.chunk, t, c, keep),
                total_len=scatter_drop(cache.total_len, t, tlen, keep),
                vals=scatter_drop(cache.vals, t, seg[None], keep),
                version=scatter_drop(cache.version, t, commit_version[i], keep),
                valid=scatter_drop(cache.valid, t, True, keep),
                n_evict=cache.n_evict + int(evict),
            )
        cache = cache._replace(
            n_insert=cache.n_insert + int(do),
            n_oversize=cache.n_oversize + int(bool(mask[i]) and int(lens[i]) > L * C),
        )
    return cache


def cache_delete(spec: CacheSpec, cache: CacheState, tpl_id, root, params, mask):
    """Exact-key write-around delete (all chunks), as batched scatters —
    deletes are idempotent, so scatter races are harmless."""
    root = torch.as_tensor(root)
    mask = torch.as_tensor(mask, device=root.device)
    deleted = torch.zeros(root.shape, dtype=torch.bool, device=root.device)
    valid = cache.valid
    for c in range(spec.max_chunks):
        found, slot, _, _ = _probe(spec, cache._replace(valid=valid), tpl_id, root, params, c)
        do = found & mask
        valid = scatter_drop(valid, slot.reshape(-1), False, do.reshape(-1))
        deleted |= do
    return cache._replace(
        valid=valid, n_delete=cache.n_delete + deleted.sum(dtype=torch.int32)
    )


def sweep_root(spec: CacheSpec, cache: CacheState, tpl_id, root, mask):
    """``clearRange(template, root)`` — delete every cached instance of the
    template whose root is ``root``, whatever its parameter values
    (DeleteKeysForRoot / Algorithm 6). The [capacity, S] compare is walked
    in blocks of ``_SWEEP_BLOCK`` sweeps to bound its intermediates."""
    dev = cache.tpl.device
    root = torch.as_tensor(root).to(device=dev, dtype=torch.int32).reshape(-1)
    tpl_id = torch.broadcast_to(
        torch.as_tensor(tpl_id).to(device=dev, dtype=torch.int32).reshape(-1), root.shape)
    mask = torch.broadcast_to(torch.as_tensor(mask).to(device=dev, dtype=torch.bool).reshape(-1),
                              root.shape)
    kill = torch.zeros_like(cache.valid)
    for lo in range(0, root.shape[0], _SWEEP_BLOCK):
        sl = slice(lo, lo + _SWEEP_BLOCK)
        kill |= (
            (cache.tpl[:, None] == tpl_id[None, sl])
            & (cache.root[:, None] == root[None, sl])
            & mask[None, sl]
        ).any(dim=1)
    n = (kill & cache.valid).sum(dtype=torch.int32)
    return cache._replace(valid=cache.valid & ~kill, n_delete=cache.n_delete + n)


def sweep_template(spec: CacheSpec, cache: CacheState, tpl_id):
    """``clearRange(template)`` — SC removal path (§4.1)."""
    kill = cache.tpl == int(tpl_id)
    n = (kill & cache.valid).sum(dtype=torch.int32)
    return cache._replace(valid=cache.valid & ~kill, n_delete=cache.n_delete + n)


def cache_entries(spec: CacheSpec, cache: CacheState) -> list:
    """Canonical host-side dump of the logical cache contents: a sorted list
    of ``(tpl, root, fp, chunk, total_len, version, leaves)`` per valid slot,
    each chunk's leaf row trimmed to its occupied prefix. Layout-free, and
    equal to the reference's dump of the same logical cache."""
    L = spec.max_leaves
    host = {f: getattr(cache, f).cpu().numpy() for f in _SLOT_FIELDS}
    host["fp"] = host["fp"].view(np.uint32)
    out = []
    for s in np.nonzero(host["valid"])[0]:
        tlen, ch = int(host["total_len"][s]), int(host["chunk"][s])
        seg = int(min(L, max(tlen - ch * L, 0)))
        out.append((
            int(host["tpl"][s]), int(host["root"][s]), int(host["fp"][s]), ch,
            tlen, int(host["version"][s]), tuple(host["vals"][s, :seg].tolist()),
        ))
    return sorted(out)


def cache_stats(cache: CacheState) -> dict:
    return {
        "hits": int(cache.n_hit),
        "misses": int(cache.n_miss),
        "inserts": int(cache.n_insert),
        "evictions": int(cache.n_evict),
        "deletes": int(cache.n_delete),
        "oversize_skipped": int(cache.n_oversize),
        "occupancy": int(cache.valid.sum()),
    }
