"""Low-level tensor helpers used across the graph store, cache, and engine.

PyTorch twin of ``repro.utils.helpers``. Every function returns exactly the
bits its JAX counterpart returns, which takes three kinds of care:

- **uint32 hashing.** Torch has no full uint32 arithmetic, so hashes live in
  int64 tensors holding the uint32 value (``0 <= v < 2**32``). Products are
  split into 16-bit halves so no intermediate leaves int64's range.
- **JAX index semantics.** ``jnp`` wraps a negative index once and clamps an
  index past the end; CUDA torch would raise a device-side assert instead.
  ``jax_index`` reproduces the JAX rule wherever the reference indexes raw.
- **Scatters with ``mode="drop"``** write dropped lanes to a trash column
  that is sliced off afterwards.

Where the reference loops on a device value (``lax.while_loop``), the eager
port reads that value on the host; ``SyncCount`` counts those reads so the
engine can report them in ``metrics["host_syncs"]``.
"""

from __future__ import annotations

import torch

# Sentinel for a missing property value (a predicate on a missing property
# never qualifies; wildcards require presence).
PROP_MISSING = -(2**31) + 1
# Sentinel for an absent id (padding in frontiers, values, probe results).
NULL_ID = -1
INT32_MAX = 2**31 - 1

U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and absent, so a
    missing card never falls back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


class SyncCount:
    """Counts blocking device->host reads of control-flow values.

    The eager stand-ins for ``lax.cond`` / ``lax.while_loop`` read one scalar
    on the host per decision; ``read`` performs that read and counts it.
    """

    def __init__(self):
        self.n = 0

    def read(self, x) -> int:
        self.n += 1
        return int(x.item())

    def read_list(self, x) -> list:
        """One read of a whole (small) tensor, as nested lists."""
        self.n += 1
        return x.tolist()


def as_u32(x) -> torch.Tensor:
    """``x.astype(uint32)`` as int64: two's complement, so -1 -> 0xFFFFFFFF."""
    return torch.as_tensor(x).to(torch.int64) & U32


def u32_bits(x) -> torch.Tensor:
    """An int64 tensor holding uint32 values, as int32 of the same bits
    (``astype(uint32).view(int32)``): the int64 -> int32 cast keeps the low
    32 bits, on the CPU (C++ conversion) and on CUDA (PTX ``cvt``) alike."""
    return torch.as_tensor(x).to(torch.int32)


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for 0 <= x < 2**32, without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _rotl32(x, r: int):
    return ((x << r) & U32) | (x >> (32 - r))


def hash_mix(h, x):
    """One round of a murmur3-style 32-bit mix: fold ``x`` into state ``h``."""
    h = as_u32(h)
    x = as_u32(x)
    x = _mul32(x, _GOLDEN)
    x = _rotl32(x, 15)
    x = _mul32(x, _MIX1)
    h = h ^ x
    h = _rotl32(h, 13)
    return (_mul32(h, 5) + 0xE6546B64) & U32


def _finalize(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def hash_rows(cols, seed):
    """Hash a sequence of integer tensors (broadcastable) element-wise.

    Returns int64 holding the uint32 hash. Different ``seed`` values give
    independent hash families (slot hash vs fingerprint). A tuple of seeds
    hashes every family in one pass, on a trailing axis of ``len(seed)``
    that the columns broadcast against.
    """
    seeds = [s & U32 for s in seed] if isinstance(seed, (tuple, list)) else seed & U32
    h = torch.tensor(seeds, dtype=torch.int64)
    for c in cols:
        c = torch.as_tensor(c)
        h = hash_mix(h.to(c.device), c)
    return _finalize(h)


def jax_index(idx, n: int):
    """Map ``idx`` to the element ``jnp``'s gather reads from an axis of
    length ``n``: a negative index wraps once, then everything clamps."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def take_along0(table, idx):
    """``table[idx]`` with idx clipped to valid range (caller masks)."""
    return table[idx.to(torch.int64).clamp(0, table.shape[0] - 1)]


def keep_last_occurrence(idx, active):
    """Mask ``active`` down to the last active lane of each index value.

    ``x.at[idx].set(v)`` with duplicate indices keeps the last write on
    JAX's CPU backend, while a CUDA scatter keeps an arbitrary one; masking
    the earlier duplicates first makes the port's scatters deterministic and
    equal to the reference. O(K^2) over a small mutation section.
    """
    same = (idx[:, None] == idx[None, :]) & active[:, None] & active[None, :]
    later = torch.triu(torch.ones(same.shape, dtype=torch.bool, device=idx.device), 1)
    return active & ~(same & later).any(dim=1)


def scatter_drop(target, idx, vals, keep):
    """``target.at[where(keep, idx, OOB)].set(vals, mode="drop")`` along dim 0,
    returning a new tensor (``target`` is not written). Indices still out of
    range after JAX's one negative wrap are dropped. Kept indices must be
    distinct unless they write equal values (see ``keep_last_occurrence``)."""
    n = target.shape[0]
    out = torch.empty((n + 1,) + tuple(target.shape[1:]), dtype=target.dtype,
                      device=target.device)
    out[:n] = target
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)  # jnp wraps a negative index once
    keep = keep & (idx >= 0) & (idx < n)
    dest = torch.where(keep, idx, n)
    out[dest] = torch.as_tensor(vals, dtype=target.dtype, device=target.device)
    return out[:n]


def compact_masked(vals, mask, out_width: int, fill=NULL_ID):
    """Stream-compact ``vals`` where ``mask`` along the last axis.

    Works on [..., W] inputs; returns ([..., out_width] vals, [..., out_width]
    mask). Order-preserving. Entries beyond ``out_width`` are dropped.
    """
    mask = mask.to(torch.bool)
    lead = vals.shape[:-1]
    W = vals.shape[-1]
    flat_vals = vals.reshape(-1, W)
    flat_mask = mask.reshape(-1, W)
    R = flat_vals.shape[0]
    idx = torch.cumsum(flat_mask.to(torch.int64), dim=-1) - 1
    dest = torch.where(flat_mask, idx, out_width).clamp(max=out_width)
    out = torch.full((R, out_width + 1), fill, dtype=vals.dtype, device=vals.device)
    out.scatter_(1, dest, flat_vals)
    out = out[:, :out_width].reshape(lead + (out_width,))
    n = torch.clamp(mask.sum(-1), max=out_width)
    omask = torch.arange(out_width, device=vals.device) < n[..., None]
    return out, omask


def first_occurrence(v):
    """Mask of each row's first occurrence of every value (last axis).

    Stable sort + adjacent compare, so a value's earliest lane is the head
    of its run: O(W log W) per row, no [W, W] intermediate.
    """
    sv, order = torch.sort(v, dim=-1, stable=True)
    head = torch.ones_like(sv, dtype=torch.bool)
    head[..., 1:] = sv[..., 1:] != sv[..., :-1]
    first = torch.empty_like(head)
    first.scatter_(-1, order, head)
    return first


def sort_dedup_masked(vals, mask, out_width: int, fill=NULL_ID):
    """Sort-based per-row dedup + order-preserving compaction.

    Keep the first occurrence of each distinct masked value in original
    order, compact left, truncate to ``out_width``, pad with ``fill``.
    """
    mask = mask.to(torch.bool)
    big = INT32_MAX  # sorts after every valid id
    keyed = torch.where(mask, vals, torch.full_like(vals, big))
    keep = first_occurrence(keyed) & (keyed != big)
    return compact_masked(vals, keep, out_width, fill)


def segmented_dedup_merge(vals, counts, out_width: int, fill=NULL_ID,
                          syncs: SyncCount | None = None):
    """Frontier merge specialized for *left-packed* segments.

    ``vals``: [B, S, W] where each segment row holds ``counts[b, s]`` valid
    entries left-packed at offsets [0, counts). Equivalent to
    ``sort_dedup_masked`` on the flattened [B, S*W] row with the prefix
    masks, but touches only ``out_width``-sized windows per round; rows
    finish in ceil(n_valid / F) rounds. The round loop reads its condition
    on the host once per round (counted in ``syncs``).
    """
    syncs = syncs if syncs is not None else SyncCount()
    B, S, W = vals.shape
    F = out_width
    dev = vals.device
    counts = counts.to(torch.int32)
    cum = torch.cumsum(counts, dim=1, dtype=torch.int32)  # [B, S]
    n_valid = cum[:, -1] if S else torch.zeros(B, dtype=torch.int32, device=dev)
    vflat = vals.reshape(B, S * W)
    rows = torch.arange(B, device=dev)[:, None]
    tril = torch.tril(torch.ones((F, F), dtype=torch.bool, device=dev), -1)
    nwin = -(-(S * W) // F)
    n_steps = max(S.bit_length() + 1, 1)
    lane = torch.arange(F, dtype=torch.int32, device=dev)

    def rank_positions(targets):  # 1-based ranks [B, F] -> flat positions
        lo = torch.zeros_like(targets)
        hi = torch.full_like(targets, S - 1)
        for _ in range(n_steps):  # first segment s with cum[s] >= target
            mid = (lo + hi) // 2
            ge = cum[rows, mid.clamp(0, S - 1).long()] >= targets
            lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
        seg = lo.clamp(0, S - 1)
        prev = torch.where(seg > 0, cum[rows, (seg - 1).clamp(min=0).long()], 0)
        return seg * W + (targets - 1 - prev)

    acc_vals = torch.full((B, F), fill, dtype=vals.dtype, device=dev)
    acc_n = torch.zeros(B, dtype=torch.int32, device=dev)
    win = 0
    while win < nwin and syncs.read(((acc_n < F) & (win * F < n_valid)).any()):
        targets = win * F + 1 + lane[None, :]
        wm = targets <= n_valid[:, None]
        pos = rank_positions(torch.minimum(targets, n_valid[:, None].clamp(min=1)))
        wv = torch.where(wm, vflat[rows, pos.clamp(0, S * W - 1).long()],
                         torch.full_like(pos, fill, dtype=vals.dtype))
        dup_acc = (
            (wv[:, :, None] == acc_vals[:, None, :])
            & (lane[None, None, :] < acc_n[:, None, None])
        ).any(dim=2)
        dup_win = ((wv[:, :, None] == wv[:, None, :]) & tril[None]).any(dim=2)
        keep = wm & ~dup_acc & ~dup_win
        dest = acc_n[:, None] + torch.cumsum(keep.to(torch.int32), dim=1) - 1
        dest = torch.where(keep & (dest < F), dest, F).to(torch.int64)
        acc = torch.cat([acc_vals, acc_vals[:, :1]], dim=1)  # trash column F
        acc.scatter_(1, dest, wv)
        acc_vals = acc[:, :F]
        acc_n = torch.clamp(acc_n + keep.sum(dim=1, dtype=torch.int32), max=F)
        win += 1
    omask = lane[None, :] < acc_n[:, None]
    return torch.where(omask, acc_vals, torch.full_like(acc_vals, fill)), omask


def dedup_masked(vals, mask):
    """Mask out duplicate values along the last axis (keeps first occurrence).

    The reference compares all [W, W] pairs, which XLA fuses; eager torch
    would materialise it (19 GB per intermediate at B=16384, W=1088), so the
    port finds first occurrences by sorting instead. Same mask bit for bit:
    masked-out lanes take part as NULL_ID exactly as in the reference.
    """
    v = torch.where(mask, vals, torch.full_like(vals, NULL_ID))
    return mask & first_occurrence(v)
