"""Cache maintenance under gRW-Txs (§3.2 + Appendix A), vectorized.

PyTorch twin of ``repro.core.invalidation``: the write-around policy
(``invalidate_write_around``) and the write-through policy
(``write_through_update``: append or remove single leaf ids in place,
deleting multi-chunk or full entries instead). Both run Algorithms 1–9 over
a batch of mutations × all registered templates as tensor ops:

- Algorithm 6 (DeleteKeysForRoot / FDB clearRange)  -> ``sweep_root``
- Algorithm 7 (DeleteKeysForLeaf, reverse traversal) -> ``_delete_keys_for_leaf``
- Algorithm 8 (HandleEdgeChange)                     -> ``_handle_edge_change``
- Algorithms 1–4 are the per-change-type drivers in ``_run_policy``.

The drivers write to a *sink*: ``_ApplySink`` applies each emission to a
cache at once; ``_CollectSink`` materializes the impacted keys as a flat op
stream (``derive_cache_ops``), which the gRW step compacts and applies in
one batch. On a partitioned view (``partition.BlockStoreView``) every
emission is gated to the shard owning its storage, so the union over
shards is the single host's stream. Each op carries an ``order`` key
(emission serial × global position) that reconstructs the sequential order
after routing. Deletes and sweeps commute; only write-through value edits
on one key are order-sensitive, which ``apply_op_stream`` (a sequential
walk) and ``apply_op_stream_segmented`` (round ``r`` applies every key's
``r``-th op at once) respect.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cache import CacheSpec, CacheState, _probe, cache_delete, sweep_root
from repro_torch.core.keys import PARAM_LEN
from repro_torch.core.templates import (
    DIR_BOTH,
    DIR_IN,
    DIR_OUT,
    MAX_CONDS,
    PredSpec,
    TemplateTable,
    evaluate_pred,
    extract_wildcards,
    pred_row,
)
from repro_torch.graphstore.mutations import AppliedMutations
from repro_torch.graphstore.store import GlobalStoreView
from repro_torch.utils import (
    INT32_MAX, NULL_ID, PROP_MISSING, SyncCount, compact_masked, scatter_drop, take_along0,
)

# op kinds of the collected maintenance stream
OP_DELETE, OP_VAL_ADD, OP_VAL_REMOVE = 0, 1, 2

# order = serial * _ORDER_STRIDE + *global* row-major position within the
# emission (global mutation row x gather width + lane), so a routed stream
# sorts back into the single-host application order. A round-robin slice of
# the batch (``row_stride`` ranks) keeps the bound: its global rows stay below
# ``row_stride * ceil(K / row_stride)``, about the section cap K
_ORDER_STRIDE = 1 << 22


class CacheOpStream(NamedTuple):
    """Flat tensor stream of exact-key maintenance ops."""

    kind: torch.Tensor  # int32 [M]  OP_DELETE / OP_VAL_ADD / OP_VAL_REMOVE
    tpl: torch.Tensor  # int32 [M]
    root: torch.Tensor  # int32 [M]
    params: torch.Tensor  # int32 [M, PARAM_LEN]
    vid: torch.Tensor  # int32 [M]  leaf id for value ops (NULL_ID otherwise)
    order: torch.Tensor  # int32 [M]  sequential-application order key
    ok: torch.Tensor  # bool  [M]


class SweepStream(NamedTuple):
    """Flat tensor stream of (template, root) range sweeps (Algorithm 6)."""

    tpl: torch.Tensor  # int32 [S]
    root: torch.Tensor  # int32 [S]
    ok: torch.Tensor  # bool  [S]


def _full_like_i32(x, v):
    return torch.full(x.shape, v, dtype=torch.int32, device=x.device)


class _ApplySink:
    """Applies maintenance ops to a cache immediately."""

    def __init__(self, espec, cache: CacheState):
        self.cspec = espec.cache
        self.cache = cache

    def delete(self, t, root, params, ok, order, bound):
        self.cache = cache_delete(self.cspec, self.cache, _full_like_i32(root, t),
                                  root, params, ok)

    def value(self, t, root, params, vid, ok, delta, order, bound):
        self.cache = _value_update(self.cspec, self.cache, t, root, params, vid, ok, delta)

    def sweep(self, t, roots, ok, order, bound):
        self.cache = sweep_root(self.cspec, self.cache, _full_like_i32(roots, t), roots, ok)


class _CollectSink:
    """Collects maintenance ops as flat tensors instead of applying them."""

    def __init__(self):
        self._ops = []
        self._sweeps = []
        self._serial = 0

    def _order(self, pos, bound):
        # ``bound`` is the static maximum position this emission can hold
        assert bound <= _ORDER_STRIDE, (
            f"emission positions up to {bound} overflow the op-order stride"
        )
        assert (self._serial + 1) * _ORDER_STRIDE < 2**31, (
            "too many emissions for int32 op-order keys"
        )
        o = self._serial * _ORDER_STRIDE + pos.to(torch.int32)
        self._serial += 1
        return o.to(torch.int32)

    def _push(self, kind, t, root, params, vid, ok, order, bound):
        root = root.to(torch.int32).reshape(-1)
        self._ops.append((
            _full_like_i32(root, kind),
            _full_like_i32(root, t),
            root,
            params.to(torch.int32).reshape(-1, PARAM_LEN),
            vid.to(torch.int32).reshape(-1),
            self._order(order.reshape(-1), bound),
            ok.to(torch.bool).reshape(-1),
        ))

    def delete(self, t, root, params, ok, order, bound):
        self._push(OP_DELETE, t, root, params, _full_like_i32(root, NULL_ID), ok,
                   order, bound)

    def value(self, t, root, params, vid, ok, delta, order, bound):
        self._push(OP_VAL_ADD if delta > 0 else OP_VAL_REMOVE, t, root, params, vid, ok,
                   order, bound)

    def sweep(self, t, roots, ok, order, bound):
        self._sweeps.append((_full_like_i32(roots, t), roots.to(torch.int32),
                             ok.to(torch.bool)))
        self._serial += 1

    def streams(self, device):
        if not self._ops:  # no registered templates: empty streams
            z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
            ops = CacheOpStream(z(0), z(0), z(0), z(0, PARAM_LEN), z(0), z(0),
                                torch.zeros(0, dtype=torch.bool, device=device))
        else:
            ops = CacheOpStream(*(torch.cat([op[i] for op in self._ops]) for i in range(7)))
        if not self._sweeps:
            sw = SweepStream(torch.zeros(0, dtype=torch.int32, device=device),
                             torch.zeros(0, dtype=torch.int32, device=device),
                             torch.zeros(0, dtype=torch.bool, device=device))
        else:
            sw = SweepStream(*(torch.cat([s[i] for s in self._sweeps]) for i in range(3)))
        return ops, sw


def _has_all_wildcards(pred: PredSpec, props):
    """Algorithm 7 line 2 / Algorithm 8 line 2: element must carry every
    wildcard property of the predicate."""
    ok = torch.ones(props.shape[:-1], dtype=torch.bool, device=props.device)
    for c in range(MAX_CONDS):
        pid = int(pred.prop_ids[c])
        if pid >= 0 and bool(pred.wild[c]):
            ok &= props[..., min(pid, props.shape[-1] - 1)] != PROP_MISSING
    return ok


def _prop_in_pred(pred: PredSpec, pid):
    """'P appears in P^x' test, vectorized over a batch of pids."""
    hit = torch.zeros(pid.shape, dtype=torch.bool, device=pid.device)
    for c in range(MAX_CONDS):
        p = int(pred.prop_ids[c])
        if p >= 0:
            hit |= pid == p
    return hit


def _edge_label_ok(elab_t: int, elabel):
    if elab_t < 0:
        return torch.ones(elabel.shape, dtype=torch.bool, device=elabel.device)
    return elabel == elab_t


def _handle_edge_change(espec, sink, ttable: TemplateTable, t: int, view_ep,
                        elabel, eprops, src, dst, active, rows, rbound, value_delta=None):
    """Algorithm 8 over a batch of edges. ``view_ep`` supplies endpoint
    labels/properties (pre- or post-state per the caller's change type).
    ``value_delta``: None deletes the keys (write-around), +1 / -1 appends /
    removes the leaf (write-through). ``rows`` carries each edge's global
    mutation-row index (the ordering key) and ``rbound`` its exclusive upper
    bound. On a partitioned view each side's emission is gated to the shard
    owning its root side."""
    pe = pred_row(ttable.pe, t)
    pr = pred_row(ttable.pr, t)
    pl = pred_row(ttable.pl, t)
    direction = int(ttable.direction[t])

    e_ok = active & _has_all_wildcards(pe, eprops) & evaluate_pred(pe, elabel, eprops)
    e_ok &= _edge_label_ok(int(ttable.edge_label[t]), elabel)
    we = extract_wildcards(pe, eprops)  # [K, MAXC]

    use_rl = direction in (DIR_OUT, DIR_BOTH)  # R=src, L=dst
    use_lr = direction in (DIR_IN, DIR_BOTH)  # R=dst, L=src
    for R, L, use in ((src, dst, use_rl), (dst, src, use_lr)):
        rlab = take_along0(view_ep.vlabel, R)
        rprops = take_along0(view_ep.vprops, R)
        llab = take_along0(view_ep.vlabel, L)
        lprops = take_along0(view_ep.vprops, L)
        ok = (
            e_ok
            & use
            & _has_all_wildcards(pl, lprops)
            & evaluate_pred(pr, rlab, rprops)
            & evaluate_pred(pl, llab, lprops)
        )
        if view_ep.own is not None:
            ok &= view_ep.own(R)
        wl = extract_wildcards(pl, lprops)
        params = torch.cat([we, wl], dim=-1)
        if value_delta is None:
            sink.delete(t, R, params, ok, rows, rbound)
        else:
            sink.value(t, R, params, L, ok, value_delta, rows, rbound)


def _delete_keys_for_leaf(espec, sink, ttable: TemplateTable, t: int, view_trav,
                          leaf_vid, leaf_label, leaf_props, active, rows, rbound,
                          value_delta=None):
    """Algorithm 7 over a batch of leaves: reverse-traverse to each possible
    root and delete (or, with ``value_delta``, edit in place) the keys. On
    a partitioned view the traversal runs at the leaf's owner, whose blocks
    hold every edge at the leaf, and its emissions are gated to it."""
    pe = pred_row(ttable.pe, t)
    pr = pred_row(ttable.pr, t)
    pl = pred_row(ttable.pl, t)
    direction = int(ttable.direction[t])
    elab_t = int(ttable.edge_label[t])

    act = active & _has_all_wildcards(pl, leaf_props)
    act &= evaluate_pred(pl, leaf_label, leaf_props)
    if view_trav.own is not None:
        act &= view_trav.own(leaf_vid)
    wl = extract_wildcards(pl, leaf_props)  # [K, MAXC]

    # reverse query: template OUT -> roots via the leaf's incoming edges;
    # template IN -> via outgoing; BOTH -> both sides.
    use_in = direction in (DIR_OUT, DIR_BOTH)
    use_out = direction in (DIR_IN, DIR_BOTH)
    for incoming, use in ((True, use_in), (False, use_out)):
        roots, emask, _trunc, elab, ep = view_trav.adjacency(
            leaf_vid, espec.max_deg, incoming=incoming
        )
        ok = emask & act[:, None] & use
        ok &= _edge_label_ok(elab_t, elab)
        ok &= _has_all_wildcards(pe, ep) & evaluate_pred(pe, elab, ep)
        we = extract_wildcards(pe, ep)  # [K, W, MAXC]
        rlab = take_along0(view_trav.vlabel, roots)
        rprops = take_along0(view_trav.vprops, roots)
        ok &= evaluate_pred(pr, rlab, rprops)
        params = torch.cat([we, wl[:, None, :].expand(we.shape)], dim=-1)
        K, W = roots.shape
        order = rows[:, None] * W + torch.arange(W, dtype=torch.int32, device=roots.device)[None, :]
        flat = lambda x: x.reshape((K * W,) + tuple(x.shape[2:]))
        if value_delta is None:
            sink.delete(t, flat(roots), flat(params), flat(ok), flat(order), rbound * W)
        else:
            sink.value(t, flat(roots), flat(params), flat(leaf_vid[:, None].expand(K, W)),
                       flat(ok), value_delta, flat(order), rbound * W)


def _value_update_batched(cspec: CacheSpec, cache: CacheState, tpl, root, params, vid,
                          mask, add: bool):
    """Write-through value edit of a batch of *distinct-key* rows: every row
    probes the same state, then all edits land in one scatter. Distinct keys
    hold distinct slots, so no two kept writes collide and each row sees the
    state its sequential turn would; rows sharing a key must be serialized
    by the caller (``apply_op_stream_segmented``'s rounds).

    Per entry: single-chunk entries take the edit (append ``vid`` if absent
    and there is room, remove it if present); a multi-chunk entry, or a full
    one that lacks ``vid``, is deleted instead (the write-around fallback).
    """
    L = cspec.max_leaves
    found, slot, _, _ = _probe(cspec, cache, tpl, root, params, 0)
    s = slot.clamp(min=0).long()
    tlen = cache.total_len[s]
    single = tlen <= L
    do = mask & found
    row = cache.vals[s]  # [B, L]
    lane = torch.arange(L, dtype=torch.int32, device=row.device)[None, :]
    present = ((row == vid[:, None]) & (lane < tlen[:, None])).any(dim=1)
    if add:
        new_row = torch.where(lane == tlen.clamp(0, L - 1)[:, None], vid[:, None], row)
        new_len = tlen + 1
        write = do & single & ~present & (tlen < L)
        kill = do & (~single | ((tlen >= L) & ~present))
    else:
        keep = (row != vid[:, None]) & (lane < tlen[:, None])
        new_row, _ = compact_masked(row, keep, L)
        new_len = keep.sum(dim=1, dtype=torch.int32)
        write = do & single & present
        kill = do & ~single
    return cache._replace(
        vals=scatter_drop(cache.vals, s, new_row, write),
        total_len=scatter_drop(cache.total_len, s, new_len, write),
        valid=scatter_drop(cache.valid, s, False, kill),
        n_delete=cache.n_delete + kill.sum(dtype=torch.int32),
    )


def _value_row(cspec: CacheSpec, cache: CacheState, t, root, params, vid, mask, add: bool):
    """Write-through edit of one entry: ``_value_update_batched`` on a batch
    of one row (``params`` [PARAM_LEN], the rest scalars)."""
    dev = cache.tpl.device
    row = lambda x, dt=torch.int32: torch.as_tensor(x).to(device=dev, dtype=dt).reshape(1, -1)
    return _value_update_batched(cspec, cache, row(t)[0], row(root)[0], row(params),
                                 row(vid)[0], row(mask, torch.bool)[0], add)


def _value_update(cspec: CacheSpec, cache: CacheState, t, root, params, vid, mask, delta):
    """Write-through value edits over a batch, walked row by row (the sink
    path's reference). A masked row is a no-op, so the walk visits the
    unmasked rows only, found by one host read."""
    for i in torch.nonzero(mask).reshape(-1).tolist():
        cache = _value_row(cspec, cache, t, root[i], params[i], vid[i], True, delta > 0)
    return cache


def apply_op_stream(cspec: CacheSpec, cache: CacheState, ops: CacheOpStream):
    """Order-preserving sequential application of an exact-key op stream:
    rows walked in ``order``, so a routed or merged stream reproduces the
    single host's emission order (value edits do not commute with deletes
    on the same key). Masked rows are no-ops and are skipped."""
    perm = torch.argsort(torch.where(ops.ok, ops.order, INT32_MAX), stable=True)
    for i in perm[ops.ok[perm]].tolist():
        kind = min(max(int(ops.kind[i]), 0), 2)
        if kind == OP_DELETE:
            cache = cache_delete(cspec, cache, ops.tpl[i:i + 1], ops.root[i:i + 1],
                                 ops.params[i:i + 1], ops.ok[i:i + 1])
        else:
            cache = _value_row(cspec, cache, ops.tpl[i], ops.root[i], ops.params[i],
                               ops.vid[i], True, kind == OP_VAL_ADD)
    return cache


def apply_op_stream_segmented(cspec: CacheSpec, cache: CacheState, ops: CacheOpStream,
                              syncs: SyncCount | None = None):
    """Key-segmented application of an exact-key op stream, bit-equal to
    ``apply_op_stream``'s walk, stats included.

    Ops on distinct keys commute, so only a key's own ops need their order.
    The stream is sorted by (validity, key, order) with a chain of stable
    argsorts, least-significant column first; round ``r`` applies every
    key's r-th op as three batched passes (deletes, value-adds,
    value-removes), all over distinct keys. The number of rounds, the most
    ops any key has, is one host read (counted in ``syncs``).
    """
    syncs = syncs if syncs is not None else SyncCount()
    M = ops.root.shape[0]
    if M == 0:
        return cache
    idx = torch.argsort(torch.where(ops.ok, ops.order, INT32_MAX), stable=True)
    cols = [ops.params[:, c] for c in range(PARAM_LEN - 1, -1, -1)]
    for col in cols + [ops.root, ops.tpl, (~ops.ok).to(torch.int32)]:
        idx = idx[torch.argsort(col[idx], stable=True)]
    kind, tpl, root = ops.kind[idx], ops.tpl[idx], ops.root[idx]
    params, vid, ok = ops.params[idx], ops.vid[idx], ops.ok[idx]

    same = ((tpl[1:] == tpl[:-1]) & (root[1:] == root[:-1])
            & (params[1:] == params[:-1]).all(dim=1) & ok[1:] & ok[:-1])
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=same.device), ~same])
    pos = torch.arange(M, dtype=torch.int32, device=same.device)
    rank = pos - torch.cummax(torch.where(boundary, pos, 0), dim=0).values
    n_rounds = syncs.read(torch.where(ok, rank, -1).max() + 1)
    for r in range(n_rounds):
        sel = ok & (rank == r)
        cache = cache_delete(cspec, cache, tpl, root, params, sel & (kind == OP_DELETE))
        cache = _value_update_batched(cspec, cache, tpl, root, params, vid,
                                      sel & (kind == OP_VAL_ADD), True)
        cache = _value_update_batched(cspec, cache, tpl, root, params, vid,
                                      sel & (kind == OP_VAL_REMOVE), False)
    return cache


def apply_op_stream_batched(cspec: CacheSpec, cache: CacheState, ops: CacheOpStream):
    """Apply a pure-delete op stream (write-around) as one batched
    ``cache_delete``: deletes are idempotent and commute. Value ops take
    ``apply_op_stream`` or ``apply_op_stream_segmented``."""
    return cache_delete(cspec, cache, ops.tpl, ops.root, ops.params,
                        ops.ok & (ops.kind == OP_DELETE))


def apply_sweeps(cspec: CacheSpec, cache: CacheState, sweeps: SweepStream):
    """Apply a (template, root) sweep stream (Algorithm 6). Sweeps commute
    with every other maintenance op (no inserts happen during maintenance)."""
    return sweep_root(cspec, cache, sweeps.tpl, sweeps.root, sweeps.ok)


def _sec(n, ids):
    return torch.arange(ids.shape[0], device=ids.device) < n


def _run_policy(espec, view_pre, view_post, sink, ttable, applied: AppliedMutations, *,
                through: bool, row_offset: int = 0, row_stride: int = 1):
    """Drive Algorithms 1–4 over every (mutation, template) pair into ``sink``.

    ``view_pre``/``view_post`` are storage views of the pre-/post-commit
    states: the full store (``GlobalStoreView``) or one shard's blocks
    (``partition.BlockStoreView``), whose ``own`` gates every emission to
    the shard holding its storage (reverse traversals at the leaf's owner,
    edge-change emissions at the root side's owner, sweeps at the swept
    root's owner). ``through`` turns the leaf-side deletes into value edits.
    Emission order matches the reference exactly, so the op-order keys agree
    with it.

    ``row_offset`` / ``row_stride`` turn each section row of a round-robin
    slice of the batch (``mutations.shard_mutation_rows``) back into its
    global row, ``row_offset + row_stride * j``, which the op-order keys
    use; the default (0, 1) is the identity.
    """
    b = applied.batch
    own = view_post.own
    dev = b.sv_vid.device
    T = int(ttable.direction.shape[0])
    nv = espec.store.n_vprops

    def rows_of(ids):
        # (global rows, their static bound)
        rows = row_offset + row_stride * torch.arange(ids.shape[0], dtype=torch.int32, device=dev)
        return rows, row_stride * ids.shape[0]

    ne_m, de_m = _sec(b.ne_n, b.ne_src), _sec(b.de_n, b.de_eid)
    se_m, sv_m, dv_m = _sec(b.se_n, b.se_eid), _sec(b.sv_n, b.sv_vid), _sec(b.dv_n, b.dv_vid)
    ne_r, de_r = rows_of(b.ne_src), rows_of(b.de_eid)
    se_r, sv_r, dv_r = rows_of(b.se_eid), rows_of(b.sv_vid), rows_of(b.dv_vid)

    # edge-prop change = delete old edge + add new edge (Example 5)
    se_pcol = b.se_pid.clamp(0, espec.store.n_eprops - 1).long()
    se_old_props = applied.se_props.clone()
    se_old_props[torch.arange(b.se_eid.shape[0], device=dev), se_pcol] = applied.se_old

    # vertex-prop pre/post rows
    sv_post = take_along0(view_post.vprops, b.sv_vid)
    sv_pcol = b.sv_pid.clamp(0, nv - 1).long()
    sv_pre = sv_post.clone()
    sv_pre[torch.arange(b.sv_vid.shape[0], device=dev), sv_pcol] = applied.sv_old
    sv_lab = take_along0(view_post.vlabel, b.sv_vid)

    dv_lab = take_along0(view_pre.vlabel, b.dv_vid)
    dv_props = take_along0(view_pre.vprops, b.dv_vid)

    sv_own = own(b.sv_vid) if own is not None else True
    dv_own = own(b.dv_vid) if own is not None else True
    add_d, del_d = (+1, -1) if through else (None, None)

    for t in range(T):
        wen = bool(ttable.write_enabled[t])
        pr = pred_row(ttable.pr, t)
        pl = pred_row(ttable.pl, t)

        # --- Algorithm 3: add edges (post state) / delete edges (pre state)
        _handle_edge_change(
            espec, sink, ttable, t, view_post,
            b.ne_label, b.ne_props, b.ne_src, b.ne_dst, ne_m & wen, *ne_r,
            value_delta=add_d,
        )
        _handle_edge_change(
            espec, sink, ttable, t, view_pre,
            applied.de_label, applied.de_props, applied.de_src, applied.de_dst,
            de_m & wen, *de_r, value_delta=del_d,
        )

        # --- Algorithm 4: edge property change (only templates whose P^e
        # references the property)
        in_pe = _prop_in_pred(pred_row(ttable.pe, t), b.se_pid)
        _handle_edge_change(
            espec, sink, ttable, t, view_pre,
            applied.se_label, se_old_props, applied.se_src, applied.se_dst,
            se_m & wen & in_pe, *se_r, value_delta=del_d,
        )
        _handle_edge_change(
            espec, sink, ttable, t, view_post,
            applied.se_label, applied.se_props, applied.se_src, applied.se_dst,
            se_m & wen & in_pe, *se_r, value_delta=add_d,
        )

        # --- Algorithm 2: vertex property change
        in_pr = _prop_in_pred(pr, b.sv_pid)
        r_hit = evaluate_pred(pr, sv_lab, sv_pre) | evaluate_pred(pr, sv_lab, sv_post)
        # root-side changes clear the whole (template, root) range under
        # both policies (write-through has no cheaper edit, §3.2)
        sink.sweep(t, b.sv_vid, sv_m & wen & in_pr & r_hit & sv_own, *sv_r)
        in_pl = _prop_in_pred(pl, b.sv_pid)
        _delete_keys_for_leaf(
            espec, sink, ttable, t, view_post, b.sv_vid, sv_lab, sv_pre,
            sv_m & wen & in_pl, *sv_r, value_delta=del_d,
        )
        _delete_keys_for_leaf(
            espec, sink, ttable, t, view_post, b.sv_vid, sv_lab, sv_post,
            sv_m & wen & in_pl, *sv_r, value_delta=add_d,
        )

        # --- Algorithm 1: delete vertex (pre state)
        r_ok = evaluate_pred(pr, dv_lab, dv_props)
        sink.sweep(t, b.dv_vid, dv_m & wen & r_ok & dv_own, *dv_r)
        _delete_keys_for_leaf(
            espec, sink, ttable, t, view_pre, b.dv_vid, dv_lab, dv_props,
            dv_m & wen, *dv_r, value_delta=del_d,
        )


def _apply_policy(espec, store_pre, store_post, cache, ttable, applied, through):
    sink = _ApplySink(espec, cache)
    _run_policy(espec, GlobalStoreView(espec.store, store_pre),
                GlobalStoreView(espec.store, store_post), sink, ttable, applied,
                through=through)
    return sink.cache


def invalidate_write_around(espec, store_pre, store_post, cache, ttable, applied):
    """Write-around policy (§4): delete every impacted cache entry, in the
    same commit as the graph writes."""
    return _apply_policy(espec, store_pre, store_post, cache, ttable, applied, False)


def write_through_update(espec, store_pre, store_post, cache, ttable, applied):
    """Write-through policy (§3.2, lazy variant): edit impacted entries in
    place where possible, delete where not."""
    return _apply_policy(espec, store_pre, store_post, cache, ttable, applied, True)


def derive_cache_ops(espec, store_pre, store_post, ttable, applied, *, through: bool,
                     row_offset: int = 0, row_stride: int = 1):
    """Run the mutation listener without touching any cache, returning the
    impacted keys as tensor streams ``(CacheOpStream, SweepStream)``.
    ``row_offset`` / ``row_stride`` give the global rows of a round-robin
    slice of the batch (``shard_mutation_rows``) for the op-order keys."""
    return derive_cache_ops_views(
        espec, GlobalStoreView(espec.store, store_pre),
        GlobalStoreView(espec.store, store_post), ttable, applied, through=through,
        row_offset=row_offset, row_stride=row_stride,
    )


def derive_cache_ops_views(espec, view_pre, view_post, ttable, applied, *, through: bool,
                           row_offset: int = 0, row_stride: int = 1):
    """``derive_cache_ops`` over storage views, under either policy. On the
    partitioned tier each shard passes its ``BlockStoreView``s and derives
    exactly the ops whose storage it owns, with global op-order keys."""
    sink = _CollectSink()
    _run_policy(espec, view_pre, view_post, sink, ttable, applied, through=through,
                row_offset=row_offset, row_stride=row_stride)
    return sink.streams(applied.batch.sv_vid.device)
