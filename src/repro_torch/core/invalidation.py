"""Cache maintenance under gRW-Txs (§3.2 + Appendix A), vectorized.

PyTorch twin of ``repro.core.invalidation``, the write-around policy.
``invalidate_write_around`` runs Algorithms 1–9 over a batch of mutations ×
all registered templates as tensor ops:

- Algorithm 6 (DeleteKeysForRoot / FDB clearRange)  -> ``sweep_root``
- Algorithm 7 (DeleteKeysForLeaf, reverse traversal) -> ``_delete_keys_for_leaf``
- Algorithm 8 (HandleEdgeChange)                     -> ``_handle_edge_change``
- Algorithms 1–4 are the per-change-type drivers in ``_run_policy``.

The drivers write to a *sink*: ``_ApplySink`` applies each emission to a
cache at once; ``_CollectSink`` materializes the impacted keys as a flat op
stream (``derive_cache_ops``), which the gRW step compacts and applies in
one batch. Each op carries an ``order`` key (emission serial × position)
that reconstructs the sequential order; the stream keeps the reference's
layout, value-op columns included. Write-through (value edits in place) is
not part of this slice: ``derive_cache_ops(..., through=True)`` and
``policy="write-through"`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cache import CacheSpec, CacheState, cache_delete, sweep_root
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
from repro_torch.utils import NULL_ID, PROP_MISSING, take_along0

# op kinds of the collected maintenance stream
OP_DELETE, OP_VAL_ADD, OP_VAL_REMOVE = 0, 1, 2

# order = serial * _ORDER_STRIDE + row-major position within the emission
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
                        elabel, eprops, src, dst, active, rows, rbound):
    """Algorithm 8 over a batch of edges. ``view_ep`` supplies endpoint
    labels/properties (pre- or post-state per the caller's change type).
    ``rows`` carries each edge's mutation-row index (the ordering key) and
    ``rbound`` its static exclusive upper bound."""
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
        wl = extract_wildcards(pl, lprops)
        sink.delete(t, R, torch.cat([we, wl], dim=-1), ok, rows, rbound)


def _delete_keys_for_leaf(espec, sink, ttable: TemplateTable, t: int, view_trav,
                          leaf_vid, leaf_label, leaf_props, active, rows, rbound):
    """Algorithm 7 over a batch of leaves: reverse-traverse to each possible
    root and delete the corresponding keys."""
    pe = pred_row(ttable.pe, t)
    pr = pred_row(ttable.pr, t)
    pl = pred_row(ttable.pl, t)
    direction = int(ttable.direction[t])
    elab_t = int(ttable.edge_label[t])

    act = active & _has_all_wildcards(pl, leaf_props)
    act &= evaluate_pred(pl, leaf_label, leaf_props)
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
        sink.delete(t, flat(roots), flat(params), flat(ok), flat(order), rbound * W)


def apply_op_stream_batched(cspec: CacheSpec, cache: CacheState, ops: CacheOpStream):
    """Apply a pure-delete op stream (write-around) as one batched
    ``cache_delete``: deletes are idempotent and commute."""
    return cache_delete(cspec, cache, ops.tpl, ops.root, ops.params,
                        ops.ok & (ops.kind == OP_DELETE))


def apply_sweeps(cspec: CacheSpec, cache: CacheState, sweeps: SweepStream):
    """Apply a (template, root) sweep stream (Algorithm 6). Sweeps commute
    with every other maintenance op (no inserts happen during maintenance)."""
    return sweep_root(cspec, cache, sweeps.tpl, sweeps.root, sweeps.ok)


def _sec(n, ids):
    return torch.arange(ids.shape[0], device=ids.device) < n


def _run_policy(espec, view_pre, view_post, sink, ttable, applied: AppliedMutations):
    """Drive Algorithms 1–4 over every (mutation, template) pair into ``sink``.

    ``view_pre``/``view_post`` are storage views of the pre-/post-commit
    states. Emission order matches the reference exactly, so the op-order
    keys agree with it.
    """
    b = applied.batch
    dev = b.sv_vid.device
    T = int(ttable.direction.shape[0])
    nv = espec.store.n_vprops

    def rows_of(ids):
        return torch.arange(ids.shape[0], dtype=torch.int32, device=dev), ids.shape[0]

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

    for t in range(T):
        wen = bool(ttable.write_enabled[t])
        pr = pred_row(ttable.pr, t)
        pl = pred_row(ttable.pl, t)

        # --- Algorithm 3: add edges (post state) / delete edges (pre state)
        _handle_edge_change(
            espec, sink, ttable, t, view_post,
            b.ne_label, b.ne_props, b.ne_src, b.ne_dst, ne_m & wen, *ne_r,
        )
        _handle_edge_change(
            espec, sink, ttable, t, view_pre,
            applied.de_label, applied.de_props, applied.de_src, applied.de_dst,
            de_m & wen, *de_r,
        )

        # --- Algorithm 4: edge property change (only templates whose P^e
        # references the property)
        in_pe = _prop_in_pred(pred_row(ttable.pe, t), b.se_pid)
        _handle_edge_change(
            espec, sink, ttable, t, view_pre,
            applied.se_label, se_old_props, applied.se_src, applied.se_dst,
            se_m & wen & in_pe, *se_r,
        )
        _handle_edge_change(
            espec, sink, ttable, t, view_post,
            applied.se_label, applied.se_props, applied.se_src, applied.se_dst,
            se_m & wen & in_pe, *se_r,
        )

        # --- Algorithm 2: vertex property change
        in_pr = _prop_in_pred(pr, b.sv_pid)
        r_hit = evaluate_pred(pr, sv_lab, sv_pre) | evaluate_pred(pr, sv_lab, sv_post)
        # root-side changes clear the whole (template, root) range
        sink.sweep(t, b.sv_vid, sv_m & wen & in_pr & r_hit, *sv_r)
        in_pl = _prop_in_pred(pl, b.sv_pid)
        _delete_keys_for_leaf(
            espec, sink, ttable, t, view_post, b.sv_vid, sv_lab, sv_pre,
            sv_m & wen & in_pl, *sv_r,
        )
        _delete_keys_for_leaf(
            espec, sink, ttable, t, view_post, b.sv_vid, sv_lab, sv_post,
            sv_m & wen & in_pl, *sv_r,
        )

        # --- Algorithm 1: delete vertex (pre state)
        r_ok = evaluate_pred(pr, dv_lab, dv_props)
        sink.sweep(t, b.dv_vid, dv_m & wen & r_ok, *dv_r)
        _delete_keys_for_leaf(
            espec, sink, ttable, t, view_pre, b.dv_vid, dv_lab, dv_props,
            dv_m & wen, *dv_r,
        )


def invalidate_write_around(espec, store_pre, store_post, cache, ttable, applied):
    """Write-around policy (§4): delete every impacted cache entry, in the
    same commit as the graph writes."""
    sink = _ApplySink(espec, cache)
    _run_policy(
        espec, GlobalStoreView(espec.store, store_pre),
        GlobalStoreView(espec.store, store_post), sink, ttable, applied,
    )
    return sink.cache


def derive_cache_ops(espec, store_pre, store_post, ttable, applied, *, through: bool):
    """Run the mutation listener without touching any cache, returning the
    impacted keys as tensor streams ``(CacheOpStream, SweepStream)``."""
    return derive_cache_ops_views(
        espec, GlobalStoreView(espec.store, store_pre),
        GlobalStoreView(espec.store, store_post), ttable, applied, through=through,
    )


def derive_cache_ops_views(espec, view_pre, view_post, ttable, applied, *, through: bool):
    """``derive_cache_ops`` over storage views."""
    if through:
        raise NotImplementedError("write-through is not ported yet")
    sink = _CollectSink()
    _run_policy(espec, view_pre, view_post, sink, ttable, applied)
    return sink.streams(applied.batch.sv_vid.device)
