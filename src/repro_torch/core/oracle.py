"""Pure-python reference semantics for one-hop sub-queries.

PyTorch twin of ``repro.core.oracle``.

The slow, obviously-correct oracle used by the hypothesis invariant tests
and as the conceptual ``ref`` for the onehop_gather kernel: given the host
(numpy) view of a store, compute the exact leaf-id set of a template
instance. Mirrors Definition 2.1 directly.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.templates import (
    DIR_BOTH,
    DIR_IN,
    DIR_OUT,
    MAX_CONDS,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_LT,
    OP_NEQ,
    PredSpec,
)
from repro_torch.utils import PROP_MISSING

_MISSING = int(PROP_MISSING)
_OPS = {
    OP_EQ: lambda a, b: a == b,
    OP_NEQ: lambda a, b: a != b,
    OP_LT: lambda a, b: a < b,
    OP_LE: lambda a, b: a <= b,
    OP_GT: lambda a, b: a > b,
    OP_GE: lambda a, b: a >= b,
}


class HostStore:
    """Numpy snapshot of a GraphStore (device -> host once per check)."""

    def __init__(self, store):
        for f in (
            "vlabel", "valive", "vprops", "esrc", "edst", "elabel", "ealive",
            "eprops",
        ):
            setattr(self, f, getattr(store, f).cpu().numpy())
        self.v_len = int(store.v_len)
        self.e_len = int(store.e_len)


def eval_pred_host(pred: PredSpec, label: int, props: np.ndarray, bound=None) -> bool:
    plabel = int(pred.label)
    if plabel >= 0 and label != plabel:
        return False
    for c in range(MAX_CONDS):
        pid = int(pred.prop_ids[c])
        if pid < 0:
            continue
        pv = int(props[pid])
        if pv == _MISSING:
            return False
        if bool(pred.wild[c]):
            if bound is None:
                continue  # presence is enough
            if pv != int(bound[c]):
                return False
        else:
            if not _OPS[int(pred.ops[c])](pv, int(pred.vals[c])):
                return False
    return True


def extract_wildcards_host(pred: PredSpec, props: np.ndarray):
    out = []
    for c in range(MAX_CONDS):
        pid = int(pred.prop_ids[c])
        if pid >= 0 and bool(pred.wild[c]):
            out.append(int(props[pid]))
        else:
            out.append(_MISSING)
    return out


def onehop_oracle(
    hs: HostStore,
    direction: int,
    edge_label: int,
    pr: PredSpec,
    pe: PredSpec,
    pl: PredSpec,
    root: int,
    params,
) -> set:
    """Exact leaf-id set of a one-hop sub-query instance at ``hs``."""
    params = np.asarray(params)
    pe_b, pl_b = params[:MAX_CONDS], params[MAX_CONDS:]
    if root < 0 or root >= len(hs.valive) or not hs.valive[root]:
        return set()
    if not eval_pred_host(pr, int(hs.vlabel[root]), hs.vprops[root]):
        return set()
    leaves = set()
    for e in range(hs.e_len):
        if not hs.ealive[e]:
            continue
        src, dst = int(hs.esrc[e]), int(hs.edst[e])
        cands = []
        if direction in (DIR_OUT, DIR_BOTH) and src == root:
            cands.append(dst)
        if direction in (DIR_IN, DIR_BOTH) and dst == root:
            cands.append(src)
        for leaf in cands:
            if leaf < 0 or leaf >= len(hs.valive) or not hs.valive[leaf]:
                continue
            if edge_label >= 0 and int(hs.elabel[e]) != edge_label:
                continue
            if not eval_pred_host(pe, int(hs.elabel[e]), hs.eprops[e], bound=pe_b):
                continue
            if not eval_pred_host(pl, int(hs.vlabel[leaf]), hs.vprops[leaf], bound=pl_b):
                continue
            leaves.add(leaf)
    return leaves
