"""One-hop sub-query templates (Definitions 2.1 / 2.2), tensorized.

PyTorch twin of ``repro.core.templates``. A template is ``(direction, P^r,
P^e, P^l)``; each predicate holds a label test plus up to ``MAX_CONDS``
property conditions, either a bound comparison ``prop <op> value`` or a
wildcard ``prop = ?`` (matches any *present* value).

Predicates and the template table are a few dozen integers of static
configuration, so they stay on the host as numpy arrays: evaluating a
predicate branches on them in Python and launches device work only over
the graph elements. The result is the same as the reference's traced
``jnp.select`` over every op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.utils import PROP_MISSING

MAX_CONDS = 3  # the paper's production templates use <= 2 conditions

# direction codes (Definition 2.1: incoming, outgoing, or both)
DIR_OUT, DIR_IN, DIR_BOTH = 0, 1, 2
# comparison ops
OP_EQ, OP_NEQ, OP_LT, OP_LE, OP_GT, OP_GE = 0, 1, 2, 3, 4, 5
ANY_LABEL = -1
WILDCARD = object()  # host-side marker in template definitions


class PredSpec(NamedTuple):
    """Host-side predicate. Stacks to [T, ...] in a TemplateTable."""

    label: np.ndarray  # int32 scalar; ANY_LABEL = no label test
    prop_ids: np.ndarray  # int32 [MAX_CONDS]; -1 = unused condition
    ops: np.ndarray  # int32 [MAX_CONDS]
    vals: np.ndarray  # int32 [MAX_CONDS] (ignored when wild)
    wild: np.ndarray  # bool  [MAX_CONDS]


@dataclass(frozen=True)
class Template:
    """Host-side template definition (what an admin registers with the SC)."""

    name: str
    direction: int  # DIR_OUT / DIR_IN / DIR_BOTH
    root: tuple  # (label, [(prop_id, op, value|WILDCARD), ...])
    edge: tuple
    leaf: tuple
    edge_label: int = ANY_LABEL


class TemplateTable(NamedTuple):
    """All registered templates stacked, plus the lifecycle masks the Service
    Coordinator drives (§4.1): reads may use the cache only when
    read-enabled; writes must invalidate whenever write-enabled."""

    direction: np.ndarray  # int32 [T]
    edge_label: np.ndarray  # int32 [T]
    pr: PredSpec  # fields shaped [T, ...]
    pe: PredSpec
    pl: PredSpec
    read_enabled: np.ndarray  # bool [T]
    write_enabled: np.ndarray  # bool [T]


def make_pred(label: int, conds: Sequence[tuple]) -> PredSpec:
    assert len(conds) <= MAX_CONDS
    pid = np.full(MAX_CONDS, -1, np.int32)
    ops = np.zeros(MAX_CONDS, np.int32)
    vals = np.zeros(MAX_CONDS, np.int32)
    wild = np.zeros(MAX_CONDS, bool)
    for i, (p, op, v) in enumerate(conds):
        pid[i] = p
        ops[i] = op
        if v is WILDCARD:
            wild[i] = True
        else:
            vals[i] = v
    return PredSpec(np.int32(label), pid, ops, vals, wild)


def make_template_table(templates: Sequence[Template]) -> TemplateTable:
    preds = {"pr": [], "pe": [], "pl": []}
    for t in templates:
        preds["pr"].append(make_pred(*t.root))
        preds["pe"].append(make_pred(*t.edge))
        preds["pl"].append(make_pred(*t.leaf))
    stack = lambda ps: PredSpec(*(np.stack(xs) for xs in zip(*ps)))
    return TemplateTable(
        direction=np.asarray([t.direction for t in templates], np.int32),
        edge_label=np.asarray([t.edge_label for t in templates], np.int32),
        pr=stack(preds["pr"]),
        pe=stack(preds["pe"]),
        pl=stack(preds["pl"]),
        read_enabled=np.zeros(len(templates), bool),
        write_enabled=np.zeros(len(templates), bool),
    )


def pred_row(stacked: PredSpec, t: int) -> PredSpec:
    """Template ``t``'s predicate out of a stacked table."""
    return PredSpec(*(getattr(stacked, f)[t] for f in PredSpec._fields))


def _cmp(op: int, a, b):
    if op == OP_EQ:
        return a == b
    if op == OP_NEQ:
        return a != b
    if op == OP_LT:
        return a < b
    if op == OP_LE:
        return a <= b
    if op == OP_GT:
        return a > b
    if op == OP_GE:
        return a >= b
    return torch.zeros_like(a, dtype=torch.bool)


def _prop(props, pid: int):
    return props[..., min(max(pid, 0), props.shape[-1] - 1)]


def evaluate_pred(pred: PredSpec, labels, props, bound_vals=None):
    """Algorithm 5 (Evaluate), vectorized over N graph elements.

    ``labels``: int32 [...], ``props``: int32 [..., NP]. ``bound_vals``
    optionally binds wildcard conditions to concrete values (int32
    [..., MAX_CONDS]); unbound wildcards only require presence.
    """
    label = int(pred.label)
    if label < 0:
        ok = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    else:
        ok = labels == label
    for c in range(MAX_CONDS):
        pid = int(pred.prop_ids[c])
        if pid < 0:
            continue
        pv = _prop(props, pid)
        present = pv != PROP_MISSING
        wild = bool(pred.wild[c])
        if bound_vals is None:
            cond = present if wild else present & _cmp(int(pred.ops[c]), pv, int(pred.vals[c]))
        elif wild:
            cond = present & (pv == bound_vals[..., c])
        else:
            cond = present & _cmp(int(pred.ops[c]), pv, int(pred.vals[c]))
        ok = ok & cond
    return ok


def extract_wildcards(pred: PredSpec, props):
    """Algorithm 9 (ExtractWildcardValues), vectorized.

    Returns int32 [..., MAX_CONDS]: the element's value for each wildcard
    condition (PROP_MISSING where the condition is unused or bound).
    """
    outs = []
    for c in range(MAX_CONDS):
        pid = int(pred.prop_ids[c])
        if pid >= 0 and bool(pred.wild[c]):
            outs.append(_prop(props, pid))
        else:
            outs.append(torch.full(props.shape[:-1], PROP_MISSING,
                                   dtype=props.dtype, device=props.device))
    return torch.stack(outs, dim=-1)
