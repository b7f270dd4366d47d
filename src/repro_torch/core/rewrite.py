"""Query re-writing (§4.2, the Q+ knob).

PyTorch twin of ``repro.core.rewrite`` (pure host logic on the plan IR).

Amdahl's law: the cache only accelerates the one-hop fraction ``f`` of a
gR-Tx; re-writing attacks the ``1-f`` remainder. Rules operate on the
engine's QueryPlan IR and are cost-annotated so benchmarks can report the
phases each rule removes.

Rule 1 (the paper's example): a final filter that compares a *user-defined
unique property* of each leaf against the root's value requires fetching
that property for every leaf (one extra storage phase). When the property is
declared unique-per-vertex, engine-generated vertex ids are an equivalent
filter and cost nothing: ``("prop_neq_root", pid)`` -> ``("id_neq",)``.

Rule 2: a ``FINAL_VALUES`` clause over a property declared derivable from
the id (e.g. user-visible ids that are bijective with vertex ids) becomes
``FINAL_IDS`` — the valueMap fetch phase disappears.

Rule 3 (predicate de-duplication): a hop whose root predicate re-checks
exactly the previous hop's leaf predicate is redundant — the engine already
guarantees it; dropping it saves per-element predicate evaluations (CPU, not
a storage phase).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import FINAL_IDS, FINAL_VALUES, QueryPlan
from repro_torch.core.templates import ANY_LABEL, PredSpec, make_pred


def _pred_equal(a: PredSpec, b: PredSpec) -> bool:
    return all(
        np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
        for f in PredSpec._fields
    )


def rewrite_plan(plan: QueryPlan, unique_props: frozenset = frozenset()) -> QueryPlan:
    """Apply all applicable rules; returns a new plan (never mutates)."""
    post = plan.post_filter
    # Rule 1
    if post is not None and post[0] == "prop_neq_root" and post[1] in unique_props:
        post = ("id_neq",)
    # Rule 2
    final, final_prop = plan.final, plan.final_prop
    if final == FINAL_VALUES and final_prop in unique_props:
        final, final_prop = FINAL_IDS, -1
    # Rule 3
    hops = list(plan.hops)
    for i in range(1, len(hops)):
        prev, cur = hops[i - 1], hops[i]
        if _pred_equal(prev.pl, cur.pr):
            # the engine's frontier already satisfies this predicate
            hops[i] = cur._replace(pr=make_pred(ANY_LABEL, []))
    return plan._replace(hops=tuple(hops), final=final, final_prop=final_prop, post_filter=post)


def rewrite_savings(plan: QueryPlan, rewritten: QueryPlan) -> dict:
    """Phase savings the rules bought (for benchmark reporting)."""
    saved = 0
    if plan.post_filter != rewritten.post_filter:
        saved += 1
    if plan.final != rewritten.final:
        saved += 1
    return {"phases_saved": saved}
