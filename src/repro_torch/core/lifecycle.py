"""Sub-query template life-cycle (§4.1): the Service Coordinator.

PyTorch twin of ``repro.core.lifecycle`` (pure host logic; the template
table's masks are host numpy arrays in the port).

States: ``registered -> installed -> enabled -> installed -> removed``.
Enable is a two-phase workflow across all Graph-QPs:

  Phase 1: every QP starts *write invalidation* for the template (deleting
           possibly-nonexistent entries is safe); only when all QPs ack does
           the state become ``installed``.
  Phase 2: every QP activates *reads* for the template; when all ack, the
           state becomes ``enabled``.

Disable reverses the phases (reads off everywhere first, then writes off,
then one clearRange frees the template's entries). The SC retries failed or
timed-out QP requests until acked — we simulate message loss with a seeded
RNG so tests can drive the retry path deterministically.

The safety invariant (tested): **whenever any QP serves reads from the cache
for a template, every QP is write-invalidating it.**
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.cache import CacheSpec, CacheState, sweep_template
from repro_torch.core.templates import TemplateTable


class TemplateState(enum.Enum):
    REGISTERED = "registered"
    INSTALLED = "installed"
    ENABLED = "enabled"
    REMOVED = "removed"


@dataclass
class GraphQP:
    """One query processor's local view of template activation."""

    name: str
    read_active: set = field(default_factory=set)
    write_active: set = field(default_factory=set)
    reachable: bool = True  # SC marks unreachable QPs bad and removes them

    def ttable_masks(self, ttable: TemplateTable, n_templates: int) -> TemplateTable:
        r = np.zeros(n_templates, bool)
        w = np.zeros(n_templates, bool)
        for t in self.read_active:
            r[t] = True
        for t in self.write_active:
            w[t] = True
        return ttable._replace(read_enabled=r, write_enabled=w)


class ServiceCoordinator:
    """Deterministic simulation of the SC's two-phase workflows.

    ``drop_prob`` injects request loss; the SC re-sends until each QP acks
    (§4.1 last paragraph). ``max_rounds`` bounds the simulation.
    """

    def __init__(self, qps, seed: int = 0, drop_prob: float = 0.0, max_rounds: int = 100):
        self.qps = list(qps)
        self.states: dict[int, TemplateState] = {}
        self.rng = np.random.default_rng(seed)
        self.drop_prob = drop_prob
        self.max_rounds = max_rounds
        self.audit_log: list = []  # removed templates are tracked for auditing
        self.messages_sent = 0
        self.messages_dropped = 0

    # -- message layer --------------------------------------------------
    def _request_all(self, action: Callable) -> None:
        """Send ``action(qp)`` to every QP, retrying drops until all ack."""
        pending = [qp for qp in self.qps if qp.reachable]
        rounds = 0
        while pending:
            rounds += 1
            if rounds > self.max_rounds:
                raise RuntimeError("SC: retry budget exhausted")
            nxt = []
            for qp in pending:
                self.messages_sent += 1
                if self.rng.random() < self.drop_prob:
                    self.messages_dropped += 1
                    nxt.append(qp)  # no ack; re-send next round
                    continue
                action(qp)
            pending = nxt

    # -- admin API --------------------------------------------------------
    def register(self, tpl_idx: int):
        self.states[tpl_idx] = TemplateState.REGISTERED
        self.audit_log.append(("register", tpl_idx))

    def enable(self, tpl_idx: int):
        assert self.states[tpl_idx] in (TemplateState.REGISTERED, TemplateState.INSTALLED)
        # Phase 1: all QPs begin write invalidation
        self._request_all(lambda qp: qp.write_active.add(tpl_idx))
        self.states[tpl_idx] = TemplateState.INSTALLED
        self.audit_log.append(("installed", tpl_idx))
        # Phase 2: all QPs activate reads
        self._request_all(lambda qp: qp.read_active.add(tpl_idx))
        self.states[tpl_idx] = TemplateState.ENABLED
        self.audit_log.append(("enabled", tpl_idx))

    def disable_and_remove(self, tpl_idx: int, cache: CacheState, cspec: CacheSpec):
        assert self.states[tpl_idx] == TemplateState.ENABLED
        # Phase 1: stop reads everywhere (writes keep invalidating)
        self._request_all(lambda qp: qp.read_active.discard(tpl_idx))
        self.states[tpl_idx] = TemplateState.INSTALLED
        self.audit_log.append(("installed", tpl_idx))
        # Phase 2: stop write invalidation, then reclaim the subspace
        self._request_all(lambda qp: qp.write_active.discard(tpl_idx))
        cache = sweep_template(cspec, cache, tpl_idx)
        self.states[tpl_idx] = TemplateState.REMOVED
        self.audit_log.append(("removed", tpl_idx))
        return cache

    # -- invariants (used by tests) --------------------------------------
    def check_safety(self) -> bool:
        """Any QP reading => all QPs writing, per template."""
        live = [qp for qp in self.qps if qp.reachable]
        for t, s in self.states.items():
            if s == TemplateState.REMOVED:
                continue
            if any(t in qp.read_active for qp in live):
                if not all(t in qp.write_active for qp in live):
                    return False
        return True

    def remove_bad_qp(self, qp: GraphQP):
        qp.reachable = False
        self.audit_log.append(("qp_removed", qp.name))
