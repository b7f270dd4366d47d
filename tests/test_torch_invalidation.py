"""Parity: write-around cache maintenance under gRW-Txs.

Random mutation batches over a populated cache: the port's gRW step
(``run_grw_tx``: apply mutations + op-stream derivation + compaction +
sweeps + batched deletes) and its sink-based ``invalidate_write_around``
against the JAX package's; post-states compared bit for bit.
"""

import numpy as np
import pytest

import repro.core as J
from conftest import P_ISACTIVE, P_LISTING_ID, P_STATUS
from repro.core.invalidation import invalidate_write_around as j_invalidate
from repro.graphstore import apply_mutations as j_apply, make_mutation_batch as j_batch
import repro_torch.core as T
from repro_torch.core.invalidation import invalidate_write_around as t_invalidate
from repro_torch.graphstore import apply_mutations as t_apply, make_mutation_batch as t_batch
from test_torch_engine import Both
from test_torch_fixtures import _torch_test_env  # noqa: F401


def _random_commit(rng, nv, e_len):
    """One random gRW batch over the watch-list world's change types."""
    kw = {}
    if rng.random() < 0.7:
        kw["set_vprops"] = [(int(rng.integers(0, nv)), int(rng.choice([P_STATUS, P_LISTING_ID])),
                             int(rng.integers(0, 2))) for _ in range(int(rng.integers(1, 4)))]
    if rng.random() < 0.5:
        kw["new_edges"] = [(int(rng.integers(0, 4)), int(rng.integers(4, nv)), 0,
                            [int(rng.integers(0, 2))]) for _ in range(int(rng.integers(1, 3)))]
    if rng.random() < 0.5:
        kw["del_edges"] = [int(e) for e in rng.choice(e_len, int(rng.integers(1, 3)), replace=False)]
    if rng.random() < 0.4:
        kw["set_eprops"] = [(int(rng.integers(0, e_len)), P_ISACTIVE, int(rng.integers(0, 2)))]
    if rng.random() < 0.2:
        kw["del_vertices"] = [int(rng.integers(0, nv))]
    return kw


def _populate_all(w):
    """Queue every SQ1/SQ2 key of the world (both IsActive/Status values)
    and let both populators drain it."""
    M = -(2**31) + 1
    ver = int(w.jstore.version)
    keys = [(0, r, [a, M, M, s, M, M]) for r in range(4) for a in (0, 1) for s in (0, 1)]
    keys += [(1, r, [a, M, M, M, M, M]) for r in range(4, int(w.jstore.v_len)) for a in (0, 1)]
    jm = [J.MissRecord(t, r, np.array(p, np.int32), ver) for t, r, p in keys]
    tm = [T.MissRecord(t, r, np.array(p, np.int32), ver) for t, r, p in keys]
    for lo in range(0, len(keys), 128):
        w.populate(jm[lo:lo + 128], tm[lo:lo + 128])


@pytest.mark.parametrize("seed", [0, 1])
def test_run_grw_tx_random_batches(seed):
    w = Both(seed=seed)
    rng = np.random.default_rng(seed)
    _populate_all(w)
    assert len(T.cache_entries(w.tspec.cache, w.tcache)) > 0
    impacted = 0
    for _ in range(3):
        nv, ne = int(w.jstore.v_len), int(w.jstore.e_len)
        impacted += w.grw(**_random_commit(rng, nv, ne))["impacted_keys"]
        _populate_all(w)
    assert impacted > 0


def test_invalidate_write_around_sink_path():
    w = Both(seed=4)
    _populate_all(w)
    rng = np.random.default_rng(4)
    for _ in range(2):
        kw = _random_commit(rng, int(w.jstore.v_len), int(w.jstore.e_len))
        js2, japplied = j_apply(w.jspec.store, w.jstore, j_batch(w.jspec.store, **kw))
        ts2, tapplied = t_apply(w.tspec.store, w.tstore, t_batch(w.tspec.store, device="cpu", **kw))
        jc = j_invalidate(w.jspec, w.jstore, js2, w.jcache, w.jttable, japplied)
        tc = t_invalidate(w.tspec, w.tstore, ts2, w.tcache, w.tttable, tapplied)
        w.jstore, w.jcache, w.tstore, w.tcache = js2, jc, ts2, tc
        w.check_state("invalidate_write_around")

