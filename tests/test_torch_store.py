"""Parity: the port's graph store (``ingest``, ``compact``, ``_gather`` with a
live recent region, ``apply_mutations``, ``conflicts``) against the JAX
package. Every store array is compared, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_world
from repro.graphstore import apply_mutations as j_apply, make_mutation_batch as j_batch
from repro.graphstore.store import _gather as j_gather
from repro.graphstore.txn import conflicts as j_conflicts
from repro_torch import interop
from repro_torch.graphstore import (
    StoreSpec,
    apply_mutations,
    compact,
    empty_store,
    ingest,
    make_mutation_batch,
)
from repro_torch.graphstore.store import _gather
from repro_torch.graphstore.txn import conflicts
from test_torch_fixtures import _torch_test_env  # noqa: F401


def to_np(x):
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(got, want, what=""):
    """Field-by-field equality of two (nested) dicts of arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _mutations(spec, rng, nv, e_len):
    """A random commit touching every section (with duplicate property
    writes, which must resolve last-writer-wins)."""
    return dict(
        new_vertices=[(1, [int(rng.integers(0, 2)), 2000 + i]) for i in range(2)],
        new_edges=[(int(rng.integers(0, 4)), int(rng.integers(4, nv)), 0,
                    [int(rng.integers(0, 2))]) for _ in range(3)],
        del_edges=[int(e) for e in rng.choice(e_len, 2, replace=False)],
        del_vertices=[int(rng.integers(4, nv))],
        set_vprops=[(5, 0, 1), (6, 0, 0), (5, 0, 0), (7, 1, 77)],
        set_eprops=[(1, 0, 0), (2, 0, 1), (1, 0, 1)],
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_ingest_compact_gather_and_mutations(seed):
    spec, jstore = build_world(seed=seed)
    rng = np.random.default_rng(seed)
    tstore = interop.store_from_numpy(to_np(jstore), device="cpu")
    assert_same(to_np(tstore), to_np(jstore), "ingest")

    # the port's own ingest from the same host arrays
    nv, ne = int(jstore.v_len), int(jstore.e_len)
    host = to_np(jstore)
    own = ingest(spec, host["vlabel"][:nv], host["vprops"][:nv], host["esrc"][:ne],
                 host["edst"][:ne], host["elabel"][:ne], host["eprops"][:ne], device="cpu")
    assert_same(to_np(own), to_np(jstore), "port ingest")

    # two commits: the second reads a live recent region (edges past csr_len)
    for step in range(2):
        kw = _mutations(spec, rng, nv, ne)
        jstore2, japplied = j_apply(spec, jstore, j_batch(spec, **kw))
        tstore2, tapplied = apply_mutations(spec, tstore, make_mutation_batch(spec, device="cpu", **kw))
        assert_same(to_np(tstore2), to_np(jstore2), f"store after commit {step}")
        assert_same(to_np(tapplied), to_np(japplied), f"applied {step}")
        assert_same(to_np(tstore), to_np(jstore), "pre-state left intact")
        jstore, tstore = jstore2, tstore2
    assert int(tstore.e_len) > int(tstore.csr_len)  # recent region is live

    roots = np.array([0, 1, 2, 3, 5, 9, -1, 63, 64, 200], np.int32)
    for incoming in (False, True):
        for max_deg in (2, 8):
            want = j_gather(spec, jstore, jnp.asarray(roots), max_deg, incoming=incoming)
            got = _gather(spec, tstore, torch.as_tensor(roots), max_deg, incoming=incoming)
            for g, w, name in zip(got, want, ("eids", "other", "mask", "trunc")):
                assert_same(g.numpy(), np.asarray(w), f"gather {name} in={incoming} d={max_deg}")

    # compaction folds the recent region into the CSR
    from repro.graphstore import compact as j_compact
    assert_same(to_np(compact(spec, tstore)), to_np(j_compact(spec, jstore)), "compact")

    # OCC conflict check: batched and collapsed verdicts
    rs = rng.integers(-2, spec.v_cap + 3, (6, 9)).astype(np.int32)
    rm = rng.random((6, 9)) < 0.7
    for rv in (0, 1, 2):
        for axis in (None, 1):
            w = j_conflicts(spec, jstore, rv, jnp.asarray(rs), jnp.asarray(rm), axis=axis)
            g = conflicts(spec, tstore, rv, torch.as_tensor(rs), torch.as_tensor(rm), axis=axis)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_empty_store_matches():
    from repro.graphstore import empty_store as j_empty
    spec = StoreSpec(v_cap=16, e_cap=64, n_vprops=2, n_eprops=1, recent_cap=8)
    assert_same(to_np(empty_store(spec, device="cpu")), to_np(j_empty(spec)), "empty")
