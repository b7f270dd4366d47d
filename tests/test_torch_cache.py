"""Parity: the port's one-hop result cache against ``repro.core.cache``.

Inserts with forced probe-window collisions, evictions, duplicate keys and
oversize results; lookups (the read path runs the ``cache_probe`` wrapper);
exact-key deletes; root and template sweeps. The comparison is
``cache_entries`` plus every cache array, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cache as J
import repro_torch.core.cache as T
from repro_torch import interop
from repro_torch.utils import SyncCount
from test_torch_fixtures import _torch_test_env  # noqa: F401


MISSING = -(2**31) + 1


def to_np(x):
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_cache_same(tspec, tcache, jspec, jcache, what=""):
    assert T.cache_entries(tspec, tcache) == J.cache_entries(jspec, jcache), what
    got, want = interop.cache_to_numpy(tcache), to_np(jcache)
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}.{k}")


def _batch(rng, B, L, C, n_roots=6, oversize=True):
    tpl = rng.integers(0, 3, B).astype(np.int32)
    root = rng.integers(0, n_roots, B).astype(np.int32)
    params = np.full((B, 6), MISSING, np.int32)
    params[:, 0] = rng.integers(0, 2, B)
    params[:, 3] = rng.integers(0, 2, B)
    lens = rng.integers(0, L * C + 1, B).astype(np.int32)
    if oversize:
        lens[::7] = L * C + 3  # oversize: skipped and counted
    leaves = rng.integers(0, 500, (B, L * C)).astype(np.int32)
    ver = rng.integers(1, 9, B).astype(np.int32)
    mask = rng.random(B) < 0.85
    # duplicate keys inside the batch: last writer wins
    tpl[-3:], root[-3:], params[-3:] = tpl[0], root[0], params[0]
    return tpl, root, params, leaves, lens, ver, mask


def _specs(cap, probes, L, C):
    jspec = J.CacheSpec(capacity=cap, probes=probes, max_leaves=L, max_chunks=C)
    return jspec, interop.cache_spec(tuple(jspec))


def _insert_both(jspec, tspec, jcache, tcache, batch, width=None):
    tpl, root, params, leaves, lens, ver, mask = batch
    if width is not None:
        leaves = leaves[:, :width]
    jargs = [jnp.asarray(a) for a in (tpl, root, params, leaves, lens, ver, mask)]
    targs = [torch.as_tensor(a) for a in (tpl, root, params, leaves, lens, ver, mask)]
    syncs = SyncCount()
    tc = T.cache_insert(tspec, tcache, *targs, syncs=syncs)
    return J.cache_insert(jspec, jcache, *jargs), tc, syncs.n


@pytest.mark.parametrize("cap,probes,L,C,B", [
    (16, 4, 4, 2, 24),    # tiny table: window collisions + evictions
    (64, 8, 4, 3, 40),
    (1024, 8, 8, 2, 32),  # roomy: one priority round
])
def test_insert_lookup_delete_sweep(cap, probes, L, C, B):
    rng = np.random.default_rng(cap + B)
    jspec, tspec = _specs(cap, probes, L, C)
    jcache, tcache = J.empty_cache(jspec), T.empty_cache(tspec, device="cpu")
    assert_cache_same(tspec, tcache, jspec, jcache, "empty")

    for step in range(2):
        batch = _batch(rng, B, L, C)
        width = L if step else None  # second round: narrow rows get padded
        jcache2, tcache2, rounds = _insert_both(jspec, tspec, jcache, tcache, batch, width)
        assert_cache_same(tspec, tcache2, jspec, jcache2, f"insert {step}")
        assert_cache_same(tspec, tcache, jspec, jcache, "pre-state left intact")
        assert rounds >= 1
        jcache, tcache = jcache2, tcache2
    if cap == 16:
        assert int(tcache.n_evict) > 0 and int(tcache.n_oversize) > 0

    # the sequential oracle agrees with the batched insert on both sides
    batch = _batch(rng, 12, L, C)
    targs = [torch.as_tensor(a) for a in batch[:3]] + [torch.as_tensor(a) for a in batch[3:]]
    seq = T.cache_insert_sequential(tspec, tcache, *targs)
    jseq = J.cache_insert_sequential(jspec, jcache, *map(jnp.asarray, batch))
    assert_cache_same(tspec, seq, jspec, jseq, "sequential")

    # lookups: every key of the last batches, plus keys never inserted
    tpl, root, params = batch[0], batch[1], batch[2]
    for t in range(3):
        probe_roots = np.concatenate([root, np.arange(8, dtype=np.int32)])
        probe_params = np.concatenate([params, params[:8]])
        for lean in (True, False):
            jf = J.cache_lookup_lean if lean else J.cache_lookup
            tf = T.cache_lookup_lean if lean else T.cache_lookup
            want = jf(jspec, jseq, t, jnp.asarray(probe_roots), jnp.asarray(probe_params))
            got = tf(tspec, seq, t, torch.as_tensor(probe_roots), torch.as_tensor(probe_params))
            hit, count = np.asarray(want[0]), np.asarray(want[2])
            np.testing.assert_array_equal(got[0].numpy(), hit)
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
            if lean:  # leaves_raw is defined on the counted prefix only
                np.testing.assert_array_equal(got[2].numpy(), count)
                raw_g, raw_w = got[1].numpy(), np.asarray(want[1])
                for r in range(len(hit)):
                    n = int(count[r])
                    np.testing.assert_array_equal(raw_g[r, :n], raw_w[r, :n])
            else:
                np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
                np.testing.assert_array_equal(got[2].numpy(), count)

    # exact-key deletes (some keys absent), then root and template sweeps
    dmask = np.random.default_rng(1).random(len(tpl)) < 0.7
    jd = J.cache_delete(jspec, jseq, jnp.asarray(tpl), jnp.asarray(root), jnp.asarray(params), jnp.asarray(dmask))
    td = T.cache_delete(tspec, seq, torch.as_tensor(tpl), torch.as_tensor(root),
                        torch.as_tensor(params), torch.as_tensor(dmask))
    assert_cache_same(tspec, td, jspec, jd, "delete")
    st = np.array([0, 1, 2, 1], np.int32)
    sr = np.array([0, 1, 2, 3], np.int32)
    sm = np.array([True, True, False, True])
    js = J.sweep_root(jspec, jd, jnp.asarray(st), jnp.asarray(sr), jnp.asarray(sm))
    ts = T.sweep_root(tspec, td, torch.as_tensor(st), torch.as_tensor(sr), torch.as_tensor(sm))
    assert_cache_same(tspec, ts, jspec, js, "sweep_root")
    assert_cache_same(tspec, T.sweep_template(tspec, ts, 2), jspec,
                      J.sweep_template(jspec, js, 2), "sweep_template")
    assert T.cache_stats(ts) == J.cache_stats(js)


def test_insert_slabs_large_batch():
    """Batches past the slab cap (``_INSERT_SLAB`` virtual rows) insert slab
    by slab, each into the state the previous slab left."""
    rng = np.random.default_rng(9)
    jspec, tspec = _specs(2048, 8, 4, 2)
    B = 1100
    batch = _batch(rng, B, 4, 2, n_roots=400, oversize=False)
    jc, tc, _ = _insert_both(jspec, tspec, J.empty_cache(jspec),
                             T.empty_cache(tspec, device="cpu"), batch)
    assert_cache_same(tspec, tc, jspec, jc, "slabbed insert")
