"""Parity: ``repro_torch.utils.helpers`` against ``repro.utils.helpers``.

Same numpy inputs through both packages; every output is an integer or a
bool, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as J
import repro_torch.utils as T
from test_torch_fixtures import _torch_test_env  # noqa: F401


I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_hash_rows_bits(seed):
    rng = np.random.default_rng(seed)
    n = 257
    cols = [rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32) for _ in range(4)]
    # the edge values: negatives (two's complement), PROP_MISSING, extremes
    cols[0][:6] = [-1, 0, int(J.PROP_MISSING), I32_MIN, I32_MAX, -2]
    cols[1][:3] = int(J.PROP_MISSING)
    seeds = (0, 0x51ED5EED, 0xF1A9F00D, 0xFFFFFFFF)
    # every family in one pass, on a trailing axis
    many = T.hash_rows([_t(c)[:, None] for c in cols], seeds).numpy()
    assert many.shape == (n, len(seeds))
    for k, s in enumerate(seeds):
        want = np.asarray(J.hash_rows([jnp.asarray(c) for c in cols], s))
        np.testing.assert_array_equal(many[:, k].astype(np.uint32), want)
        got = T.hash_rows([_t(c) for c in cols], s).numpy()
        assert want.dtype == np.uint32
        np.testing.assert_array_equal(got.astype(np.uint32), want)
        assert got.min() >= 0 and got.max() < 2**32
        # the int32 bits the cache and the probe kernel keep
        bits = T.u32_bits(torch.as_tensor(got)).numpy()
        assert bits.dtype == np.int32
        np.testing.assert_array_equal(bits, want.view(np.int32))


def test_u32_bits_edges():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], dtype=torch.int64)
    want = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32).view(np.int32)
    np.testing.assert_array_equal(T.u32_bits(x).numpy(), want)


def test_hash_mix_scalar_broadcast():
    rng = np.random.default_rng(3)
    x = rng.integers(I32_MIN, I32_MAX, 64, dtype=np.int64).astype(np.int32)
    want = np.asarray(J.hash_mix(jnp.uint32(12345), jnp.asarray(x).astype(jnp.uint32)))
    got = T.hash_mix(12345, _t(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,width", [((13,), 5), ((13,), 20), ((4, 9), 3), ((2, 3, 11), 6)])
def test_compact_masked(shape, width):
    rng = np.random.default_rng(11)
    vals = rng.integers(-5, 50, shape).astype(np.int32)
    mask = rng.random(shape) < 0.6
    wv, wm = J.compact_masked(jnp.asarray(vals), jnp.asarray(mask), width)
    gv, gm = T.compact_masked(_t(vals), _t(mask), width)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("seed", [0, 5])
def test_sort_and_dedup_masked(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 8, (6, 40)).astype(np.int32)
    mask = rng.random((6, 40)) < 0.7
    for width in (4, 16, 50):
        wv, wm = J.sort_dedup_masked(jnp.asarray(vals), jnp.asarray(mask), width)
        gv, gm = T.sort_dedup_masked(_t(vals), _t(mask), width)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    # dedup_masked: the port sorts where the reference compares [W, W] pairs;
    # masked-out lanes take part as NULL_ID in both
    vals[:, ::5] = -1
    want = np.asarray(J.dedup_masked(jnp.asarray(vals), jnp.asarray(mask)))
    got = T.dedup_masked(_t(vals), _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,S,W,F", [(5, 1, 8, 4), (7, 6, 8, 8), (3, 16, 16, 32), (4, 5, 3, 2)])
def test_segmented_dedup_merge(B, S, W, F):
    rng = np.random.default_rng(B * 100 + S)
    vals = rng.integers(0, 3 * W, (B, S, W)).astype(np.int32)
    counts = rng.integers(0, W + 1, (B, S)).astype(np.int32)
    counts[0] = 0  # an empty row
    wv, wm = J.segmented_dedup_merge(jnp.asarray(vals), jnp.asarray(counts), F)
    syncs = T.SyncCount()
    gv, gm = T.segmented_dedup_merge(_t(vals), _t(counts), F, syncs=syncs)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert syncs.n >= 1  # each merge round reads its condition on the host


def test_take_along0_and_jax_index():
    table = np.arange(10, dtype=np.int32) * 3
    idx = np.array([-12, -11, -10, -1, 0, 5, 9, 10, 40], np.int32)
    want = np.asarray(J.take_along0(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(T.take_along0(_t(table), _t(idx)).numpy(), want)
    # raw jnp gather: a negative index wraps once, then everything clamps
    raw = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    np.testing.assert_array_equal(_t(table)[T.jax_index(_t(idx), 10)].numpy(), raw)


def test_scatter_drop_matches_at_set():
    base = np.arange(8, dtype=np.int32)
    idx = np.array([-1, 2, 8, -9, 5, 3], np.int32)
    keep = np.array([True, True, True, True, False, True])
    vals = np.array([10, 20, 30, 40, 50, 60], np.int32)
    want = np.asarray(
        jnp.asarray(base).at[jnp.where(jnp.asarray(keep), jnp.asarray(idx), 8)].set(
            jnp.asarray(vals), mode="drop")
    )
    got = T.scatter_drop(_t(base), _t(idx), _t(vals), _t(keep))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(base, np.arange(8))  # input untouched
    # duplicate targets: the reference keeps the last write
    dup = np.array([1, 4, 1, 1], np.int32)
    act = np.array([True, True, True, False])
    last = T.keep_last_occurrence(_t(dup), _t(act)).numpy()
    np.testing.assert_array_equal(last, [False, True, True, False])
