"""Parity: the port's segment_spmm (the plain version its wrapper runs on
the CPU, and the CSR by destination its CUDA kernel walks, in both the
per-call and the prebuilt-CSR form) against the JAX package's
``segment_spmm_ref``, ``jax.ops.segment_sum`` and its Pallas
``segment_spmm`` in interpret mode.

Tolerances: fp32 1e-5 (sums in another order than XLA's), bf16 1e-1 (the
JAX sweep's: the reference sums in bf16, the port in fp32 rounded once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_spmm.ops import segment_spmm as j_segment_spmm
from repro.kernels.segment_spmm.ref import segment_spmm_ref as j_segment_spmm_ref
from repro_torch.kernels.segment_spmm import ops
from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref, segment_spmm_ref
from test_torch_fixtures import _torch_test_env  # noqa: F401


TOL = {"float32": 1e-5, "bfloat16": 1e-1}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, N, E, D, dtype, n_rows=None):
    """x [n_rows or N, D] in ``dtype`` (the same values on both sides), and
    src / dst [E] in [0, N) with destinations only in the first half, so
    half the output rows are empty."""
    rng = np.random.default_rng(seed)
    x32 = rng.normal(size=(n_rows or N, D)).astype(np.float32)
    xj = jnp.asarray(x32, J_DTYPE[dtype])
    xt = torch.as_tensor(np.array(xj.astype(jnp.float32))).to(T_DTYPE[dtype])
    src = rng.integers(0, n_rows or N, E).astype(np.int32)
    dst = rng.integers(0, max(N // 2, 1), E).astype(np.int32)
    return xj, xt, src, dst


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,E,D", [(64, 256, 16), (128, 512, 75), (128, 0, 8), (32, 300, 33)])
def test_against_reference_and_pallas(N, E, D, dtype):
    """Empty rows, E = 0 and D not a multiple of 32, against the JAX ref and
    the Pallas kernel (every tile well within its 16,384-edge cap)."""
    xj, xt, src, dst = _inputs(N + E + D, N, E, D, dtype)
    got = ops.segment_spmm(xt, torch.as_tensor(src), torch.as_tensor(dst))
    assert got.dtype == T_DTYPE[dtype] and got.shape == (N, D)
    _close(got, j_segment_spmm_ref(xj, jnp.asarray(src), jnp.asarray(dst)), dtype)
    if E:
        pallas = j_segment_spmm(xj, jnp.asarray(src), jnp.asarray(dst), block_n=16,
                                block_e=64, max_chunks=E // 64 + 1)
        _close(got, pallas, dtype)
    assert not got[N // 2:].to(torch.float32).any(), "rows with no edge must be zero"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_and_out_of_range_edges_are_dropped(dtype):
    N, E, D = 48, 400, 40
    xj, xt, src, dst = _inputs(7, N, E, D, dtype, n_rows=E)
    rng = np.random.default_rng(8)
    dst = rng.integers(-N, 2 * N, E).astype(np.int32)  # a third in range
    mask = rng.random(E) < 0.6
    got = ops.segment_spmm(xt, torch.as_tensor(src), torch.as_tensor(dst), n_nodes=N,
                           edge_mask=torch.as_tensor(mask))
    assert got.shape == (N, D)
    # jax.ops.segment_sum drops ids outside [0, N); masked edges add nothing
    want = j_segment_spmm_ref(xj, jnp.asarray(src[mask]), jnp.asarray(dst[mask]), n_nodes=N)
    _close(got, want, dtype)


def test_prepare_edges_is_the_kernels_csr():
    """The CSR the kernel walks, walked in numpy in the kernel's order (one
    row at a time, edges in sorted order, fp32 sums), equals the plain
    version; the sort is stable and the offsets bound each row's edges."""
    N, E, D = 40, 500, 7
    rng = np.random.default_rng(11)
    x = rng.normal(size=(E, D)).astype(np.float32)
    src = rng.integers(-3, E + 3, E).astype(np.int32)  # jnp's gather rule
    dst = rng.integers(-5, N + 5, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    csr = ops.prepare_edges(torch.as_tensor(src), torch.as_tensor(dst), N, E,
                            torch.as_tensor(mask))
    assert csr.n_nodes == N and csr.n_src == E
    src_s, offs = csr.src_sorted.numpy(), csr.offsets.numpy()
    assert src_s.dtype == np.int32 and offs.dtype == np.int32 and offs.shape == (N + 1,)
    kept = mask & (dst >= 0) & (dst < N)
    assert offs[0] == 0 and offs[N] == kept.sum() and (np.diff(offs) >= 0).all()
    src_j = np.clip(np.where(src < 0, src + E, src), 0, E - 1)
    walked = np.zeros((N, D), np.float32)
    for v in range(N):
        want_rows = src_j[kept & (dst == v)]  # original order: the sort is stable
        np.testing.assert_array_equal(src_s[offs[v]:offs[v + 1]], want_rows)
        for s in want_rows:
            walked[v] += x[s]
    ref = segment_spmm_ref(torch.as_tensor(x), torch.as_tensor(src), torch.as_tensor(dst),
                           N, torch.as_tensor(mask))
    np.testing.assert_array_equal(walked, ref.numpy())  # same order, same bits


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    xt = torch.ones((4, 3))
    before = ops.launches
    out = ops.segment_spmm(xt, torch.tensor([0, 1, 2]), torch.tensor([1, 1, 3]))
    assert ops.launches == before
    np.testing.assert_array_equal(out.numpy(), [[0] * 3, [2] * 3, [0] * 3, [1] * 3])
    with pytest.raises(ValueError, match="unsupported device"):
        ops.segment_spmm(xt.to("meta"), torch.tensor([0]), torch.tensor([0]))


def _masked_edges(seed, N, E):
    """src [E] in [0, E), dst [E] a third in [0, N) (the rest out of range on
    both sides, so many rows stay empty), a mask that keeps ~60 %."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, E, E).astype(np.int32)
    dst = rng.integers(-N, 2 * N, E).astype(np.int32)
    return src, dst, rng.random(E) < 0.6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,E,D", [(48, 400, 40), (64, 1, 3), (16, 0, 8)])
def test_csr_form_against_segment_sum(N, E, D, dtype):
    """``segment_spmm(x, csr=...)`` over a CSR from ``prepare_edges``, with
    masked edges, out-of-range destinations and empty rows, against
    ``jax.ops.segment_sum`` of the kept edges."""
    src, dst, mask = _masked_edges(N + E + D, N, E)
    xj, xt, _, _ = _inputs(N + D, N, E, D, dtype, n_rows=max(E, 1))
    csr = ops.prepare_edges(torch.as_tensor(src), torch.as_tensor(dst), N, xt.shape[0],
                            torch.as_tensor(mask))
    before = ops.launches
    got = ops.segment_spmm(xt, csr=csr)
    assert ops.launches == before, "the CPU path launches no kernel"
    assert got.dtype == T_DTYPE[dtype] and got.shape == (N, D)
    want = jax.ops.segment_sum(xj[src[mask]], jnp.asarray(dst[mask]), num_segments=N)
    _close(got, want, dtype)
    empty = np.ones(N, bool)
    empty[dst[mask & (dst >= 0) & (dst < N)]] = False
    assert not got[torch.as_tensor(empty)].to(torch.float32).any(), "empty rows must be zero"


def test_one_csr_serves_many_x_bit_for_bit():
    """One CSR reused over several x gives, bit for bit, what a fresh CSR
    per call and the per-call form give (the same sums in the same order)."""
    N, E = 40, 500
    src, dst, mask = _masked_edges(3, N, E)
    args = (torch.as_tensor(src), torch.as_tensor(dst), N)
    csr = ops.prepare_edges(*args, E, torch.as_tensor(mask))
    rng = np.random.default_rng(4)
    for D in (1, 7, 75):
        x = torch.as_tensor(rng.normal(size=(E, D)).astype(np.float32))
        got = ops.segment_spmm(x, csr=csr)
        fresh = ops.prepare_edges(*args, E, torch.as_tensor(mask))
        assert torch.equal(got, segment_spmm_csr_ref(x, fresh.src_sorted, fresh.offsets))
        assert torch.equal(got, ops.segment_spmm(x, *args, edge_mask=torch.as_tensor(mask)))
    assert csr.src_sorted.shape == (E,) and csr.offsets.shape == (N + 1,)


def test_csr_form_takes_csr_or_edges_not_both():
    x = torch.ones((3, 2))
    src, dst = torch.tensor([0, 1, 2]), torch.tensor([1, 1, 0])
    csr = ops.prepare_edges(src, dst, 2, 3)
    np.testing.assert_array_equal(ops.segment_spmm(x, csr=csr).numpy(), [[1, 1], [2, 2]])
    with pytest.raises(ValueError, match="either csr"):
        ops.segment_spmm(x, src, dst, csr=csr)
    with pytest.raises(ValueError, match="required without a csr"):
        ops.segment_spmm(x)
    with pytest.raises(ValueError, match="indexes 3 rows of x, got 2"):
        ops.segment_spmm(x[:2], csr=csr)
