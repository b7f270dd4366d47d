"""Parity: the port's embedding_bag (the plain version its wrapper runs on
the CPU) against the JAX package's ``recsys.embedding.embedding_bag`` and
its Pallas ``embedding_bag`` in interpret mode, at ``tests/test_kernels.py``'s
sweep, plus out-of-range ids, an all-masked bag and K = 1.

Tolerances, as that sweep's: fp32 1e-5 (sums in another order), bf16 5e-2
(the reference sums and divides in bf16, the port in fp32 rounded once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as j_bag_pallas
from repro.recsys.embedding import embedding_bag as j_bag, embedding_bag_flat as j_bag_flat
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.recsys.embedding import embedding_bag, embedding_bag_flat

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, V, D, B, K, dtype, id_lo=0, id_hi=None, p_mask=0.7):
    rng = np.random.default_rng(seed)
    t32 = rng.normal(size=(V, D)).astype(np.float32)
    tj = jnp.asarray(t32, J_DTYPE[dtype])
    tt = torch.as_tensor(np.array(tj.astype(jnp.float32))).to(T_DTYPE[dtype])
    ids = rng.integers(id_lo, V if id_hi is None else id_hi, (B, K)).astype(np.int32)
    mask = rng.random((B, K)) < p_mask
    return tj, tt, ids, mask


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,B,K,bb,bd", [(64, 32, 16, 4, 8, 16), (128, 64, 32, 8, 16, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_against_reference_and_pallas(V, D, B, K, bb, bd, dtype, mode):
    tj, tt, ids, mask = _inputs(V + D + K, V, D, B, K, dtype)
    got = ops.embedding_bag(tt, torch.as_tensor(ids), torch.as_tensor(mask), mode=mode)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (B, D)
    _close(got, j_bag(tj, jnp.asarray(ids), jnp.asarray(mask), mode=mode), dtype)
    pallas = j_bag_pallas(tj, jnp.asarray(ids), jnp.asarray(mask), mode=mode, block_b=bb,
                          block_d=bd)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edges_clipped_ids_empty_bag_and_k1(dtype, mode):
    """Ids below 0 and past V clip to the first and last row; a bag with
    every position masked is zero (mean divides by max(0, 1)); K = 1."""
    V, D, B, K = 48, 40, 12, 6
    tj, tt, ids, mask = _inputs(5, V, D, B, K, dtype, id_lo=-20, id_hi=V + 20)
    mask[3] = False
    assert (ids < 0).any() and (ids >= V).any()
    got = embedding_bag_ref(tt, torch.as_tensor(ids), torch.as_tensor(mask), mode=mode)
    _close(got, j_bag(tj, jnp.asarray(ids), jnp.asarray(mask), mode=mode), dtype)
    assert not got[3].to(torch.float32).any(), "an all-masked bag must be zero"
    one = embedding_bag_ref(tt, torch.as_tensor(ids[:, :1]), torch.as_tensor(mask[:, :1]),
                            mode=mode)
    _close(one, j_bag(tj, jnp.asarray(ids[:, :1]), jnp.asarray(mask[:, :1]), mode=mode), dtype)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_model_facing_forms(mode):
    """``recsys.embedding.embedding_bag`` with leading dims, without a mask
    and with weights, and ``embedding_bag_flat`` with an out-of-range
    segment, against the reference's, fp32 at 1e-5."""
    tj, tt, ids, mask = _inputs(9, 50, 24, 6, 5, "float32", id_hi=55)
    ids3, mask3 = ids.reshape(2, 3, 5), mask.reshape(2, 3, 5)
    w = np.random.default_rng(1).normal(size=ids3.shape).astype(np.float32)
    T = lambda a: torch.as_tensor(a)
    _close(embedding_bag(tt, T(ids3), T(mask3), mode=mode),
           j_bag(tj, jnp.asarray(ids3), jnp.asarray(mask3), mode=mode), "float32")
    _close(embedding_bag(tt, T(ids3), mode=mode), j_bag(tj, jnp.asarray(ids3), mode=mode),
           "float32")
    _close(embedding_bag(tt, T(ids3), T(mask3), mode=mode, weights=T(w)),
           j_bag(tj, jnp.asarray(ids3), jnp.asarray(mask3), mode=mode, weights=jnp.asarray(w)),
           "float32")
    flat = ids.reshape(-1)
    seg = np.repeat(np.arange(6), 5).astype(np.int32)
    seg[-1] = 7  # past n_bags: dropped
    _close(embedding_bag_flat(tt, T(flat), T(seg), 6, mode=mode, weights=T(w.reshape(-1))),
           j_bag_flat(tj, jnp.asarray(flat), jnp.asarray(seg), 6, mode=mode,
                      weights=jnp.asarray(w.reshape(-1))), "float32")


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_version_in_chunks(monkeypatch, mode):
    """The plain version walks the bags CHUNK at a time; a ragged last chunk
    gives what one step gives."""
    from repro_torch.kernels.embedding_bag import ref

    tj, tt, ids, mask = _inputs(13, 40, 16, 23, 6, "float32")
    monkeypatch.setattr(ref, "CHUNK", 5)
    got = ref.embedding_bag_ref(tt, torch.as_tensor(ids), torch.as_tensor(mask), mode=mode)
    _close(got, j_bag(tj, jnp.asarray(ids), jnp.asarray(mask), mode=mode), "float32")


def test_wrapper_refuses_other_devices_and_bad_modes():
    z = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.embedding_bag(torch.zeros((3, 2), device="meta"), z, z.bool())
    with pytest.raises(ValueError):
        embedding_bag_ref(torch.zeros((3, 2)), torch.zeros((4, 2), dtype=torch.int32),
                          torch.ones((4, 2), dtype=torch.bool), mode="max")


def _good_args(V=6, D=8, B=5, K=3):
    return (torch.zeros((V, D)), torch.zeros((B, K), dtype=torch.int32),
            torch.ones((B, K), dtype=torch.bool))


@pytest.mark.parametrize("bad", [
    "mode", "table_dtype", "table_dim", "table_strided", "ids_dtype", "ids_strided",
    "ids_dim", "mask_dtype", "mask_shape", "mask_strided", "empty_table", "ids_device",
])
def test_check_args_refuses_what_the_kernel_does_not_take(bad):
    """The checks a CUDA call passes before its launch, run here on CPU
    tensors: each malformed argument raises ValueError."""
    table, ids, mask = _good_args()
    mode = "sum"
    if bad == "mode":
        mode = "max"
    elif bad == "table_dtype":
        table = table.to(torch.float16)
    elif bad == "table_dim":
        table = table.reshape(-1)
    elif bad == "table_strided":
        table = torch.zeros((8, 6)).T
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_strided":
        ids = torch.zeros((3, 5), dtype=torch.int32).T
    elif bad == "ids_dim":
        ids = ids.reshape(-1)
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "mask_shape":
        mask = mask[:, :2]
    elif bad == "mask_strided":
        mask = torch.ones((3, 5), dtype=torch.bool).T
    elif bad == "empty_table":
        table = torch.zeros((0, 8))
    elif bad == "ids_device":
        ids = ids.to("meta")
    with pytest.raises(ValueError):
        ops.check_args(table, ids, mask, mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_args_accepts_the_kernels_inputs(dtype):
    table, ids, mask = _good_args()
    for mode in ("sum", "mean"):
        ops.check_args(table.to(dtype), ids, mask, mode)
    ops.check_args(table, torch.zeros((0, 3), dtype=torch.int32),
                   torch.zeros((0, 3), dtype=torch.bool), "sum")


@pytest.mark.parametrize("B,K,D", [(0, 4, 8), (5, 0, 8), (5, 4, 0)])
def test_empty_shapes_on_the_cpu_path(B, K, D):
    """No bags, empty bags and zero-width rows: the CPU path gives the
    reference's [B, D] (zeros), and counts no launch."""
    tj, tt, ids, mask = _inputs(2, 7, D, B, K, "float32")
    before = ops.launches
    for mode in ("sum", "mean"):
        got = ops.embedding_bag(tt, torch.as_tensor(ids), torch.as_tensor(mask), mode=mode)
        assert got.shape == (B, D) and got.dtype == torch.float32
        _close(got, j_bag(tj, jnp.asarray(ids), jnp.asarray(mask), mode=mode), "float32")
    assert ops.launches == before


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "sum"), (torch.bfloat16, "mean")])
def test_kernel_binding_passes_the_c_arguments(monkeypatch, dtype, mode):
    """``embedding_bag_cuda`` hands the C entry point the four pointers,
    then V, B, K, D, the mean flag and the bf16 flag, then the stream, and
    raises when the launch reports an error. The C call is a stand-in: no
    kernel runs here."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import kernel

    seen, err = [], [0]

    def fake_bind(name, symbol, n_pointers, n_ints):
        assert (name, symbol, n_pointers, n_ints) == ("embedding_bag", "embedding_bag_launch",
                                                      4, 6)
        return lambda *a: seen.append(a) or err[0]

    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 1234})())
    table, ids, mask = _good_args(V=9, D=16, B=4, K=5)
    table = table.to(dtype)
    out = kernel.embedding_bag_cuda(table, ids, mask, mean=mode == "mean")
    assert out.shape == (4, 16) and out.dtype == dtype
    (a,) = seen
    assert a == (table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 9, 4, 5, 16, int(mode == "mean"), int(dtype == torch.bfloat16), 1234)
    err[0] = 9
    with pytest.raises(RuntimeError, match="cudaError 9"):
        kernel.embedding_bag_cuda(table, ids, mask, mean=False)
