"""Parity: the port's flash_attention (the plain version its wrapper runs
on the CPU) against the JAX package's ``lm.attention.flash_attention`` in
the LM layout, and against ``attention_ref`` and the Pallas
``flash_attention`` in interpret mode in their [B, H, S, d] layout with the
KV heads repeated, over ``tests/test_kernels.py``'s sweep plus GQA, window,
``q_offset`` and fully masked rows; and the port's ``decode_attention``
against the reference's.

Tolerances, as that sweep's: fp32 2e-5, bf16 2e-2 (one bf16 rounding of
the output; the Pallas kernel scales q in fp32, the reference and the port
round ``q * scale`` to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.lm.attention import decode_attention as j_decode, flash_attention as j_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.lm.attention import decode_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, Sq, Sk, H, KV, d, dtype):
    """q [B, Sq, H, d], k / v [B, Sk, KV, d]: the same values on both sides."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d)):
        j = jnp.asarray(rng.normal(size=shape).astype(np.float32), J_DTYPE[dtype])
        out.append((j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(T_DTYPE[dtype])))
    return out


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _bhsd(x, G=1):
    """[B, S, KV, d] -> [B, KV * G, S, d], each KV head repeated G times."""
    return jnp.repeat(x, G, axis=2).transpose(0, 2, 1, 3)


SHAPES = [
    (1, 1, 32, 32, 16, 16, 16),
    (2, 3, 64, 64, 32, 16, 32),
    (1, 2, 48, 96, 64, 16, 48),  # cross-attention lengths
]
# the sweep's cases less causal with Sq != Sk, which it skips (causal
# assumes aligned positions; q_offset covers that below)
SWEEP = [(*s, c, w) for s in SHAPES for c, w in [(True, None), (True, 16), (False, None)]
         if not (c and s[2] != s[3])]


@pytest.mark.parametrize("B,H,Sq,Sk,d,bq,bk,causal,window", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_against_reference_ref_and_pallas(B, H, Sq, Sk, d, bq, bk, dtype, causal, window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(Sq + Sk + d, B, Sq, Sk, H, H, d, dtype)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (B, Sq, H, d)
    _close(got, j_flash(qj, kj, vj, causal=causal, window=window, q_chunk=bq, k_chunk=bk), dtype)
    bhsd = lambda x: x.transpose(0, 2, 1, 3)
    ref = j_attention_ref(bhsd(qj), bhsd(kj), bhsd(vj), causal=causal, window=window)
    pallas = j_flash_pallas(bhsd(qj), bhsd(kj), bhsd(vj), causal=causal, window=window,
                            block_q=bq, block_k=bk)
    _close(got, bhsd(ref), dtype)
    _close(got, bhsd(pallas), dtype)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_against_reference_and_repeated_heads(dtype, window):
    """H 4 over KV 2: query head h reads KV head h // 2 (``repeat``, not
    ``tile``), as the reference's reshape to [B, S, KV, G, dh]."""
    B, S, H, KV, d = 2, 32, 4, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, B, S, S, H, KV, d, dtype)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    _close(got, j_flash(qj, kj, vj, causal=True, window=window, q_chunk=16, k_chunk=16), dtype)
    G = H // KV
    ref = j_attention_ref(_bhsd(qj), _bhsd(kj, G), _bhsd(vj, G), causal=True, window=window)
    pallas = j_flash_pallas(_bhsd(qj), _bhsd(kj, G), _bhsd(vj, G), causal=True, window=window,
                            block_q=16, block_k=16)
    _close(got, ref.transpose(0, 2, 1, 3), dtype)
    _close(got, pallas.transpose(0, 2, 1, 3), dtype)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 16),   # a suffix of the prompt against its whole cache
    (True, 4, 40),      # rows past Sk + window - 1 have no allowed key
    (False, 4, 48),     # non-causal window: the same fully masked rows
    (True, None, -3),   # rows at negative positions have no allowed key
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_offset_and_fully_masked_rows(dtype, causal, window, q_offset):
    """Query row i at position q_offset + i; a row with no allowed key gets
    the reference's mean of v over every key (scores -1e30, not -inf)."""
    B, Sq, Sk, H, KV, d = 1, 16, 32, 4, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = _qkv(11, B, Sq, Sk, H, KV, d, dtype)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window, q_offset=q_offset)
    want = j_flash(qj, kj, vj, causal=causal, window=window, q_chunk=16, k_chunk=16,
                   q_offset=q_offset)
    _close(got, want, dtype)
    assert torch.isfinite(got.to(torch.float32)).all()
    if q_offset in (40, 48, -3):
        row = 15 if q_offset > 0 else 0
        mean_v = vt.to(torch.float32).mean(1).repeat_interleave(H // KV, dim=1)  # [B, H, d]
        _close(got[:, row], mean_v.numpy(), dtype)


@pytest.mark.parametrize("window", [None, 0, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_against_reference(dtype, window):
    B, S, H, KV, d, pos = 2, 24, 4, 2, 16, 13
    (qj, qt), (kj, kt), (vj, vt) = _qkv(7, B, 1, S, H, KV, d, dtype)
    got = decode_attention(qt, kt, vt, pos, window=window)
    _close(got, j_decode(qj, kj, vj, pos, window=window), dtype)


def test_ref_is_the_wrapper_on_the_cpu_and_other_devices_raise():
    (_, qt), (_, kt), (_, vt) = _qkv(1, 1, 8, 8, 2, 1, 8, "float32")
    assert torch.equal(ops.flash_attention(qt, kt, vt), flash_attention_ref(qt, kt, vt))
    m = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(m, m, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_path_counts_no_launch_on_either_route(dtype):
    """The plain version on the CPU is no launch of either kernel: the three
    counters (all launches, the bf16 tensor-core route, the fp32 SIMT
    route) stay as they were."""
    (_, qt), (_, kt), (_, vt) = _qkv(2, 1, 16, 16, 4, 2, 16, dtype)
    before = (ops.launches, ops.launches_bf16_tc, ops.launches_f32_simt)
    ops.flash_attention(qt, kt, vt)
    assert (ops.launches, ops.launches_bf16_tc, ops.launches_f32_simt) == before
