"""The per-launch check that ``chip_smoke.py`` holds each main-path
``flash_attention`` launch to: the relative norm of the difference over
each 64-row band of each sequence and head (``band_rel``), at the limit
``FLASH_REL_TOL``. Run here on the CPU against the plain version, with
outputs at the Yi-6B path's value scale (entries ~0.18, near-uniform
softmaxes, so the outputs are ~1e-2 and below).
"""

import pytest
import torch

import chip_smoke as cs
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

S, H, KV, DH = 256, 2, 1, 64


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(0.18 * torch.randn(1, S, n, DH, generator=g)).bfloat16() for n in (H, KV, KV)]


def _dropping_tile(q, k, v, tile):
    """Attention as a kernel would compute it that skips key tile ``tile``
    (64 keys) for every row past it."""
    allowed = torch.ones(S, S, dtype=torch.bool).tril()
    lo = 64 * tile
    allowed[lo + 64:, lo:lo + 64] = False
    qs = (q * DH**-0.5).float()[0].view(S, KV, H // KV, DH).permute(1, 2, 0, 3)
    s = torch.einsum("kgqd,kcd->kgqc", qs, k.float()[0].permute(1, 0, 2))
    p = torch.softmax(s.masked_fill(~allowed, -1e30), -1)
    o = torch.einsum("kgqc,kcd->kgqd", p, v.float()[0].permute(1, 0, 2))
    return o.permute(2, 0, 1, 3).reshape(1, S, H, DH).bfloat16()


@pytest.mark.parametrize("tile", [0, 1, 2])
def test_band_check_catches_a_dropped_key_tile(tile):
    q, k, v = _inputs()
    want = flash_attention_ref(q, k, v)
    assert cs.band_rel(_dropping_tile(q, k, v, tile), want) > 10 * cs.FLASH_REL_TOL


def test_band_check_passes_bf16_rounding_and_sees_a_ragged_band():
    q, k, v = _inputs(1)
    want = flash_attention_ref(q, k, v)
    g = torch.Generator().manual_seed(2)
    # the same fp32 values moved by 1e-3 relative, then rounded to bf16
    noisy = (want.float() * (1 + 1e-3 * torch.randn(want.shape, generator=g))).bfloat16()
    assert cs.band_rel(noisy, want) < cs.FLASH_REL_TOL
    assert cs.band_rel(want, want) == 0.0
    # a ragged sequence (70 rows: one full band and one of 6): a wrong last
    # row shows in its own band
    got = want[:, :70].clone()
    got[:, 69] *= 1.5
    assert cs.band_rel(got, want[:, :70].contiguous()) > 10 * cs.FLASH_REL_TOL
    assert cs.rel_norm(got, want[:, :70]) < cs.band_rel(got, want[:, :70])
