"""The per-launch check that ``chip_smoke.py`` holds each main-path
``flash_attention`` launch to: the relative norm of the difference over
each 64-row band of each sequence and head (``band_rel``), at the limit
``FLASH_REL_TOL``. Run here on the CPU against the plain version, with
outputs at the Yi-6B path's value scale (entries ~0.18, near-uniform
softmaxes, so the outputs are ~1e-2 and below), for the failure modes of
the kernels' tilings: 64-key tiles (fp32 SIMT), and 128-row CTAs of two
64-row warpgroups over 128-key tiles (bf16 tensor cores).
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


TC_ROWS = TC_KEYS = 128  # the bf16 kernel's query rows per CTA and keys per tile
S_TC = 3 * TC_ROWS  # three row tiles: every key tile but the last has rows past it


def _tc_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    return [(0.18 * torch.randn(1, S_TC, n, DH, generator=g)).bfloat16() for n in (H, KV, KV)]


def _tc_online(q, k, v, *, drop_tile=None, stale_second_half=False):
    """Causal attention as the bf16 kernel walks it: each 128-row CTA walks
    the 128-key tiles up to its diagonal with an online softmax (running
    max m, sum l, accumulator o; p rounded to bf16 before the product with
    v). ``drop_tile``: that key tile is never added. ``stale_second_half``:
    the rows of each CTA's second 64-row warpgroup never store their new
    running max (it stays at its initial -1e30), so every tile's correction
    factor wipes what came before."""
    qs = (q * DH**-0.5).float()[0].view(S_TC, KV, H // KV, DH).permute(1, 2, 0, 3)
    kk, vv = (x.float()[0].permute(1, 0, 2)[:, None] for x in (k, v))  # [KV, 1, S, DH]
    rows = torch.arange(S_TC)
    stale = (rows % TC_ROWS >= 64)[:, None] if stale_second_half else torch.zeros(S_TC, 1, dtype=torch.bool)
    m = torch.full(qs.shape[:-1] + (1,), -1e30)
    l, o = torch.zeros_like(m), torch.zeros_like(qs)
    for t in range(S_TC // TC_KEYS):
        keys = torch.arange(t * TC_KEYS, (t + 1) * TC_KEYS)
        walks = (rows // TC_ROWS >= t)[:, None]  # the CTA's key range reaches this tile
        if t == drop_tile:
            continue
        s = torch.einsum("kgqd,kzcd->kgqc", qs, kk[:, :, keys])
        s = torch.where(keys[None, :] <= rows[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = torch.where(walks, l * corr + p.sum(-1, keepdim=True), l)
        pv = torch.einsum("kgqc,kzcd->kgqd", p.bfloat16().float(), vv[:, :, keys])
        o = torch.where(walks, o * corr + pv, o)
        m = torch.where(walks & ~stale, m_new, m)
    out = o / l.clamp(min=1e-30)
    return out.permute(2, 0, 1, 3).reshape(1, S_TC, H, DH).bfloat16()


def test_tc_tiling_simulation_passes_the_band_check():
    """The bf16 kernel's walk without a fault is within the limit: the band
    check leaves room for its other rounding points."""
    q, k, v = _tc_inputs(3)
    assert cs.band_rel(_tc_online(q, k, v), flash_attention_ref(q, k, v)) < cs.FLASH_REL_TOL


@pytest.mark.parametrize("tile", [0, 1])
def test_band_check_catches_a_dropped_128_key_tile(tile):
    q, k, v = _tc_inputs(4)
    got = _tc_online(q, k, v, drop_tile=tile)
    assert cs.band_rel(got, flash_attention_ref(q, k, v)) > 10 * cs.FLASH_REL_TOL


def test_band_check_catches_a_stale_running_max_in_the_second_warpgroup():
    q, k, v = _tc_inputs(5)
    want = flash_attention_ref(q, k, v)
    got = _tc_online(q, k, v, stale_second_half=True)
    assert cs.band_rel(got, want) > 10 * cs.FLASH_REL_TOL
    # only the second warpgroup's rows of CTAs that walk two or more tiles
    # are wrong: the first 128 rows (one tile) and every first half agree
    first = torch.cat([got[:, c * TC_ROWS:c * TC_ROWS + 64] for c in range(3)], 1)
    first_want = torch.cat([want[:, c * TC_ROWS:c * TC_ROWS + 64] for c in range(3)], 1)
    assert cs.band_rel(first, first_want) < cs.FLASH_REL_TOL
    assert cs.band_rel(got[:, :TC_ROWS], want[:, :TC_ROWS].contiguous()) < cs.FLASH_REL_TOL


# ``ptxas -v`` as nvcc 12 prints it for two backward kernels (their
# anonymous namespace mangled with the file's hash): a tensor-core
# instantiation and an fp32 SIMT one that spills
PTXAS_TC = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d3032flash_attention_bwd_dq_tc_kernelILi256EEEv14CUtensorMap_stS1_S1_S1_PK13__nv_bfloat16S4_PKfPS2_Pfiiiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d3032flash_attention_bwd_dq_tc_kernelILi256EEEv14CUtensorMap_stS1_S1_S1_PK13__nv_bfloat16S4_PKfPS2_Pfiiiiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 216 registers, used 1 barriers, 1024 bytes cmem[0]
"""
PTXAS_SIMT = """ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d3029flash_attention_bwd_dq_kernelILi64EfEEvPKT0_S3_S3_S3_S3_PKfPS1_Pfiiiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d3029flash_attention_bwd_dq_kernelILi64EfEEvPKT0_S3_S3_S3_S3_PKfPS1_Pfiiiiiiiiif
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 452 bytes cmem[0]
"""
PTXAS = PTXAS_TC + PTXAS_SIMT


def test_ptxas_report_gives_each_kernels_registers_and_spills(monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setitem(_build.BUILD_INFO, "ptxas", {"flash_attention_bwd": PTXAS})
    assert cs.ptxas_kernels("flash_attention_bwd") == {
        "flash_attention_bwd_dq_tc_kernel<256>": {"registers": 216, "spill_bytes": 0},
        "flash_attention_bwd_dq_kernel<64><float>": {"registers": 128, "spill_bytes": 12},
    }
    assert cs.ptxas_kernels("segment_spmm") is None


def test_bwd_build_check_refuses_a_spilling_tensor_core_kernel(monkeypatch):
    """Phase 16's build check asks for all six bf16 instantiations (dq and
    dk / dv at DHP 64, 128, 256) with no spill; the fp32 SIMT kernels are
    reported but not held to it."""
    from repro_torch.kernels import _build

    def report(spill):
        blocks = []
        for fn in ("32flash_attention_bwd_dq_tc_kernel", "34flash_attention_bwd_dkdv_tc_kernel"):
            for dhp in (64, 128, 256):
                blocks.append(
                    "ptxas info    : Compiling entry function "
                    f"'_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d30{fn}ILi{dhp}EEEv'"
                    f" for 'sm_90a'\n    0 bytes stack frame, {spill if dhp == 256 else 0} bytes "
                    "spill stores, 0 bytes spill loads\nptxas info    : Used 200 registers\n")
        return "".join(blocks) + PTXAS_SIMT

    monkeypatch.setitem(_build.BUILD_INFO, "ptxas", {"flash_attention_bwd": report(0)})
    assert len(cs.check_bwd_build()) == 7
    monkeypatch.setitem(_build.BUILD_INFO, "ptxas", {"flash_attention_bwd": report(16)})
    with pytest.raises(AssertionError, match="spills"):
        cs.check_bwd_build()
