"""The per-launch check that ``chip_smoke.py`` holds each main-path
``flash_attention`` launch to: the relative norm of the difference over
each 64-row band of each sequence and head (``band_rel``), at the limit
``FLASH_REL_TOL``. Run here on the CPU against the plain version, with
outputs at the Yi-6B path's value scale (entries ~0.18, near-uniform
softmaxes, so the outputs are ~1e-2 and below), for the failure modes of
the kernels' tilings: 64-key tiles (fp32 SIMT), and 128-row CTAs of two
64-row warpgroups over 128-key tiles (bf16 tensor cores).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from test_torch_fixtures import _torch_test_env  # noqa: F401


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


# ------------------------------------------------ phase 17's pure-Python parts
def _moe_args(N=96, D=32, E=8, F=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, D, generator=g).bfloat16()
    router = torch.randn(D, E, generator=g).bfloat16()
    w = [(0.2 * torch.randn(*s, generator=g)).bfloat16() for s in ((E, D, F), (E, D, F),
                                                                     (E, F, D))]
    return (x, router, *w), dict(top_k=2, capacity_factor=0.5)


def test_moe_checks_count_drops_and_hold_bf16_to_fp32(monkeypatch):
    from repro_torch.lm import layers as lm_layers

    args, kw = _moe_args()
    r = cs.moe_layer_drops(lm_layers, args[0], args[1], kw)
    assert r["dropped"] == r["dropped_by_formula"] > 0  # capacity 0.5 drops pairs
    assert r["capacity"] == int(96 * 2 / 8 * 0.5)
    rel = cs.moe_dense_rel(lm_layers, args, kw, 64)
    assert 0 < rel <= cs.MOE_REL_TOL
    # a dispatch that keeps one pair past C shows in the dropped count
    inner = lm_layers.moe_dispatch
    monkeypatch.setattr(lm_layers, "moe_dispatch",
                        lambda e, E, C: inner(e, E, C + 1))
    r = cs.moe_layer_drops(lm_layers, args[0], args[1], kw)
    assert r["dropped"] != r["dropped_by_formula"]


def test_moe_dense_ref_is_moe_apply_in_fp32():
    """In fp32 the dense reference and ``moe_apply`` compute one function
    (drops included: capacity 0.5), in other orders."""
    from repro_torch.lm import layers as lm_layers

    (x, router, *w), kw = _moe_args()
    x, router, w = x.float(), router.float(), [t.float() for t in w]
    C = lm_layers.moe_capacity(x.shape[0], 2, 8, kw["capacity_factor"])
    _, gate, expert = lm_layers.moe_route(x, router, 2)
    want = cs.moe_dense_ref(x, gate, expert, *w, C)
    got = lm_layers.moe_apply(x, gate, expert, *w, C)
    assert want.dtype == torch.float32 and torch.allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("capacity", [1, 5, 24, 200])
def test_moe_kept_pairs_are_those_the_dispatch_keeps(capacity):
    from repro_torch.lm import layers as lm_layers

    (x, router, *_), _ = _moe_args()
    _, _, expert = lm_layers.moe_route(x, router, 2)
    order, _, keep = lm_layers.moe_dispatch(expert, 8, capacity)
    kept = torch.empty_like(keep)
    kept[order] = keep  # back to token-major pair order
    assert torch.equal(cs.moe_kept_pairs(expert, 8, capacity), kept.view(expert.shape))


@pytest.mark.parametrize("fault", ["rank_collision", "rank_skip", "gate_swap"])
def test_moe_dense_check_catches_a_wrong_dispatch_or_combine(monkeypatch, fault):
    """A dispatch whose ranks put two pairs in one slot (one token then
    reads the other's output) or skip a slot (the last pair within C is
    dropped), or a combine that weights each pair with the token's other
    gate, moves the output well past ``MOE_REL_TOL`` of the dense
    reference. (A consistent relabelling of slots changes nothing: the
    check is of the function, not of the layout.)"""
    from repro_torch.lm import layers as lm_layers

    args, kw = _moe_args()
    if fault == "gate_swap":
        inner = lm_layers.moe_apply
        monkeypatch.setattr(lm_layers, "moe_apply", lambda x, gate, *a: inner(
            x, gate.flip(-1), *a))
    else:
        inner = lm_layers.moe_dispatch

        def wrong(expert, E, C):
            order, slot, keep = inner(expert, E, C)
            rank = slot % C
            if fault == "rank_collision":  # rank 1 written as rank 0
                slot = torch.where(keep & (rank == 1), slot - 1, slot)
            else:  # ranks from 1: the pair at C - 1 falls off the end
                keep = keep & (rank < C - 1)
                slot = torch.where(keep, slot + 1, E * C)
            return order, slot, keep

        monkeypatch.setattr(lm_layers, "moe_dispatch", wrong)
    assert cs.moe_dense_rel(lm_layers, args, kw, 64) > cs.MOE_REL_TOL


def _train_attention_calls(seed=0):
    """One with-lse forward and one backward call, captured as a training
    run's are, bf16 at head dim 16."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator().manual_seed(seed)
    q, k, v = ((0.5 * torch.randn(2, 64, n, 16, generator=g)).bfloat16().requires_grad_(True)
               for n in (4, 2, 2))
    cap = cs.CallCapture((fa_ops, "_forward"), (fa_ops, "flash_attention_bwd"))
    with cap:
        o = fa_ops.flash_attention(q, k, v, causal=True)
        o.backward(torch.randn(o.shape, generator=g).bfloat16())
    return cap.calls["_forward"], cap.calls["flash_attention_bwd"]


def test_train_attention_check_holds_each_call():
    fwd, bwd = _train_attention_calls()
    assert len(fwd) == len(bwd) == 1 and fwd[0][1] == {"with_lse": True}
    worst = cs.check_train_attention_calls(fwd, bwd, " test")
    assert worst == dict(o_rel=0.0, o_band=0.0, lse_err=0.0, grad_rel=0.0)


@pytest.mark.parametrize("fault", ["dk_scaled", "lse_shifted", "o_tile_dropped"])
def test_train_attention_check_catches_a_wrong_call(monkeypatch, fault):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fwd, bwd = _train_attention_calls()
    if fault == "dk_scaled":
        inner = fa_ops.flash_attention_bwd

        def wrong(*a, **kw):
            dq, dk, dv = inner(*a, **kw)
            return dq, dk * 1.05, dv

        monkeypatch.setattr(fa_ops, "flash_attention_bwd", wrong)
    else:
        inner = fa_ops._forward

        def wrong(*a, **kw):
            o, lse = inner(*a, **kw)
            if fault == "lse_shifted":
                return o, lse + 1e-4
            return torch.cat([o[:, :32], o[:, 32:] * 0.9], 1), lse

        monkeypatch.setattr(fa_ops, "_forward", wrong)
    with pytest.raises(AssertionError):
        cs.check_train_attention_calls(fwd, bwd, " test")


def test_random_rotation_is_a_proper_rotation():
    q = cs.random_rotation(torch.Generator().manual_seed(2)).double()
    assert torch.allclose(q @ q.T, torch.eye(3, dtype=torch.float64), atol=1e-6)
    assert abs(float(torch.linalg.det(q)) - 1.0) < 1e-6


def test_zipf_logq_is_the_samplers_law():
    V = 1000
    perm = torch.randperm(V, generator=torch.Generator().manual_seed(3))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(V)
    logq = cs.zipf_logq(perm, inv)  # every id once: the masses sum to 1
    assert abs(float(logq.double().exp().sum()) - 1.0) < 1e-5
    ids = cs.zipf_ids(torch.Generator().manual_seed(4), perm, (200_000,))
    top = perm[:3]  # ranks 1-3
    freq = torch.stack([(ids == t).double().mean() for t in top])
    assert torch.allclose(freq, cs.zipf_logq(top, inv).double().exp(), rtol=0.05)


def test_embedding_bag_backward_bound_writes_the_dense_gradient_once():
    dout = torch.zeros(6, 4)
    ids = torch.zeros(6, 3, dtype=torch.int32)
    mask = torch.tensor([[1, 1, 0]] * 6, dtype=torch.bool)
    nbytes, ops = cs.eb_bwd_bound(dout, ids, mask, 100)
    assert nbytes == 6 * 4 * 4 + 6 * 3 * 4 + 6 * 3 + 100 * 4 * 4
    assert ops == 12 * 4


def test_embedding_bag_backward_passes_are_read_from_the_profile():
    by_kernel = {
        "embedding_bag_bwd_bounds_kernel(int const*, int*, int, int)": (1.0, 0.05),
        "void embedding_bag_bwd_chunks_kernel<true>(float const*, int const*)": (1.0, 0.1),
        "void embedding_bag_bwd_rows_kernel<float, true>(float const*, int const*)": (1.0, 3.8),
        "void embedding_bag_kernel<float, true>(float const*, int const*)": (1.0, 2.6),
        "void at::native::vectorized_elementwise_kernel<4>(int, float*)": (2.0, 0.2),
    }
    passes = cs.eb_bwd_passes(by_kernel)
    assert passes == {"bounds": dict(launches=1.0, device_ms=0.05),
                      "chunks": dict(launches=1.0, device_ms=0.1),
                      "rows": dict(launches=1.0, device_ms=3.8)}


# ---------------------------------------------------------------- phase 18
def test_alloc_matches_rounds_each_tensor_and_allows_a_large_blocks_tail():
    """A build's requested bytes equal its tensors'; the bytes held lie
    between each tensor rounded up to 512 bytes and that plus 1 MiB for
    each tensor over 1 MiB (a large block's unsplit tail)."""
    sizes = [100, 512, 3 * 2**20 + 5]
    lo = 512 + 512 + (3 * 2**20 + 512)
    req = sum(sizes)
    assert cs.alloc_matches(lo, req, sizes) and cs.alloc_matches(lo + 2**20, req, sizes)
    assert not cs.alloc_matches(lo - 512, req, sizes)
    assert not cs.alloc_matches(lo + 2**20 + 512, req, sizes)
    assert not cs.alloc_matches(lo, req + 1, sizes)
    assert cs.alloc_matches(1024, 612, [100, 512]) and not cs.alloc_matches(1536, 612, [100, 512])


def test_output_leaves_walks_a_steps_output():
    from repro_torch.lm.model import KVCache

    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    out = (z(2, 1, dt=torch.int32), KVCache(z(3, 4), z(3, 4)), {"loss": z(), "a": z(5)}, None, 7)
    assert cs.output_leaves(out) == [((2, 1), "torch.int32"), ((3, 4), "torch.float32"),
                                     ((3, 4), "torch.float32"), ((5,), "torch.float32"),
                                     ((), "torch.float32")]


def test_one_hop_sets_keep_edges_and_leaves_of_the_served_values():
    dst = np.array([[5, 6, 7], [8, 8, 9]])
    eprop = np.array([[1, 0, 1], [1, 1, 1]])
    vprop = np.array([[0, 0, 1], [0, 0, 1]])
    assert cs.one_hop_sets([0, 1], dst, eprop, vprop, edge_val=1, leaf_val=0) == [{5}, {8}]


def test_meta_cell_outputs_are_those_of_a_real_run():
    """The meta run's output leaves, held against the card's in phase 18,
    are those of the same cut cell run for real (here on the CPU), and its
    distinct tensors' bytes are the dry-run's argument bytes less none."""
    from repro_torch.configs import glm4_9b
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell

    kw = dict(cfg=glm4_9b.SMOKE, info=dict(seq_len=16, global_batch=2))
    want, sizes, out = cs.meta_cell("glm4-9b", "prefill_32k", make_debug_mesh(), **kw)
    step, _, args = build_cell("glm4-9b", "prefill_32k", make_debug_mesh(), device="cpu",
                               generator=torch.Generator().manual_seed(0), **kw)
    assert out == cs.output_leaves(step(*args))
    assert want == sum(sizes) == sum(t.numel() * t.element_size() for t in
                                     [*args[0]["layers"].values(), args[1],
                                      *(v for k, v in args[0].items() if k != "layers")])


class _FakeLM:
    def __init__(self, fn):
        self.flash_attention = fn


@pytest.mark.parametrize("fault", [None, "first band", "last band"])
def test_flash_band_check_holds_both_bands(monkeypatch, fault):
    """Phase 18's per-call check of the GLM4-9B prefill: the first and the
    last GLM_BAND query rows of every call against the plain version over
    those rows; a wrong row in either band fails it."""
    def kernel(q, k, v, **kw):
        out = flash_attention_ref(q, k, v, **kw).clone()
        if fault == "first band":
            out[:, 3] = out[:, 3] + 0.5
        elif fault == "last band":
            out[:, -2] = -out[:, -2]
        return out

    q, k, v = (t.float() for t in _inputs(5))
    with cs.FlashBandCheck(_FakeLM(kernel)) as chk:
        if fault is None:
            chk.mod.flash_attention(q, k, v, causal=True, window=None)
            assert chk.calls == 1 and chk.worst < 1e-6 and chk.last[0] is q
        else:
            with pytest.raises(AssertionError, match="differ from the plain version"):
                chk.mod.flash_attention(q, k, v, causal=True, window=None)


@pytest.mark.parametrize("fault", [None, "row"])
def test_spmm_check_holds_every_slice_of_rows(monkeypatch, fault):
    from types import SimpleNamespace

    from repro_torch.kernels.segment_spmm import ops as ss_ops

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    g = torch.Generator().manual_seed(3)
    n, E = 50, 300
    src, dst = torch.randint(0, n, (E,), generator=g), torch.randint(0, n, (E,), generator=g)
    csr = ss_ops.prepare_edges(src, dst, n, n)
    x = torch.randn(n, 4, generator=g)

    def csr_sum(x_, csr_, backward=False):
        out = ss_ops.csr_sum(x_, csr_)
        if fault:
            out[37, 1] += 1e-3
        return out

    fake = SimpleNamespace(csr_sum=csr_sum)
    with cs.SpmmCheck(fake, slices=7) as chk:
        if fault is None:
            fake.csr_sum(x, csr)
            assert chk.calls == 1 and chk.largest[0] == (n, 4) and chk.err < 1e-6
        else:
            with pytest.raises(AssertionError, match="rows 32..39 "):
                fake.csr_sum(x, csr)
    assert fake.csr_sum is csr_sum


def test_dryrun_line_prints_a_record():
    rec = dict(arch="glm4-9b", shape="train_4k", mesh="pod", fits_card=True, traced=True,
               memory=dict(argument_bytes=3 * 2**29), cost=dict(flops_global=8.16e16))
    assert cs.dryrun_line(rec) == ("dryrun glm4-9b train_4k pod: 1.500 GiB/device "
                                   "fits_card=True traced=True tflop=81600.000")
    rec.update(traced=False, cost=dict(flops_global=None))
    assert cs.dryrun_line(rec).endswith("traced=False tflop=-")
