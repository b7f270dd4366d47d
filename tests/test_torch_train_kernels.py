"""Parity of the training path's kernels' gradients on the CPU: the
flash-attention backward and ``segment_spmm``'s, and PNA's ``train_step``
through them, against the JAX package.

- The attention backward's plain version (``flash_attention_bwd_ref``,
  which the wrapper's ``autograd.Function`` runs on the CPU) against
  ``jax.vjp`` of ``repro.lm.attention.flash_attention``: causal, window,
  GQA, ``q_offset`` and rows with no allowed key, fp32, 1e-5 (fp32 sums in
  another order).
- The CUDA backward kernels' decomposition (``csrc/flash_attention_bwd.cu``:
  the dq kernel's walk over its band's key tiles, the dk / dv kernel's walk
  over the query tiles that reach its keys, tiles of 64 rows, 32 at head
  dim 256) simulated tile by tile in torch and held to the plain version,
  1e-5.
- ``segment_spmm``'s gradient (the kernel's function over the transposed
  edge list) against ``jax.grad`` of ``jax.ops.segment_sum``, 1e-5.
- PNA's ``train_step`` against ``repro.gnn.models.train_step`` on SMOKE,
  1e-4 (its forward's tolerance). ``scatter_max`` / ``scatter_min`` take
  autograd's gradient of ``scatter_reduce`` as the reference takes
  ``segment_max``'s: both split a tie evenly, and ties among random float
  messages have probability zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn import models as JGM
from repro.lm.attention import flash_attention as j_flash
from repro.optim import adamw as j_adamw, chain as j_chain, clip_by_global_norm as j_clip
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import pna as pna_cfg
from repro_torch.gnn import GNNConfig
from repro_torch.gnn import graph as TG
from repro_torch.gnn import models as TGM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, band_mask, flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.segment_spmm import ops as ss_ops
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.optim.adamw import value_and_grad
from test_torch_gnn import _batch, _both, _params

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# name: B, Sq, Sk, H, KV, dh, causal, window, q_offset
ATTN_CASES = {
    "causal": (2, 32, 32, 4, 4, 16, True, None, 0),
    "window": (1, 48, 48, 4, 2, 16, True, 8, 0),
    "gqa_g4": (1, 32, 32, 8, 2, 32, True, None, 0),
    "q_offset": (2, 16, 40, 4, 2, 16, True, None, 24),
    "q_offset_window": (1, 16, 40, 2, 1, 24, True, 10, 24),
    "negative_q_offset_empty_rows": (1, 24, 16, 2, 1, 16, True, None, -5),
    "non_causal_window_empty_rows": (1, 24, 16, 2, 2, 16, False, 3, 15),
}


def _attn_inputs(case, seed=0):
    B, Sq, Sk, H, KV, dh = ATTN_CASES[case][:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh), (B, Sq, H, dh))]


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_backward_matches_jax_vjp(case):
    """dq, dk, dv of the wrapper's ``autograd.Function`` (the forward with
    its lse, then the plain backward) against ``jax.vjp`` of the
    reference's attention, and the forward's lse against a direct
    log-sum-exp."""
    B, Sq, Sk, H, KV, dh, causal, window, off = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(case)
    fn = lambda q, k, v: j_flash(q, k, v, causal=causal, window=window, q_chunk=Sq,
                                 k_chunk=Sk, q_offset=off)
    jo, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=off)
    assert o.grad_fn is not None and type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    _close(o, jo)
    dq, dk, dv = torch.autograd.grad(o, (tq, tk, tv), torch.as_tensor(do))
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got, want)
    _, lse = flash_attention_ref(tq.detach(), tk.detach(), tv.detach(), causal=causal,
                                 window=window, q_offset=off, with_lse=True)
    allowed = band_mask(Sq, Sk, causal=causal, window=window, q_offset=off, device="cpu")
    s = torch.einsum("bqhd,bkhd->bhqk", tq.detach() * dh**-0.5,
                     tk.detach().repeat_interleave(H // KV, dim=2))
    want = torch.logsumexp(torch.where(allowed, s, NEG_INF), -1)
    _close(lse, want)
    empty = ~allowed.any(-1)
    assert bool((lse[..., empty] == NEG_INF).all())
    if case.endswith("empty_rows"):
        assert bool(empty.any())


def _key_range(pf, pl, sk, causal, window):
    """The kernels' key_range."""
    lo = lambda p: max(0, p - window + 1) if window else 0
    hi = lambda p: min(sk, p + 1) if causal else sk
    if lo(pf) >= hi(pf) or lo(pl) >= hi(pl):
        return 0, sk
    return lo(pf), hi(pl)


def _qtile_walk(k0, sq, sk, causal, window, off, T=64):
    """The bf16 dk / dv kernel's ``qtile_walk``: the query tiles its CTA for
    keys [k0, k0 + 64) walks, in order (up to three runs, computed
    directly)."""
    nq, last = -(-sq // T), off + sq - 1
    cdiv = lambda a: -((-a) // T)
    f1 = min(max(cdiv(-off), 0), nq) if causal else 0
    f3 = nq
    if window > 0 and last >= sk + window - 1:
        f3 = min(max(cdiv(sk + window - 1 - off - (T - 1)), 0), nq - 1)
    f3 = max(f3, f1)
    a, b = 0, nq
    if causal:
        a = min(max(cdiv(k0 - off - (T - 1)), 0), nq - 1) if last >= k0 else nq
    if window > 0:
        b = min(max((k0 + T - 2 + window - off) // T + 1, 0), nq)
    a, b = max(a, f1), min(b, f3)
    return list(range(f1)) + list(range(a, max(a, b))) + list(range(f3, nq))


def _qtiles_reaching(k0, sq, sk, causal, window, off, T=64):
    """Every query tile whose rows' key range reaches keys [k0, k0 + T),
    found one tile at a time (the SIMT kernel's ``continue``)."""
    out = []
    for q0 in range(0, sq, T):
        lo, hi = _key_range(off + q0, off + min(q0 + T, sq) - 1, sk, causal, window)
        if lo < k0 + T and hi > k0:
            out.append(q0 // T)
    return out


def simulate_backward_kernels(q, k, v, o, do, lse, *, causal, window, q_offset, design="simt"):
    """``csrc/flash_attention_bwd.cu``, tile by tile, in either design.

    ``simt`` (the fp32 kernels): the dq kernel (one CTA per BT query rows
    and head: delta, then its band's key tiles) and the dk / dv kernel (one
    CTA per BT keys and KV head: its G heads' query tiles, skipping those
    that reach none of its keys), BT 64, 32 at head dim 256.

    ``tc`` (the bf16 tensor-core kernels): the dq kernel's CTA holds 64 NWG
    query rows (NWG 2 up to a padded head dim DHP of 128, 1 at 256) and
    walks 64-key tiles of its rows' key range, each warpgroup masking only a
    tile that crosses its band edge or Sk; the dk / dv kernel's CTA holds 64
    keys and walks its G heads' query tiles by ``qtile_walk`` (held here to
    the tiles found one at a time), the last tile first, masking only a
    tile that crosses the band edge or Sk, with a row that has no allowed
    key at p = 1 / Sk, ds = 0. For bf16 inputs p and ds are rounded to bf16
    before their products.

    Each tile's scores and probabilities as the kernels form them (rows past
    Sq with lse +inf, keys past Sk staged as zeros)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, dh**-0.5
    tc = design == "tc"
    BT = 64 if tc or dh <= 128 else 32
    w = window or 0
    f = lambda t: t.to(torch.float32)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if tc and q.dtype == torch.bfloat16 else f
    qs = f(q * scale)
    dq, dk, dv = (torch.zeros(t.shape, dtype=torch.float32) for t in (q, k, v))
    delta = (f(do) * f(o)).sum(-1).permute(0, 2, 1)  # [B, H, Sq]

    def tile(x, r0, rows):  # rows [r0, r0 + BT) of [S, dh], zeros past rows
        out = torch.zeros(BT, dh)
        n = max(0, min(BT, rows - r0))
        out[:n] = x[r0:r0 + n]
        return out

    def probs(b, h, q0, k0, Qs, Os, Ks, Vs, edge=True):
        rows, keys = q0 + torch.arange(BT), k0 + torch.arange(BT)
        lr = torch.where(rows < Sq, lse[b, h, rows.clamp(max=Sq - 1)], torch.inf)[:, None]
        dd = torch.where(rows < Sq, delta[b, h, rows.clamp(max=Sq - 1)], 0.0)[:, None]
        s, dp = Qs @ Ks.T, Os @ Vs.T
        pos = (q_offset + rows)[:, None]
        ok = (keys[None] < Sk) & ((keys[None] <= pos) | (not causal)) & (
            (keys[None] > pos - w) | (w <= 0))
        if not edge:  # a tile the kernels take as wholly allowed
            ok = torch.ones_like(ok)
        empty = lr <= 0.5 * NEG_INF
        p = torch.where(ok & ~empty & (lr < torch.inf), torch.exp(s - lr), 0.0)
        p = torch.where(empty & (keys[None] < Sk), 1.0 / max(Sk, 1), p)
        ds = torch.where(ok & ~empty, p * (dp - dd), 0.0)
        return p, ds

    def crosses(k0, pf, pl):  # the tensor-core kernels' test for a tile that needs the mask
        return k0 + BT > Sk or (causal and k0 + BT - 1 > pf) or (w > 0 and k0 <= pl - w)

    rows_cta = BT * (2 if dh <= 128 else 1) if tc else BT
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for c0 in range(0, Sq, rows_cta):
                lo, hi = _key_range(q_offset + c0, q_offset + min(c0 + rows_cta, Sq) - 1, Sk,
                                    causal, w)
                for q0 in range(c0, min(c0 + rows_cta, Sq), BT):
                    Qs, Os = tile(qs[b, :, h], q0, Sq), tile(f(do[b, :, h]), q0, Sq)
                    acc = torch.zeros(BT, dh)
                    for kt in range(lo, hi, BT):
                        Ks, Vs = tile(f(k[b, :, kvh]), kt, Sk), tile(f(v[b, :, kvh]), kt, Sk)
                        edge = not tc or crosses(kt, q_offset + q0, q_offset + q0 + BT - 1)
                        _, ds = probs(b, h, q0, kt, Qs, Os, Ks, Vs, edge)
                        acc += rnd(ds) @ Ks
                    n = min(BT, Sq - q0)
                    dq[b, q0:q0 + n, h] = acc[:n] * scale
        for kvh in range(KV):
            for k0 in range(0, Sk, BT):
                Ks, Vs = tile(f(k[b, :, kvh]), k0, Sk), tile(f(v[b, :, kvh]), k0, Sk)
                dka, dva = torch.zeros(BT, dh), torch.zeros(BT, dh)
                reach = _qtiles_reaching(k0, Sq, Sk, causal, w, q_offset, BT)
                if tc:
                    walk = _qtile_walk(k0, Sq, Sk, causal, w, q_offset, BT)
                    assert walk == reach, (k0, walk, reach)
                for g in range(G):
                    h = kvh * G + g
                    for qt in (reversed(reach) if tc else reach):
                        q0 = qt * BT
                        Qs, Os = tile(qs[b, :, h], q0, Sq), tile(f(do[b, :, h]), q0, Sq)
                        edge = not tc or crosses(k0, q_offset + q0, q_offset + q0 + BT - 1)
                        p, ds = probs(b, h, q0, k0, Qs, Os, Ks, Vs, edge)
                        dva += rnd(p).T @ Os
                        dka += rnd(ds).T @ Qs
                n = min(BT, Sk - k0)
                dk[b, k0:k0 + n, kvh], dv[b, k0:k0 + n, kvh] = dka[:n], dva[:n]
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


# the kernels' tilings: several 64-row tiles (a ragged last one), 32-row
# tiles at dh 256 (SIMT), one 64-row warpgroup a dq CTA at dh 256 (tensor
# cores), bands that skip tiles, rows with no allowed key at both ends, a
# GQA group of 4 walked by one dk / dv CTA over several query tiles a key
# tile
TILE_CASES = {
    "causal_window_ragged": (1, 150, 150, 4, 2, 16, True, 40, 0),
    "dh256_causal": (1, 100, 100, 2, 1, 256, True, None, 0),
    "dh256_window": (1, 100, 100, 2, 2, 256, True, 24, 0),
    "gqa4_dh256_window": (1, 300, 300, 8, 2, 256, True, 100, 0),
    "negative_offset_empty_rows": (1, 130, 80, 2, 1, 16, True, None, -70),
    "non_causal_window_empty_tail": (1, 140, 70, 2, 1, 24, False, 8, 20),
    "q_offset_decode_like": (2, 20, 200, 4, 1, 32, True, 64, 180),
}


def _tile_inputs(case, dtype):
    B, Sq, Sk, H, KV, dh = TILE_CASES[case][:6]
    rng = np.random.default_rng(1)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh), (B, Sq, H, dh))]


@pytest.mark.parametrize("case,design", [
    pytest.param(c, d, id=c if d == "simt" else f"{c}-{d}")
    for d in ("simt", "tc") for c in sorted(TILE_CASES)])
def test_backward_kernel_tiling_simulated(case, design):
    """Each design's tiling on fp32 values against the plain backward, 1e-5;
    the tensor-core design also on bf16 values (p and ds rounded to bf16
    before their products, outputs in bf16) within 2e-2 relative norm of
    the fp32 yardstick: the plain backward of the same values in fp32."""
    causal, window, off = TILE_CASES[case][6:]
    kw = dict(causal=causal, window=window, q_offset=off)
    q, k, v, do = _tile_inputs(case, torch.float32)
    o, lse = flash_attention_ref(q, k, v, with_lse=True, **kw)
    got = simulate_backward_kernels(q, k, v, o, do, lse, design=design, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for a, b in zip(got, want):
        _close(a, b)
    if design == "tc":
        x = _tile_inputs(case, torch.bfloat16)
        o16, lse16 = flash_attention_ref(*x[:3], with_lse=True, **kw)
        got = simulate_backward_kernels(*x[:3], o16, x[3], lse16, design=design, **kw)
        f = [t.float() for t in x]
        o32, lse32 = flash_attention_ref(*f[:3], with_lse=True, **kw)
        want = flash_attention_bwd_ref(*f[:3], o32, f[3], lse32, **kw)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            rel = float((a.float() - b).norm() / b.norm())
            assert rel <= 2e-2, rel


WALK_SHAPES = [  # Sq, Sk, causal, window, q_offset
    (4096, 4096, True, 0, 0), (4096, 4096, True, 1024, 0), (1000, 1000, True, 0, 0),
    (333, 517, False, 0, 0), (100, 700, True, 256, 600), (130, 80, True, 0, -70),
    (140, 70, False, 8, 20), (20, 200, True, 64, 180), (300, 90, True, 30, -100),
    (64, 2, True, 3, -10), (257, 129, False, 40, -60), (190, 250, True, 65, 37),
]


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_qtile_walk_is_the_tiles_that_reach_each_key_tile(shape):
    """The bf16 dk / dv kernel's directly computed walk (which its producer
    and consumers both take) is, for every key tile, exactly the query
    tiles whose key range reaches it, in increasing order: Gemma3-4B's two
    layers and the phase-16 shapes, rows with no allowed key at either end,
    a tile that has both."""
    sq, sk, causal, window, off = shape
    for k0 in range(0, sk, 64):
        assert _qtile_walk(k0, sq, sk, causal, window, off) == \
            _qtiles_reaching(k0, sq, sk, causal, window, off), k0


def test_attention_backward_bf16_against_fp32():
    """bf16 inputs: the plain backward in bf16 within 2e-2 relative norm of
    the fp32 one on the same values (the yardstick the card's check uses)."""
    case = "gqa_g4"
    B, Sq, Sk, H, KV, dh, causal, window, off = ATTN_CASES[case]
    x = [torch.as_tensor(a).to(torch.bfloat16) for a in _attn_inputs(case, 2)]
    kw = dict(causal=causal, window=window, q_offset=off)
    o, lse = flash_attention_ref(*x[:3], with_lse=True, **kw)
    got = flash_attention_bwd_ref(*x[:3], o, x[3], lse, **kw)
    f = [t.float() for t in x]
    o32, lse32 = flash_attention_ref(*f[:3], with_lse=True, **kw)
    want = flash_attention_bwd_ref(*f[:3], o32, f[3], lse32, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        rel = float((a.float() - b).norm() / b.norm())
        assert rel <= 2e-2, rel


def _misaligned_like(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary, as a view into a larger buffer can."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == t.element_size()
    return out


def test_backward_refuses_misaligned_bf16_o_and_do():
    """The bf16 backward kernels read o and do by TMA and 16-byte loads: the
    wrapper's check refuses either one off a 16-byte boundary, as it does
    q, k and v."""
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    o, do, lse = torch.zeros_like(q), torch.zeros_like(q), torch.zeros(1, 2, 8)
    fa_ops._check_grads(q, o, do, lse)
    for args in ((q, _misaligned_like(o), do, lse), (q, o, _misaligned_like(do), lse)):
        with pytest.raises(ValueError, match="16-byte"):
            fa_ops._check_grads(*args)
    fa_ops._check_grads(q.float(), o.float(), _misaligned_like(do.float()), lse)  # fp32: SIMT


def test_autograd_hands_the_backward_an_aligned_do(monkeypatch):
    """An upstream gradient that autograd hands over misaligned reaches the
    backward as an aligned copy of the same values."""
    seen = []
    inner = fa_ops.flash_attention_bwd
    monkeypatch.setattr(fa_ops, "flash_attention_bwd",
                        lambda *a, **k: seen.append(a[4]) or inner(*a, **k))
    q, k, v, do = (torch.as_tensor(x).bfloat16() for x in _attn_inputs("causal"))
    q.requires_grad_()
    o = fa_ops.flash_attention(q, k, v)
    g = _misaligned_like(do)
    dq, = torch.autograd.grad(o, q, g)
    (got,) = seen
    assert got.data_ptr() % 16 == 0 and torch.equal(got, do)
    want = flash_attention_bwd_ref(q.detach(), k, v, o.detach(), do,
                                   flash_attention_ref(q.detach(), k, v, with_lse=True)[1])[0]
    assert torch.equal(dq, want)


def test_prefill_path_writes_no_lse(monkeypatch):
    """Without a gradient, the wrapper takes the forward alone (no lse), as
    prefill always did."""
    seen = []
    inner = fa_ops.flash_attention_ref
    monkeypatch.setattr(fa_ops, "flash_attention_ref",
                        lambda *a, **k: seen.append(k.get("with_lse", False)) or inner(*a, **k))
    q, k, v, _ = (torch.as_tensor(x) for x in _attn_inputs("causal"))
    fa_ops.flash_attention(q, k, v)
    with torch.no_grad():
        fa_ops.flash_attention(q.requires_grad_(), k, v)
    assert seen == [False, False]
    fa_ops.flash_attention(q, k, v)
    assert seen[-1] is True


# ------------------------------------------------------------ segment_spmm
def _edges(seed, N, E, n_out):
    """Edges with masked ones, destinations past n_out and negative, and
    negative sources (jnp's gather wraps them once). A source past N reads
    row N - 1 (jnp's clamp) in both packages, but jax's gradient drops it
    where the transposed CSR sends it to that row; no caller passes one
    (PNA's sums read edge rows by their ids)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-3, N, E).astype(np.int32)
    dst = rng.integers(-2, n_out + 2, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    return src, dst, mask


@pytest.mark.parametrize("form", ["per_call", "csr", "csr_transposed_once"])
def test_segment_spmm_gradient_matches_jax(form):
    N, E, n_out, D = 40, 300, 30, 7
    src, dst, mask = _edges(3, N, E, n_out)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, D)).astype(np.float32)
    up = rng.standard_normal((n_out, D)).astype(np.float32)

    def jfn(x):
        keep = jnp.asarray(mask) & (jnp.asarray(dst) >= 0) & (jnp.asarray(dst) < n_out)
        vals = jnp.where(keep[:, None], x[jnp.asarray(src)], 0)
        return jax.ops.segment_sum(vals, jnp.asarray(dst), num_segments=n_out)

    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(up))
    tx = torch.tensor(x, requires_grad=True)
    args = (torch.as_tensor(src), torch.as_tensor(dst), n_out, torch.as_tensor(mask))
    if form == "per_call":
        out = ss_ops.segment_spmm(tx, *args)
    else:
        csr = ss_ops.prepare_edges(args[0], args[1], n_out, N, args[3],
                                   transpose=form == "csr_transposed_once")
        assert (csr.transpose is not None) == (form == "csr_transposed_once")
        if form == "csr":  # the backward walks a transpose built with the CSR, or none
            with pytest.raises(ValueError, match="transpose"):
                ss_ops.segment_spmm(tx, csr=csr)
            with torch.no_grad():
                _close(ss_ops.segment_spmm(tx, csr=csr), jout)
            csr = ss_ops.prepare_edges(args[0], args[1], n_out, N, args[3], transpose=True)
        out = ss_ops.segment_spmm(tx, csr=csr)
    assert type(out.grad_fn).__name__ == "SegmentSpmmFnBackward"
    _close(out, jout)
    (dx,) = torch.autograd.grad(out, tx, torch.as_tensor(up))
    _close(dx, jdx)


def test_transposed_csr_of_edge_rows_holds_one_edge_a_row():
    """PNA's sums run over edge rows (``src`` = edge ids): the transposed CSR
    has one row an edge, holding its destination if the edge is kept and
    nothing otherwise; the degrees take no gradient."""
    d = _batch(7, 32, 100, 3, 2)
    dst, em = torch.as_tensor(d["edge_dst"]), torch.as_tensor(d["edge_mask"])
    csr = TG.edge_csr(dst, 32, em, transpose=True)
    t = csr.transpose
    assert (t.n_nodes, t.n_src) == (100, 32)
    counts = (t.offsets[1:] - t.offsets[:-1]).numpy()
    keep = em.numpy() & (d["edge_dst"] >= 0) & (d["edge_dst"] < 32)
    np.testing.assert_array_equal(counts, keep.astype(np.int32))
    np.testing.assert_array_equal(t.src_sorted[:int(keep.sum())].numpy(), d["edge_dst"][keep])
    ones = torch.ones((100, 1))
    assert not TG.degrees(dst, 32, em, csr).requires_grad and not ones.requires_grad


# ------------------------------------------------------------ PNA training
def test_pna_train_step_matches_reference():
    """PNA SMOKE under clip + AdamW: the loss's gradients within 1e-4 of
    ``jax.grad``'s, two ``train_step``s' losses within 1e-4 of the
    reference's and the parameters after the first within lr x 1e-2 (Adam's
    first step is about lr x sign(g): a gradient near 0 may move its
    parameter by another fraction of lr), and every segment sum that takes
    a gradient run through ``segment_spmm`` forward and backward (over the
    transposed CSR)."""
    cfg_kw = {f: getattr(pna_cfg.SMOKE, f) for f in pna_cfg.SMOKE.__dataclass_fields__}
    from repro.gnn import GNNConfig as JConfig

    jcfg, tcfg = JConfig(**cfg_kw), GNNConfig(**cfg_kw)
    jp, tp = _params(cfg_kw, 8)
    jg, tg = _both(_batch(9, 96, 400, cfg_kw["d_in"], cfg_kw["n_classes"]))
    jgrads = jax.grad(lambda p: JGM.loss_fn(jcfg, p, jg))(jp)
    _, tgrads = value_and_grad(lambda p: TGM.loss_fn(tcfg, p, tg), tp)
    for a, b in zip(tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        _close(a, b, 1e-4)

    lr = 1e-2
    jopt, topt = j_chain(j_clip(1.0), j_adamw(lr)), chain(clip_by_global_norm(1.0), adamw(lr))
    jstep, tstep = jax.jit(JGM.train_step(jcfg, jopt)), TGM.train_step(tcfg, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    sums = []
    inner = ss_ops.csr_sum
    try:
        ss_ops.csr_sum = lambda x, csr, backward=False: sums.append(backward) or inner(
            x, csr, backward)
        for i in range(2):
            jp, js, jm = jstep(jp, js, jg)
            tp, ts, tm = tstep(tp, ts, tg)
            assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
            if i == 0:
                for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
                    _close(a, b, lr * 1e-2)
    finally:
        ss_ops.csr_sum = inner
    # per step: the 5 sums a layer forward (as on the card); the 2 of them
    # whose x requires a gradient (the messages and their squares) backward
    L = cfg_kw["n_layers"]
    assert (sums.count(False), sums.count(True)) == (2 * 5 * L, 2 * 2 * L), sums
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TGM.train_step(GNNConfig(name="g", kind="gat", n_layers=1, d_hidden=2, d_in=2), topt)
