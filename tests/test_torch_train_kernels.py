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


def simulate_backward_kernels(q, k, v, o, do, lse, *, causal, window, q_offset):
    """``csrc/flash_attention_bwd.cu``, tile by tile: the dq kernel (one
    CTA per BT query rows and head: delta, then its band's key tiles) and
    the dk / dv kernel (one CTA per BT keys and KV head: its G heads' query
    tiles, skipping those that reach none of its keys), each tile's scores
    and probabilities as the kernels form them (rows past Sq with lse
    +inf, keys past Sk staged as zeros)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, dh**-0.5
    BT = 32 if dh > 128 else 64
    w = window or 0
    qs = (q * scale).to(torch.float32)
    f = lambda t: t.to(torch.float32)
    dq, dk, dv = (torch.zeros(t.shape, dtype=torch.float32) for t in (q, k, v))
    delta = (f(do) * f(o)).sum(-1).permute(0, 2, 1)  # [B, H, Sq]

    def tile(x, r0, rows):  # rows [r0, r0 + BT) of [S, dh], zeros past rows
        out = torch.zeros(BT, dh)
        n = max(0, min(BT, rows - r0))
        out[:n] = x[r0:r0 + n]
        return out

    def probs(b, h, q0, k0, Qs, Os, Ks, Vs):
        rows, keys = q0 + torch.arange(BT), k0 + torch.arange(BT)
        lr = torch.where(rows < Sq, lse[b, h, rows.clamp(max=Sq - 1)], torch.inf)[:, None]
        dd = torch.where(rows < Sq, delta[b, h, rows.clamp(max=Sq - 1)], 0.0)[:, None]
        s, dp = Qs @ Ks.T, Os @ Vs.T
        pos = (q_offset + rows)[:, None]
        ok = (keys[None] < Sk) & ((keys[None] <= pos) | (not causal)) & (
            (keys[None] > pos - w) | (w <= 0))
        empty = lr <= 0.5 * NEG_INF
        p = torch.where(ok & ~empty & (lr < torch.inf), torch.exp(s - lr), 0.0)
        p = torch.where(empty & (keys[None] < Sk), 1.0 / max(Sk, 1), p)
        ds = torch.where(ok & ~empty, p * (dp - dd), 0.0)
        return p, ds

    for b in range(B):
        for h in range(H):
            kvh = h // G
            for q0 in range(0, Sq, BT):
                Qs, Os = tile(qs[b, :, h], q0, Sq), tile(f(do[b, :, h]), q0, Sq)
                lo, hi = _key_range(q_offset + q0, q_offset + min(q0 + BT, Sq) - 1, Sk,
                                    causal, w)
                acc = torch.zeros(BT, dh)
                for kt in range(lo, hi, BT):
                    Ks, Vs = tile(f(k[b, :, kvh]), kt, Sk), tile(f(v[b, :, kvh]), kt, Sk)
                    _, ds = probs(b, h, q0, kt, Qs, Os, Ks, Vs)
                    acc += ds @ Ks
                n = min(BT, Sq - q0)
                dq[b, q0:q0 + n, h] = acc[:n] * scale
        for kvh in range(KV):
            for k0 in range(0, Sk, BT):
                Ks, Vs = tile(f(k[b, :, kvh]), k0, Sk), tile(f(v[b, :, kvh]), k0, Sk)
                dka, dva = torch.zeros(BT, dh), torch.zeros(BT, dh)
                for g in range(G):
                    h = kvh * G + g
                    for q0 in range(0, Sq, BT):
                        lo, hi = _key_range(q_offset + q0, q_offset + min(q0 + BT, Sq) - 1, Sk,
                                            causal, w)
                        if lo >= k0 + BT or hi <= k0:
                            continue
                        Qs, Os = tile(qs[b, :, h], q0, Sq), tile(f(do[b, :, h]), q0, Sq)
                        p, ds = probs(b, h, q0, k0, Qs, Os, Ks, Vs)
                        dva += p.T @ Os
                        dka += ds.T @ Qs
                n = min(BT, Sk - k0)
                dk[b, k0:k0 + n, kvh], dv[b, k0:k0 + n, kvh] = dka[:n], dva[:n]
    return dq, dk, dv


# the kernels' tiling: several 64-row tiles (a ragged last one), 32-row
# tiles at dh 256, bands that skip tiles, rows with no allowed key at both
# ends, a GQA group walked by one dk / dv CTA
TILE_CASES = {
    "causal_window_ragged": (1, 150, 150, 4, 2, 16, True, 40, 0),
    "dh256_causal": (1, 100, 100, 2, 1, 256, True, None, 0),
    "dh256_window": (1, 100, 100, 2, 2, 256, True, 24, 0),
    "negative_offset_empty_rows": (1, 130, 80, 2, 1, 16, True, None, -70),
    "non_causal_window_empty_tail": (1, 140, 70, 2, 1, 24, False, 8, 20),
    "q_offset_decode_like": (2, 20, 200, 4, 1, 32, True, 64, 180),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_backward_kernel_tiling_simulated(case):
    B, Sq, Sk, H, KV, dh, causal, window, off = TILE_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh), (B, Sq, H, dh)))
    kw = dict(causal=causal, window=window, q_offset=off)
    o, lse = flash_attention_ref(q, k, v, with_lse=True, **kw)
    got = simulate_backward_kernels(q, k, v, o, do, lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for a, b in zip(got, want):
        _close(a, b)


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
