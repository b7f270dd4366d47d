"""The CUDA ``block_gather`` kernel's decomposition, simulated on the CPU.

``csrc/block_gather.cu`` cuts the batch into CTAs of ``ROWS`` rows, stages
each row's inputs and the block's recent window (key and other padded one
word in 32, ok bits 32 to a word) in shared memory, walks (row, 4-lane
chunk) tasks by additions, and stores a chunk with one 16-byte leaf store
and 4-byte mask stores or, where W % 4 != 0, lane by lane.
``simulate_block_gather`` does the same steps with the same index
arithmetic in numpy; it is held equal to the plain version
(``block_gather_filter_ref``) and to the JAX package's reference on the
shapes where the kernel's paths differ: ``max_deg`` off the chunk (a chunk
straddles the two regions), W off the chunk (the lane-by-lane stores), a clamped
window (``csr_len > EB - R``), a region shorter than the window, a region
whose ok bits span words (a chunk reads across two), B = 1 and B off the
row tile, and ``lroot`` values that wrap, clamp and overflow.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.block_gather.ref import block_gather_filter_ref as j_bg_ref
from repro_torch.core.templates import MAX_CONDS, OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, OP_NEQ
from repro_torch.kernels.block_gather import ops as bg_ops
from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
from repro_torch.utils import PROP_MISSING
from test_kernels import _PRED_CASES
from test_torch_fixtures import _torch_test_env  # noqa: F401


ROWS, LANES, THREADS = 16, 4, 256  # the kernel's kRows, kLanes, kThreads
NAMES = ("leaf", "scan", "emask", "qual", "trunc")

_j_bg_ref = jax.jit(j_bg_ref, static_argnames=(
    "max_deg", "recent_cap", "e_blk_cap", "edge_label", "pe", "pl"))


def _i32(x):
    return int(np.int64(x).astype(np.int32))


def _clamp(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


def _jidx(i, n):
    if i < 0:
        i += n
    return _clamp(i, 0, n - 1)


def _pad(j):
    return j + (j >> 5)


def _cmp(op, a, b):
    return {OP_EQ: a == b, OP_NEQ: a != b, OP_LT: a < b, OP_LE: a <= b,
            OP_GT: a > b, OP_GE: a >= b}.get(op, False)


def _eval_pred(stat, lab, props_row, bound_row):
    """The kernel's ``eval_pred``: label, then each condition in order."""
    label, conds = stat
    ok = label < 0 or lab == label
    for lane, pid, op, val, wild in conds:
        pv = int(props_row[min(pid, len(props_row) - 1)])
        cond = pv == int(bound_row[lane]) if wild else _cmp(op, pv, val)
        ok = ok and pv != PROP_MISSING and cond
    return ok


def simulate_block_gather(args, *, max_deg, recent_cap, e_blk_cap, edge_label, pe, pl,
                          threads=THREADS, aligned=True):
    """``block_gather_kernel`` step by step: returns its five outputs and
    the set of store paths it took ("vec" / "scalar")."""
    (indptr, key, other, label, alive, props, vlabel, valive, vprops, csr_len, blk_len,
     roots, lroot, rvalid, cvalid, rmask, r_ok, pe_bound, pl_bound) = (np.asarray(a) for a in args)
    B, R, EB = len(roots), recent_cap, e_blk_cap
    W, Vp, v_cap = max_deg + R, len(indptr), len(valive)
    # garbage where nothing was written yet, so a missed store shows
    leaf_o = np.full((B, W), 0x5A5A5A5A, np.int64)
    masks = {n: np.full((B, W), 7, np.int64) for n in ("scan", "emask", "qual")}
    trunc_o = np.full(B, 7, np.int64)
    visits = np.zeros((B, -(-W // LANES)), np.int64)
    vec = W % LANES == 0 and aligned
    paths = set()
    cl, bl = int(csr_len), int(blk_len)
    roff = _clamp(cl, 0, EB - R)
    nw = (R + 31) >> 5
    for row0 in range(0, B, ROWS):
        nrows = min(ROWS, B - row0)
        ctx = []
        for t in range(nrows):  # per-row inputs, one thread a row
            row = row0 + t
            lr = int(lroot[row])
            start = int(indptr[_jidx(lr, Vp)])
            deg = _i32(int(indptr[_jidx(_i32(lr + 1), Vp)]) - start)
            trunc_o[row] = deg > max_deg
            r = int(roots[row])
            ralive = bool(valive[_clamp(r, 0, v_cap - 1)])
            execd = bool(rmask[row]) and ralive
            ctx.append((r, start, deg, execd and bool(cvalid[row]), execd and bool(rvalid[row]),
                        bool(r_ok[row])))
        # the recent window: padded key / other, ok bits by ballot
        s_key = np.zeros(_pad(R - 1) + 1, np.int64)
        s_other = np.zeros_like(s_key)
        s_okw = [0] * (nw + 1)
        for j0 in range(0, nw * 32, 32):
            bits = 0
            for j in range(j0, j0 + 32):
                if j < R:
                    sid = roff + j
                    s_key[_pad(j)], s_other[_pad(j)] = key[sid], other[sid]
                    ok = (cl <= sid < bl and bool(alive[sid])
                          and bool(valive[_clamp(int(other[sid]), 0, v_cap - 1)]))
                    bits |= int(ok) << (j - j0)
            s_okw[j0 >> 5] = bits
        nch = -(-W // LANES)
        step_r, step_c = threads // nch, threads % nch
        for tid in range(threads):
            tr, tc = tid // nch, tid % nch
            for _ in range(tid, nrows * nch, threads):
                visits[row0 + tr, tc] += 1
                r, start, deg, csr_open, rec_open, rok = ctx[tr]
                lane0 = tc * LANES
                jb = max(lane0 - max_deg, 0)
                okb = ((s_okw[(jb >> 5) + 1] << 32 | s_okw[jb >> 5]) >> (jb & 31)) & 0xFFFFFFFF
                leafv, scanb, emb, qb = [0] * LANES, 0, 0, 0
                for k in range(LANES):
                    lane, cand, live = lane0 + k, False, True
                    if lane < max_deg:
                        slot = _clamp(start + lane, 0, EB - 1)
                        leafv[k] = int(other[slot])
                        cand = csr_open and lane < deg
                    elif lane < W:
                        j = lane - max_deg
                        slot = roff + j
                        leafv[k] = int(s_other[_pad(j)])
                        cand = rec_open and (okb >> (j - jb)) & 1 and s_key[_pad(j)] == r
                    if cand:  # every record the lane's masks need, at once
                        leaf_c = _clamp(leafv[k], 0, v_cap - 1)
                        if lane < max_deg:
                            live = bool(alive[slot]) and bool(valive[leaf_c])
                        elab = int(label[slot])
                        pe_ok = _eval_pred(pe, elab, props[slot], pe_bound[row0 + tr])
                        e_ok = (edge_label < 0 or elab == edge_label) and pe_ok
                        l_ok = _eval_pred(pl, int(vlabel[leaf_c]), vprops[leaf_c],
                                          pl_bound[row0 + tr])
                        scanb |= int(live) << k
                        emb |= int(live and e_ok) << k
                        qb |= int(live and e_ok and rok and l_ok) << k
                o = (row0 + tr) * W + lane0
                out_bits = {"scan": scanb, "emask": emb, "qual": qb}
                if vec:
                    assert o % LANES == 0  # a 16-byte aligned leaf store, 4-byte mask stores
                    paths.add("vec")
                    lanes = range(LANES)
                else:
                    paths.add("scalar")
                    lanes = [k for k in range(LANES) if lane0 + k < W]
                for k in lanes:
                    leaf_o.flat[o + k] = leafv[k]
                    for n, b in out_bits.items():
                        masks[n].flat[o + k] = b >> k & 1
                tc += step_c
                tr += step_r
                if tc >= nch:
                    tc -= nch
                    tr += 1
    assert (visits == 1).all(), "a (row, chunk) task was skipped or done twice"
    out = (leaf_o.astype(np.int32),) + tuple(masks[n].astype(bool) for n in ("scan", "emask", "qual"))
    assert all((m <= 1).all() for m in masks.values()) and (trunc_o <= 1).all()
    return out + (trunc_o.astype(bool),), paths


def _world(rng, B, *, max_deg, R, EB=256, csr_len=100, blk_len=130, v_loc=12, v_cap=48):
    """One orientation's operands: a CSR region with over-degree rows
    (trunc), junk past ``csr_len``, a recent region [csr_len, blk_len)
    whose keys hit some of the batch's roots, and lroot values that wrap
    (negative), clamp (past Vp) and overflow (int32 max)."""
    deg = rng.integers(0, 6, v_loc)
    deg[1:3] = max_deg + 2, max_deg  # one over-degree row, one full window
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    assert indptr[-1] <= min(csr_len, EB)
    key = rng.integers(0, v_cap, EB).astype(np.int32)
    other = rng.integers(-2, v_cap + 3, EB).astype(np.int32)
    label = rng.integers(0, 2, EB).astype(np.int32)
    alive = rng.random(EB) < 0.85
    props = rng.integers(0, 8, (EB, 2)).astype(np.int32)
    props[rng.random((EB, 2)) < 0.15] = PROP_MISSING
    vlabel = rng.integers(0, 2, v_cap).astype(np.int32)
    valive = rng.random(v_cap) < 0.9
    vprops = rng.integers(0, 8, (v_cap, 2)).astype(np.int32)
    vprops[rng.random((v_cap, 2)) < 0.15] = PROP_MISSING
    roots = rng.integers(0, v_cap, B).astype(np.int32)
    lo, hi = max(csr_len, 0), min(blk_len, EB)
    if hi > lo:
        key[lo:hi] = roots[rng.integers(0, B, hi - lo)]
    lroot = rng.integers(0, v_loc, B).astype(np.int32)
    special = [1, -1, -(v_loc + 4), v_loc, 2**31 - 1]  # 1: over degree
    lroot[:len(special)] = special[:B]
    rvalid = rng.random(B) < 0.85
    cvalid = rvalid & (rng.random(B) < 0.8)
    rmask = rng.random(B) < 0.85
    r_ok = rmask & (rng.random(B) < 0.8)
    rvalid[0] = cvalid[0] = rmask[0] = r_ok[0] = valive[roots[0]] = True
    pe_bound = rng.integers(0, 8, (B, MAX_CONDS)).astype(np.int32)
    pl_bound = rng.integers(0, 8, (B, MAX_CONDS)).astype(np.int32)
    args = (indptr, key, other, label, alive, props, vlabel, valive, vprops,
            np.int32(csr_len), np.int32(blk_len), roots, lroot, rvalid, cvalid, rmask,
            r_ok, pe_bound, pl_bound)
    return args, dict(max_deg=max_deg, recent_cap=R, e_blk_cap=EB)


# (name, B, world keywords, the store path the kernel takes)
_SHAPES = [
    ("aligned, B off the row tile", 40, dict(max_deg=16, R=48), "vec"),
    ("max_deg off the chunk: a chunk straddles", 33, dict(max_deg=10, R=38), "vec"),
    ("W off the chunk: lane-by-lane stores", 17, dict(max_deg=20, R=30), "scalar"),
    ("clamped window, csr_len > EB - R", 16, dict(max_deg=16, R=32, EB=128, csr_len=120,
                                                    blk_len=128), "vec"),
    ("region shorter than the window", 21, dict(max_deg=16, R=64, blk_len=104), "vec"),
    ("region across several ok words", 24, dict(max_deg=6, R=102, EB=320, blk_len=195), "vec"),
    ("B = 1, max_deg and W off the chunk", 1, dict(max_deg=5, R=8), "scalar"),
    ("empty region, blk_len < csr_len", 5, dict(max_deg=8, R=24, blk_len=90), "vec"),
]


@pytest.mark.parametrize("threads", [THREADS, 3])
@pytest.mark.parametrize("name,B,world,path", _SHAPES, ids=[s[0] for s in _SHAPES])
def test_simulated_kernel_matches_plain_and_jax(name, B, world, path, threads):
    rng = np.random.default_rng(B * 31 + world["R"])
    args, statics = _world(rng, B, **world)
    for edge_label, pe, pl in _PRED_CASES:
        kw = dict(statics, edge_label=edge_label, pe=pe, pl=pl)
        got, paths = simulate_block_gather(args, threads=threads, **kw)
        assert paths == {path}
        plain = block_gather_filter_ref(*(torch.as_tensor(np.array(a)) for a in args), **kw)
        want = _j_bg_ref(*args, **kw)
        for n, g, p, w in zip(NAMES, got, plain, want):
            assert torch.equal(torch.as_tensor(g), p), f"{name}: {n} differs from the plain version"
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name}: {n} vs JAX")
    # the world reaches what it is for: both regions scan, some row truncates
    scan = plain[1].numpy()
    assert scan[:, world["max_deg"]:].any() or name.startswith("empty")
    assert plain[4].any()


def test_misaligned_outputs_take_the_lane_by_lane_stores():
    rng = np.random.default_rng(3)
    args, statics = _world(rng, 19, max_deg=16, R=32)
    kw = dict(statics, edge_label=-1, pe=(-1, ()), pl=(-1, ()))
    vec, p1 = simulate_block_gather(args, **kw)
    lane, p2 = simulate_block_gather(args, aligned=False, **kw)
    assert (p1, p2) == ({"vec"}, {"scalar"})
    for a, b in zip(vec, lane):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B", [1, 200])
def test_kernel_binding_passes_the_unpadded_rows(monkeypatch, B):
    """``block_gather_cuda`` hands the C entry point the 24 pointers, then
    the ints (B as given: the grid covers any B, nothing is padded), the
    predicates and the stream, and raises when the launch reports an error.
    The C call is a stand-in: no kernel runs here."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_gather import kernel

    seen, err = [], [0]

    def fake_bind(name, symbol, n_pointers, n_ints):
        assert (name, n_pointers, n_ints) == ("block_gather", 24, 9 + 2 * (2 + 5 * MAX_CONDS))
        return lambda *a: seen.append((symbol, a)) or err[0]

    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 1234})())
    args, statics = _world(np.random.default_rng(5), B, max_deg=16, R=32)
    t = [torch.as_tensor(np.array(a)) for a in args]
    pe = (0, ((1, 0, OP_LE, 3, True),))
    kw = dict(statics, edge_label=1, pe=pe, pl=(-1, ()))
    out = kernel.block_gather_cuda(t[:11], t[11:], **kw)
    assert [tuple(o.shape) for o in out] == [(B, 48)] * 4 + [(B,)]
    out2 = kernel.block_gather_cuda(t[:11], t[11:], symbol=kernel.LANE_LAUNCH, **kw)
    (sym, a), (sym2, _) = seen
    assert (sym, sym2) == (kernel.LAUNCH, kernel.LANE_LAUNCH)
    assert a[:24] == tuple(x.data_ptr() for x in (*t, *out))
    assert a[24:33] == (B, 13, 256, 48, 2, 2, 16, 32, 1)
    assert a[33:50] == (0, 1, 1, 0, OP_LE, 3, 1) + (0,) * 10
    assert a[50:] == (-1, 0) + (0,) * 15 + (1234,)
    assert out2[0].shape == (B, 48)
    err[0] = 9
    with pytest.raises(RuntimeError, match="cudaError 9"):
        kernel.block_gather_cuda(t[:11], t[11:], **kw)
