"""Parity: the port's two-tower training against the JAX package's, on the
CPU, fp32, with the reference's parameters carried across by ``interop``.

- The ``embedding_bag`` table gradient: the plain backward against
  ``jax.grad`` of the reference's ``embedding_bag`` (sum and mean), with
  ids clipped at both ends, masked entries and an all-masked bag, 1e-6,
  at the default chunk size and at one where the hot id's run spans many
  chunks; autograd reaches it through ``EmbeddingBagFn``. The CUDA
  kernels' decomposition (terms scaled once a bag, entries sorted by row
  and the chunks of the long runs listed by ``prepare_rows``, the chunk
  pass's partials, the row pass's runs or partials in order, every row
  written once) simulated in torch and equal bit for bit to the plain
  version, runs of exactly C and C + 1 entries included; the chunk table
  itself against its definition. The kernels run only on the card, where
  ``chip_smoke.py`` phase 17 (e) holds every call to the plain version.
- ``loss_fn`` and its gradients, and two clip + AdamW ``train_step``s, at
  SMOKE, 1e-5 (losses relative; gradients and parameters absolute and
  relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.optim import adamw as j_adamw, chain as j_chain, clip_by_global_norm as j_clip
from repro.recsys import embedding as JE, twotower as JT
from repro_torch import interop
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ref import (RUN_CHUNK, embedding_bag_backward_ref,
                                                  scaled_rows)
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.optim.adamw import value_and_grad
from repro_torch.recsys import twotower as TT
from repro_torch.recsys.config import TwoTowerConfig
from test_torch_fixtures import _torch_test_env  # noqa: F401

BWD_TOL = 1e-6
TOL = 1e-5
LR = 1e-2


def _bags(seed, B, K, V):
    """ids past both ends of [0, V) (clipped to rows 0 and V-1), about a
    third masked, bag 1 all masked, a hot id repeated across bags."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, V + 3, (B, K)).astype(np.int32)
    ids[:, 0] = 5  # a run of one id across every bag
    mask = rng.random((B, K)) < 0.67
    mask[1] = False
    return ids, mask


@pytest.mark.parametrize("chunk", [RUN_CHUNK, 2])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_backward_matches_jax_grad(mode, chunk):
    V, D, B, K = 37, 12, 24, 6
    ids, mask = _bags(1, B, K, V)
    rng = np.random.default_rng(2)
    table = rng.normal(size=(V, D)).astype(np.float32)
    dout = rng.normal(size=(B, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: JE.embedding_bag(t, jnp.asarray(ids), jnp.asarray(mask),
                                                mode=mode), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(dout))
    args = (torch.as_tensor(dout), torch.as_tensor(ids), torch.as_tensor(mask), V)
    got = embedding_bag_backward_ref(*args, mode=mode, chunk=chunk)
    assert got.shape == (V, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BWD_TOL, atol=BWD_TOL)
    # the clipped ids send their gradient to rows 0 and V-1
    assert (ids < 0)[mask].any() and (ids >= V)[mask].any() and got[0].abs().sum() > 0
    # the hot id's run spans one chunk, or many
    assert ((np.clip(ids, 0, V - 1) == 5) & mask).sum() > (chunk < RUN_CHUNK) * 4 * chunk > 0 \
        or chunk == RUN_CHUNK
    got = embedding_bag_backward_ref(*args, mode=mode)  # the wrapper's chunk

    # through autograd: the table's gradient is this backward, counted once
    calls = []
    inner = eb_ops.embedding_bag_backward
    t = torch.as_tensor(table).requires_grad_(True)
    try:
        eb_ops.embedding_bag_backward = lambda *a, **kw: calls.append(a) or inner(*a, **kw)
        out = eb_ops.embedding_bag(t, torch.as_tensor(ids), torch.as_tensor(mask), mode=mode)
        assert type(out.grad_fn).__name__ == "EmbeddingBagFnBackward"
        (g,) = torch.autograd.grad(out, t, torch.as_tensor(dout))
    finally:
        eb_ops.embedding_bag_backward = inner
    assert len(calls) == 1 and torch.equal(g, got)
    with torch.no_grad():  # no gradient wanted: the plain bags, no Function
        assert eb_ops.embedding_bag(t, torch.as_tensor(ids), torch.as_tensor(mask),
                                    mode=mode).grad_fn is None


def simulate_backward_kernel(dout, ids, mask, n_rows, mode, chunk):
    """``csrc/embedding_bag_bwd.cu`` step by step: the bags' terms scaled
    once (``scaled_rows``), the entries sorted by row, each row's run found
    by the bounds pass (one thread a sorted position, writing where the key
    changes into a zeroed table; held equal to the plan's plain bounds), and
    the long runs' chunks listed (``prepare_rows``); then the chunk pass,
    one walk a used slot over its chunk (idle slots exit), and the row
    pass, groups of 32 rows, the group's bounds at once, then a row at a
    time one walk over a run of at most ``chunk`` entries or over a longer
    run's partials in chunk order, each row written once, zeros for an
    empty run. A walk adds in fp32 from 0, 32 positions at a time and 8
    rows in flight (the loads first, the adds in order)."""
    B, K = ids.shape
    D = dout.shape[1]
    g = scaled_rows(dout, mask, mode)
    plan = eb_ops.prepare_rows(ids, mask, n_rows, chunk=chunk)
    order, bounds = plan.order, plan.bounds
    key, _ = eb_ops.sorted_keys(ids, mask, n_rows)
    keys = [-1] + key.tolist() + [n_rows]  # position q's key at keys[q + 1]
    found = torch.zeros((n_rows, 2), dtype=torch.int32)
    for q in range(key.numel() + 1):  # the bounds pass
        prev, cur = keys[q], keys[q + 1]
        if cur != prev:
            if cur < n_rows:
                found[cur, 0] = q
            if 0 <= prev < n_rows:
                found[prev, 1] = q
    assert torch.equal(found, bounds)

    def walk(rows_of, lo, hi):
        acc = torch.zeros(D)
        for base in range(lo, hi, 32):
            rows = rows_of(base, min(base + 32, hi))
            for j in range(0, len(rows), 8):
                loaded = list(rows[j:j + 8])  # the loads
                for row in loaded:  # then the adds, in order
                    acc = acc + row
        return acc

    terms = lambda a, b: g[order[a:b].long() // K]
    partials = torch.full((plan.slot_row.numel(), D), float("nan"))
    for s, r in enumerate(plan.slot_row.tolist()):  # the chunk pass
        if r < n_rows:
            lo = int(plan.slot_start[s])
            partials[s] = walk(terms, lo, min(lo + chunk, int(bounds[r, 1])))
    out = torch.empty((n_rows, D))
    for r0 in range(0, n_rows, 32):  # the row pass: a group's bounds, then its rows
        for r, (lo, hi) in enumerate(bounds[r0:r0 + 32].tolist(), r0):
            if hi - lo <= chunk:
                out[r] = walk(terms, lo, hi)
            else:
                first = int(plan.chunk_rank[lo]) - 1
                n = -(-(hi - lo) // chunk)
                out[r] = walk(lambda a, b: partials[first + a:first + b], 0, n)
    return out, plan


def _planted_bags(seed, B, K, V, chunk):
    """``_bags`` with row 7's run exactly ``chunk`` entries long and row
    11's ``chunk + 1``, planted at random positions outside the all-masked
    bag 1."""
    ids, mask = _bags(seed, B, K, V)
    rng = np.random.default_rng(seed + 1)
    clipped = np.clip(ids, 0, V - 1)
    ids[np.isin(clipped, (7, 11))] = 12
    free = np.flatnonzero(np.arange(B * K) // K != 1)
    pos = rng.choice(free, 2 * chunk + 1, replace=False)
    ids.reshape(-1)[pos[:chunk]], ids.reshape(-1)[pos[chunk:]] = 7, 11
    mask.reshape(-1)[pos] = True
    return ids, mask


@pytest.mark.parametrize("chunk", sorted({4, RUN_CHUNK, 256}))
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_backward_kernel_walk_simulated(mode, chunk):
    V, D, B, K = 40, 16, 64, 9  # the hot id's run spans more than 32 positions
    ids, mask = _planted_bags(3, B, K, V, chunk)
    dout = torch.as_tensor(np.random.default_rng(4).normal(size=(B, D)).astype(np.float32))
    ids_t, mask_t = torch.as_tensor(ids), torch.as_tensor(mask)
    got, plan = simulate_backward_kernel(dout, ids_t, mask_t, V, mode, chunk)
    want = embedding_bag_backward_ref(dout, ids_t, mask_t, V, mode=mode, chunk=chunk)
    # the same terms added in the same order: equal bit for bit, as the
    # card's check holds the kernels to this plain version on the host
    assert torch.equal(got, want)
    order, bounds = plan.order, plan.bounds
    assert all(t.dtype == torch.int32 for t in plan) and bounds.shape == (V, 2)
    counts = (bounds[:, 1] - bounds[:, 0]).numpy()
    clipped = np.clip(ids, 0, V - 1)
    np.testing.assert_array_equal(counts, np.bincount(clipped[mask], minlength=V))
    assert (counts[7], counts[11]) == (chunk, chunk + 1) and int(bounds[:, 1].max()) == mask.sum()
    assert chunk > 32 or counts[5] > 32  # a hot run of many chunks
    # each row's run keeps its entries in flat (bag, slot) order: a stable sort
    for r in range(V):
        run = order[bounds[r, 0]:bounds[r, 1]].numpy()
        assert (np.diff(run) > 0).all() and (clipped.reshape(-1)[run] == r).all()
    assert not got[counts == 0].any()
    check_chunk_table(plan, V, chunk)


def check_chunk_table(plan, n_rows, chunk):
    """The chunk table against its definition: the runs longer than
    ``chunk``, each cut into ceil(len / chunk) chunks of ``chunk``
    entries, in row order, then idle slots; the slot count is the bound."""
    n = plan.order.numel()
    want_rows, want_starts = [], []
    for r, (lo, hi) in enumerate(plan.bounds.tolist()):
        if hi - lo > chunk:
            want_rows += [r] * -(-(hi - lo) // chunk)
            want_starts += list(range(lo, hi, chunk))
    used = len(want_rows)
    assert plan.slot_row.numel() == eb_ops.n_slots(n, chunk) >= used
    assert plan.slot_row[:used].tolist() == want_rows
    assert plan.slot_start[:used].tolist() == want_starts
    assert (plan.slot_row[used:] == n_rows).all() and (plan.slot_start[used:] == n).all()
    # a long run's first chunk is in slot chunk_rank[lo] - 1
    for s, (r, p) in enumerate(zip(want_rows, want_starts)):
        assert p != int(plan.bounds[r, 0]) or int(plan.chunk_rank[p]) - 1 == s
    return used


@pytest.mark.parametrize("chunk", [1, 4])
def test_chunk_table_at_its_slot_bound(chunk):
    """Runs of chunk + 1 entries each, two chunks a run: the most slots a
    batch can use, 2 n / (C + 1); masked entries, a clipped id and empty
    rows besides."""
    run, n_runs, K = chunk + 1, 11, 4
    rows = np.repeat(np.arange(n_runs) * 2 + 1, run)  # the even rows stay empty
    ids = np.concatenate([rows, np.full(-len(rows) % K + K, 40)])  # 40: clipped, masked
    mask = np.arange(len(ids)) < len(rows)
    mask[len(rows)] = True  # one unmasked clipped id: a run of 1 on row 22
    perm = np.random.default_rng(chunk).permutation(len(ids))
    ids_t = torch.as_tensor(ids[perm].reshape(-1, K).astype(np.int32))
    mask_t = torch.as_tensor(mask[perm].reshape(-1, K))
    plan = eb_ops.prepare_rows(ids_t, mask_t, 23, chunk=chunk)
    used = check_chunk_table(plan, 23, chunk)
    assert used == 2 * n_runs
    dout = torch.as_tensor(np.random.default_rng(5).normal(size=(ids_t.shape[0], 8))
                           .astype(np.float32))
    got, _ = simulate_backward_kernel(dout, ids_t, mask_t, 23, "mean", chunk)
    assert torch.equal(got, embedding_bag_backward_ref(dout, ids_t, mask_t, 23, mode="mean",
                                                       chunk=chunk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_binding_passes_the_c_arguments(monkeypatch, dtype):
    """``embedding_bag_bwd_cuda`` hands the C entry point g, the plan's five
    arrays, the fp32 [S, D] partials and the output, then V, S, K, D, the
    chunk size and the bf16 flag, then the stream; ``row_bounds_cuda`` the
    sorted keys and a zeroed [V, 2] table, then N, V and the stream. Both
    raise when the launch reports an error. The C calls are stand-ins: no
    kernel runs here."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import kernel

    seen, err, made = [], [0], []
    signatures = {"embedding_bag_bwd_launch": (8, 6), "embedding_bag_bwd_bounds_launch": (2, 2)}

    def fake_bind(name, symbol, n_pointers, n_ints):
        assert name == "embedding_bag_bwd" and signatures[symbol] == (n_pointers, n_ints)
        return lambda *a: seen.append(a) or err[0]

    empty = torch.empty
    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 1234})())
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(empty(*a, **kw)) or made[-1])
    ids, mask = (torch.as_tensor(a) for a in _bags(0, 6, 4, 10))
    plan = eb_ops.prepare_rows(ids, mask, 10, chunk=2)
    g = torch.zeros(6, 16)
    out = kernel.embedding_bag_bwd_cuda(g, plan, 4, dtype, chunk=2)
    out_t, partials = made[:2]
    assert out is out_t and out.shape == (10, 16) and out.dtype == dtype
    assert partials.shape == (eb_ops.n_slots(24, 2), 16) and partials.dtype == torch.float32
    (a,) = seen
    assert a == (g.data_ptr(), *(t.data_ptr() for t in plan), partials.data_ptr(),
                 out.data_ptr(), 10, 24, 4, 16, 2, int(dtype == torch.bfloat16), 1234)
    key, _ = eb_ops.sorted_keys(ids, mask, 10)
    bounds = kernel.row_bounds_cuda(key, 10)
    assert bounds.shape == (10, 2) and bounds.dtype == torch.int32 and not bounds.any()
    assert seen[1] == (key.data_ptr(), bounds.data_ptr(), 24, 10, 1234)
    err[0] = 9
    with pytest.raises(RuntimeError, match="cudaError 9"):
        kernel.embedding_bag_bwd_cuda(g, plan, 4, dtype, chunk=2)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        kernel.row_bounds_cuda(key, 10)


@pytest.mark.parametrize("bad", ["mode", "ids_dtype", "ids_device", "mask_shape", "mask_dtype",
                                 "no_rows", "rows_past_int32"])
def test_backward_checks_refuse_what_the_kernel_does_not_take(bad):
    """The checks a CUDA backward call passes before its launch (those of
    the forward's bags, and its sizes), run here on CPU tensors."""
    ids, mask = (torch.as_tensor(a) for a in _bags(0, 6, 4, 10))
    mode, dev, sizes = "mean", torch.device("cpu"), [10, 8, 6, 4]
    if bad == "mode":
        mode = "max"
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_device":
        ids = ids.to("meta")
    elif bad == "mask_shape":
        mask = mask[:, :3]
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "no_rows":
        sizes[0] = 0
    else:
        sizes[0] = 2**31
    with pytest.raises(ValueError):
        eb_ops._check_bags(ids, mask, mode, dev)
        eb_ops._check_sizes(*sizes)


def _setup():
    jcfg = j_configs.get_arch("two-tower-retrieval").SMOKE
    tcfg = TwoTowerConfig(**dataclasses.asdict(jcfg))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed, B=16):
    rng = np.random.default_rng(seed)
    d = {}
    for tower, fields, vocab in (("user", cfg.user_fields, cfg.user_vocab),
                                 ("item", cfg.item_fields, cfg.item_vocab)):
        ids = rng.integers(-2, vocab + 2, (B, fields, cfg.bag_size)).astype(np.int32)
        mask = rng.random((B, fields, cfg.bag_size)) < 0.7
        mask[0, 0] = False  # an all-masked bag in one field
        d[f"{tower}_bags"], d[f"{tower}_mask"] = ids, mask
    d["item_logq"] = np.log(rng.random(B).astype(np.float32) * 1e-3 + 1e-6)
    return d


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_loss_grads_and_train_steps_match_reference():
    jcfg, tcfg, jp, tp = _setup()
    d = _batch(jcfg, 5)
    jb = {k: jnp.asarray(v) for k, v in d.items()}
    tb = {k: torch.as_tensor(v) for k, v in d.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(jcfg, p, jb)))(jp)
    tloss, tgrads = value_and_grad(lambda p: TT.loss_fn(tcfg, p, tb), tp)
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    assert set(tgrads) == set(jgrads)
    for k in jgrads:
        _close(tgrads[k], jgrads[k])
    assert tgrads["user_table"].shape == (jcfg.user_vocab, jcfg.embed_dim)
    assert tgrads["user_table"][0].abs().sum() > 0  # clipped ids reach row 0

    jopt, topt = j_chain(j_clip(1.0), j_adamw(LR)), chain(clip_by_global_norm(1.0), adamw(LR))
    jstep, tstep = jax.jit(JT.train_step(jcfg, jopt)), TT.train_step(tcfg, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    for i, seed in enumerate((5, 6)):
        b = _batch(jcfg, seed)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        new, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v) for k, v in b.items()})
        assert new is tp  # in place
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
        if i == 0:
            for k in jgrads:
                g = np.asarray(jgrads[k])
                # Adam's first step is about lr x sign(g): a gradient within
                # 1e-5 of 0 may take another fraction of lr, or flip
                tol = np.where(np.abs(g) > 1e-5, LR * 1e-3, 2 * LR + LR * 1e-3)
                assert (np.abs(tp[k].numpy() - np.asarray(jp[k])) <= tol).all(), k
    for k in jp:
        _close(tp[k], jp[k], 2 * LR)
