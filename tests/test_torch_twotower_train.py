"""Parity: the port's two-tower training against the JAX package's, on the
CPU, fp32, with the reference's parameters carried across by ``interop``.

- The ``embedding_bag`` table gradient: the plain backward against
  ``jax.grad`` of the reference's ``embedding_bag`` (sum and mean), with
  ids clipped at both ends, masked entries and an all-masked bag, 1e-6;
  autograd reaches it through ``EmbeddingBagFn``. The CUDA kernel's
  decomposition (terms scaled once a bag, entries sorted by row with
  ``prepare_rows``, one walk a row in sorted order, every row written
  once) simulated in torch and equal bit for bit to the plain version.
  The kernel itself runs only on the card, where ``chip_smoke.py`` phase
  17 (e) holds every call to the plain version.
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
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_ref, scaled_rows
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.optim.adamw import value_and_grad
from repro_torch.recsys import twotower as TT
from repro_torch.recsys.config import TwoTowerConfig

BWD_TOL = 1e-6
TOL = 1e-5
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bags(seed, B, K, V):
    """ids past both ends of [0, V) (clipped to rows 0 and V-1), about a
    third masked, bag 1 all masked, a hot id repeated across bags."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, V + 3, (B, K)).astype(np.int32)
    ids[:, 0] = 5  # a run of one id across every bag
    mask = rng.random((B, K)) < 0.67
    mask[1] = False
    return ids, mask


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_backward_matches_jax_grad(mode):
    V, D, B, K = 37, 12, 24, 6
    ids, mask = _bags(1, B, K, V)
    rng = np.random.default_rng(2)
    table = rng.normal(size=(V, D)).astype(np.float32)
    dout = rng.normal(size=(B, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: JE.embedding_bag(t, jnp.asarray(ids), jnp.asarray(mask),
                                                mode=mode), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(dout))
    got = embedding_bag_backward_ref(torch.as_tensor(dout), torch.as_tensor(ids),
                                     torch.as_tensor(mask), V, mode=mode)
    assert got.shape == (V, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BWD_TOL, atol=BWD_TOL)
    # the clipped ids send their gradient to rows 0 and V-1
    assert (ids < 0)[mask].any() and (ids >= V)[mask].any() and got[0].abs().sum() > 0

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


def simulate_backward_kernel(dout, ids, mask, n_rows, mode):
    """``csrc/embedding_bag_bwd.cu`` step by step: the bags' terms scaled
    once (``scaled_rows``) and the entries sorted by row
    (``prepare_rows``), then for each row a walk over its run in sorted
    order, adding the terms in fp32, 32 positions at a time and 8 rows in
    flight (the loads first, the adds in order), and the row written once,
    zeros for an empty run."""
    B, K = ids.shape
    g = scaled_rows(dout, mask, mode)
    order, offsets = eb_ops.prepare_rows(ids, mask, n_rows)
    assert order.dtype == offsets.dtype == torch.int32 and offsets.shape == (n_rows + 1,)
    out = torch.empty((n_rows, dout.shape[1]))
    for r in range(n_rows):
        lo, hi = int(offsets[r]), int(offsets[r + 1])
        acc = torch.zeros(dout.shape[1])
        for base in range(lo, hi, 32):
            bags = order[base:min(base + 32, hi)].long() // K
            for j in range(0, len(bags), 8):
                rows = [g[b] for b in bags[j:j + 8]]  # the loads
                for row in rows:  # then the adds, in order
                    acc = acc + row
        out[r] = acc
    return out, order, offsets


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_backward_kernel_walk_simulated(mode):
    V, D, B, K = 40, 16, 64, 9  # the hot id's run spans more than 32 positions
    ids, mask = _bags(3, B, K, V)
    dout = torch.as_tensor(np.random.default_rng(4).normal(size=(B, D)).astype(np.float32))
    ids_t, mask_t = torch.as_tensor(ids), torch.as_tensor(mask)
    got, order, offsets = simulate_backward_kernel(dout, ids_t, mask_t, V, mode)
    want = embedding_bag_backward_ref(dout, ids_t, mask_t, V, mode=mode)
    # the same terms added in the same order: equal bit for bit, as the
    # card's check holds the kernel to this plain version on the host
    assert torch.equal(got, want)
    counts = (offsets[1:] - offsets[:-1]).numpy()
    clipped = np.clip(ids, 0, V - 1)
    np.testing.assert_array_equal(counts, np.bincount(clipped[mask], minlength=V))
    assert counts[5] > 32 and int(offsets[-1]) == int(mask.sum())
    # each row's run keeps its entries in flat (bag, slot) order: a stable sort
    for r in range(V):
        run = order[offsets[r]:offsets[r + 1]].numpy()
        assert (np.diff(run) > 0).all() and (clipped.reshape(-1)[run] == r).all()
    assert not got[counts == 0].any()


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
