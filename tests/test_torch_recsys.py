"""Parity: the port's two-tower serving path (towers, ``serve_step``,
``retrieval_step``) against the JAX package's at ``SMOKE``, with the
reference's parameters carried across by ``interop``.

Tolerance fp32 1e-5 (the bag sums and the tower matmuls in another order).
``best`` and the top-k ids must be equal wherever the reference's scores
separate them by more than that tolerance (a tie within it may flip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as j_cfgs
from repro.recsys import twotower as JT
from repro_torch import interop
from repro_torch.configs import two_tower_retrieval as t_cfgs
from repro_torch.recsys import twotower as TT

TOL = 1e-5
CFG = t_cfgs.SMOKE


def _params():
    jp = JT.init_params(j_cfgs.SMOKE, jax.random.PRNGKey(0))
    return jp, interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                         device="cpu")


def _bags(rng, B, F, K, vocab):
    """Bags with ids past both ends of the vocab, ragged lengths and one
    all-masked bag."""
    ids = rng.integers(-4, vocab + 4, (B, F, K)).astype(np.int32)
    mask = np.arange(K)[None, None, :] < rng.integers(1, K + 1, (B, F))[..., None]
    mask[0, 1] = False
    return ids, mask


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _separated(scores, k):
    """Ranks i < k of the reference's descending scores whose score is more
    than TOL away from both neighbours."""
    s = np.sort(np.asarray(scores), axis=-1)[..., ::-1]
    gap = np.abs(np.diff(s, axis=-1)) > TOL
    left = np.concatenate([np.ones_like(gap[..., :1]), gap], -1)
    right = np.concatenate([gap, np.ones_like(gap[..., :1])], -1)
    return (left & right)[..., :k], s


def test_config_copy_and_param_count():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(j_cfgs.SMOKE)
    assert dataclasses.asdict(t_cfgs.FULL) == dataclasses.asdict(j_cfgs.FULL)
    assert t_cfgs.SHAPES == j_cfgs.SHAPES
    assert t_cfgs.FULL.param_count() == j_cfgs.FULL.param_count()
    assert TT.param_shapes(CFG) == JT.param_shapes(j_cfgs.SMOKE)


def test_towers_serve_and_retrieval_match_reference():
    jp, tp = _params()
    rng = np.random.default_rng(0)
    B, C, N = 8, 12, 64
    ub, um = _bags(rng, B, CFG.user_fields, CFG.bag_size, CFG.user_vocab)
    ib, im = _bags(rng, N, CFG.item_fields, CFG.bag_size, CFG.item_vocab)
    T = torch.as_tensor
    u = TT.user_tower(CFG, tp, T(ub), T(um))
    _close(u, JT.user_tower(j_cfgs.SMOKE, jp, jnp.asarray(ub), jnp.asarray(um)))
    corpus_j = JT.item_tower(j_cfgs.SMOKE, jp, jnp.asarray(ib), jnp.asarray(im))
    corpus = TT.item_tower(CFG, tp, T(ib), T(im))
    _close(corpus, corpus_j)

    cand = rng.integers(0, N, (B, C))
    item_emb = np.asarray(corpus_j)[cand]
    scores, best = TT.serve_step(CFG, tp, T(ub), T(um), T(item_emb))
    j_scores, j_best = JT.serve_step(j_cfgs.SMOKE, jp, jnp.asarray(ub), jnp.asarray(um),
                                     jnp.asarray(item_emb))
    _close(scores, j_scores)
    sep, _ = _separated(j_scores, 1)
    assert sep.any()
    np.testing.assert_array_equal(best.numpy()[sep[:, 0]], np.asarray(j_best)[sep[:, 0]])

    k = 10
    vals, idx = TT.retrieval_step(CFG, tp, T(ub[:2]), T(um[:2]), T(np.array(corpus_j)), k=k)
    j_vals, j_idx = JT.retrieval_step(j_cfgs.SMOKE, jp, jnp.asarray(ub[:2]),
                                      jnp.asarray(um[:2]), corpus_j, k=k)
    _close(vals, j_vals)
    j_all = np.asarray(u[:2].numpy() @ np.asarray(corpus_j).T)
    sep, s = _separated(j_all, k)
    np.testing.assert_array_equal(idx.numpy()[sep], np.asarray(j_idx)[sep])
    for r in range(2):  # the k-th / (k+1)-th boundary: the same set when separated
        if s[r, k - 1] - s[r, k] > TOL:
            assert set(idx[r].tolist()) == set(np.asarray(j_idx)[r].tolist())


def test_init_rule_and_training_not_ported():
    p = TT.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == TT.param_shapes(CFG)
    for name, v in p.items():
        if "_b" in name:
            assert not v.any(), name
        else:  # normal * shape[0] ** -0.5
            assert abs(float(v.std()) * v.shape[0] ** 0.5 - 1) < 0.1, name
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.loss_fn(CFG, p, {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.train_step(CFG, None)


def test_params_round_trip_through_numpy():
    jp, tp = _params()
    back = interop.params_to_numpy(tp)
    assert back.keys() == jp.keys()
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))


@pytest.mark.parametrize("k", [10, 100])
def test_top_k_breaks_ties_as_lax_top_k(k):
    """Exact ties planted among the top scores, in every row across rank k
    and in one row filling it: ``top_k`` gives ``jax.lax.top_k``'s ids and
    values exactly (the lower index first among equal scores), which
    ``torch.topk`` does not promise."""
    rng = np.random.default_rng(k)
    s = rng.normal(size=(4, 5000)).astype(np.float32)
    for r in range(3):
        kth = np.sort(s[r])[::-1][k - 1]
        s[r, rng.choice(5000, size=60 * (r + 1), replace=False)] = kth
    s[3, rng.choice(5000, size=2 * k, replace=False)] = s[3].max() + 1
    vals, ids = TT.top_k(torch.as_tensor(s), k)
    j_vals, j_ids = jax.lax.top_k(jnp.asarray(s), k)
    assert ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


def test_top_k_orders_signed_zeros_and_nans_as_lax_top_k():
    s = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, np.nan, -1.0, np.inf, -np.nan, -np.inf]],
                 np.float32)
    vals, ids = TT.top_k(torch.as_tensor(s), s.shape[1])
    j_vals, j_ids = jax.lax.top_k(jnp.asarray(s), s.shape[1])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(np.signbit(vals.numpy()), np.signbit(np.asarray(j_vals)))
    with pytest.raises(ValueError):
        TT.top_k(torch.as_tensor(s), s.shape[1] + 1)


def test_retrieval_step_ids_on_repeated_corpus_rows():
    """A corpus of 20 distinct rows, each repeated, whose scores for the
    users lie 0.01 apart: both packages score repeats exactly equal, so
    the top-k ids must be equal in full, ties and rank k included."""
    jp, tp = _params()
    rng = np.random.default_rng(5)
    ub, um = _bags(rng, 2, CFG.user_fields, CFG.bag_size, CFG.user_vocab)
    u = np.asarray(JT.user_tower(j_cfgs.SMOKE, jp, jnp.asarray(ub), jnp.asarray(um)))[0]
    # distinct rows: score c_i along u for user 0, plus noise orthogonal to u
    noise = rng.normal(size=(20, u.shape[0]))
    noise -= np.outer(noise @ u, u) / (u @ u)
    base = (np.linspace(-0.1, 0.1, 20)[:, None] * u / (u @ u) + 0.01 * noise).astype(np.float32)
    corpus = base[rng.integers(0, 20, 64)]
    k = 8
    s = np.sort(u @ corpus.T)[::-1]
    assert s[k - 1] == s[k], "no tie across rank k"
    vals, idx = TT.retrieval_step(CFG, tp, torch.as_tensor(ub[:1]), torch.as_tensor(um[:1]),
                                  torch.as_tensor(corpus), k=k)
    j_vals, j_idx = JT.retrieval_step(j_cfgs.SMOKE, jp, jnp.asarray(ub[:1]),
                                      jnp.asarray(um[:1]), jnp.asarray(corpus), k=k)
    _close(vals, j_vals)
    j_vals, j_idx = np.asarray(j_vals), np.asarray(j_idx)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
