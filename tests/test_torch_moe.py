"""Parity: the port's MoE against the JAX package's, on the CPU, fp32.

- ``moe_ffn`` (output and load-balancing aux) against
  ``repro.lm.layers.moe_ffn`` on the same numpy inputs, 1e-5: a case that
  drops pairs past the capacity, a case with C = 1, and router
  probabilities that tie (the lower expert first, as ``jax.lax.top_k``).
  The dispatch's kept pairs are held to the capacity formula.
- Grok-1 and Kimi K2 SMOKE (Kimi with its shared expert): ``forward``'s
  hidden states and summed aux, ``loss_fn`` and its gradients (1e-4),
  ``prefill_step`` and 4 ``decode_step``s (the same tokens), with the
  reference's parameters carried across by ``interop``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.lm import layers as JL, model as JM
from repro_torch import configs as t_configs, interop
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.lm import LMConfig, layers as TL, model as TM
from repro_torch.optim.adamw import value_and_grad
from test_torch_fixtures import _torch_test_env  # noqa: F401

TOL = 1e-5
MODEL_TOL = 1e-4


def _inputs(seed, N, D, E, F, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    router = rng.normal(size=(D, E)).astype(np.float32)
    if tie:  # experts 1 and 2 see the same logits, so every token ties them
        router[:, 2] = router[:, 1]
        x[: N // 4] = 0.0  # and these tokens tie all E experts
    w = [rng.normal(size=s).astype(np.float32) * 0.3
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return [x, router, *w]


def _kept(expert, E, C):
    """Pairs the capacity keeps, from the routing alone: per expert,
    min(count, C)."""
    counts = np.bincount(np.asarray(expert).reshape(-1), minlength=E)
    return int(np.minimum(counts, C).sum())


@pytest.mark.parametrize("case", [
    dict(N=48, E=4, k=2, cf=1.25),  # the configs' factor
    dict(N=48, E=8, k=2, cf=0.4),  # drops pairs past C
    dict(N=6, E=8, k=2, cf=0.2),  # C = 1
    dict(N=40, E=6, k=3, cf=1.0, tie=True),  # tied router probabilities
], ids=["cf1.25", "drops", "c1", "ties"])
def test_moe_ffn_matches_reference(case):
    D, F = 16, 8
    arrs = _inputs(7, case["N"], D, case["E"], F, case.get("tie", False))
    kw = dict(top_k=case["k"], capacity_factor=case["cf"])
    j_out, j_aux = jax.jit(JL.moe_ffn, static_argnames=("top_k", "capacity_factor"))(
        *map(jnp.asarray, arrs), **kw)
    t_out, t_aux = TL.moe_ffn(*map(torch.as_tensor, arrs), **kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=TOL, atol=TOL)
    assert abs(float(t_aux) - float(j_aux)) <= TOL * abs(float(j_aux))
    C = TL.moe_capacity(case["N"], case["k"], case["E"], case["cf"])
    assert C == max(1, int(case["N"] * case["k"] / case["E"] * case["cf"]))  # a floor
    probs, gate, expert = TL.moe_route(torch.as_tensor(arrs[0]), torch.as_tensor(arrs[1]),
                                       case["k"])
    j_gate, j_expert = jax.lax.top_k(jax.nn.softmax(jnp.asarray(arrs[0] @ arrs[1]), -1),
                                     case["k"])
    np.testing.assert_array_equal(expert.numpy(), np.asarray(j_expert))
    _, slot, keep = TL.moe_dispatch(expert, case["E"], C)
    assert int(keep.sum()) == _kept(expert, case["E"], C)
    assert (slot[~keep] == case["E"] * C).all() and slot[keep].unique().numel() == keep.sum()
    dropped = case["N"] * case["k"] - int(keep.sum())
    if case.get("tie"):
        assert (expert[: case["N"] // 4] == torch.arange(case["k"])).all()
    elif case["cf"] < 1:
        assert dropped > 0, "the case must drop pairs"
    if case["N"] == 6:
        assert C == 1


def _setup(arch):
    jcfg = dataclasses.replace(j_configs.get_arch(arch).SMOKE, dtype="float32")
    ported = {f.name for f in dataclasses.fields(LMConfig)}
    tcfg = LMConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in ported})
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_moe_model_matches_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    assert tcfg.is_moe and bool(tcfg.n_shared_experts) == (arch == "kimi-k2-1t-a32b")
    # the stacked router / expert leaves (and Kimi's shared expert) round-trip
    back = interop.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(2)
    B, S = 2, 16
    tokens, labels = (rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32) for _ in range(2))
    jh, jaux = jax.jit(lambda p, t: JM.forward(jcfg, p, t))(jp, jnp.asarray(tokens))
    th, taux = TM.forward(tcfg, tp, torch.as_tensor(tokens))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=MODEL_TOL, atol=MODEL_TOL)
    assert float(taux) > 0 and abs(float(taux) - float(jaux)) <= MODEL_TOL * float(jaux)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels))))(jp)
    tloss, tgrads = value_and_grad(
        lambda p: TM.loss_fn(tcfg, p, torch.as_tensor(tokens), torch.as_tensor(labels)), tp)
    assert abs(float(tloss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))
    for a, b in zip(tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=MODEL_TOL, atol=MODEL_TOL)
    assert float(tgrads["layers"]["router"].abs().sum()) > 0  # the aux and gates reach it

    # prefill (the config's capacity factor), then decode at factor 4.0
    jtok, jcache = jax.jit(lambda p, t: JM.prefill_step(jcfg, p, t))(jp, jnp.asarray(tokens))
    ttok, tcache = TM.prefill_step(tcfg, tp, torch.as_tensor(tokens))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    L, KV, dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.d_model // jcfg.n_heads
    jc = JM.init_kv_cache(jcfg, B, S + 4)
    jc = JM.KVCache(jc.k.at[:, :, :S].set(jcache.k), jc.v.at[:, :, :S].set(jcache.v))
    tc = TM.init_kv_cache(tcfg, B, S + 4, device="cpu")
    tc.k[:, :, :S], tc.v[:, :, :S] = tcache.k, tcache.v
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=MODEL_TOL, atol=MODEL_TOL)
    assert tc.k.shape == (L, B, S + 4, KV, dh)
    jt, tt = jtok, ttok
    j_decode = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    for pos in range(S, S + 4):
        jt, jc = j_decode(jp, jc, jt, jnp.int32(pos))
        tt, tc = TM.decode_step(tcfg, tp, tc, tt, pos)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_decode_routes_at_capacity_factor_four(monkeypatch):
    """The decode step routes at capacity factor 4.0 whatever the config's;
    prefill and training at the config's (the reference's rule)."""
    _, tcfg, _, tp = _setup("grok-1-314b")
    seen = []
    inner = TL.moe_ffn
    monkeypatch.setattr(TM, "moe_ffn", lambda *a, **kw: seen.append(kw["capacity_factor"])
                        or inner(*a, **kw))
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    _, cache = TM.prefill_step(tcfg, tp, tokens)
    assert seen == [tcfg.capacity_factor] * tcfg.n_layers
    seen.clear()
    full = TM.init_kv_cache(tcfg, 2, 9, device="cpu")
    full.k[:, :, :8], full.v[:, :, :8] = cache.k, cache.v
    TM.decode_step(tcfg, tp, full, torch.zeros((2, 1), dtype=torch.int64), 8)
    assert seen == [4.0] * tcfg.n_layers


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_launch_train_runs_the_moe_smoke_configs(arch):
    """``launch.train --arch <moe> --smoke`` trains unchanged: finite
    losses, the routers and experts moved."""
    from repro_torch.launch import train as t_train

    keep = {}
    losses = t_train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq",
                           "16", "--device", "cpu", "--log-every", "1"], keep=keep)
    assert len(losses) == 2 and np.isfinite(losses).all()
    # the entry point's own initialisation (seed 0), before its steps
    fresh = TM.init_params(t_configs.get_arch(arch).SMOKE, torch.Generator().manual_seed(0),
                           device="cpu")
    for name in ("router", "we1", "we2"):
        assert not torch.equal(keep["params"]["layers"][name], fresh["layers"][name]), name
