"""Parity: the port's LM serving path (forward, prefill, KV-cache decode)
against the JAX package's, fp32, for Yi-6B's SMOKE with GQA (n_kv_heads 2;
the SMOKE has KV = H) and Gemma3-4B's SMOKE (local / global sliding-window
layers), with the reference's parameters carried across by ``interop``.

Tolerance fp32 1e-4 on logits, hidden states and KV caches (a few layers of
fp32 matmuls and softmaxes in another order); next tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as j_gemma, yi_6b as j_yi
from repro.lm import model as JM
from repro_torch import interop
from repro_torch.configs import lm_shapes, yi_6b as t_yi
from repro_torch.lm import LMConfig, model as TM

TOL = 1e-4
S, B, N_DECODE = 16, 2, 3

CONFIGS = {
    "yi_6b_gqa": dataclasses.replace(j_yi.SMOKE, n_kv_heads=2, dtype="float32"),
    "gemma3_4b": dataclasses.replace(j_gemma.SMOKE, dtype="float32"),
}


# the reference's knobs the port leaves out: the chunk sizes of its scan
# attention (the kernel tiles by its own) and a sharding hint
NOT_PORTED = {"attn_q_chunk", "attn_k_chunk", "shard_experts_over"}


def _port_cfg(jcfg):
    """The port's LMConfig with the reference config's shared fields."""
    ported = {f.name for f in dataclasses.fields(LMConfig)}
    return LMConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in ported})


def _setup(name):
    jcfg = CONFIGS[name]
    tcfg = _port_cfg(jcfg)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, tokens


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _j_last_logits(jcfg, jp, tokens):
    """The reference's logits at the last position, through its forward
    (one-row chunks, so any length tiles)."""
    cfg = dataclasses.replace(jcfg, attn_q_chunk=1, attn_k_chunk=1)
    h, _ = JM.forward(cfg, jp, jnp.asarray(tokens))
    return (h[:, -1:] @ jp["unembed"]).astype(jnp.float32)


def test_config_copies():
    assert {f.name for f in dataclasses.fields(j_yi.FULL)} - {
        f.name for f in dataclasses.fields(LMConfig)} == NOT_PORTED
    assert t_yi.FULL == _port_cfg(j_yi.FULL)
    assert t_yi.SMOKE == _port_cfg(j_yi.SMOKE)
    assert t_yi.SHAPES == j_yi.SHAPES and t_yi.SKIPS == j_yi.SKIPS
    assert lm_shapes.LM_SHAPES == j_yi.LM_SHAPES
    full = _port_cfg(j_gemma.FULL)
    assert (full.head_dim, full.param_count(), full.active_param_count()) == (
        j_gemma.FULL.head_dim, j_gemma.FULL.param_count(), j_gemma.FULL.active_param_count())
    assert [full.layer_is_local(i) for i in range(12)] == [
        j_gemma.FULL.layer_is_local(i) for i in range(12)]
    assert TM.param_shapes(t_yi.FULL) == JM.param_shapes(j_yi.FULL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_then_decode_match_reference(name):
    jcfg, tcfg, jp, tp, tokens = _setup(name)
    h, _ = TM.forward(tcfg, tp, torch.as_tensor(tokens))
    _close(h, JM.forward(jcfg, jp, jnp.asarray(tokens))[0])

    logits, cache = TM.prefill_logits(tcfg, tp, torch.as_tensor(tokens))
    j_tok, j_cache = JM.prefill_step(jcfg, jp, jnp.asarray(tokens))
    _close(logits, _j_last_logits(jcfg, jp, tokens))
    _close(cache.k, j_cache.k)
    _close(cache.v, j_cache.v)
    tok, _ = TM.prefill_step(tcfg, tp, torch.as_tensor(tokens))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))

    L = S + N_DECODE
    big = TM.init_kv_cache(tcfg, B, L, device="cpu")
    big.k[:, :, :S], big.v[:, :, :S] = cache.k, cache.v
    shape = (jcfg.n_layers, B, L, jcfg.n_kv_heads, jcfg.head_dim)
    j_big = JM.KVCache(jnp.zeros(shape).at[:, :, :S].set(j_cache.k),
                       jnp.zeros(shape).at[:, :, :S].set(j_cache.v))
    seq = tokens
    for i in range(N_DECODE):
        seq = np.concatenate([seq, tok.numpy()], axis=1)  # the token fed at S + i
        logits, big = TM.decode_logits(tcfg, tp, big, tok, S + i)
        j_tok, j_big = JM.decode_step(jcfg, jp, j_big, j_tok, S + i)
        _close(logits, _j_last_logits(jcfg, jp, seq))
        tok = torch.argmax(logits, -1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
        _close(big.k, j_big.k)
        _close(big.v, j_big.v)


def test_init_rule_not_ported_paths_and_round_trip():
    cfg = CONFIGS["yi_6b_gqa"]
    tcfg = _port_cfg(cfg)
    p = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    # the reference's rule leaves the stacked [L, D] norms normal * L**-0.5
    std = float(p["layers"]["attn_norm"].std()) * cfg.n_layers ** 0.5
    assert 0.5 < std < 1.5
    assert abs(float(p["layers"]["w1"].std()) * cfg.d_model ** 0.5 - 1) < 0.1
    # training is ported (tests/test_torch_train.py holds it to the
    # reference): the loss of random tokens is near log V, and a step runs
    tokens = torch.randint(0, cfg.vocab, (1, 16), generator=torch.Generator().manual_seed(1))
    loss = TM.loss_fn(tcfg, p, tokens, tokens)
    assert abs(float(loss) - np.log(cfg.vocab)) < 1.0
    from repro_torch.optim import adamw

    opt = adamw(1e-3)
    _, state, m = TM.train_step(tcfg, opt)(p, opt.init(p), tokens, tokens)
    assert int(state.step) == 1 and np.isfinite(float(m["grad_norm"]))
    moe = LMConfig(name="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=8,
                   vocab=32, n_experts=4, top_k=2, dtype="float32")
    pm = TM.init_params(moe, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.prefill_step(moe, pm, torch.zeros((1, 4), dtype=torch.int64))

    # fp32 (gemma3) and the reference's default bf16 (yi SMOKE): numpy ->
    # port -> numpy keeps every value (bf16 leaves the port as fp32)
    _, _, jp, tp, _ = _setup("gemma3_4b")
    jp16 = JM.init_params(j_yi.SMOKE, jax.random.PRNGKey(3))
    tp16 = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp16), device="cpu")
    assert tp16["layers"]["wq"].dtype == torch.bfloat16
    for j, t in ((jp, tp), (jp16, tp16)):
        back = interop.params_to_numpy(t)
        want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), j)
        assert back.keys() == want.keys() and back["layers"].keys() == want["layers"].keys()
        for k in ("embed", "unembed", "final_norm"):
            np.testing.assert_array_equal(back[k], want[k])
        for k, v in want["layers"].items():
            np.testing.assert_array_equal(back["layers"][k], v)
