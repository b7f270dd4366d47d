"""Parity: the port's LM training path against the JAX package's, on the
CPU, with the reference's parameters carried across by ``interop``.

- ``loss_fn``, its gradients and one ``train_step`` (clip + AdamW), on
  Gemma3-4B SMOKE (local / global sliding-window layers) and Yi-6B SMOKE
  with GQA. fp32: loss 1e-5 relative, gradients 1e-4, the parameters after
  the step within lr x 1e-2 (Adam's first step is about lr x sign(g), so a
  gradient within ~1e-5 of 0 may move its parameter by another fraction of
  lr, or flip: 2 lr). bf16: loss 1e-2 relative, each gradient leaf within
  5e-2 relative norm, the parameters after the step within 2 lr and the
  bf16 rounding of the new value (bf16 rounds the two packages' matmuls
  and norms at other points, so a small gradient may change sign).
- ``launch.train``: ``synthetic_batches`` gives the reference's tokens;
  ``main`` through a checkpoint and ``--resume`` gives the uninterrupted
  run's losses; ``--compress-grads`` runs; the checkpoint (bf16 leaves
  included) is read by the reference's ``restore_checkpoint``.
- The configs registry holds the reference's architectures as data.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.checkpoint import restore_checkpoint as j_restore
from repro.launch import train as j_train
from repro.lm import model as JM
from repro.optim import adamw as j_adamw, chain as j_chain, clip_by_global_norm as j_clip
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.launch import train as t_train
from repro_torch.lm import LMConfig, model as TM
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.optim.adamw import value_and_grad

LR = 1e-2
B, S = 2, 32

CONFIGS = {
    "gemma3_4b": j_configs.get_arch("gemma3-4b").SMOKE,
    "yi_6b_gqa": dataclasses.replace(j_configs.get_arch("yi-6b").SMOKE, n_kv_heads=2),
}
# dtype: (loss relative, gradient tolerance, parameters after the step)
TOLS = {"float32": (1e-5, 1e-4, LR * 1e-2), "bfloat16": (1e-2, 5e-2, 2 * LR)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    ported = {f.name for f in dataclasses.fields(LMConfig)}
    return LMConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in ported})


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else \
        x.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_grads_and_train_step_match_reference(name, dtype):
    jcfg = dataclasses.replace(CONFIGS[name], dtype=dtype)
    tcfg = _port_cfg(jcfg)
    loss_tol, grad_tol, param_tol = TOLS[dtype]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    tokens, labels = (rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32) for _ in range(2))

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels))))(jp)
    tloss, tgrads = value_and_grad(
        lambda p: TM.loss_fn(tcfg, p, torch.as_tensor(tokens), torch.as_tensor(labels)), tp)
    assert abs(float(tloss) - float(jloss)) <= loss_tol * abs(float(jloss))
    for a, b in zip(tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert a.dtype == tp["embed"].dtype
        if dtype == "float32":
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=grad_tol, atol=grad_tol)
        else:
            rel = np.linalg.norm(_f32(a) - _f32(b)) / max(np.linalg.norm(_f32(b)), 1e-30)
            assert rel <= grad_tol, rel

    # the reference's train_step is value_and_grad, the optimizer and
    # p + u.astype(p.dtype): the same from the gradients above
    jopt = j_chain(j_clip(1.0), j_adamw(LR))
    ju, _ = jopt.update(jgrads, jopt.init(jp), jp)
    jnew = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), jp, ju)
    jnorm = np.sqrt(sum(float(jnp.sum(jnp.square(g.astype(jnp.float32))))
                        for g in jax.tree_util.tree_leaves(jgrads)))
    topt = chain(clip_by_global_norm(1.0), adamw(LR))
    tstate = topt.init(tp)
    tnew, tstate, m = TM.train_step(tcfg, topt)(tp, tstate, torch.as_tensor(tokens),
                                                 torch.as_tensor(labels))
    assert tnew is tp  # in place
    assert abs(float(m["loss"]) - float(jloss)) <= loss_tol * abs(float(jloss))
    assert abs(float(m["grad_norm"]) - jnorm) <= max(loss_tol, 1e-5) * 10 * jnorm
    assert int(tstate[1].step) == 1
    for a, b, g in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew),
                       jax.tree_util.tree_leaves(jgrads)):
        b = _f32(b)
        if dtype == "float32":
            # a gradient within ~1e-5 of 0 may take another fraction of lr
            # or flip (u = -lr g / (|g| + eps) on the first step)
            tol = np.where(np.abs(_f32(g)) > 1e-5, param_tol, 2 * LR + param_tol)
        else:
            # a flip of u (itself rounded to bf16), and the bf16 rounding of
            # p + u on either side (half a step of each side's value at most)
            tol = param_tol * (1 + 2.0**-7) + 2.0**-8 * (np.abs(_f32(a)) + np.abs(b))
        assert (np.abs(_f32(a) - b) <= tol).all(), float(np.abs(_f32(a) - b).max())


def test_forward_remats_blocks_and_never_builds_full_logits(monkeypatch):
    """With ``remat`` each block runs again in the backward (the attention
    forward twice a layer, its backward once); the loss's largest logits
    are one chunk's."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg = _port_cfg(dataclasses.replace(CONFIGS["gemma3_4b"], dtype="float32"))
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa_ops.flash_attention_ref, fa_ops.flash_attention_bwd_ref
    monkeypatch.setattr(fa_ops, "flash_attention_ref",
                        lambda *a, **k: calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a, **k))
    monkeypatch.setattr(fa_ops, "flash_attention_bwd_ref",
                        lambda *a, **k: calls.__setitem__("bwd", calls["bwd"] + 1) or bwd(*a, **k))
    widest = []
    inner = TM._chunk_nll
    monkeypatch.setattr(TM, "_chunk_nll",
                        lambda hs, u, ls: widest.append(hs.shape[1]) or inner(hs, u, ls))
    for remat, want in ((True, 2), (False, 1)):
        calls.update(fwd=0, bwd=0)
        widest.clear()
        c = dataclasses.replace(cfg, remat=remat)
        value_and_grad(lambda p: TM.loss_fn(c, p, tokens, tokens), tp)
        assert calls == {"fwd": want * cfg.n_layers, "bwd": cfg.n_layers}, (remat, calls)
        assert max(widest) == cfg.loss_chunk < S
    with torch.no_grad():
        calls.update(fwd=0, bwd=0)
        TM.loss_fn(cfg, tp, tokens, tokens)
        assert calls == {"fwd": cfg.n_layers, "bwd": 0}
    moe = LMConfig(name="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=8,
                   vocab=32, n_experts=4, top_k=2, dtype="float32", loss_chunk=4)
    pm = TM.init_params(moe, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.loss_fn(moe, pm, torch.zeros((1, 4), dtype=torch.int64),
                   torch.zeros((1, 4), dtype=torch.int64))


def test_synthetic_batches_are_the_references():
    j = j_train.synthetic_batches(512, 3, 16, seed=4)
    t = t_train.synthetic_batches(512, 3, 16, seed=4, device="cpu")
    for _ in range(3):
        (jt, jl), (tt, tl) = next(j), next(t)
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


ARGS = ["--arch", "gemma3-4b", "--smoke", "--batch", "2", "--seq", "16", "--lr", "1e-2",
        "--log-every", "3", "--device", "cpu"]


def test_main_resumes_to_the_uninterrupted_losses(tmp_path):
    """Six steps with a checkpoint at 3, then a run resumed from it: its
    steps 4-6 give the uninterrupted run's losses (the resumed run takes up
    the data stream at batch 4); the loss falls; the checkpoint, bf16
    parameters and the optimizer state, reads back in the reference."""
    ckpt = str(tmp_path / "ckpt")
    keep = {}
    full = t_train.main(ARGS + ["--steps", "6", "--ckpt", ckpt, "--ckpt-every", "3"], keep=keep)
    assert len(full) == 6 and len(keep["step_s"]) == 6 and all(np.isfinite(full))
    assert full[-1] < full[0]
    # a run that died after step 3: only that checkpoint on its disk
    shutil.copytree(os.path.join(ckpt, "step_3"), os.path.join(ckpt + "_r", "step_3"))
    resumed = t_train.main(
        ARGS + ["--steps", "6", "--ckpt", ckpt + "_r", "--ckpt-every", "3", "--resume"])
    assert len(resumed) == 3
    np.testing.assert_allclose(resumed, full[3:], rtol=1e-6, atol=0)

    # the reference reads the port's checkpoint of step 6
    jcfg = j_configs.get_arch("gemma3-4b").SMOKE
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = j_chain(j_clip(1.0), j_adamw(1e-2))
    got = j_restore(ckpt, 6, (jp, jopt.init(jp)))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    tree_leaves((keep["params"], keep["opt_state"]))):
        assert a.shape == tuple(b.shape) and jnp.dtype(a.dtype).name == str(b.dtype)[6:]
        np.testing.assert_array_equal(np.asarray(jnp.asarray(a, jnp.float32)), _f32(b))


def test_main_with_compressed_grads(tmp_path):
    losses = t_train.main(ARGS + ["--steps", "4", "--compress-grads"])
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_configs_registry_holds_the_references_data():
    """Every architecture of the reference's registry, as data: FAMILY,
    SHAPES, SKIPS and each config's shared fields (the LM configs less the
    attention chunk sizes and the expert-sharding hint, the graph config
    less its name and its route cap factor, which the port does not read),
    and the same cells."""
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    assert t_configs.all_cells() == j_configs.all_cells()
    assert t_configs.all_cells(False) == j_configs.all_cells(False)
    for arch in j_configs.ARCH_IDS:
        jm, tm = j_configs.get_arch(arch), t_configs.get_arch(arch)
        assert tm.__name__ == f"repro_torch.configs.{arch.replace('-', '_')}"
        assert (tm.FAMILY, tm.SHAPES, tm.SKIPS) == (jm.FAMILY, jm.SHAPES, jm.SKIPS), arch
        for which in ("FULL", "SMOKE"):
            j, t = dataclasses.asdict(getattr(jm, which)), dataclasses.asdict(getattr(tm, which))
            left_out = set(j) - set(t)
            assert left_out <= {"attn_q_chunk", "attn_k_chunk", "shard_experts_over", "name",
                                "route_cap_factor"}, left_out
            assert {k: j[k] for k in t} == t, (arch, which)
