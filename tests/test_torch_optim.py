"""Parity: the port's optimizer transforms (``repro_torch.optim``) against
the JAX package's, fed the same numpy gradients for 3 steps.

The port's transforms work in place (they scale and overwrite the gradient
tensors they are given, and return AdamW's updates cast to the parameters'
dtype), so each step hands them fresh copies, and the reference's updates
are compared after the same cast. Tolerance 1e-6: the same fp32
arithmetic, summed in another order for the global norm.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (adamw as j_adamw, chain as j_chain, clip_by_global_norm as j_clip,
                         cosine_schedule as j_cosine, int8_compress_grads as j_int8)
from repro_torch import interop
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.optim import (adamw, chain, clip_by_global_norm, cosine_schedule,
                               int8_compress_grads)

# the modules (the packages export their functions under the same names)
j_adamw_mod = importlib.import_module("repro.optim.adamw")
t_adamw_mod = importlib.import_module("repro_torch.optim.adamw")

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny tensors: a pool's spin
    waits slow them many times over when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, dtype=np.float32):
    """A tree like an LM's and a GNN's at once: a dict with a stacked
    [L, ...] dict, a list of (w, b) pairs, a scalar-shaped vector."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "embed": f(7, 5),
        "layers": {"wq": f(3, 5, 6), "norm": f(3, 5)},
        "head": [(f(5, 4), f(4)), (f(4, 2), f(2))],
        "final_norm": f(5),
    }


def _j(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _t(tree, dtype):
    """Torch copies (the port's transforms write into what they are given)."""
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)).to(dtype), tree)


def _close(got, want, tol=TOL):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().to(torch.float32).numpy(),
                                   np.asarray(b, np.float32), rtol=tol, atol=tol)


CASES = {
    # name: (make the two optimizers, param dtype)
    "adamw": (lambda m: (m[0].adamw(1e-2), m[1].adamw(1e-2)), "float32"),
    "chain_clip_cosine_wd": (lambda m: (
        m[0].chain(m[0].clip_by_global_norm(0.5),
                   m[0].adamw(m[0].cosine_schedule(3e-2, warmup=2, total=5), weight_decay=0.1)),
        m[1].chain(m[1].clip_by_global_norm(0.5),
                   m[1].adamw(m[1].cosine_schedule(3e-2, warmup=2, total=5), weight_decay=0.1))),
        "float32"),
    "bf16_params_bf16_moments": (lambda m: (
        m[0].adamw(1e-2, moment_dtype=jnp.bfloat16), m[1].adamw(1e-2, moment_dtype=torch.bfloat16)),
        "bfloat16"),
}


class _Mods:
    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Mods(adamw=j_adamw, chain=j_chain, clip_by_global_norm=j_clip, cosine_schedule=j_cosine)
T = _Mods(adamw=adamw, chain=chain, clip_by_global_norm=clip_by_global_norm,
          cosine_schedule=cosine_schedule)


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_steps_match_reference(name):
    make, dt = CASES[name]
    jopt, topt = make((J, T))
    jdt, tdt = jnp.dtype(dt), {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    jp, tp = _j(p0, jdt), _t(p0, tdt)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: a * (10.0 if step == 1 else 1.0), _tree(rng))
        ju, js = jopt.update(_j(g, jdt), js, jp)
        tu, ts = topt.update(_t(g, tdt), ts, tp)
        # the port returns the updates cast to the parameters' dtype
        _close(tu, jax.tree_util.tree_map(lambda u, p: u.astype(p.dtype), ju, jp))
        jp = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), jp, ju)
        for p, u in zip(tree_leaves(tp), tree_leaves(tu)):
            p.add_(u.to(p.dtype))
        _close(tp, jp)
        jadam = js if hasattr(js, "step") else js[-1]
        tadam = ts if hasattr(ts, "step") else ts[-1]
        assert int(tadam.step) == int(jadam.step) == step + 1
        _close(tadam.m, jadam.m)
        _close(tadam.v, jadam.v)
        # the state crosses to the reference and back through interop
        back = interop.opt_state_from_numpy(
            interop.opt_state_to_numpy(ts), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(ts)))


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(4))
    ju, _ = j_clip(max_norm).update(_j(g, jnp.float32), (), None)
    tg = _t(g, torch.float32)
    tu, _ = clip_by_global_norm(max_norm).update(tg, (), None)
    _close(tu, ju)
    assert tree_leaves(tu)[0] is tree_leaves(tg)[0]  # scaled in place
    want = np.sqrt(sum(float(np.sum(np.square(a))) for a in jax.tree_util.tree_leaves(g)))
    assert abs(float(t_adamw_mod.global_norm(tree_leaves(_t(g, torch.float32)))) - want) \
        <= 1e-6 * want


def test_cosine_schedule_matches_reference():
    jl, tl = j_cosine(1e-3, warmup=10, total=50), cosine_schedule(1e-3, warmup=10, total=50)
    for step in [0, 1, 5, 9, 10, 11, 30, 49, 50, 70]:
        want = float(jl(step))
        assert abs(float(tl(step)) - want) <= 1e-7 * max(abs(want), 1e-3), step
        assert abs(float(tl(torch.tensor(step, dtype=torch.int32))) - want) <= 1e-10 + 1e-7 * want


def test_int8_compress_grads_matches_reference():
    """Three steps of error feedback on leaves whose sizes are not multiples
    of the 256-value block, one of them bf16, and one leaf of zeros (the
    scale's floor)."""
    rng = np.random.default_rng(5)
    jr = tr = None
    for _ in range(3):
        g = {"a": rng.standard_normal((3, 301)).astype(np.float32),
             "b": (rng.standard_normal(700) * 1e-3).astype(np.float32),
             "z": np.zeros((2, 5), np.float32)}
        jg = {"a": jnp.asarray(g["a"]), "b": jnp.asarray(g["b"], jnp.bfloat16),
              "z": jnp.asarray(g["z"])}
        tg = {"a": torch.as_tensor(g["a"]), "b": torch.as_tensor(g["b"]).to(torch.bfloat16),
              "z": torch.as_tensor(g["z"])}
        jd, jr = j_int8(jg, jr)
        td, tr = int8_compress_grads(tg, tr)
        assert td["b"].dtype == torch.bfloat16 and tr["b"].dtype == torch.float32
        _close(td, jd)
        _close(tr, jr)


def test_tree_map_follows_jax_leaf_order():
    tree = _tree(np.random.default_rng(6))
    tt = _t(tree, torch.float32)
    assert [tuple(x.shape) for x in tree_leaves(tt)] == [
        x.shape for x in jax.tree_util.tree_leaves(tree)]
    doubled = t_adamw_mod.tree_map(lambda a, b: a + b, tt, tt)
    assert isinstance(doubled["head"], list) and isinstance(doubled["head"][0], tuple)
    _close(doubled, jax.tree_util.tree_map(lambda a: 2 * a, tree))


def test_leaf_slices_bound_the_temporaries(monkeypatch):
    """A stacked leaf is walked a layer at a time, a wide one a few rows at
    a time, a small one whole; AdamW over slices equals AdamW over whole
    leaves."""
    monkeypatch.setattr(t_adamw_mod, "SLICE_ELEMS", 40)
    assert [s.shape for s in t_adamw_mod.leaf_slices(torch.zeros(3, 5, 6))] == [(1, 5, 6)] * 3
    assert [s.shape[0] for s in t_adamw_mod.leaf_slices(torch.zeros(20, 3))] == [13, 7]
    assert len(t_adamw_mod.leaf_slices(torch.zeros(8, 5))) == 1
    assert len(t_adamw_mod.leaf_slices(torch.zeros(()))) == 1
    rng = np.random.default_rng(7)
    p0, g = _tree(rng), _tree(rng)
    outs = []
    for elems in (40, 1 << 30):
        monkeypatch.setattr(t_adamw_mod, "SLICE_ELEMS", elems)
        opt = adamw(1e-2, weight_decay=0.1)
        tp = _t(p0, torch.float32)
        u, s = opt.update(_t(g, torch.float32), opt.init(tp), tp)
        outs.append(tree_leaves(u) + tree_leaves(s.m) + tree_leaves(s.v))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert j_adamw_mod.AdamWState._fields == t_adamw_mod.AdamWState._fields
