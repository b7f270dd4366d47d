"""Parity: the port's GAT, EGNN and NequIP against the JAX package's, on
the CPU, fp32, at their SMOKE configs, with the reference's parameters
carried across by ``interop``.

For each kind: the parameter layout (and its round trip through numpy),
``forward``, ``loss_fn`` and its gradients within 1e-4 of ``jax.grad``'s,
and two clip + AdamW ``train_step``s (losses within 1e-4; the parameters
after the first within lr x 1e-2 = 1e-4, or 2 lr more where a gradient is
within 1e-5 of 0, since Adam's first step is about lr x sign(g)). Every
segment sum runs through ``segment_spmm`` (counted forward and backward).
EGNN's and NequIP's energies are unchanged by a rotation and translation
of the positions: the property both architectures exist for.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import gnn_kind_sums
import repro.gnn.graph as JG
from repro import configs as j_configs
from repro.gnn import models as JGM
from repro.optim import adamw as j_adamw, chain as j_chain, clip_by_global_norm as j_clip
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.gnn import GNNConfig
from repro_torch.gnn import models as TGM
from repro_torch.kernels.segment_spmm import ops as ss_ops
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.optim.adamw import value_and_grad
from test_torch_fixtures import _torch_test_env  # noqa: F401

TOL = 1e-4
LR = 1e-2
ARCHS = {"gat": "gat-cora", "egnn": "egnn", "nequip": "nequip"}


def _batch(kind, cfg, seed=3, N=48, E=160, n_graphs=4, self_loops=False):
    """A padded batch with masked nodes and edges and nodes that receive no
    edge; positions and per-graph ids for the equivariant kinds; no edge
    from a node to itself unless ``self_loops``."""
    rng = np.random.default_rng(seed)
    eq = kind in ("egnn", "nequip")
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, 3 * N // 4, E).astype(np.int32)
    if not self_loops:  # EGNN's reference gradient is NaN on one (see below)
        dst = np.where(dst == src, (dst + 1) % (3 * N // 4), dst).astype(np.int32)
    return dict(
        node_feat=rng.normal(size=(N, cfg.d_in)).astype(np.float32),
        edge_src=src,
        edge_dst=dst,
        node_mask=rng.random(N) < 0.9,
        edge_mask=rng.random(E) < 0.85,
        labels=rng.integers(0, cfg.n_classes, N).astype(np.int32),
        positions=rng.normal(size=(N, 3)).astype(np.float32) * 1.5 if eq else None,
        graph_ids=(np.arange(N) % n_graphs).astype(np.int32) if eq else None,
        n_graphs=n_graphs if eq else 1,
    )


def _both(d):
    jg = JG.GraphBatch(**{k: v if v is None or k == "n_graphs" else jnp.asarray(v)
                          for k, v in d.items()})
    return jg, interop.graph_batch_from_numpy(d, device="cpu")


def _setup(kind, **over):
    jcfg = dataclasses.replace(j_configs.get_arch(ARCHS[kind]).SMOKE, **over)
    tcfg = GNNConfig(**dataclasses.asdict(jcfg))
    jp = JGM.init_params(jcfg, jax.random.PRNGKey(5))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """The reference's batch, targets, loss and gradients for ``kind``
    (jitted once; the file's two parity tests share them)."""
    jcfg, _, jp, _ = _setup(kind)
    d = _batch(kind, jcfg)
    targets = None
    if kind != "gat":
        targets = np.random.default_rng(4).normal(size=d["n_graphs"]).astype(np.float32)
    jg, _ = _both(d)
    jt = None if targets is None else jnp.asarray(targets)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JGM.loss_fn(jcfg, p, jg, jt)))(jp)
    return d, targets, jloss, jgrads


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_layout_forward_loss_and_grads_match_reference(kind):
    jcfg, tcfg, jp, tp = _setup(kind)
    assert tcfg == t_configs.get_arch(ARCHS[kind]).SMOKE
    # the port's own initialisation has the reference's layout, and the
    # reference's parameters come back from the port unchanged
    own = TGM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: [tuple(x.shape) for x in jax.tree_util.tree_leaves(t)]
    assert shapes(interop.params_to_numpy(own)) == shapes(jp)
    for a, b in zip(jax.tree_util.tree_leaves(interop.params_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))

    d, targets, jloss, jgrads = _reference(kind)
    jg, tg = _both(d)
    tt = None if targets is None else torch.as_tensor(targets)
    out = TGM.forward(tcfg, tp, tg)
    want = (d["node_feat"].shape[0], jcfg.n_classes) if kind == "gat" else (d["n_graphs"],)
    assert out.shape == want
    _close(out, jax.jit(JGM.forward, static_argnums=0)(jcfg, jp, jg))
    sums = []
    inner = ss_ops.csr_sum
    try:
        ss_ops.csr_sum = lambda x, csr, backward=False: sums.append(backward) or inner(
            x, csr, backward)
        tloss, tgrads = value_and_grad(lambda p: TGM.loss_fn(tcfg, p, tg, tt), tp)
    finally:
        ss_ops.csr_sum = inner
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    for a, b in zip(tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        _close(a, b)
    assert (sums.count(False), sums.count(True)) == gnn_kind_sums(kind, tcfg.n_layers), sums


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_train_steps_match_reference(kind):
    jcfg, tcfg, jp, tp = _setup(kind)
    d, targets, _, jgrads = _reference(kind)
    jg, tg = _both(d)
    jt = None if targets is None else jnp.asarray(targets)
    tt = None if targets is None else torch.as_tensor(targets)
    jopt, topt = j_chain(j_clip(1.0), j_adamw(LR)), chain(clip_by_global_norm(1.0), adamw(LR))
    jstep, tstep = jax.jit(JGM.train_step(jcfg, jopt)), TGM.train_step(tcfg, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(2):
        jp, js, jm = jstep(jp, js, jg, jt)
        tp, ts, tm = tstep(tp, ts, tg, tt)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
        if i == 0:
            for a, b, g in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                               jax.tree_util.tree_leaves(jgrads)):
                tol = np.where(np.abs(np.asarray(g)) > 1e-5, LR * 1e-2, 2 * LR + LR * 1e-2)
                assert (np.abs(a.numpy() - np.asarray(b)) <= tol).all(), \
                    float(np.abs(a.numpy() - np.asarray(b)).max())


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


@pytest.mark.parametrize("kind", ["egnn", "nequip"])
def test_energies_are_invariant_under_rotation_and_translation(kind):
    _, tcfg, _, tp = _setup(kind)
    d = _batch(kind, tcfg, seed=8)
    rng = np.random.default_rng(9)
    moved = dict(d, positions=(d["positions"] @ _rotation(rng).T
                               + rng.normal(size=3).astype(np.float32) * 4.0))
    with torch.no_grad():
        e0 = TGM.forward(tcfg, tp, interop.graph_batch_from_numpy(d, device="cpu"))
        e1 = TGM.forward(tcfg, tp, interop.graph_batch_from_numpy(moved, device="cpu"))
    assert float(e0.abs().max()) > 0
    np.testing.assert_allclose(e1.numpy(), e0.numpy(), rtol=1e-4,
                               atol=1e-4 * float(e0.abs().max()))
    # a shear is no symmetry of either: it moves the energies
    sheared = dict(d, positions=d["positions"] * np.array([1.0, 1.0, 3.0], np.float32))
    with torch.no_grad():
        e2 = TGM.forward(tcfg, tp, interop.graph_batch_from_numpy(sheared, device="cpu"))
    assert float((e2 - e0).abs().max()) > 1e-3 * float(e0.abs().max())


def test_egnn_gradient_is_finite_where_the_references_is_nan():
    """EGNN scales each edge's position message by ``1 / max(sqrt(d2), 1)``.
    On an edge from a node to itself d2 = 0, and the reference's gradient
    through ``sqrt`` at 0 is inf x 0 = NaN, masked edge or not. It reaches
    the parameters from the third layer on (the first layer's positions
    are an input, the last layer's feed no loss), so at the FULL config's 4
    layers every step on a graph with a self-loop is NaN; here 3 layers.
    The port takes ``sqrt(max(d2, 1))``, the same values bit for bit, whose
    gradient there is 0; elsewhere the two gradients agree."""
    jcfg, tcfg, jp, tp = _setup("egnn", n_layers=3)
    d = _batch("egnn", jcfg, self_loops=True)
    assert (d["edge_src"] == d["edge_dst"]).any()
    jg, tg = _both(d)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JGM.loss_fn(jcfg, p, jg)))(jp)
    tloss, tgrads = value_and_grad(lambda p: TGM.loss_fn(tcfg, p, tg), tp)
    j_leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    assert any(np.isnan(g).any() for g in j_leaves)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(tgrads))
    for a, b in zip(tree_leaves(tgrads), j_leaves):
        ok = np.isfinite(b)
        np.testing.assert_allclose(a.numpy()[ok], b[ok], rtol=TOL, atol=TOL)
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))

