"""Minimal optax-style gradient transforms.

PyTorch twin of ``repro.optim.adamw``, over the same trees (dicts, tuples
and NamedTuples of tensors, in ``jax.tree_util`` leaf order: see
``checkpoint.ckpt.tree_leaves``) and with the same arithmetic and dtype
points: a gradient is cast to fp32, the moments are stored in
``moment_dtype``, and the update is computed in fp32.

One difference, for memory: where the reference's transforms are pure,
these work in place. ``clip_by_global_norm`` scales the gradient tensors
it is given, and ``adamw`` updates its moments in place and writes each
update, cast to its parameter's dtype, into the gradient's buffer (a new
tensor where the two dtypes differ), returning that tree as the updates.
The cast is the one the reference's ``p + u.astype(p.dtype)`` makes, so
the sum a step adds is the same. Every leaf is walked in slices along its
first axis (one layer of a stacked ``[L, ...]`` leaf, or rows of an
embedding) of at most ``SLICE_ELEMS`` elements, so the fp32 temporaries
stay near one slice's size. At Gemma3-4B's widths one fp32 copy of its
largest leaf is 3.3 GiB, and five such copies a leaf would not fit the
card beside the 50.9 GiB of parameters, gradients and moments.

Beside the transforms, the training steps' tree helpers: ``tree_map``,
``global_norm``, ``value_and_grad`` (``jax.value_and_grad`` over a tree of
tensors) and ``apply_updates`` (``p + u.astype(p.dtype)``, in place).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
from repro_torch.kernels import plain_slices

SLICE_ELEMS = 1 << 24  # elements of a leaf's slice: 64 MiB of fp32 a temporary


class GradientTransform(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the
    same structure), as ``jax.tree_util.tree_map``."""
    flat = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def leaf_slices(t: torch.Tensor):
    """Views of ``t`` along its first axis, each of at most
    ``SLICE_ELEMS`` elements (one row at least); ``t`` itself when it is
    small or a scalar."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        return (t,)
    rows = max(1, SLICE_ELEMS // max(1, t.numel() // t.shape[0]))
    return tuple(t[sl] for sl in plain_slices(t.shape[0], rows, t.device))


def global_norm(leaves) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(g.astype(f32) ** 2))`` as an fp32
    scalar tensor on the leaves' device, one slice at a time."""
    dev = leaves[0].device if leaves else torch.device("cpu")
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for g in leaves:
        for s in leaf_slices(g):
            total = total + torch.square(s.to(torch.float32)).sum()
    return torch.sqrt(total)


def value_and_grad(fn, params):
    """``(fn(params), its gradients)``, the gradients a tree like ``params``
    in their dtypes, as ``jax.value_and_grad``. The parameters are taken as
    detached leaves, so ``params`` need not require gradients and is not
    changed. A leaf the value does not depend on gets a zero gradient, as in
    jax (an EGNN's last position update, a NequIP's last vector and matrix
    mixes feed no energy)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        value = fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return value.detach(), tree_unflatten(params, grads)


def apply_updates(params, updates):
    """``p + u.astype(p.dtype)`` for every leaf, as the reference's steps
    apply an optimizer's updates, in place; returns ``params``."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params


def chain(*transforms: GradientTransform) -> GradientTransform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransform(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    """Scales the gradients, in place, by ``min(1, max_norm / norm)``."""

    def init(params):
        return ()

    def update(grads, state, params):
        gn = global_norm(tree_leaves(grads))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        for g in tree_leaves(grads):
            g.mul_(scale.to(g.dtype))
        return grads, state

    return GradientTransform(init, update)


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: object  # tree like params, in moment_dtype
    v: object


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          moment_dtype=torch.float32) -> GradientTransform:
    """AdamW with bias correction and decoupled weight decay; ``lr`` a
    float or a function of the step (an int32 tensor)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    def upd(g, m, v, p, out, lr_t, bc1, bc2):
        g32 = g.to(torch.float32)
        m.copy_(b1 * m.to(torch.float32) + (1 - b1) * g32)
        v.copy_(b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32))
        mhat = m.to(torch.float32) / bc1
        vhat = v.to(torch.float32) / bc2
        u = -lr_t * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32))
        out.copy_(u)

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        step_f = step.to(torch.float32)
        bc1, bc2 = 1 - b1 ** step_f, 1 - b2 ** step_f
        flat_g = tree_leaves(grads)
        flat_m, flat_v, flat_p = tree_leaves(state.m), tree_leaves(state.v), tree_leaves(params)
        updates = []
        with torch.no_grad():
            for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
                out = g if g.dtype == p.dtype else torch.empty_like(p)
                for sl in zip(*(leaf_slices(t) for t in (g, m, v, p, out))):
                    upd(*sl, lr_t, bc1, bc2)
                updates.append(out)
        return tree_unflatten(grads, updates), AdamWState(step=step, m=state.m, v=state.v)

    return GradientTransform(init, update)
