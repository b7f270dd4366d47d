"""Atomic, compressed checkpoints of a tree of tensors.

PyTorch package twin of ``repro.checkpoint.ckpt``, with its on-disk
layout: ``<dir>/step_<n>/`` holds one ``<i>.zst`` blob per leaf (the leaf's
raw bytes, zstd-compressed at level 3, or raw where ``zstandard`` is
missing) and ``manifest.json`` (step, the tree's type name, each leaf's
shape and dtype). A write goes to ``step_<n>.tmp`` and is renamed
into place, so a reader never sees a torn checkpoint.

Leaves are numbered in ``jax.tree_util``'s order: a tuple or NamedTuple's
fields in order, a dict's values by sorted key, depth first. So either
package restores a checkpoint the other wrote; only ``manifest.json``'s
``treedef`` string differs, and neither package reads it.

``restore_checkpoint`` takes a ``device`` where the reference takes
``shardings``. A bf16 leaf is written as its raw 2-byte values under the
dtype name ``bfloat16``, as the reference's ``ml_dtypes`` leaves are.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.utils import resolve_device

try:
    import zstandard as zstd
except ImportError:  # the card's machine may not have it: raw bytes then
    zstd = None

CODEC = "zstd" if zstd else "raw"


def _comp(b: bytes) -> bytes:
    return zstd.ZstdCompressor(level=3).compress(b) if zstd else b


def _decomp(b: bytes) -> bytes:
    return zstd.ZstdDecompressor().decompress(b) if zstd else b


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def tree_leaves(tree) -> list:
    """The leaves of a tree of tuples, NamedTuples and dicts, in
    ``jax.tree_util.tree_leaves`` order (``None`` has none)."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if _is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        children = [build(x) for x in t]
        if hasattr(t, "_fields"):
            return type(t)(*children)
        return type(t)(children)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _host(leaf):
    """``(the leaf's bytes as a numpy array, its dtype name)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    return leaf, str(leaf.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write every leaf of ``tree`` under ``<ckpt_dir>/step_<step>``, then
    publish it with one rename. Returns the published path."""
    leaves = tree_leaves(tree)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    # the reference writes jax's treedef string here; neither package reads it
    manifest = {"step": step, "treedef": type(tree).__name__, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _host(leaf)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, f"{i}.zst"), "wb") as f:
            f.write(_comp(np.ascontiguousarray(arr).tobytes()))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str):
    """The newest published step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, template, device=None):
    """Restore into the structure of ``template`` (a tree of tensors, such
    as ``meta`` tensors that carry only shapes and dtypes), each leaf a
    tensor on ``device`` (CUDA unless another is named)."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    t_leaves = tree_leaves(template)
    if len(t_leaves) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint {path} holds {len(manifest['leaves'])} leaves, "
                         f"the template {len(t_leaves)}")
    out = []
    for i, (tmpl, meta) in enumerate(zip(t_leaves, manifest["leaves"])):
        bf16 = meta["dtype"] == "bfloat16"
        with open(os.path.join(path, f"{i}.zst"), "rb") as f:
            raw = _decomp(f.read())
        arr = np.frombuffer(raw, dtype=np.int16 if bf16 else np.dtype(meta["dtype"]))
        arr = arr.reshape(meta["shape"])
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i} of {path}: shape {arr.shape} != {tuple(tmpl.shape)}")
        t = torch.from_numpy(arr.copy())
        out.append((t.view(torch.bfloat16) if bf16 else t).to(dev))
    return tree_unflatten(template, out)
