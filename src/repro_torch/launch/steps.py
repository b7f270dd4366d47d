"""Per-family step builders and their argument specs, for the dry-run.

PyTorch twin of ``repro.launch.steps``. ``build_cell(arch_id, shape_name,
mesh)`` returns ``(step_fn, arg_specs, args)``: the step of one
(architecture x shape) cell, its arguments at the cell's global shapes, and
a tree like ``args`` holding each tensor leaf's spec (a tuple with one
entry a dimension: None, an axis name or a tuple of axis names, validated
against ``mesh`` as the reference validates its ``in_shardings``).
``device="meta"`` (the default) builds the arguments as ``meta`` tensors,
which allocate nothing; a real device builds the same tree with values
drawn from ``generator``.

Shapes are padded to multiples of 512 where the published number is
indivisible (masked padding), as in the reference. A decode cell's
position is a Python int (``lm.model.decode_step`` takes one), counted as
the reference's int32 scalar. ``cell_leaves`` and ``argument_bytes`` read
a built cell: each leaf's (shape, dtype, spec), and the bytes one device
holds under the specs (each dimension divided by its axes' sizes).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch import configs as configs_pkg
from repro_torch.distributed.sharding import (add_data_axis, maybe_spec, tree_map_with_path,
                                               tree_shardings)
from repro_torch.optim import adamw, chain, clip_by_global_norm

BATCH_AXES = ("pod", "data")
ALL_AXES = ("pod", "data", "model")
# above this many parameters the AdamW moments are kept in bf16, as the
# reference keeps them (a 1T model's fp32 moments fit no mesh's share)
BF16_MOMENTS_ABOVE = 3e11


def _pad512(n: int) -> int:
    return ((n + 511) // 512) * 512


def _tok_spec(mesh, shape):
    return maybe_spec(shape, (BATCH_AXES, None), mesh)


class _Maker:
    """Tensors on ``device``: ``meta`` shapes, or values from ``generator``."""

    def __init__(self, device, generator):
        self.dev = torch.device(device)
        self.meta = self.dev.type == "meta"
        if not self.meta and generator is None:
            raise ValueError("a cell built on a real device draws its values from a generator")
        self.gen = generator

    def ints(self, shape, hi, dtype=torch.int32):
        if self.meta:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        return torch.randint(0, hi, shape, dtype=dtype, generator=self.gen,
                             device=self.gen.device).to(self.dev)

    def bools(self, shape):
        if self.meta:
            return torch.empty(shape, dtype=torch.bool, device=self.dev)
        return (torch.rand(shape, generator=self.gen, device=self.gen.device) < 0.75).to(self.dev)

    def ones(self, shape, dtype=torch.bool):
        return torch.ones(shape, dtype=dtype, device=self.dev)

    def normal(self, shape, dtype=torch.float32):
        if self.meta:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        x = torch.randn(shape, generator=self.gen, device=self.gen.device)
        return x.to(device=self.dev, dtype=dtype)


# ---------------------------------------------------------------- LM
def _lm_cell(cfg, info, mesh, mk: _Maker):
    from repro_torch.lm import model as lm_model

    moment_dtype = torch.bfloat16 if cfg.param_count() > BF16_MOMENTS_ABOVE else torch.float32
    if mk.meta:
        params = lm_model.abstract_params(cfg)
    else:
        params = lm_model.init_params(cfg, mk.gen, device=mk.dev)
    rule = lm_model.param_spec_rule(cfg)
    pspec = tree_shardings(params, rule, mesh)
    S, B = info["seq_len"], info["global_batch"]

    if info["kind"] == "train":
        opt = chain(clip_by_global_norm(1.0), adamw(3e-4, moment_dtype=moment_dtype))
        opt_state = opt.init(params)
        # ZeRO-1: moments take the param spec + a data axis
        mspec = tree_map_with_path(
            lambda path, leaf: add_data_axis(maybe_spec(leaf.shape, rule(path, leaf), mesh),
                                             leaf.shape, mesh, axes=("data",)), opt_state)
        step = lm_model.train_step(cfg, opt)
        tokens, labels = mk.ints((B, S), cfg.vocab), mk.ints((B, S), cfg.vocab)
        specs = (pspec, mspec, _tok_spec(mesh, (B, S)), _tok_spec(mesh, (B, S)))
        return step, specs, (params, opt_state, tokens, labels)

    if info["kind"] == "prefill":
        step = functools.partial(lm_model.prefill_step, cfg)
        return step, (pspec, _tok_spec(mesh, (B, S))), (params, mk.ints((B, S), cfg.vocab))

    if info["kind"] == "decode":
        cache = lm_model.init_kv_cache(cfg, B, S, device=mk.dev)
        cspec = tree_shardings(cache, lm_model.kv_cache_spec_rule(cfg), mesh)
        step = functools.partial(lm_model.decode_step, cfg)
        # the step at the cache's last position: every slot attended
        specs = (pspec, cspec, _tok_spec(mesh, (B, 1)), ())
        return step, specs, (params, cache, mk.ints((B, 1), cfg.vocab), S - 1)

    raise ValueError(info["kind"])


# ---------------------------------------------------------------- GNN
def _gnn_cell(cfg, info, mesh, mk: _Maker):
    from repro_torch.gnn.graph import GraphBatch
    from repro_torch.gnn.models import init_params, train_step

    cfg = dataclasses.replace(cfg, d_in=info["d_feat"], n_classes=max(info["n_classes"], 2))
    N, E = _pad512(info["n_nodes"]), _pad512(info["n_edges"])
    ng = info.get("n_graphs", 1)
    F = info["d_feat"]
    g = GraphBatch(
        node_feat=mk.normal((N, F)),
        edge_src=mk.ints((E,), N),
        edge_dst=mk.ints((E,), N),
        node_mask=mk.ones((N,)),
        edge_mask=mk.ones((E,)),
        labels=mk.ints((N,), cfg.n_classes),
        positions=mk.normal((N, 3)) if cfg.needs_positions else None,
        graph_ids=mk.ints((N,), ng) if ng > 1 else None,
        n_graphs=ng,
    )
    # the parameters are small at every shape: drawn on the host for meta
    gen = torch.Generator().manual_seed(0) if mk.meta else mk.gen
    params = init_params(cfg, gen, device=mk.dev)
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    step = train_step(cfg, opt)
    repl = lambda t: tree_map_with_path(lambda *_: (), t)
    ns = lambda shape, spec: maybe_spec(shape, spec, mesh)
    gspec = GraphBatch(
        node_feat=ns((N, F), (ALL_AXES, None)),
        edge_src=ns((E,), (ALL_AXES,)),
        edge_dst=ns((E,), (ALL_AXES,)),
        node_mask=ns((N,), (ALL_AXES,)),
        edge_mask=ns((E,), (ALL_AXES,)),
        labels=ns((N,), (ALL_AXES,)),
        positions=ns((N, 3), (ALL_AXES, None)) if cfg.needs_positions else None,
        graph_ids=ns((N,), (ALL_AXES,)) if ng > 1 else None,
        n_graphs=ng,
    )
    if cfg.kind in ("egnn", "nequip"):
        targets = mk.normal((ng,))
        return step, (repl(params), repl(opt_state), gspec, ()), (params, opt_state, g, targets)
    return step, (repl(params), repl(opt_state), gspec), (params, opt_state, g)


# ---------------------------------------------------------------- recsys
def _rec_cell(cfg, info, mesh, mk: _Maker):
    from repro_torch.recsys import twotower as tt

    if mk.meta:
        params = tt.abstract_params(cfg)
    else:
        params = tt.init_params(cfg, mk.gen, device=mk.dev)
    rule = tt.param_spec_rule(cfg)
    pspec = tree_shardings(params, rule, mesh)
    B = info["batch"]
    K, Fu, Fi, D = cfg.bag_size, cfg.user_fields, cfg.item_fields, cfg.embed_dim
    ub, um = mk.ints((B, Fu, K), cfg.user_vocab), mk.bools((B, Fu, K))
    ubs = maybe_spec((B, Fu, K), (BATCH_AXES, None, None), mesh)

    if info["kind"] == "rec_train":
        opt = adamw(1e-3)
        opt_state = opt.init(params)
        mspec = tree_map_with_path(
            lambda path, leaf: add_data_axis(maybe_spec(leaf.shape, rule(path, leaf), mesh),
                                             leaf.shape, mesh), opt_state)
        step = tt.train_step(cfg, opt)
        batch = dict(user_bags=ub, user_mask=um, item_bags=mk.ints((B, Fi, K), cfg.item_vocab),
                     item_mask=mk.bools((B, Fi, K)), item_logq=mk.normal((B,)))
        ibs = maybe_spec((B, Fi, K), (BATCH_AXES, None, None), mesh)
        bspec = dict(user_bags=ubs, user_mask=ubs, item_bags=ibs, item_mask=ibs,
                     item_logq=maybe_spec((B,), (BATCH_AXES,), mesh))
        return step, (pspec, mspec, bspec), (params, opt_state, batch)

    if info["kind"] == "rec_serve":
        C = info["n_candidates"]
        step = functools.partial(tt.serve_step, cfg)
        specs = (pspec, ubs, ubs, maybe_spec((B, C, D), (BATCH_AXES, None, None), mesh))
        return step, specs, (params, ub, um, mk.normal((B, C, D)))

    if info["kind"] == "rec_retrieval":
        Nc = info["n_candidates"]
        step = functools.partial(tt.retrieval_step, cfg)
        specs = (pspec, maybe_spec((B, Fu, K), (), mesh), maybe_spec((B, Fu, K), (), mesh),
                 maybe_spec((Nc, D), ("model", None), mesh))
        return step, specs, (params, ub, um, mk.normal((Nc, D)))

    raise ValueError(info["kind"])


# ---------------------------------------------------------------- graph
def _graph_cell(cfg, info, mesh, mk: _Maker, **kw):
    from repro_torch.distributed import graph_serve as gs

    step, specs, args, _rt = gs.config_cell(
        cfg, mesh, use_cache=info["use_cache"], global_batch=info["batch"], device=mk.dev,
        generator=mk.gen, **kw)
    return step, specs, args


def build_cell(arch_id: str, shape_name: str, mesh, *, device="meta", generator=None,
               cfg=None, info=None, **graph_kw):
    """``(step_fn, arg_specs, args)`` for one dry-run cell.

    ``cfg`` and ``info`` replace the architecture's FULL config and the
    shape's dimensions (a cell cut to size, or a SMOKE cell); a graph cell
    passes ``graph_kw`` (``blk_slack``, ``pstore``) to ``config_cell``."""
    mod = configs_pkg.get_arch(arch_id)
    info = dict(mod.SHAPES[shape_name], **(info or {}))
    cfg = mod.FULL if cfg is None else cfg
    mk = _Maker(device, generator)
    if mod.FAMILY == "lm":
        return _lm_cell(cfg, info, mesh, mk)
    if mod.FAMILY == "gnn":
        return _gnn_cell(cfg, info, mesh, mk)
    if mod.FAMILY == "recsys":
        return _rec_cell(cfg, info, mesh, mk)
    if mod.FAMILY == "graph":
        return _graph_cell(cfg, info, mesh, mk, **graph_kw)
    raise ValueError(mod.FAMILY)


# ------------------------------------------------------------ reading a cell
def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, int))


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if dataclasses.is_dataclass(tree):
        # a GraphBatch: its tensors are children, ``n_graphs`` is static
        return [getattr(tree, f.name) for f in dataclasses.fields(tree) if f.name != "n_graphs"]
    return list(tree)


def _flat(tree, spec, out):
    if tree is None:
        return out
    if _is_leaf(tree):
        out.append((tree, spec))
        return out
    for t, s in zip(_children(tree), _children(spec)):
        _flat(t, s, out)
    return out


def dtype_name(leaf) -> str:
    if isinstance(leaf, int):
        return "int32"
    if isinstance(leaf, np.ndarray):
        return str(leaf.dtype)
    return str(leaf.dtype).removeprefix("torch.")


def norm_spec(spec, rank: int) -> tuple:
    """A spec in one spelling: one entry a dimension, None, an axis name,
    or a tuple of two or more axis names."""
    out = []
    for e in tuple(spec)[:rank] + (None,) * (rank - len(tuple(spec)[:rank])):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out)


def cell_leaves(args, arg_specs) -> list:
    """Every leaf of a cell's arguments as ``(shape, dtype name, spec)``,
    in tree order: a Python int is an int32 scalar."""
    out = []
    for leaf, spec in _flat(args, arg_specs, []):
        shape = () if isinstance(leaf, int) else tuple(int(d) for d in leaf.shape)
        out.append((shape, dtype_name(leaf), norm_spec(spec, len(shape))))
    return out


def arg_tensors(args) -> list:
    """The distinct tensors among a cell's argument leaves (one that stands
    at two leaves, as the cache's shared zero counter, once), in tree
    order: what a device holds for the cell."""
    seen, out = set(), []
    for leaf, _ in _flat(args, args, []):
        if isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
            seen.add(id(leaf))
            out.append(leaf)
    return out


_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "bfloat16": 2, "float16": 2, "int16": 2,
             "int32": 4, "float32": 4, "uint32": 4, "int64": 8, "float64": 8}


def argument_bytes(args, arg_specs, mesh=None) -> int:
    """The bytes of the arguments one device holds: each leaf's dimensions
    divided (rounding up) by the product of its spec's axis sizes in
    ``mesh``; everything where ``mesh`` is None (one card holds the cell)."""
    total = 0
    for shape, dt, spec in cell_leaves(args, arg_specs):
        n = 1
        for d, e in zip(shape, spec):
            axes = () if e is None or mesh is None else (e if isinstance(e, tuple) else (e,))
            n *= -(-d // math.prod(mesh.shape[a] for a in axes)) if axes else d
        total += n * _ITEMSIZE[dt]
    return total
