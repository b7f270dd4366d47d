"""Two-tower retrieval: towers, in-batch sampled softmax, serve paths.

PyTorch twin of ``repro.recsys.twotower``. Parameters are a plain dict of
tensors named as in the reference. The reference's ``constrain`` hints
are left out: they have no meaning on one card. ``abstract_params`` and
``param_spec_rule`` stay for the dry-run (``launch.steps``). In training each tower's bags go through the
``embedding_bag`` kernel forward and its backward kernel for the table's
dense gradient.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import apply_updates, value_and_grad
from repro_torch.recsys.config import TwoTowerConfig
from repro_torch.recsys.embedding import embedding_bag
from repro_torch.utils import resolve_device, top_k

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_shapes(cfg: TwoTowerConfig) -> dict:
    d = cfg.embed_dim
    shapes = {
        "user_table": (cfg.user_vocab, d),
        "item_table": (cfg.item_vocab, d),
    }
    for tower, fields in (("user", cfg.user_fields), ("item", cfg.item_fields)):
        last = fields * d
        for i, h in enumerate(cfg.tower_mlp):
            shapes[f"{tower}_w{i}"] = (last, h)
            shapes[f"{tower}_b{i}"] = (h,)
            last = h
    return shapes


def abstract_params(cfg: TwoTowerConfig) -> dict:
    """The parameters as ``meta`` tensors of ``cfg.dtype``."""
    dt = _DTYPES[cfg.dtype]
    return {k: torch.empty(s, dtype=dt, device="meta") for k, s in param_shapes(cfg).items()}


def param_spec_rule(cfg: TwoTowerConfig):
    """The reference's specs by parameter path: tables row-sharded over
    ``model``, tower weights column-sharded, biases replicated."""

    def rule(path: str, leaf):
        if "table" in path:
            return ("model", None)  # row-sharded embedding tables
        if "_w" in path:
            return (None, "model")
        return (None,)

    return rule


def init_params(cfg: TwoTowerConfig, generator: torch.Generator, device=None) -> dict:
    """The reference's rule: biases are zeros, every other leaf is
    ``normal * shape[0]**-0.5`` (the tables get ``vocab**-0.5``), drawn in
    fp32 from ``generator`` (in place of the reference's key) on the
    generator's device, in place, then moved to ``device`` (CUDA unless the
    caller names another) in ``cfg.dtype``. A CUDA generator draws a table
    on the card without a host copy."""
    dev = resolve_device(device)
    dt = _DTYPES[cfg.dtype]
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(tuple("0123456789")) and "_b" in name:
            out[name] = torch.zeros(shape, dtype=dt, device=dev)
            continue
        x = torch.empty(shape, dtype=torch.float32, device=generator.device)
        x.normal_(generator=generator).mul_(shape[0] ** -0.5)
        out[name] = x.to(device=dev, dtype=dt)
        del x
    return out


def _tower(cfg, params, prefix, bags, mask, table):
    # Every field of a tower reads the same table, so the F per-field bags
    # go through one embedding_bag call: bags [B, F, K] -> [B*F, K] ->
    # [B*F, D] -> [B, F*D], field f in columns f*D .. (f+1)*D - 1, which is
    # the reference's concatenation of its F per-field calls.
    B, F, K = bags.shape
    h = embedding_bag(table, bags.reshape(B * F, K), mask.reshape(B * F, K), mode="mean")
    h = h.reshape(B, F * cfg.embed_dim)
    i = 0
    while f"{prefix}_w{i}" in params:
        h = h @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        if f"{prefix}_w{i+1}" in params:
            h = torch.relu(h)
        i += 1
    # L2-normalized embeddings (standard for dot retrieval)
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(min=1e-6)


def user_tower(cfg, params, user_bags, user_mask):
    """user_bags [B, F_u, K] int, user_mask same bool -> [B, D]."""
    return _tower(cfg, params, "user", user_bags, user_mask, params["user_table"])


def item_tower(cfg, params, item_bags, item_mask):
    return _tower(cfg, params, "item", item_bags, item_mask, params["item_table"])


def loss_fn(cfg: TwoTowerConfig, params, batch):
    """In-batch sampled softmax with logQ correction.

    batch: dict(user_bags, user_mask, item_bags, item_mask, item_logq [B]).
    The [B, B] logits are fp32; user b's positive is item b."""
    u = user_tower(cfg, params, batch["user_bags"], batch["user_mask"])
    it = item_tower(cfg, params, batch["item_bags"], batch["item_mask"])
    logits = ((u @ it.T) / cfg.temperature).to(torch.float32)
    logits = logits - batch["item_logq"][None, :]  # logQ correction
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits)
    return torch.mean(logz - gold)


def train_step(cfg: TwoTowerConfig, optimizer):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    {"loss"})`` for ``optimizer``, a ``repro_torch.optim``
    GradientTransform: the loss's gradients (the tables' dense, from the
    ``embedding_bag`` backward), the optimizer, then ``p + u.to(p.dtype)``
    as in the reference, in place: the returned tree is ``params``."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, p, batch), params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, {"loss": loss}

    return step


def serve_step(cfg: TwoTowerConfig, params, user_bags, user_mask, item_emb):
    """Online scoring: users [B] against their per-request candidate items
    [B, C, D] (pre-embedded); returns (scores [B, C], best [B] int64).
    serve_p99 / serve_bulk shapes."""
    u = user_tower(cfg, params, user_bags, user_mask)  # [B, D]
    scores = torch.einsum("bd,bcd->bc", u, item_emb)
    best = torch.argmax(scores, dim=-1)
    return scores, best


def retrieval_step(cfg: TwoTowerConfig, params, user_bags, user_mask, corpus_emb,
                   k: int = 100):
    """retrieval_cand: one (or few) queries against a corpus [N, D]: one
    matmul and a top-k. Returns (values [B, k], ids [B, k] int64)."""
    u = user_tower(cfg, params, user_bags, user_mask)  # [B, D]
    scores = u @ corpus_emb.T  # [B, N]
    return top_k(scores, k)
