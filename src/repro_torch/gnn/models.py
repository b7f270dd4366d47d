"""GNN models: init / forward / loss / train_step dispatched on
``config.kind``.

PyTorch twin of ``repro.gnn.models`` for ``kind="pna"``: the path that
serves (cached sampling, then the forward pass and its loss as
evaluation) and trains (``train_step``, whose backward runs every segment
sum's gradient through the ``segment_spmm`` kernel too). The other kinds
are not ported yet: they raise ``NotImplementedError`` naming the ROADMAP
item.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.gnn.config import GNNConfig
from repro_torch.gnn.graph import GraphBatch, edge_csr
from repro_torch.gnn.layers import mlp, mlp_init, pna_layer, pna_layer_init
from repro_torch.optim.adamw import apply_updates, value_and_grad
from repro_torch.utils import resolve_device


def _not_ported(cfg: GNNConfig):
    return NotImplementedError(
        f"GNN kind {cfg.kind!r} is not ported yet: it waits for the GAT, EGNN and "
        "NequIP layers (ROADMAP queue 1, the rest of the model families)"
    )


def init_params(cfg: GNNConfig, generator: torch.Generator, device=None):
    """Parameters drawn from ``generator`` (in place of the reference's
    key), on ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    if cfg.kind == "pna":
        layers = [pna_layer_init(generator, cfg.d_in if i == 0 else d, d, cfg, dev)
                  for i in range(cfg.n_layers)]
        return {"layers": layers, "head": mlp_init(generator, (d, cfg.n_classes), dev)}
    raise _not_ported(cfg)


def forward(cfg: GNNConfig, params, g: GraphBatch):
    """Returns node logits [N, n_classes]. The edges are sorted by
    destination once (``edge_csr``) and that CSR serves every layer's
    segment sums; when a gradient will be taken, its transpose (built with
    it) serves their backward."""
    src, dst, em, nm = g.edge_src, g.edge_dst, g.edge_mask, g.node_mask
    if cfg.kind == "pna":
        h = g.node_feat
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in [h] + tree_leaves(params))
        csr = edge_csr(dst, h.shape[0], em, transpose=grad)
        for lp in params["layers"]:
            h = pna_layer(lp, cfg, h, src, dst, em, nm, csr)
        return mlp(params["head"], h)
    raise _not_ported(cfg)


def loss_fn(cfg: GNNConfig, params, g: GraphBatch, targets=None):
    """Mean cross-entropy of the node logits over the valid nodes."""
    if cfg.kind != "pna":
        raise _not_ported(cfg)
    logits = forward(cfg, params, g).to(torch.float32)
    logz = torch.logsumexp(logits, -1)
    gold = torch.take_along_dim(logits, g.labels.long()[:, None], -1)[:, 0]
    per = (logz - gold) * g.node_mask
    return per.sum() / g.node_mask.sum().clamp(min=1)


def train_step(cfg: GNNConfig, optimizer):
    """The step ``(params, opt_state, g, targets=None) -> (params,
    opt_state, {"loss"})`` for ``optimizer``, a ``repro_torch.optim``
    GradientTransform. The parameters move by ``p + u.to(p.dtype)`` as in
    the reference, in place: the returned tree is ``params`` itself."""
    if cfg.kind != "pna":
        raise _not_ported(cfg)

    def step(params, opt_state, g: GraphBatch, targets=None):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, p, g, targets), params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, {"loss": loss}

    return step
