"""GNN models: init / forward / loss / train_step dispatched on
``config.kind``.

PyTorch twin of ``repro.gnn.models`` for every kind: PNA and GAT classify
nodes, EGNN and NequIP regress a per-graph energy. A forward sorts its
edges by destination once (``edge_csr``) and that CSR serves every
layer's segment sums; when a gradient will be taken, its transpose (built
with it) serves their backward, so in training every segment sum runs the
``segment_spmm`` kernel both ways on the card. The per-graph pooling of
the energies is a segment sum too.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.gnn.config import GNNConfig
from repro_torch.gnn.graph import GraphBatch, edge_csr, scatter_sum
from repro_torch.gnn.layers import (
    egnn_layer,
    egnn_layer_init,
    gat_layer,
    gat_layer_init,
    mlp,
    mlp_init,
    nequip_layer,
    nequip_layer_init,
    pna_layer,
    pna_layer_init,
)
from repro_torch.optim.adamw import apply_updates, value_and_grad
from repro_torch.utils import resolve_device


def init_params(cfg: GNNConfig, generator: torch.Generator, device=None):
    """Parameters drawn from ``generator`` (in place of the reference's
    key), on ``device`` (CUDA unless the caller names another), in the
    reference's layout for ``cfg.kind``."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    if cfg.kind == "pna":
        layers = [pna_layer_init(generator, cfg.d_in if i == 0 else d, d, cfg, dev)
                  for i in range(cfg.n_layers)]
        return {"layers": layers, "head": mlp_init(generator, (d, cfg.n_classes), dev)}
    if cfg.kind == "gat":
        h = cfg.n_heads
        layers = [gat_layer_init(generator, cfg.d_in if i == 0 else d * h, d, h, dev)
                  for i in range(cfg.n_layers - 1)]
        # the last layer: n_classes outputs a head, averaged over the heads
        layers.append(gat_layer_init(generator, d * h if cfg.n_layers > 1 else cfg.d_in,
                                     cfg.n_classes, h, dev))
        return {"layers": layers}
    if cfg.kind in ("egnn", "nequip"):
        layer_init = egnn_layer_init if cfg.kind == "egnn" else nequip_layer_init
        layers = [layer_init(generator, d, cfg, dev) for _ in range(cfg.n_layers)]
        return {"embed": mlp_init(generator, (cfg.d_in, d), dev), "layers": layers,
                "head": mlp_init(generator, (d, d, 1), dev)}
    raise ValueError(cfg.kind)


def forward(cfg: GNNConfig, params, g: GraphBatch):
    """Returns node logits [N, n_classes] (pna / gat) or per-graph energy
    [n_graphs] (egnn / nequip)."""
    src, dst, em, nm = g.edge_src, g.edge_dst, g.edge_mask, g.node_mask
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [g.node_feat] + tree_leaves(params))
    csr = edge_csr(dst, g.node_feat.shape[0], em, transpose=grad)
    if cfg.kind == "pna":
        h = g.node_feat
        for lp in params["layers"]:
            h = pna_layer(lp, cfg, h, src, dst, em, nm, csr)
        return mlp(params["head"], h)
    if cfg.kind == "gat":
        h = g.node_feat
        for i, lp in enumerate(params["layers"]):
            last = i == len(params["layers"]) - 1
            h = gat_layer(lp, h, src, dst, em, nm, concat=not last, csr=csr)
        return h
    if cfg.kind == "egnn":
        h = mlp(params["embed"], g.node_feat)
        x = g.positions
        for lp in params["layers"]:
            h, x = egnn_layer(lp, h, x, src, dst, em, nm, csr)
        e_node = mlp(params["head"], h)[:, 0] * nm
        return _graph_pool(e_node, g)
    if cfg.kind == "nequip":
        n, c = g.node_feat.shape[0], cfg.d_hidden
        s = mlp(params["embed"], g.node_feat)
        v = torch.zeros((n, c, 3), dtype=s.dtype, device=s.device)
        t = torch.zeros((n, c, 3, 3), dtype=s.dtype, device=s.device)
        for lp in params["layers"]:
            s, v, t = nequip_layer(lp, cfg, s, v, t, g.positions, src, dst, em, nm, csr)
        e_node = mlp(params["head"], s)[:, 0] * nm
        return _graph_pool(e_node, g)
    raise ValueError(cfg.kind)


def _graph_pool(e_node, g: GraphBatch):
    """Each graph's energy: the sum of its nodes' [n_graphs], a segment sum
    over ``graph_ids``; the whole batch's [1] when there are none."""
    if g.graph_ids is None:
        return torch.sum(e_node)[None]
    keep = torch.ones(e_node.shape[0], dtype=torch.bool, device=e_node.device)
    return scatter_sum(e_node[:, None], g.graph_ids, g.n_graphs, keep)[:, 0]


def loss_fn(cfg: GNNConfig, params, g: GraphBatch, targets=None):
    """PNA / GAT: the mean cross-entropy of the node logits over the valid
    nodes. EGNN / NequIP: the mean squared error of the per-graph energies
    against ``targets`` (zeros when None)."""
    out = forward(cfg, params, g)
    if cfg.kind in ("pna", "gat"):
        logits = out.to(torch.float32)
        logz = torch.logsumexp(logits, -1)
        gold = torch.take_along_dim(logits, g.labels.long()[:, None], -1)[:, 0]
        per = (logz - gold) * g.node_mask
        return per.sum() / g.node_mask.sum().clamp(min=1)
    tgt = targets if targets is not None else torch.zeros_like(out)
    return torch.mean(torch.square(out - tgt))


def train_step(cfg: GNNConfig, optimizer):
    """The step ``(params, opt_state, g, targets=None) -> (params,
    opt_state, {"loss"})`` for ``optimizer``, a ``repro_torch.optim``
    GradientTransform. The parameters move by ``p + u.to(p.dtype)`` as in
    the reference, in place: the returned tree is ``params`` itself."""

    def step(params, opt_state, g: GraphBatch, targets=None):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, p, g, targets), params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, {"loss": loss}

    return step
