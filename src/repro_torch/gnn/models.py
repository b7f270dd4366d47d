"""GNN models: init / forward / loss dispatched on ``config.kind``.

PyTorch twin of ``repro.gnn.models`` for ``kind="pna"``, the path that
serves (cached sampling, then the forward pass and its loss as
evaluation). The other kinds and ``train_step`` are not ported yet: they
raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import torch

from repro_torch.gnn.config import GNNConfig
from repro_torch.gnn.graph import GraphBatch
from repro_torch.gnn.layers import mlp, mlp_init, pna_layer, pna_layer_init
from repro_torch.utils import resolve_device


def _not_ported(cfg: GNNConfig):
    return NotImplementedError(
        f"GNN kind {cfg.kind!r} is not ported yet (ROADMAP queue 1, item 12: "
        "the GAT, EGNN and NequIP layers)"
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
    """Returns node logits [N, n_classes]."""
    src, dst, em, nm = g.edge_src, g.edge_dst, g.edge_mask, g.node_mask
    if cfg.kind == "pna":
        h = g.node_feat
        for lp in params["layers"]:
            h = pna_layer(lp, cfg, h, src, dst, em, nm)
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
