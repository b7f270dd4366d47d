"""GNN layers: PNA.

PyTorch twin of the PNA part of ``repro.gnn.layers``. The layer consumes a
padded edge list and uses segment reductions; no dense adjacency ever
materializes. Parameters keep the reference's layout: an MLP is a list of
``(w [a, b], b [b])`` pairs, a layer a dict of MLPs. The reference's GAT,
EGNN and NequIP layers are not ported yet (ROADMAP queue 1, item 12).

Float32 products run in full float32: the port leaves PyTorch's default
(TF32 off for matmul) as it is, and the reference's forward is fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.gnn.graph import degrees, scatter_max, scatter_mean, scatter_min


def mlp(params, x, act=F.silu):
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i + 1 < len(params):
            x = act(x)
    return x


def mlp_init(generator: torch.Generator, sizes, device):
    """Weights ``N(0, 1) / sqrt(fan_in)`` drawn from ``generator``, zero
    biases, on ``device``."""
    return [
        (
            (torch.randn((a, b), generator=generator, device=generator.device) * a**-0.5).to(device),
            torch.zeros((b,), dtype=torch.float32, device=device),
        )
        for a, b in zip(sizes[:-1], sizes[1:])
    ]


# ---------------------------------------------------------------- PNA
def pna_layer_init(generator: torch.Generator, d_in, d, cfg, device):
    n_feats = len(cfg.aggregators) * len(cfg.scalers)
    return {
        "msg": mlp_init(generator, (2 * d_in, d), device),
        "upd": mlp_init(generator, (d_in + n_feats * d, d, d), device),
    }


def pna_layer(p, cfg, h, src, dst, emask, nmask):
    n = h.shape[0]
    m = mlp(p["msg"], torch.cat([h[src.long()], h[dst.long()]], -1))
    mean, cnt = scatter_mean(m, dst, n, emask)
    mx = scatter_max(m, dst, n, emask)
    mn = scatter_min(m, dst, n, emask)
    sq, _ = scatter_mean(torch.square(m), dst, n, emask)
    std = torch.sqrt(torch.relu(sq - torch.square(mean)) + 1e-8)
    aggs = {"mean": mean, "max": mx, "min": mn, "std": std}
    deg = degrees(dst, n, emask)
    logd = torch.log1p(deg)[:, None]
    delta = cfg.mean_log_degree
    scal = {
        "identity": torch.ones_like(logd),
        "amplification": logd / delta,
        "attenuation": delta / logd.clamp(min=1e-3),
    }
    feats = [aggs[a] * scal[s] for a in cfg.aggregators for s in cfg.scalers]
    out = mlp(p["upd"], torch.cat([h] + feats, -1))
    return torch.where(nmask[:, None], out, 0)
