"""GNN layers: PNA, GAT, EGNN, NequIP-lite (restricted tensor product).

PyTorch twin of ``repro.gnn.layers``. Every layer consumes a padded edge
list and uses segment reductions; no dense adjacency ever materializes.
Every segment sum goes through ``graph.scatter_sum`` and so through the
``segment_spmm`` kernel on the card, forward and backward; each layer
takes the ``csr`` that its model's forward built once (``edge_csr``).
Parameters keep the reference's layout: an MLP is a list of ``(w [a, b],
b [b])`` pairs, a layer a dict of MLPs and arrays. NequIP keeps its l=2
features as traceless symmetric 3x3 matrices, as the reference does.

Float32 products run in full float32: the port leaves PyTorch's default
(TF32 off for matmul) as it is, and the reference's forward is fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.gnn.graph import (degrees, scatter_max, scatter_mean, scatter_min, scatter_sum,
                                   segment_softmax)


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


def pna_layer(p, cfg, h, src, dst, emask, nmask, csr=None):
    """One PNA layer; ``csr`` (``graph.edge_csr`` of ``dst``, ``n`` and
    ``emask``) serves its five segment sums, or each sorts the edges
    itself when it is None."""
    n = h.shape[0]
    m = mlp(p["msg"], torch.cat([h[src.long()], h[dst.long()]], -1))
    mean, cnt = scatter_mean(m, dst, n, emask, csr)
    mx = scatter_max(m, dst, n, emask)
    mn = scatter_min(m, dst, n, emask)
    sq, _ = scatter_mean(torch.square(m), dst, n, emask, csr)
    std = torch.sqrt(torch.relu(sq - torch.square(mean)) + 1e-8)
    aggs = {"mean": mean, "max": mx, "min": mn, "std": std}
    deg = degrees(dst, n, emask, csr)
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


def _normal(generator, shape, scale, device):
    return (torch.randn(shape, generator=generator, device=generator.device) * scale).to(device)


# ---------------------------------------------------------------- GAT
def gat_layer_init(generator: torch.Generator, d_in, d, heads, device):
    return {
        "w": _normal(generator, (d_in, heads, d), d_in**-0.5, device),
        "a_src": _normal(generator, (heads, d), d**-0.5, device),
        "a_dst": _normal(generator, (heads, d), d**-0.5, device),
    }


def gat_layer(p, h, src, dst, emask, nmask, concat=True, csr=None):
    """One GAT layer over h [N, d_in]: [N, H*d] with ``concat``, else the
    mean over the heads [N, d]. The edge softmax's normaliser and the
    [E, H*d] aggregation are segment sums."""
    n = h.shape[0]
    s, t = src.long(), dst.long()
    hw = torch.einsum("nf,fhd->nhd", h, p["w"])  # [N, H, d]
    es = torch.einsum("nhd,hd->nh", hw, p["a_src"])[s]  # SDDMM scores
    ed = torch.einsum("nhd,hd->nh", hw, p["a_dst"])[t]
    score = F.leaky_relu(es + ed, 0.2)
    alpha = segment_softmax(score, dst, n, emask, csr)  # [E, H]
    msg = hw[s] * alpha[..., None]
    agg = scatter_sum(msg.reshape(msg.shape[0], -1), dst, n, emask, csr).reshape(hw.shape)
    out = agg.reshape(n, -1) if concat else agg.mean(dim=1)
    return torch.where(nmask[:, None], F.elu(out), 0)


# ---------------------------------------------------------------- EGNN
def egnn_layer_init(generator: torch.Generator, d, cfg, device):
    return {
        "phi_e": mlp_init(generator, (2 * d + 1, d, d), device),
        "phi_x": mlp_init(generator, (d, d, 1), device),
        "phi_h": mlp_init(generator, (2 * d, d, d), device),
    }


def egnn_layer(p, h, x, src, dst, emask, nmask, csr=None):
    """One E(n)-equivariant layer: features h [N, d], positions x [N, 3]."""
    n = h.shape[0]
    s, t = src.long(), dst.long()
    rel = x[s] - x[t]  # [E, 3]
    d2 = torch.sum(torch.square(rel), -1, keepdim=True)
    m = mlp(p["phi_e"], torch.cat([h[s], h[t], d2], -1))
    # position update (E(n)-equivariant)
    coef = mlp(p["phi_x"], m)  # [E, 1]
    # max(sqrt(d2), 1) as sqrt(max(d2, 1)): the same values bit for bit, and
    # a zero gradient below 1 where the reference's is NaN at d2 = 0 (an
    # edge from a node to itself, or two nodes at one position)
    dx = scatter_sum(rel * coef / torch.sqrt(d2.clamp(min=1.0)), dst, n, emask, csr)
    cnt = degrees(dst, n, emask, csr)[:, None]
    x = x + torch.where(nmask[:, None], dx / cnt.clamp(min=1), 0)
    # feature update
    agg = scatter_sum(m, dst, n, emask, csr)
    h = h + mlp(p["phi_h"], torch.cat([h, agg], -1))
    return torch.where(nmask[:, None], h, 0), x


# ---------------------------------------------------------------- NequIP-lite
def _bessel(d, n_rbf, cutoff):
    d = d.clamp(min=1e-6)
    k = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    rbf = torch.sin(k[None, :] * torch.pi * d[:, None] / cutoff) / d[:, None]
    # smooth cosine cutoff envelope
    env = 0.5 * (torch.cos(torch.pi * torch.clamp(d / cutoff, 0, 1)) + 1.0)
    return rbf * env[:, None]


N_PATHS = 8  # radial-weighted tensor-product paths (see nequip_layer)


def nequip_layer_init(generator: torch.Generator, c, cfg, device):
    return {
        "radial": mlp_init(generator, (cfg.n_rbf, c, N_PATHS * c), device),
        "mix_s": _normal(generator, (2 * c, c), (2 * c) ** -0.5, device),
        "mix_v": _normal(generator, (3 * c, c), (3 * c) ** -0.5, device),
        "mix_t": _normal(generator, (2 * c, c), (2 * c) ** -0.5, device),
        "gate": mlp_init(generator, (c, 2 * c), device),
    }


def nequip_layer(p, cfg, s, v, t, x, src, dst, emask, nmask, csr=None):
    """One interaction block. Features: scalars s [N,C], vectors v [N,C,3],
    traceless-symmetric matrices t [N,C,3,3] (the l=2 stand-in).

    Paths (all radial-weighted, aggregated with segment sums of widths C,
    3C and 9C):
      l0 <- s_j (0x0), v_j.u (1x1), <t_j, uu^T> (2x2)
      l1 <- s_j*u (0x1), v_j (1x0), v_j x u (1x1), t_j u (2x1)
      l2 <- s_j*(uu^T - I/3) (0x2)
    """
    n, c = s.shape
    si, di = src.long(), dst.long()
    rel = x[si] - x[di]
    d = torch.linalg.vector_norm(rel + 1e-9, dim=-1)  # 1e-9 on each component, as the reference
    u = rel / d.clamp(min=1e-6)[:, None]  # [E, 3]
    rbf = _bessel(d, cfg.n_rbf, cfg.cutoff)
    R = mlp(p["radial"], rbf).reshape(-1, N_PATHS, c)  # [E, P, C]

    uu = u[:, None, :, None] * u[:, None, None, :]  # [E,1,3,3]
    eye = torch.eye(3, dtype=u.dtype, device=u.device) / 3.0
    y2 = uu - eye[None, None]  # traceless

    sj, vj, tj = s[si], v[si], t[si]
    ub = u[:, None, :].expand_as(vj)
    m_s = (
        R[:, 0] * sj
        + R[:, 1] * torch.einsum("eci,ei->ec", vj, u)
        + R[:, 2] * torch.einsum("ecij,eij->ec", tj, y2[:, 0])
    )
    m_v = (
        R[:, 3, :, None] * sj[..., None] * u[:, None, :]
        + R[:, 4, :, None] * vj
        + R[:, 5, :, None] * torch.linalg.cross(vj, ub, dim=-1)
        + R[:, 6, :, None] * torch.einsum("ecij,ej->eci", tj, u)
    )
    m_t = R[:, 7, :, None, None] * sj[..., None, None] * y2

    agg_s = scatter_sum(m_s, dst, n, emask, csr)
    agg_v = scatter_sum(m_v.reshape(-1, c * 3), dst, n, emask, csr).reshape(n, c, 3)
    agg_t = scatter_sum(m_t.reshape(-1, c * 9), dst, n, emask, csr).reshape(n, c, 3, 3)

    # self-interaction: linear channel mixing (equivariant) + gated nonlin
    s2 = torch.cat([s, agg_s], -1) @ p["mix_s"]
    vcat = torch.cat([v, agg_v, torch.linalg.cross(v, agg_v, dim=-1)], dim=1)  # [N,3C,3]
    v2 = torch.einsum("nki,kc->nci", vcat, p["mix_v"])
    tcat = torch.cat([t, agg_t], dim=1)  # [N,2C,3,3]
    t2 = torch.einsum("nkij,kc->ncij", tcat, p["mix_t"])
    gates = mlp(p["gate"], F.silu(s2))
    gv, gt = torch.chunk(torch.sigmoid(gates), 2, dim=-1)
    s = s + F.silu(s2)
    v = v + v2 * gv[..., None]
    t = t + t2 * gt[..., None, None]
    z = nmask[:, None].to(s.dtype)
    return s * z, v * z[..., None], t * z[..., None, None]

