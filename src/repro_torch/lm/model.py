"""LM forward, training, prefill and KV-cache decode.

PyTorch twin of ``repro.lm.model``, dense and MoE. Parameters keep the
reference's layout: ``embed``, ``unembed``, ``final_norm`` and a
``layers`` dict of stacked ``[L, ...]`` tensors, walked by a Python loop
where the reference scans. Every attention goes through the
``flash_attention`` kernel on CUDA, and in training through its backward
kernels too. An MoE block runs ``moe_ffn`` over the block's tokens
flattened to ``[B*S, D]``, plus the always-on shared expert where the
config has one, and ``forward`` returns the layers' summed load-balancing
loss. The reference's ``constrain`` hints are left out: they have no
meaning on one card. ``abstract_params``, ``param_spec_rule`` and
``kv_cache_spec_rule`` stay for the dry-run (``launch.steps``): the
parameters as ``meta`` tensors, and the reference's specs by leaf path.

Training (``loss_fn``, ``train_step``): ``forward`` checkpoints each block
when ``cfg.remat`` (``torch.utils.checkpoint``, non-reentrant): only a
block's input stays for the backward, which recomputes the whole block,
its weight GEMMs included. The reference's policy,
``dots_with_no_batch_dims_saveable``, keeps the GEMMs' outputs instead; in
torch that is a selective-checkpoint dispatch mode, whose host cost a
tensor op outweighed the GEMM time it saved on an H100 at Gemma3-4B FULL
(``chip_smoke.py`` phase 16 times the two and reads their peak memory).
The loss walks ``cfg.loss_chunk`` positions at a time, each chunk
checkpointed too, and never builds [B, S, V] logits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import tree_leaves

from repro_torch.lm.attention import decode_attention, flash_attention
from repro_torch.lm.config import LMConfig
from repro_torch.lm.layers import moe_ffn, rms_norm, rope, swiglu
from repro_torch.optim.adamw import apply_updates, global_norm, value_and_grad
from repro_torch.utils import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer_shapes(cfg: LMConfig) -> dict:
    D, H, KV, dh, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    L = cfg.n_layers
    shapes = {
        "attn_norm": (L, D),
        "mlp_norm": (L, D),
        "wq": (L, D, H * dh),
        "wk": (L, D, KV * dh),
        "wv": (L, D, KV * dh),
        "wo": (L, H * dh, D),
    }
    if cfg.is_moe:
        shapes.update(
            router=(L, D, cfg.n_experts),
            we1=(L, cfg.n_experts, D, F),
            we3=(L, cfg.n_experts, D, F),
            we2=(L, cfg.n_experts, F, D),
        )
        if cfg.n_shared_experts:
            Fs = F * cfg.n_shared_experts
            shapes.update(ws1=(L, D, Fs), ws3=(L, D, Fs), ws2=(L, Fs, D))
    else:
        shapes.update(w1=(L, D, F), w3=(L, D, F), w2=(L, F, D))
    return shapes


def param_shapes(cfg: LMConfig) -> dict:
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "unembed": (cfg.d_model, cfg.vocab),
        "final_norm": (cfg.d_model,),
        "layers": _layer_shapes(cfg),
    }


BATCH = ("pod", "data")  # logical batch axes


def abstract_params(cfg: LMConfig) -> dict:
    """The parameter tree as ``meta`` tensors of ``cfg.dtype``: the
    dry-run's zero-allocation stand-in."""
    dt = _DTYPES[cfg.dtype]
    meta = lambda s: torch.empty(s, dtype=dt, device="meta")
    shapes = param_shapes(cfg)
    out = {k: meta(s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: meta(s) for k, s in shapes["layers"].items()}
    return out


def param_spec_rule(cfg: LMConfig):
    """Logical specs by parameter path (the ``jax.tree_util.keystr`` string,
    e.g. ``"['layers']['wq']"``), validated and dropped per mesh by
    ``distributed.sharding.maybe_spec``: the reference's rule."""

    def rule(path: str, leaf):
        if "embed'" in path or path.endswith("embed']"):
            return ("model", None) if "unembed" not in path else (None, "model")
        if "unembed" in path:
            return (None, "model")
        if "norm" in path:
            return (None,)
        if any(k in path for k in ("wq", "wk", "wv", "w1", "w3", "ws1", "ws3")):
            return (None, None, "model")
        if any(k in path for k in ("wo", "w2", "ws2")):
            return (None, "model", None)
        if "router" in path:
            return (None, None, None)
        if any(k in path for k in ("we1", "we3")):
            # expert parallel over 'model' when divisible, else TP on F
            if cfg.n_experts % 16 == 0:
                return (None, "model", None, None)
            return (None, None, None, "model")
        if "we2" in path:
            if cfg.n_experts % 16 == 0:
                return (None, "model", None, None)
            return (None, None, "model", None)
        return ()

    return rule


def kv_cache_spec_rule(cfg: LMConfig):
    """KV cache specs: batch over (pod, data); heads over model when they
    divide, else the sequence axis (context parallelism for long KV)."""

    def rule(path: str, leaf):
        if cfg.n_kv_heads % 16 == 0:
            return (None, BATCH, None, "model", None)
        return (None, BATCH, "model", None, None)

    return rule


def _init_leaf(shape, dt, generator, dev):
    """The reference's rule: a leaf of rank 1 or with last dim 1 is ones;
    every other leaf, the stacked [L, D] norms included, is
    ``normal * shape[-2]**-0.5`` drawn in fp32 and cast to ``dt``. A
    stacked leaf is drawn one layer at a time, so the fp32 temporary is one
    layer's."""
    if len(shape) == 1 or shape[-1] == 1:
        return torch.ones(shape, dtype=dt, device=dev)
    scale = shape[-2] ** -0.5
    out = torch.empty(shape, dtype=dt, device=dev)
    parts = out.reshape(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for part in parts:
        x = torch.empty(part.shape, dtype=torch.float32, device=generator.device)
        part.copy_(x.normal_(generator=generator).mul_(scale))
    return out


def init_params(cfg: LMConfig, generator: torch.Generator, device=None) -> dict:
    """Parameters drawn from ``generator`` (in place of the reference's
    key) on the generator's device, on ``device`` (CUDA unless the caller
    names another) in ``cfg.dtype``."""
    dev = resolve_device(device)
    dt = _DTYPES[cfg.dtype]
    shapes = param_shapes(cfg)
    out = {k: _init_leaf(s, dt, generator, dev) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: _init_leaf(s, dt, generator, dev) for k, s in shapes["layers"].items()}
    return out


def _layer(params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _window(cfg: LMConfig, i: int):
    return cfg.sliding_window if cfg.layer_is_local(i) else None


def _ffn(cfg: LMConfig, lp, h, capacity_factor=None):
    """The FFN of a block over h [B, S, D]: (y [B, S, D], the MoE aux fp32,
    None for a dense block). An MoE block routes the B*S tokens as one
    [B*S, D] batch at ``capacity_factor`` (the config's unless given) and
    adds the shared expert's SwiGLU."""
    if not cfg.is_moe:
        return swiglu(h, lp["w1"], lp["w3"], lp["w2"]), None
    flat = h.reshape(-1, h.shape[-1])
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    y, aux = moe_ffn(flat, lp["router"], lp["we1"], lp["we3"], lp["we2"],
                     top_k=cfg.top_k, capacity_factor=cf)
    if cfg.n_shared_experts:
        y = y + swiglu(flat, lp["ws1"], lp["ws3"], lp["ws2"])
    return y.reshape(h.shape), aux


def _attn_block(cfg: LMConfig, x, lp, i: int, positions):
    """x + attention(rms_norm(x)) for a [B, S, D] prompt; also returns k, v
    [B, S, KV, dh] (the layer's KV cache)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"])
    q = rope((h @ lp["wq"]).reshape(B, S, H, dh), positions, cfg.rope_theta)
    k = rope((h @ lp["wk"]).reshape(B, S, KV, dh), positions, cfg.rope_theta)
    v = (h @ lp["wv"]).reshape(B, S, KV, dh)
    attn = flash_attention(q, k, v, causal=True, window=_window(cfg, i))
    return x + attn.reshape(B, S, H * dh) @ lp["wo"], k, v


def _layers(params):
    """The per-layer views of the stacked leaves. ``unbind`` hands autograd
    one node a leaf, whose backward stacks the layers' gradients once
    (indexing layer by layer would add a full-size zero gradient a layer)."""
    names = list(params["layers"])
    per_leaf = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, views)) for views in zip(*per_leaf)]


def _block(cfg: LMConfig, i: int, x, lp, positions):
    """One transformer block: x [B, S, D] -> (x [B, S, D], its MoE aux)."""
    x, _, _ = _attn_block(cfg, x, lp, i, positions)
    y, aux = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"]))
    return x + y, aux


def forward(cfg: LMConfig, params, tokens, positions=None):
    """tokens [B, S] -> (final hidden states [B, S, D], the MoE aux loss
    summed over the layers, fp32; 0 for a dense config).

    With autograd on and ``cfg.remat``, each block is checkpointed: its
    activations, GEMM outputs included, are recomputed in the backward from
    its input."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens].to(_DTYPES[cfg.dtype])
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(_layers(params)):
        if remat:
            x, a = checkpoint(_block, cfg, i, x, lp, positions, use_reentrant=False)
        else:
            x, a = _block(cfg, i, x, lp, positions)
        if a is not None:
            aux = aux + a
    return rms_norm(x, params["final_norm"]), aux


def _chunk_nll(hs, unembed, labels):
    """Summed cross-entropy of one chunk: hs [B, C, D], labels [B, C]."""
    logits = (hs @ unembed).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def loss_fn(cfg: LMConfig, params, tokens, labels):
    """Chunked softmax cross-entropy over ``cfg.loss_chunk`` positions at a
    time (never materializes [B, S, V]): a chunk's fp32 logits live only
    while it is summed, and again while its gradient is taken."""
    h, aux = forward(cfg, params, tokens)
    B, S, D = h.shape
    C = min(cfg.loss_chunk, S)
    assert S % C == 0
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // C):
        hs, ls = h[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
        if grad:
            part = checkpoint(_chunk_nll, hs, params["unembed"], ls, use_reentrant=False)
        else:
            part = _chunk_nll(hs, params["unembed"], ls)
        total = total + part
    loss = total / (B * S)
    if cfg.is_moe:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss


def train_step(cfg: LMConfig, optimizer):
    """The step ``(params, opt_state, tokens, labels) -> (params, opt_state,
    {"loss", "grad_norm"})`` for ``optimizer``, a ``repro_torch.optim``
    GradientTransform. ``grad_norm`` is the gradients' global norm before
    the optimizer. The parameters move by ``p + u.to(p.dtype)`` as in the
    reference, in place: the returned tree is ``params`` itself (at
    Gemma3-4B's widths a second copy would not fit the card)."""

    def step(params, opt_state, tokens, labels):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, p, tokens, labels), params)
        gnorm = global_norm(tree_leaves(grads))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S, KV, dh]
    v: torch.Tensor


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> KVCache:
    """A zeroed cache on ``device`` (CUDA unless the caller names another;
    ``meta`` gives the dry-run's abstract cache)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = _DTYPES[cfg.dtype]
    return KVCache(torch.zeros(shape, dtype=dt, device=dev),
                   torch.zeros(shape, dtype=dt, device=dev))


def _logits(params, x):
    return (rms_norm(x, params["final_norm"]) @ params["unembed"]).to(torch.float32)


def prefill_logits(cfg: LMConfig, params, tokens):
    """Prefill: the forward over the prompt tokens [B, S]. Returns the
    last position's logits [B, 1, V] fp32 and the KV cache (built layer by
    layer, [L, B, S, KV, dh] each)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens].to(_DTYPES[cfg.dtype])
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x, k, v = _attn_block(cfg, x, lp, i, positions)
        x = x + _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"]))[0]
        ks.append(k.to(x.dtype))
        vs.append(v.to(x.dtype))
    return _logits(params, x[:, -1:]), KVCache(torch.stack(ks), torch.stack(vs))


def prefill_step(cfg: LMConfig, params, tokens):
    """As the reference: (the last position's argmax [B, 1] int32, KV
    cache)."""
    logits, cache = prefill_logits(cfg, params, tokens)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def decode_logits(cfg: LMConfig, params, cache: KVCache, tokens, pos: int):
    """One token for every sequence: tokens [B, 1] at position ``pos`` (the
    cache holds [0, pos)). Writes the token's k / v into ``cache`` at
    ``pos`` in place (the reference returns an updated copy; the port saves
    the copy of a cache that may hold gigabytes). Returns the logits
    [B, 1, V] fp32 and the cache. ``pos`` is clamped to the cache as
    ``dynamic_update_slice`` clamps it."""
    B = tokens.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    slot = min(max(pos, 0), cache.k.shape[2] - 1)
    x = params["embed"][tokens].to(_DTYPES[cfg.dtype])  # [B, 1, D]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"])
        q = rope((h @ lp["wq"]).reshape(B, 1, H, dh), positions, cfg.rope_theta)
        k = rope((h @ lp["wk"]).reshape(B, 1, KV, dh), positions, cfg.rope_theta)
        v = (h @ lp["wv"]).reshape(B, 1, KV, dh)
        cache.k[i, :, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[i, :, slot] = v[:, 0].to(cache.v.dtype)
        attn = decode_attention(q, cache.k[i], cache.v[i], pos + 1, window=_window(cfg, i))
        x = x + attn.reshape(B, 1, H * dh) @ lp["wo"]
        # the reference decodes MoE at capacity factor 4.0, whatever the config's
        x = x + _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"]), capacity_factor=4.0)[0]
    return _logits(params, x), cache


def decode_step(cfg: LMConfig, params, cache: KVCache, tokens, pos: int):
    """As the reference: (next token [B, 1] int32, cache)."""
    logits, cache = decode_logits(cfg, params, cache, tokens, pos)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache
