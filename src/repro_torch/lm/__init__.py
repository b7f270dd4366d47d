"""Transformer LM substrate of the port: GQA + RoPE blocks, dense or
sort-based MoE (with a shared expert), local / global sliding-window
hybrids, prefill and training through the hand-written
``flash_attention`` kernels, KV-cache decode. PyTorch twin of
``repro.lm``."""

from repro_torch.lm.config import LMConfig
from repro_torch.lm.model import (
    KVCache,
    decode_logits,
    decode_step,
    forward,
    init_kv_cache,
    init_params,
    loss_fn,
    prefill_logits,
    prefill_step,
    train_step,
)

__all__ = [
    "LMConfig",
    "KVCache",
    "init_params",
    "forward",
    "loss_fn",
    "train_step",
    "prefill_logits",
    "prefill_step",
    "decode_logits",
    "decode_step",
    "init_kv_cache",
]
