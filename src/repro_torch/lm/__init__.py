"""Transformer LM substrate of the port: GQA + RoPE dense blocks, local /
global sliding-window hybrids, prefill through the hand-written
``flash_attention`` kernel, KV-cache decode. PyTorch twin of the serving
half of ``repro.lm``; training and MoE are not ported yet."""

from repro_torch.lm.config import LMConfig
from repro_torch.lm.model import (
    KVCache,
    decode_logits,
    decode_step,
    forward,
    init_kv_cache,
    init_params,
    prefill_logits,
    prefill_step,
)

__all__ = [
    "LMConfig",
    "KVCache",
    "init_params",
    "forward",
    "prefill_logits",
    "prefill_step",
    "decode_logits",
    "decode_step",
    "init_kv_cache",
]
