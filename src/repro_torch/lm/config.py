"""LM architecture configuration: ``repro.lm.config`` less the knobs the
port does not read (the attention chunk sizes, which the kernel's tiling
replaces, and the expert-sharding hint)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # defaults to d_model // n_heads
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0  # DeepSeek/Kimi-style always-on experts
    capacity_factor: float = 1.25
    # attention
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # local layers' window
    local_global_pattern: int = 0  # N -> N local layers per 1 global (0 = all global)
    # numerics / memory
    dtype: str = "bfloat16"
    remat: bool = True  # recompute each block's activations in the backward
    loss_chunk: int = 512  # positions per chunk of the cross-entropy

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_is_local(self, i: int) -> bool:
        """gemma3-style 5:1 pattern: layers 0..4 local, 5 global, ..."""
        if self.local_global_pattern <= 0 or self.sliding_window is None:
            return False
        return (i % (self.local_global_pattern + 1)) != self.local_global_pattern

    def param_count(self) -> int:
        """Total parameters (embedding + unembedding included)."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            ffn += self.n_shared_experts * 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        norms = 2 * d
        per_layer = attn + ffn + norms
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k + shared experts)."""
        if not self.is_moe:
            return self.param_count()
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        ffn = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff
        ffn += d * self.n_experts  # router
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d
