"""Optimizers of the port: AdamW, clipping, a cosine schedule and int8
error-feedback gradient compression (PyTorch twin of ``repro.optim``,
whose ZeRO-1 sharding has nothing to shard on one card)."""

from repro_torch.optim.adamw import (
    GradientTransform,
    adamw,
    chain,
    clip_by_global_norm,
)
from repro_torch.optim.compression import int8_compress_grads
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "GradientTransform",
    "adamw",
    "chain",
    "clip_by_global_norm",
    "cosine_schedule",
    "int8_compress_grads",
]
