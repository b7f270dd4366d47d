"""LR schedules: PyTorch twin of ``repro.optim.schedule``."""

from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor x
    peak_lr`` at ``total``. The returned function takes a step (an int or
    a tensor) and returns an fp32 tensor on the step's device."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr
