"""Checkpointing: atomic, zstd-compressed, readable by either package."""

from repro_torch.checkpoint.ckpt import (
    CODEC,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
    tree_unflatten,
)

__all__ = ["CODEC", "save_checkpoint", "restore_checkpoint", "latest_step", "tree_leaves",
           "tree_unflatten"]
