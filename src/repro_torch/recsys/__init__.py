"""RecSys substrate of the port: two-tower retrieval, serving and
training, its bags through the hand-written ``embedding_bag`` kernel and
the tables' gradients through its backward kernel. PyTorch twin of
``repro.recsys``."""

from repro_torch.recsys.config import TwoTowerConfig
from repro_torch.recsys.embedding import embedding_bag, embedding_bag_flat
from repro_torch.recsys.twotower import (
    init_params as tt_init,
    item_tower,
    loss_fn as tt_loss,
    retrieval_step,
    serve_step as tt_serve_step,
    train_step as tt_train_step,
    user_tower,
)

__all__ = [
    "TwoTowerConfig",
    "embedding_bag",
    "embedding_bag_flat",
    "tt_init",
    "tt_serve_step",
    "tt_loss",
    "tt_train_step",
    "retrieval_step",
    "user_tower",
    "item_tower",
]
