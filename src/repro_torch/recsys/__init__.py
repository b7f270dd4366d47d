"""RecSys substrate of the port: two-tower retrieval serving, its bags
through the hand-written ``embedding_bag`` kernel. PyTorch twin of the
serving half of ``repro.recsys``; training is not ported yet."""

from repro_torch.recsys.config import TwoTowerConfig
from repro_torch.recsys.embedding import embedding_bag, embedding_bag_flat
from repro_torch.recsys.twotower import (
    init_params as tt_init,
    item_tower,
    retrieval_step,
    serve_step as tt_serve_step,
    user_tower,
)

__all__ = [
    "TwoTowerConfig",
    "embedding_bag",
    "embedding_bag_flat",
    "tt_init",
    "tt_serve_step",
    "retrieval_step",
    "user_tower",
    "item_tower",
]
