"""Two-tower retrieval configuration (YouTube RecSys'19 shape); a copy of
``repro.recsys.config``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TwoTowerConfig:
    name: str
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    # categorical fields per tower; each field is a multi-hot bag
    user_fields: int = 8
    item_fields: int = 6
    bag_size: int = 16  # max ids per bag (padded)
    user_vocab: int = 100_000_000
    item_vocab: int = 10_000_000
    temperature: float = 0.05
    dtype: str = "float32"

    def param_count(self) -> int:
        d = self.embed_dim
        n = (self.user_vocab + self.item_vocab) * d
        for fields in (self.user_fields, self.item_fields):
            last = fields * d
            for h in self.tower_mlp:
                n += last * h + h
                last = h
        return n
