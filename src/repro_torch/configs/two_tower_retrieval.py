"""two-tower-retrieval: embed_dim=256 tower_mlp=1024-512-256 dot interaction,
sampled-softmax retrieval. [RecSys'19 (YouTube)]"""

from repro_torch.recsys.config import TwoTowerConfig

FAMILY = "recsys"

FULL = TwoTowerConfig(
    name="two-tower-retrieval", embed_dim=256, tower_mlp=(1024, 512, 256),
    user_fields=8, item_fields=6, bag_size=16,
    user_vocab=100_000_000, item_vocab=10_000_000,
)

SMOKE = TwoTowerConfig(
    name="two-tower-smoke", embed_dim=16, tower_mlp=(32, 16),
    user_fields=3, item_fields=2, bag_size=4,
    user_vocab=1000, item_vocab=500,
)

SHAPES = {
    "train_batch": dict(kind="rec_train", batch=65536),
    "serve_p99": dict(kind="rec_serve", batch=512, n_candidates=256),
    "serve_bulk": dict(kind="rec_serve", batch=262144, n_candidates=16),
    "retrieval_cand": dict(kind="rec_retrieval", batch=1, n_candidates=1_000_000),
}
SKIPS = {}
