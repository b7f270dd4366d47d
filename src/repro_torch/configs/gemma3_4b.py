"""gemma3-4b: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global sliding-window hybrid, 128k context. [hf:google/gemma-3]

Runs long_500k: the 5:1 local layers are sliding-window (sub-quadratic) and
decode with a KV cache is per-token linear; global layers shard KV over
'model' (context parallelism)."""

from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.lm.config import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_head=256, d_ff=10240, vocab=262144, rope_theta=1_000_000.0,
    sliding_window=1024, local_global_pattern=5,
)

SMOKE = LMConfig(
    name="gemma3-4b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=512, sliding_window=8, local_global_pattern=2,
    loss_chunk=16,
)

SHAPES = LM_SHAPES
SKIPS = {}
