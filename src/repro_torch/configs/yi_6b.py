"""yi-6b: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, llama-arch.
[arXiv:2403.04652]"""

from repro_torch.configs.lm_shapes import FULL_ATTENTION_LONG_SKIP, LM_SHAPES
from repro_torch.lm.config import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, rope_theta=5_000_000.0,
)

SMOKE = LMConfig(
    name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, loss_chunk=16,
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": FULL_ATTENTION_LONG_SKIP}
