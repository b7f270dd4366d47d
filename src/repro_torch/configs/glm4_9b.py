"""glm4-9b: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, RoPE.
[hf:THUDM/glm-4-9b]"""

from repro_torch.configs.lm_shapes import FULL_ATTENTION_LONG_SKIP, LM_SHAPES
from repro_torch.lm.config import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="glm4-9b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, rope_theta=10_000.0,
)

SMOKE = LMConfig(
    name="glm4-9b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, loss_chunk=16,
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": FULL_ATTENTION_LONG_SKIP}
