"""grok-1-314b: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1]"""

from repro_torch.configs.lm_shapes import FULL_ATTENTION_LONG_SKIP, LM_SHAPES
from repro_torch.lm.config import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, n_experts=8, top_k=2, rope_theta=10_000.0,
)

SMOKE = LMConfig(
    name="grok-1-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, n_experts=4, top_k=2,
    loss_chunk=16,
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": FULL_ATTENTION_LONG_SKIP}
