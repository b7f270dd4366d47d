"""kimi-k2-1t-a32b: 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8 (expert d_ff=2048) + 1 shared expert — trillion-param
MoE. [arXiv:2501.kimi2]

Memory note (recorded in EXPERIMENTS §Dry-run): 1T params do not fit a
single v5e-256 pod with fp32 Adam moments; the train config uses bf16
moments and ZeRO-1, and the honest fit verdict comes from
compiled.memory_analysis()."""

from repro_torch.configs.lm_shapes import FULL_ATTENTION_LONG_SKIP, LM_SHAPES
from repro_torch.lm.config import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=2048, vocab=163840, n_experts=384, top_k=8,
    n_shared_experts=1, rope_theta=50_000.0,
)

SMOKE = LMConfig(
    name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=512, n_experts=8, top_k=2, n_shared_experts=1,
    loss_chunk=16,
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": FULL_ATTENTION_LONG_SKIP}
