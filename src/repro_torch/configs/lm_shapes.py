"""The LM-family input-shape set (shared by all 5 LM archs)."""

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

FULL_ATTENTION_LONG_SKIP = (
    "long_500k requires sub-quadratic attention; this arch is pure "
    "full-attention (DESIGN.md §Arch-applicability)"
)
