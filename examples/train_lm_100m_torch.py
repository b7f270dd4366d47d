"""End-to-end training on PyTorch: a ~100M-parameter LM for a few hundred
steps with checkpointing and resume, on the synthetic token pipeline.

The twin of ``examples/train_lm_100m.py`` on ``repro_torch``: the same
configuration, optimizer (clip + AdamW on a cosine schedule at 3e-4) and
data stream. On the card its attention runs the hand-written
flash-attention kernels, forward and backward. ``--resume`` restarts from
the newest checkpoint under ``--ckpt`` and takes up the data stream where
that run left it, so a resumed run repeats the uninterrupted run's losses.

Run:  PYTHONPATH=src python examples/train_lm_100m_torch.py --steps 200 [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.lm import LMConfig, init_params  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402


def lm_100m() -> LMConfig:
    # ~100M params: 2*32768*512 embeddings + 14 layers (d=512, ff=2560)
    return LMConfig(
        name="lm-100m", n_layers=14, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=2560, vocab=32768, loss_chunk=64, remat=False,
    )


def run(steps=200, batch=4, seq=64, ckpt=None, ckpt_every=100, resume=False, device=None,
        log_every=20):
    """Trains ``steps`` steps (from the newest checkpoint under ``ckpt``
    with ``resume``); returns the losses of the steps it ran."""
    dev = resolve_device(device)
    cfg = lm_100m()
    print(f"params: {cfg.param_count():,}")
    opt, step = train_mod.build(cfg, 3e-4, steps, compress=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = opt.init(params)
    start = 0
    if resume and ckpt and (ls := latest_step(ckpt)) is not None:
        params, opt_state = restore_checkpoint(ckpt, ls, (params, opt_state), device=dev)
        start = ls
        print(f"resumed from step {ls}")
    data = train_mod.synthetic_batches(cfg.vocab, batch, seq, device=dev)
    for _ in range(start):
        next(data)
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        tokens, labels = next(data)
        params, opt_state, m = step(params, opt_state, tokens, labels)
        losses.append(float(m["loss"]))
        if (i + 1) % log_every == 0:
            print(f"step {i+1}: loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1-start)*1e3:.0f} ms/step)")
        if ckpt and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt, i + 1, (params, opt_state))
    if losses:
        print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over steps {start + 1}-{steps}")
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "lm100m_torch_ckpt"),
                    help="checkpoint directory (default: lm100m_torch_ckpt under $TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args()
    losses = run(args.steps, args.batch, args.seq, args.ckpt, args.ckpt_every, args.resume,
                 args.device)
    if not args.resume:
        assert losses[-1] < losses[0], "training must make progress"


if __name__ == "__main__":
    main()
