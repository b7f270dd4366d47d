"""The training entry point of the PyTorch port: real steps of an LM on one
device, checkpoint / restart and optional int8 gradient compression. Twin
of ``repro.launch.train``, with the same flags and defaults, plus
``--device`` (CUDA unless it names another)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
      --steps 3 --batch 1 --seq 4096 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu

On the card every attention runs the hand-written flash-attention kernels,
forward and backward, and each block is recomputed in the backward
(``cfg.remat``). The optimizer works in place, a layer slice at a time, so
Gemma3-4B FULL (bf16 parameters and gradients, fp32 AdamW moments: 50.9
GiB) trains on one 80 GB card. The reference's mesh sharding has nothing
to shard on one card and is left out. One difference: ``--resume`` skips
the batches the checkpointed run already took.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as configs_pkg
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.lm import model as lm_model
from repro_torch.lm.config import LMConfig
from repro_torch.optim import (adamw, chain, clip_by_global_norm, cosine_schedule,
                               int8_compress_grads)
from repro_torch.optim.adamw import apply_updates, tree_map, value_and_grad
from repro_torch.utils import resolve_device


def synthetic_batches(vocab: int, batch: int, seq: int, seed: int = 0, device=None):
    """The reference's deterministic synthetic LM data pipeline (a zipfian
    unigram stream with induced bigram structure, so the loss has something
    to learn): the same numpy draws, so the same tokens, as int32 tensors
    on ``device`` (CUDA unless another is named)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.5, size=vocab * 4) % vocab
    while True:
        start = rng.integers(0, len(base) - (batch * (seq + 1)) - 1)
        chunk = base[start : start + batch * (seq + 1)].reshape(batch, seq + 1)
        yield (torch.as_tensor(chunk[:, :-1].astype(np.int32), device=dev),
               torch.as_tensor(chunk[:, 1:].astype(np.int32), device=dev))


def build(cfg: LMConfig, lr: float, total_steps: int, compress: bool):
    """``(optimizer, step)``: the reference's optimizer (clip to 1.0, AdamW
    on a cosine schedule) and its step, ``(params, opt_state, tokens,
    labels)``, or with ``compress`` ``(params, opt_state, residual, tokens,
    labels)``, whose gradients take the int8 roundtrip first."""
    opt = chain(
        clip_by_global_norm(1.0),
        adamw(cosine_schedule(lr, warmup=min(100, total_steps // 10 + 1), total=total_steps)),
    )
    base_step = lm_model.train_step(cfg, opt)

    if not compress:
        return opt, base_step

    def step_with_compression(params, opt_state, residual, tokens, labels):
        loss, grads = value_and_grad(lambda p: lm_model.loss_fn(cfg, p, tokens, labels), params)
        grads, residual = int8_compress_grads(grads, residual)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, residual, {"loss": loss}

    return opt, step_with_compression


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def main(argv=None, keep=None):
    """Trains as the reference's ``main`` does; returns the step losses.
    ``keep``, a dict, receives the final ``params`` and ``opt_state``, each
    step's wall seconds (``step_s``, up to its loss's read) and its
    gradient norm (``grad_norm``; none with ``--compress-grads``), for a
    caller that checks them."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mod = configs_pkg.get_arch(args.arch)
    assert mod.FAMILY == "lm", "train.py drives the LM family"
    cfg: LMConfig = mod.SMOKE if args.smoke else mod.FULL
    if args.seq % cfg.loss_chunk != 0:
        cfg = dataclasses.replace(cfg, loss_chunk=min(args.seq, 16))
    print(f"arch={cfg.name} params={cfg.param_count():,} steps={args.steps}")

    opt, step = build(cfg, args.lr, args.steps, args.compress_grads)
    # the reference draws from jax.random.PRNGKey(0): the same seed, torch's
    # generator on the device
    params = lm_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = opt.init(params)
    residual = None
    if args.compress_grads:
        residual = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
                            params)
    start = 0
    if args.resume and args.ckpt and (ls := latest_step(args.ckpt)) is not None:
        params, opt_state = restore_checkpoint(args.ckpt, ls, (params, opt_state), device=dev)
        start = ls
        print(f"resumed from step {ls}")

    data = synthetic_batches(cfg.vocab, args.batch, args.seq, device=dev)
    # a resumed run takes up the stream where the checkpointed run left it,
    # so that it reproduces that run's later losses (the reference replays
    # the stream from its first batch)
    for _ in range(start):
        next(data)
    losses, step_s, gnorms = [], [], []
    t0 = time.time()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        tokens, labels = next(data)
        if args.compress_grads:
            params, opt_state, residual, m = step(params, opt_state, residual, tokens, labels)
        else:
            params, opt_state, m = step(params, opt_state, tokens, labels)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t_step)
        if "grad_norm" in m:
            gnorms.append(float(m["grad_norm"]))
        if (i + 1) % args.log_every == 0:
            dt = (time.time() - t0) / (i + 1 - start)
            print(f"step {i+1}: loss={losses[-1]:.4f} ({dt*1e3:.0f} ms/step)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, i + 1, (params, opt_state))
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    else:
        print("nothing to do (already at target step)")
    if keep is not None:
        keep.update(params=params, opt_state=opt_state, step_s=step_s, grad_norm=gnorms)
    return losses


if __name__ == "__main__":
    main()
