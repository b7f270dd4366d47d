"""Multi-pod dry-run: every (architecture x input shape) cell on the
production meshes, built on the ``meta`` device.

PyTorch twin of ``repro.launch.dryrun``. The reference lowers and
compiles each cell's step with XLA on a 512-device host mesh and records
XLA's memory and cost analysis. The port has no compiler to ask: it builds
each cell (``launch.steps.build_cell``) with ``meta`` tensors, which
allocate nothing, and records

- ``memory.argument_bytes``: the bytes of the step's arguments one device
  holds under their specs, exact (the twin of XLA's
  ``argument_size_in_bytes``);
- ``memory.output_bytes``: the bytes of what the step returns, from a run
  of the step on ``meta`` (global, not per device);
- ``cost.flops_global``: the FLOPs ``torch.utils.flop_counter`` counts over
  that run, at the cell's global shapes (the reference's ``flops`` is per
  device). Off CUDA the kernel wrappers take their plain versions, so
  their arithmetic is what is counted. A cell's FLOPs are counted once,
  on its first mesh, and copied to the other;
- ``traced``: whether the step ran to its end on ``meta``. A step that
  reads a value on the host cannot (the graph cells read one per hop by
  design); ``trace_error`` then names the file and line of the read, and
  the output bytes and FLOPs are null;
- ``fits_card``: the per-device arguments against the card's memory
  (``--device``; null under ``--device cpu``).

XLA's collective bytes, loop analysis, HLO size, temporary bytes and
compile seconds have no counterpart here and are left out. One JSON a
(cell, mesh) accumulates under ``experiments/dryrun_torch/``, so partial
progress survives a crash.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gat-cora --mesh multipod
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import configs as configs_pkg
from repro_torch.kernels import shapes_only
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import argument_bytes, build_cell
from repro_torch.utils import resolve_device

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _where(exc: BaseException) -> str:
    """The innermost frame of the port that raised: ``file:line``."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if os.path.abspath(f.filename).startswith(_PKG)]
    f = frames[-1] if frames else traceback.extract_tb(exc.__traceback__)[-1]
    return f"{os.path.relpath(f.filename, os.path.dirname(_PKG))}:{f.lineno}"


def trace_cell(step, args) -> dict:
    """Runs ``step(*args)`` on ``meta`` under a FLOP counter: ``traced``,
    ``output_bytes``, ``flops_global``, and where it stopped if it did."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    try:
        with shapes_only(), counter:
            out = step(*args)
    except Exception as e:  # noqa: BLE001 - a step that reads the host stops here
        return dict(traced=False, output_bytes=None, flops_global=None,
                    trace_error=f"{_where(e)}: {type(e).__name__}: {str(e)[:200]}")
    return dict(traced=True, output_bytes=_tensor_bytes(out),
                flops_global=float(counter.get_total_flops()), trace_error=None)


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str, card_bytes,
             traced=None) -> dict:
    """Builds, measures and records one (cell, mesh); ``traced`` is the
    cell's trace from another mesh (its step and global shapes are the
    same), or None to run it here."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    t0 = time.perf_counter()
    rec = dict(arch=arch, shape=shape, mesh=mesh_kind, ok=False)
    try:
        step, specs, args = build_cell(arch, shape, mesh)
        t_build = time.perf_counter() - t0
        arg_bytes = argument_bytes(args, specs, mesh)
        tr = trace_cell(step, args) if traced is None else traced
        rec.update(
            ok=True,
            build_s=round(t_build, 3),
            trace_s=round(time.perf_counter() - t0 - t_build, 3),
            memory=dict(argument_bytes=arg_bytes, output_bytes=tr["output_bytes"]),
            cost=dict(flops_global=tr["flops_global"]),
            traced=tr["traced"],
            trace_error=tr["trace_error"],
            fits_card=None if card_bytes is None else arg_bytes <= card_bytes,
        )
        flops = tr["flops_global"]
        print(f"[OK ] {arch}/{shape}/{mesh_kind}: args={arg_bytes / 2**30:.2f}GiB/device "
              f"traced={tr['traced']} flops_global="
              f"{'-' if flops is None else f'{flops:.3e}'} fits_card={rec['fits_card']}",
              flush=True)
    except Exception as e:  # noqa: BLE001 - record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[FAIL] {arch}/{shape}/{mesh_kind}: {rec['error'][:200]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the card the cells are held against (CUDA unless named; "
                         "cpu: no card, fits_card null)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    card_bytes = (torch.cuda.get_device_properties(dev).total_memory
                  if dev.type == "cuda" else None)
    cells = configs_pkg.all_cells()
    if args.arch:
        cells = [c for c in cells if c["arch"] == args.arch]
    if args.shape:
        cells = [c for c in cells if c["shape"] == args.shape]
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]

    n_ok = n_fail = n_skip = 0
    for c in cells:
        if c["skip"]:
            print(f"[SKIP] {c['arch']}/{c['shape']}: {c['skip'][:90]}")
            n_skip += 1
            rec = dict(arch=c["arch"], shape=c["shape"], mesh="-", ok=True, skipped=c["skip"])
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{c['arch']}__{c['shape']}__skip.json"), "w") as f:
                json.dump(rec, f, indent=1)
            continue
        traced = None
        for mk in meshes:
            fname = os.path.join(args.out, f"{c['arch']}__{c['shape']}__{mk}.json")
            if args.skip_done and os.path.exists(fname):
                with open(fname) as f:
                    if json.load(f).get("ok"):
                        n_ok += 1
                        continue
            rec = run_cell(c["arch"], c["shape"], mk, args.out, card_bytes, traced)
            if rec["ok"]:
                traced = dict(traced=rec["traced"], trace_error=rec["trace_error"],
                              output_bytes=rec["memory"]["output_bytes"],
                              flops_global=rec["cost"]["flops_global"])
            n_ok += int(rec["ok"])
            n_fail += int(not rec["ok"])
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
