"""Time the two output store layouts weighed for ``block_gather`` on one
CUDA card, with nothing else in the kernels: what the choice of chunk
width costs by itself.

``block_gather`` writes ``leaf`` int32 and three 1-byte masks, [B, W]
each. Two stand-in kernels write those four outputs with the values of a
lane's index, and do nothing else:

- ``chunk16``: a thread owns 16 lanes; four 16-byte streaming stores of
  leaf ids 64 bytes apart and one 16-byte store a mask. A warp's leaf store
  instruction writes half of each of 32 sectors;
- ``chunk4``: a thread owns 4 lanes (the kernel's layout); one 16-byte
  leaf store and one 4-byte store a mask, so each warp store covers whole
  sectors.

Beside them, ``zero_`` of the same four tensors and the bound (each byte
written once at 3.35 TB/s). Times are CUDA-event device time a launch over
back-to-back launches. Run on the card, from the repository root:

    PYTHONPATH=src python3 -m repro_torch.kernels.block_gather.store_probe

It builds its own source with ``nvcc`` into ``build/repro_torch/probes``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void chunk16_kernel(int32_t* leaf, uint8_t* scan, uint8_t* emask, uint8_t* qual,
                               int64_t n_chunks) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const int32_t l0 = (int32_t)(c * 16);
  int4* l = reinterpret_cast<int4*>(leaf) + c * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    __stcs(l + k, make_int4(l0 + 4 * k, l0 + 4 * k + 1, l0 + 4 * k + 2, l0 + 4 * k + 3));
  const uint32_t m = (uint32_t)l0 & 0x01010101u;
  const uint4 mv = make_uint4(m, m, m, m);
  __stcs(reinterpret_cast<uint4*>(scan) + c, mv);
  __stcs(reinterpret_cast<uint4*>(emask) + c, mv);
  __stcs(reinterpret_cast<uint4*>(qual) + c, mv);
}

__global__ void chunk4_kernel(int32_t* leaf, uint8_t* scan, uint8_t* emask, uint8_t* qual,
                              int64_t n_chunks) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const int32_t l0 = (int32_t)(c * 4);
  __stcs(reinterpret_cast<int4*>(leaf) + c, make_int4(l0, l0 + 1, l0 + 2, l0 + 3));
  const uint32_t m = (uint32_t)l0 & 0x01010101u;
  __stcs(reinterpret_cast<uint32_t*>(scan) + c, m);
  __stcs(reinterpret_cast<uint32_t*>(emask) + c, m);
  __stcs(reinterpret_cast<uint32_t*>(qual) + c, m);
}

// lanes: B * W, a multiple of 16
extern "C" int store_probe_launch(int layout, void* leaf, void* scan, void* emask, void* qual,
                                  long long lanes, void* stream) {
  const int threads = 256;
  const int64_t n = lanes / (layout == 16 ? 16 : 4);
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (layout == 16)
    chunk16_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (int32_t*)leaf, (uint8_t*)scan, (uint8_t*)emask, (uint8_t*)qual, n);
  else
    chunk4_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (int32_t*)leaf, (uint8_t*)scan, (uint8_t*)emask, (uint8_t*)qual, n);
  return (int)cudaGetLastError();
}
"""


def build():
    out = _build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "store_probe.cu", out / "store_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).store_probe_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def event_us(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=12288, help="B: phase 7's largest call")
    ap.add_argument("--lanes", type=int, default=1088, help="W = max_deg + R")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    assert args.rows * args.lanes % 16 == 0, "B * W must be a multiple of 16"
    if not torch.cuda.is_available():
        raise SystemExit("store_probe: no CUDA device")
    dev = torch.device("cuda")
    launch = build()
    n = args.rows * args.lanes
    outs = [torch.empty(n, dtype=torch.int32, device=dev)] + [
        torch.empty(n, dtype=torch.uint8, device=dev) for _ in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    res = {}
    for layout in (16, 4):
        def run(layout=layout):
            err = launch(layout, *(t.data_ptr() for t in outs), n, stream)
            if err:
                raise RuntimeError(f"store_probe launch failed: cudaError {err}")
        run()
        torch.cuda.synchronize()
        assert torch.equal(outs[0], lane), f"chunk{layout} wrote wrong leaf ids"
        res[f"chunk{layout}_us"] = event_us(run, args.iters)
    res["zero_us"] = event_us(lambda: [t.zero_() for t in outs], args.iters)
    nbytes = sum(t.numel() * t.element_size() for t in outs)
    res.update(rows=args.rows, lanes=args.lanes, bytes=nbytes, bound_us=nbytes / 3.35e12 * 1e6,
               device=torch.cuda.get_device_name(0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: not read")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
