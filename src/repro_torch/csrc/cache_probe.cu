// Cache hash-probe for the one-hop result cache, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/cache_probe/kernel.py
// (cache_probe_pallas, body _probe_kernel). For each key (tpl, root, h, fp)
// it walks the linear probe window of `probes` slots starting at
// h & (capacity - 1) and reports the first slot whose (valid, tpl, root, fp)
// all match, or -1. Bit-identical to repro_torch/kernels/cache_probe/ref.py.
//
// What bounds it on this card: bytes, and at the read path's sizes launch
// latency. Each key reads 16 B of key and writes 5 B of result; its window
// touches up to `probes` slots of four metadata arrays (13 B a slot) that
// sit in a few 32-B sectors per array. A hop of 16,384 keys moves under
// 1 MB, well under a microsecond at 3.35 TB/s, which is below the launch cost.
//
// Design: one thread per key, the window walked in registers and left at
// the first match, so a hit on its home slot reads one slot. Neighbouring
// threads hold unrelated keys, so the window loads are scattered; the L2
// (50 MB) holds the whole metadata of a 2^18-slot cache (3.25 MB), which is
// what makes the scattered reads cheap. h, fp and c_fp arrive as int32
// holding the uint32 bits, as the port keeps them: the probe needs only
// h's low bits and an equality test on the fingerprint.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void cache_probe_kernel(
    const int32_t* __restrict__ c_tpl, const int32_t* __restrict__ c_root,
    const int32_t* __restrict__ c_fp, const uint8_t* __restrict__ c_valid,
    const int32_t* __restrict__ tpl, const int32_t* __restrict__ root,
    const int32_t* __restrict__ h, const int32_t* __restrict__ fp,
    uint8_t* __restrict__ hit, int32_t* __restrict__ slot,
    int n_keys, int cap_mask, int probes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_keys) return;
  const int32_t t = tpl[i];
  const int32_t r = root[i];
  const int32_t f = fp[i];
  const int base = h[i] & cap_mask;
  uint8_t found = 0;
  int32_t first = -1;
  for (int p = 0; p < probes; ++p) {
    const int s = (base + p) & cap_mask;
    if (c_valid[s] && c_tpl[s] == t && c_root[s] == r && c_fp[s] == f) {
      found = 1;
      first = s;
      break;
    }
  }
  hit[i] = found;
  slot[i] = first;
}

extern "C" int cache_probe_launch(
    const void* c_tpl, const void* c_root, const void* c_fp, const void* c_valid,
    const void* tpl, const void* root, const void* h, const void* fp,
    void* hit, void* slot, int n_keys, int capacity, int probes, void* stream) {
  if (n_keys <= 0) return 0;
  const int threads = 256;
  const int blocks = (n_keys + threads - 1) / threads;
  cache_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)c_tpl, (const int32_t*)c_root, (const int32_t*)c_fp,
      (const uint8_t*)c_valid, (const int32_t*)tpl, (const int32_t*)root,
      (const int32_t*)h, (const int32_t*)fp, (uint8_t*)hit, (int32_t*)slot,
      n_keys, capacity - 1, probes);
  return (int)cudaGetLastError();
}
