// Cache hash-probe for the one-hop result cache, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/cache_probe/kernel.py
// (cache_probe_pallas, body _probe_kernel). For each key (tpl, root, h, fp)
// it looks at the linear probe window of `probes` slots starting at
// h & (capacity - 1) and reports the first slot in probe order whose
// (valid, tpl, root, fp) all match, or -1. Bit-identical to
// repro_torch/kernels/cache_probe/ref.py.
//
// What bounds it on this card: bytes in principle (each key reads 16 B of
// key and writes 5 B; its window touches up to `probes` slots of four
// metadata arrays, 13 B a slot: a lookup of 1,024 keys moves ~57 KB,
// 0.017 us at 3.35 TB/s), latency in practice. Walking the window serially
// with short-circuit tests made each probe up to four dependent loads, and
// a key that misses (about 42 % of the single host's) eight probes of them.
//
// Design: a group of 8 neighbouring threads per key (4 keys a warp), one
// probe slot a thread. The group's first four threads each load one of the
// key's four words and shuffle them to the group. Every thread then loads
// its slot's four metadata words at once, without short-circuit, so one
// round of independent loads covers 8 probes; within the group they are
// coalesced, as the window is contiguous except where it wraps at C. The
// group ballots its matches; the lowest set bit is the first match in
// probe order (a probe that wrapped has a lower slot index but a later
// probe order, so the lowest slot index is not the answer). Windows longer
// than 8 probes take further rounds until one matches. h, fp and c_fp
// arrive as int32 holding the uint32 bits, as the port keeps them: the
// probe needs only h's low bits and an equality test on the fingerprint.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;    // threads a key, one probe slot each
constexpr int kBlock = 256;  // 32 keys a block

}  // namespace

__global__ void __launch_bounds__(kBlock) cache_probe_kernel(
    const int32_t* __restrict__ c_tpl, const int32_t* __restrict__ c_root,
    const int32_t* __restrict__ c_fp, const uint8_t* __restrict__ c_valid,
    const int32_t* __restrict__ tpl, const int32_t* __restrict__ root,
    const int32_t* __restrict__ h, const int32_t* __restrict__ fp,
    uint8_t* __restrict__ hit, int32_t* __restrict__ slot,
    int n_keys, int cap_mask, int probes) {
  const int64_t i = ((int64_t)blockIdx.x * kBlock + threadIdx.x) / kGroup;
  if (i >= n_keys) return;  // whole groups leave together
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroup - 1);
  const int gbase = lane & ~(kGroup - 1);
  const unsigned gmask = 0xffu << gbase;

  const int32_t* word = g == 0 ? tpl : g == 1 ? root : g == 2 ? h : fp;
  const int32_t mine = g < 4 ? word[i] : 0;
  const int32_t t = __shfl_sync(gmask, mine, 0, kGroup);
  const int32_t r = __shfl_sync(gmask, mine, 1, kGroup);
  const int base = __shfl_sync(gmask, mine, 2, kGroup) & cap_mask;
  const int32_t f = __shfl_sync(gmask, mine, 3, kGroup);

  int32_t first = -1;
  for (int p0 = 0; p0 < probes; p0 += kGroup) {
    const int p = p0 + g;
    bool ok = false;
    if (p < probes) {
      const int s = (base + p) & cap_mask;
      const uint8_t v = c_valid[s];
      const int32_t a = c_tpl[s], b = c_root[s], c = c_fp[s];
      ok = (v != 0) & (a == t) & (b == r) & (c == f);
    }
    const unsigned m = (__ballot_sync(gmask, ok) >> gbase) & 0xffu;
    if (m) {
      first = (base + p0 + __ffs(m) - 1) & cap_mask;
      break;
    }
  }
  if (g == 0) {
    hit[i] = first >= 0;
    slot[i] = first;
  }
}

extern "C" int cache_probe_launch(
    const void* c_tpl, const void* c_root, const void* c_fp, const void* c_valid,
    const void* tpl, const void* root, const void* h, const void* fp, void* hit, void* slot,
    int n_keys, int capacity, int probes, void* stream) {
  if (n_keys <= 0) return 0;
  const int64_t blocks = ((int64_t)n_keys * kGroup + kBlock - 1) / kBlock;
  cache_probe_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)c_tpl, (const int32_t*)c_root, (const int32_t*)c_fp,
      (const uint8_t*)c_valid, (const int32_t*)tpl, (const int32_t*)root, (const int32_t*)h,
      (const int32_t*)fp, (uint8_t*)hit, (int32_t*)slot, n_keys, capacity - 1, probes);
  return (int)cudaGetLastError();
}
