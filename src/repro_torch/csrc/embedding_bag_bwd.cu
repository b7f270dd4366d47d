// EmbeddingBag's table gradient, hand-written for Hopper.
//
// Replaces no TPU kernel: the JAX package takes this gradient by autodiff
// through jnp.take in repro/recsys/embedding.py (embedding_bag), and its
// Pallas kernel repro/kernels/embedding_bag/kernel.py has no backward. Two-
// tower training needs it for both tables. Computes the dense gradient
//   dtable[v, :] = sum over unmasked (b, j) with clip(ids[b, j]) == v of
//                  g[b, :],   g = dout / denom in fp32
// (denom = max(count of unmasked j in bag b, 1) in mode "mean", 1 in mode
// "sum"; the wrapper scales dout once, B x D divisions, before the launch),
// every row of the [V, D] table written once, zeros where no entry reads
// it, in the table's dtype (fp32 or bf16). Equal bit for bit to
// repro_torch/kernels/embedding_bag/ref.py (embedding_bag_backward_ref)
// run on the host, whose index_add_ adds each row's terms one after
// another in the same order.
//
// What bounds it on this card: bytes. The dense gradient is written once
// (at the two-tower item table, 10M x 256 fp32, 10.24 GB: 3.06 ms at 3.35
// TB/s); g, the sorted positions and the row offsets are read once
// (tens of MB). There is one add per value of g read.
//
// Design: the entries are sorted by row beforehand, on the device, with
// torch.sort (prepare_rows in ops.py, as segment_spmm sorts its edges):
// order[] holds the flat positions b*K + j in a stable sort by clipped id,
// offsets[v] the first of row v's entries, masked entries past
// offsets[V]. Then one warp per (row, tile of 256 columns) sums its run of
// entries in sorted order, in fp32, and writes the row once: a row with no
// entries writes zeros, so the kernel itself writes the whole dense
// gradient and nothing else needs to clear it. There are no atomics, so
// two calls are equal bit for bit, and no row is written twice. Lane l
// owns 8 neighbouring columns of the tile (16-byte loads and stores, as
// the forward kernel). The warp loads 32 positions at a time, one per
// lane, and walks them in order by shuffle; it issues the g loads of 8
// entries before adding them, in order, so a long run keeps 8 row loads
// in flight and its adds are the only work between them: the division by
// the bag's count is done once a bag beforehand, not once a value here,
// which halved the Zipf head's time (PERF.md). The output is written with
// streaming stores (st.global.cs): the kernel never reads it back, so it
// should not push g out of the L2.
//
// What this design leaves: a run is summed by one warp, so a hot row (a
// Zipf head id read by ~10^5 entries of a training batch) is a serial tail
// of ~10^5 dependent adds while the rest of the grid has long finished
// (PERF.md gives its time beside the bound). Splitting long runs over
// several warps needs a second, ordered combine; that is later work.
//
// Row offsets are 64-bit (10M x 256 = 2.56e9 elements, past 2^31). Widths
// that are not a multiple of 8 columns, or unaligned rows, take scalar
// loads and stores with the same order of sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerLane = 8;
constexpr int kTile = 32 * kColsPerLane;  // columns a warp covers
constexpr int kBlock = 256;
constexpr int kInFlight = 8;  // entries whose g rows load before they add
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void load8(float* v, const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < kColsPerLane; ++e) h[e] = __float2bfloat16(v[e]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the 8 columns of g row `bag` that this lane owns, from c0
template <bool kVec>
__device__ __forceinline__ void row8(float* v, const float* g, long long bag, int d, int c0) {
  const float* row = g + bag * (long long)d;
  if (kVec) {
    if (c0 < d) {
      load8(v, row + c0);
    } else {
#pragma unroll
      for (int e = 0; e < kColsPerLane; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e) v[e] = c0 + e < d ? __ldg(row + c0 + e) : 0.f;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, T* __restrict__ out, long long n_rows, int k, int d,
    int n_tiles) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_rows * n_tiles) return;  // whole warps leave together
  const long long r = warp / n_tiles;
  const int c0 = (int)(warp % n_tiles) * kTile + lane * kColsPerLane;
  const int lo = __ldg(offsets + r), hi = __ldg(offsets + r + 1);

  float acc[kColsPerLane];
#pragma unroll
  for (int e = 0; e < kColsPerLane; ++e) acc[e] = 0.f;
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    const int my_bag = lane < n ? __ldcs(order + base + lane) / k : 0;
    for (int j = 0; j < n; j += kInFlight) {
      float v[kInFlight][kColsPerLane];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {  // the loads first ...
        const long long bag = __shfl_sync(kAll, my_bag, j + q < n ? j + q : j);
        row8<kVec>(v[q], g, bag, d, c0);
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {  // ... then the adds, in order
        if (j + q < n) {
#pragma unroll
          for (int e = 0; e < kColsPerLane; ++e) acc[e] += v[q][e];
        }
      }
    }
  }
  T* orow = out + r * (long long)d + c0;
  if (kVec) {
    if (c0 < d) store8(orow, acc);  // d % 8 == 0: all 8 columns, or none
  } else {
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e)
      if (c0 + e < d) orow[e] = from_f32<T>(acc[e]);
  }
}

template <typename T>
void launch(const void* g, const void* order, const void* offsets, void* out, int n_rows, int k,
            int d, cudaStream_t stream) {
  const int n_tiles = (d + kTile - 1) / kTile;
  const long long threads = (long long)n_rows * n_tiles * 32;
  const long long grid = (threads + kBlock - 1) / kBlock;
  // 16-byte loads and stores need every row to start 16-byte aligned and
  // hold whole 8-column chunks
  const bool vec = d % kColsPerLane == 0 && ((uintptr_t)g % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0 && ((long long)d * (long long)sizeof(T)) % 16 == 0;
  auto kernel = vec ? embedding_bag_bwd_kernel<T, true> : embedding_bag_bwd_kernel<T, false>;
  kernel<<<(unsigned)grid, kBlock, 0, stream>>>(
      (const float*)g, (const int32_t*)order, (const int32_t*)offsets, (T*)out, n_rows, k, d,
      n_tiles);
}

}  // namespace

// g fp32 [B, d] (dout scaled by its bag's denominator); order int32
// [B * k] (flat positions sorted by row); offsets int32 [n_rows + 1]; out
// [n_rows, d], fp32 (is_bf16 0) or bf16 (1). Returns cudaGetLastError().
extern "C" int embedding_bag_bwd_launch(
    const void* g, const void* order, const void* offsets, void* out, int n_rows, int k, int d,
    int is_bf16, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) launch<__nv_bfloat16>(g, order, offsets, out, n_rows, k, d, s);
  else launch<float>(g, order, offsets, out, n_rows, k, d, s);
  return (int)cudaGetLastError();
}
