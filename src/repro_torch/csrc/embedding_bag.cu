// EmbeddingBag (gather + bag reduce), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_bag/kernel.py
// (embedding_bag_pallas, body _bag_kernel). Computes, for each bag b,
//   out[b, :] = sum over j < K with mask[b, j] of table[clip(ids[b, j]), :]
// and, for mode "mean", divides by max(count of unmasked j, 1); that is
// repro.recsys.embedding.embedding_bag without weights. ids are clipped to
// [0, V-1] as the reference clips (the Pallas kernel would index out of
// range). Held to repro_torch/kernels/embedding_bag/ref.py within fp32
// rounding: the sums run over j = 0..K-1 in order, in fp32, rounded once to
// the table's type (fp32 or bf16).
//
// What bounds it on this card: bytes. Each distinct row an unmasked id
// names is read once and each bag writes one row; there is one add per
// value read, far below the card's arithmetic rate. At the two-tower
// serve_bulk shape (2,097,152 bags of 1-16 Zipf ids, D = 256 fp32) the
// ~17.8M lookups name ~2.3M distinct rows: ~4.7 GB, ~1.4 ms at 3.35 TB/s
// (every lookup's row would be ~18.3 GB). Repeated rows can come from the
// 50 MB L2 only while they stay there.
//
// Design: one warp per (bag, tile of 256 columns). Lane l owns 8
// neighbouring columns of the tile, so a warp reads a 1 KB fp32 (512 B
// bf16) row slice as 32 contiguous 16-byte chunks. The warp loads its bag's
// ids and mask itself, 32 at a time, one per lane, and walks the unmasked
// ones in order by ballot and shuffle, so no lane reads an id another lane
// already read.
// - The epilogue: each lane divides its 8 sums (mean mode) and then writes
//   them as 16-byte stores. With eight scalar stores a lane, each behind
//   its division, the mean-mode kernel took ~6 ms at serve_bulk whatever
//   the ids (PERF.md).
// - Loads in flight: one row a warp at a time, and few registers (32 a
//   thread), so 64 warps an SM keep the card's loads in flight. Issuing
//   the loads of several rows before adding them costs registers and with
//   them resident warps: at serve_bulk that ran slower on every id
//   distribution.
// - The L2 kept for the table: ids and masks are read with streaming loads
//   (ld.global.cs) and the output is written with streaming stores
//   (st.global.cs), both evict-first, so the 2.15 GB output stream and the
//   ids at serve_bulk do not push the hot rows out. Table rows take the
//   ordinary cached path.
// Row offsets are 64-bit: at 50,000,000 x 256 a table has 1.28e10 elements,
// past 2^31. Rows whose width is not a multiple of 8 columns, or whose rows
// are not 16-byte aligned, take scalar loads and stores with the same order
// of sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerLane = 8;
constexpr int kTile = 32 * kColsPerLane;  // columns a warp covers
constexpr int kBlock = 256;
constexpr unsigned kAll = 0xffffffffu;

// adds the 8 values at p (16-byte aligned) to acc
__device__ __forceinline__ void add8(float* acc, const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
  acc[4] += b.x; acc[5] += b.y; acc[6] += b.z; acc[7] += b.w;
}
__device__ __forceinline__ void add8(float* acc, const __nv_bfloat16* p) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
  for (int e = 0; e < kColsPerLane; ++e) acc[e] += __bfloat162float(h[e]);
}

// streaming (evict-first) stores of the 8 values v at p (16-byte aligned)
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kBlock) embedding_bag_kernel(
    const T* __restrict__ table, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, T* __restrict__ out,
    long long n_rows, long long n_bags, int k, int d, int n_tiles, int mean) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_bags * n_tiles) return;  // whole warps leave together
  const long long bag = warp / n_tiles;
  const int c0 = (int)(warp % n_tiles) * kTile + lane * kColsPerLane;
  const int32_t* bag_ids = ids + bag * k;
  const uint8_t* bag_mask = mask + bag * k;

  float acc[kColsPerLane];
#pragma unroll
  for (int e = 0; e < kColsPerLane; ++e) acc[e] = 0.f;
  int count = 0;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    const bool live = j < k && __ldcs(bag_mask + j) != 0;
    const int my_id = j < k ? __ldcs(bag_ids + j) : 0;
    unsigned todo = __ballot_sync(kAll, live);
    count += __popc(todo);
    while (todo) {  // unmasked positions in ascending order
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      long long r = (long long)__shfl_sync(kAll, my_id, src);
      r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
      const T* row = table + r * (long long)d;
      if (kVec) {
        if (c0 < d) add8(acc, row + c0);
      } else {
#pragma unroll
        for (int e = 0; e < kColsPerLane; ++e)
          if (c0 + e < d) acc[e] += to_f32(row[c0 + e]);
      }
    }
  }
  const float denom = mean ? (float)(count > 1 ? count : 1) : 1.f;
  float v[kColsPerLane];
#pragma unroll
  for (int e = 0; e < kColsPerLane; ++e) v[e] = mean ? acc[e] / denom : acc[e];
  T* orow = out + bag * (long long)d + c0;
  if (kVec) {
    if (c0 < d) store8(orow, v);  // d % 8 == 0: all 8 columns, or none
  } else {
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e)
      if (c0 + e < d) orow[e] = from_f32<T>(v[e]);
  }
}

template <typename T>
void launch(const void* table, const void* ids, const void* mask, void* out,
            int n_rows, int n_bags, int k, int d, int mean, cudaStream_t stream) {
  const int n_tiles = (d + kTile - 1) / kTile;
  const long long threads = (long long)n_bags * n_tiles * 32;
  const long long grid = (threads + kBlock - 1) / kBlock;
  // 16-byte loads need every row to start 16-byte aligned and hold whole
  // 8-column chunks (the output, fresh from the allocator, is aligned)
  const bool vec = d % kColsPerLane == 0 &&
                   ((uintptr_t)table % 16) == 0 && ((uintptr_t)out % 16) == 0 &&
                   ((long long)d * (long long)sizeof(T)) % 16 == 0;
  auto kernel = vec ? embedding_bag_kernel<T, true> : embedding_bag_kernel<T, false>;
  kernel<<<(unsigned)grid, kBlock, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (const uint8_t*)mask, (T*)out,
      n_rows, n_bags, k, d, n_tiles, mean);
}

}  // namespace

// table [n_rows, d]; ids int32 / mask uint8 [n_bags, k]; out [n_bags, d].
// is_bf16: 0 for fp32 table/out, 1 for bf16. Returns cudaGetLastError().
extern "C" int embedding_bag_launch(
    const void* table, const void* ids, const void* mask, void* out,
    int n_rows, int n_bags, int k, int d, int mean, int is_bf16, void* stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) launch<__nv_bfloat16>(table, ids, mask, out, n_rows, n_bags, k, d, mean, s);
  else launch<float>(table, ids, mask, out, n_rows, n_bags, k, d, mean, s);
  return (int)cudaGetLastError();
}

// The 16-byte kernel's registers a thread and resident blocks of kBlock
// threads an SM on this card, for the fp32 (is_bf16 0) or bf16 instance.
// Returns the CUDA error code.
extern "C" int embedding_bag_occupancy(int is_bf16, int* regs, int* blocks_per_sm) {
  const void* fn = is_bf16 ? (const void*)embedding_bag_kernel<__nv_bfloat16, true>
                           : (const void*)embedding_bag_kernel<float, true>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kBlock, 0);
}
