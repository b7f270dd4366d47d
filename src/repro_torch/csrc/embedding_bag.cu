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
// (every lookup's row would be ~18.3 GB). Repeated rows come from L2 at
// best, so the kernel sits between the two.
//
// Design: one warp per (bag, tile of 256 columns). Lane l owns 8
// neighbouring columns of the tile, so a warp reads a 1 KB fp32 (512 B
// bf16) row slice as 32 contiguous 16-byte-aligned chunks: two float4 loads
// a lane in fp32, one 16-byte load in bf16. The warp loads its bag's ids and
// mask itself, 32 at a time, one per lane, and walks the unmasked ones in
// order by ballot and shuffle, so the loads of a row are issued by all lanes
// at once and no lane reads an id another lane already read. Row offsets are
// 64-bit: at 50,000,000 x 256 a table has 1.28e10 elements, past 2^31.
// Rows whose width is not a multiple of 8 columns, or whose rows are not
// 16-byte aligned, take scalar loads with the same order of sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerLane = 8;
constexpr int kTile = 32 * kColsPerLane;  // columns a warp covers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
  for (int e = 0; e < 8; ++e) acc[e] += __bfloat162float(h[e]);
}

template <typename T, bool kVec>
__global__ void embedding_bag_kernel(
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
    const bool live = j < k && bag_mask[j] != 0;
    const int my_id = j < k ? bag_ids[j] : 0;
    unsigned todo = __ballot_sync(0xffffffffu, live);
    count += __popc(todo);
    while (todo) {  // unmasked positions in ascending order
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      long long r = (long long)__shfl_sync(0xffffffffu, my_id, src);
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
  T* orow = out + bag * (long long)d;
#pragma unroll
  for (int e = 0; e < kColsPerLane; ++e)
    if (c0 + e < d) orow[c0 + e] = from_f32<T>(mean ? acc[e] / denom : acc[e]);
}

template <typename T>
void launch(const void* table, const void* ids, const void* mask, void* out,
            int n_rows, int n_bags, int k, int d, int mean, cudaStream_t stream) {
  const int n_tiles = (d + kTile - 1) / kTile;
  const long long threads = (long long)n_bags * n_tiles * 32;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  // 16-byte loads need every row to start 16-byte aligned and hold whole
  // 8-column chunks
  const bool vec = d % kColsPerLane == 0 &&
                   ((uintptr_t)table % 16) == 0 &&
                   ((long long)d * (long long)sizeof(T)) % 16 == 0;
  if (vec)
    embedding_bag_kernel<T, true><<<(unsigned)grid, block, 0, stream>>>(
        (const T*)table, (const int32_t*)ids, (const uint8_t*)mask, (T*)out,
        n_rows, n_bags, k, d, n_tiles, mean);
  else
    embedding_bag_kernel<T, false><<<(unsigned)grid, block, 0, stream>>>(
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
