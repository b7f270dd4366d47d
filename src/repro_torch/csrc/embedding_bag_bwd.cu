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
// run on the host, which adds in the same order (below).
//
// What bounds it on this card: bytes. The dense gradient is written once
// (at the two-tower item table, 10M x 256 fp32, 10.24 GB: 3.06 ms at 3.35
// TB/s); g, the sorted positions and the row bounds are read once (tens of
// MB). There is one add per value of g read.
//
// Design: the entries are sorted by row beforehand, on the device, with
// torch.sort (prepare_rows in ops.py, as segment_spmm sorts its edges):
// order[] holds the flat positions b*K + j in a stable sort by clipped id,
// masked entries (key V) last. Then three launches:
//  0. the bounds pass (prepare_rows): one thread a sorted position writes,
//     where the key changes, the end of the run before and the start of the
//     run after into a zeroed [V, 2] table, so bounds[v] = (lo, hi) is row
//     v's run and a row no entry reads stays (0, 0). One pass over the keys
//     in place of a binary search of each of the V + 1 row offsets
//     (torch.searchsorted, 10x the time at the item table, PERF.md).
//     prepare_rows then cuts each run into chunks of `chunk` entries (128,
//     ref.py RUN_CHUNK, passed in by the wrapper) and lists those of the
//     runs longer than that in slots: slot_start[s] a chunk's first sorted
//     position, slot_row[s] its row (V for an idle slot), chunk_rank[p] the
//     chunks that start at or before position p.
//  1. the chunk pass: one warp per (slot, tile of 256 columns) sums the
//     scaled rows of its chunk, in sorted order, in fp32 from 0, into a
//     partial (an fp32 [slots, D] scratch, kept in the L2); idle slots exit.
//  2. the row pass: one warp per (group of 32 rows, tile) loads the group's
//     bounds at once, then for each row in turn sums a run of at most
//     `chunk` entries as the chunk pass would, or adds a longer run's
//     partials in chunk order from 0, and writes the row once: a row with no
//     entries writes zeros, so the kernel itself writes the whole dense
//     gradient and nothing else needs to clear it. (Most rows are empty: one
//     warp a row waited on that row's offsets for each 1 KB it wrote, and at
//     ~110 registers a thread too few warps were resident to hide that.)
// So a Zipf head id's run (~10^5 entries of a training batch) is summed by
// hundreds of warps at once, and its own warp adds a few hundred partials,
// where one warp once walked the whole run after the rest of the grid had
// finished (PERF.md). There are no atomics, so two calls are equal bit for
// bit, and no row is written twice. Lane l owns 8 neighbouring columns of
// the tile (16-byte loads and stores, as the forward kernel). A walk loads
// 32 positions at a time, one per lane, and goes through them in order by
// shuffle; it issues the loads of 8 rows (of g, or of partials) before
// adding them, in order, so a run keeps 8 row loads in flight and its adds
// are the only work between them. The output is written with streaming
// stores (st.global.cs): the kernel never reads it back, so it should not
// push g or the partials out of the L2.
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

// acc = the sum from 0, in order, of the g rows of sorted positions
// [lo, hi): 32 positions a step, the loads of 8 rows before their adds
template <bool kVec>
__device__ __forceinline__ void walk_run(float* acc, const float* __restrict__ g,
                                         const int32_t* __restrict__ order, int lo, int hi,
                                         int k, int d, int c0, int lane) {
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
}

// the chunk pass: one warp per (slot, tile), the partial of its chunk
template <bool kVec>
__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_chunks_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ order,
    const int32_t* __restrict__ bounds, const int32_t* __restrict__ slot_row,
    const int32_t* __restrict__ slot_start, float* __restrict__ partials, int n_rows,
    int n_slots, int k, int d, int n_tiles, int chunk) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n_slots * n_tiles) return;  // whole warps leave together
  const int s = (int)(warp / n_tiles);
  const int r = __ldg(slot_row + s);
  if (r >= n_rows) return;  // an idle slot, past the used ones
  const int c0 = (int)(warp % n_tiles) * kTile + lane * kColsPerLane;
  const int lo = __ldg(slot_start + s), hi = min(lo + chunk, __ldg(bounds + 2LL * r + 1));
  float acc[kColsPerLane];
  walk_run<kVec>(acc, g, order, lo, hi, k, d, c0, lane);
  float* prow = partials + (long long)s * d + c0;
  if (kVec) {
    if (c0 < d) {  // plain stores: the row pass reads them next, from the L2
      reinterpret_cast<float4*>(prow)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(prow)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e)
      if (c0 + e < d) prow[e] = acc[e];
  }
}

// each row's run from one pass over the sorted keys: at a position where the
// key changes, the run that ends there and the one that starts there;
// bounds was zeroed, so a row no entry reads stays (0, 0), an empty run.
// key [n]: clipped ids, n_rows where masked, sorted.
__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_bounds_kernel(
    const int32_t* __restrict__ key, int32_t* __restrict__ bounds, int n, int n_rows) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q > n) return;
  const int cur = q < n ? __ldg(key + q) : n_rows, prev = q > 0 ? __ldg(key + q - 1) : -1;
  if (cur == prev) return;
  if (cur < n_rows) bounds[2LL * cur] = (int32_t)q;  // row cur starts at q
  if (prev >= 0 && prev < n_rows) bounds[2LL * prev + 1] = (int32_t)q;  // row prev ends
}

// the row pass: one warp per (group of 32 rows, tile), each row's run or
// its partials in order, the rows one after another
template <typename T, bool kVec>
__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_rows_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ order,
    const int32_t* __restrict__ bounds, const int32_t* __restrict__ chunk_rank,
    const float* __restrict__ partials, T* __restrict__ out, long long n_rows, int k, int d,
    int n_tiles, int chunk) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_groups = (n_rows + 31) / 32;
  if (warp >= n_groups * n_tiles) return;  // whole warps leave together
  const long long r0 = warp / n_tiles * 32;
  const int c0 = (int)(warp % n_tiles) * kTile + lane * kColsPerLane;
  const int rows = (int)min(32LL, n_rows - r0);
  // the group's bounds in one load: lane l holds row r0 + l's
  const int2 my = lane < rows ? __ldg(reinterpret_cast<const int2*>(bounds) + r0 + lane)
                              : make_int2(0, 0);

  for (int i = 0; i < rows; ++i) {
    const int lo = __shfl_sync(kAll, my.x, i), hi = __shfl_sync(kAll, my.y, i);
    float acc[kColsPerLane];
    if (hi - lo <= chunk) {
      walk_run<kVec>(acc, g, order, lo, hi, k, d, c0, lane);  // zeros for an empty run
    } else {  // the partials of slots first .. first + n - 1, added in order
      const long long first = __ldg(chunk_rank + lo) - 1;
      const int n = (hi - lo + chunk - 1) / chunk;
#pragma unroll
      for (int e = 0; e < kColsPerLane; ++e) acc[e] = 0.f;
      for (int j = 0; j < n; j += kInFlight) {
        float v[kInFlight][kColsPerLane];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q)
          row8<kVec>(v[q], partials, first + (j + q < n ? j + q : j), d, c0);
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (j + q < n) {
#pragma unroll
            for (int e = 0; e < kColsPerLane; ++e) acc[e] += v[q][e];
          }
        }
      }
    }
    T* orow = out + (r0 + i) * (long long)d + c0;
    if (kVec) {
      if (c0 < d) store8(orow, acc);  // d % 8 == 0: all 8 columns, or none
    } else {
#pragma unroll
      for (int e = 0; e < kColsPerLane; ++e)
        if (c0 + e < d) orow[e] = from_f32<T>(acc[e]);
    }
  }
}

long long blocks_for(long long warps) { return (warps * 32 + kBlock - 1) / kBlock; }

template <typename T>
void launch(const void* g, const void* order, const void* bounds, const void* chunk_rank,
            const void* slot_row, const void* slot_start, void* partials, void* out, int n_rows,
            int n_slots, int k, int d, int chunk, cudaStream_t stream) {
  const int n_tiles = (d + kTile - 1) / kTile;
  // 16-byte loads and stores need every row to start 16-byte aligned and
  // hold whole 8-column chunks
  const bool vec = d % kColsPerLane == 0 && ((uintptr_t)g % 16) == 0 &&
                   ((uintptr_t)partials % 16) == 0 && ((uintptr_t)out % 16) == 0 &&
                   ((long long)d * (long long)sizeof(T)) % 16 == 0;
  if (n_slots > 0) {
    auto chunks = vec ? embedding_bag_bwd_chunks_kernel<true>
                      : embedding_bag_bwd_chunks_kernel<false>;
    chunks<<<(unsigned)blocks_for((long long)n_slots * n_tiles), kBlock, 0, stream>>>(
        (const float*)g, (const int32_t*)order, (const int32_t*)bounds,
        (const int32_t*)slot_row, (const int32_t*)slot_start, (float*)partials, n_rows, n_slots,
        k, d, n_tiles, chunk);
  }
  auto rows = vec ? embedding_bag_bwd_rows_kernel<T, true> : embedding_bag_bwd_rows_kernel<T, false>;
  rows<<<(unsigned)blocks_for((n_rows + 31LL) / 32 * n_tiles), kBlock, 0, stream>>>(
      (const float*)g, (const int32_t*)order, (const int32_t*)bounds,
      (const int32_t*)chunk_rank, (const float*)partials, (T*)out, n_rows, k, d, n_tiles, chunk);
}

}  // namespace

// key int32 [n] (sorted clipped ids, n_rows where masked); bounds int32
// [n_rows, 2], zeroed by the caller. Returns cudaGetLastError().
extern "C" int embedding_bag_bwd_bounds_launch(const void* key, void* bounds, int n, int n_rows,
                                               void* stream) {
  if (n <= 0 || n_rows <= 0) return 0;
  embedding_bag_bwd_bounds_kernel<<<(unsigned)(((long long)n + kBlock) / kBlock), kBlock, 0,
                                    (cudaStream_t)stream>>>((const int32_t*)key,
                                                            (int32_t*)bounds, n, n_rows);
  return (int)cudaGetLastError();
}

// g fp32 [B, d] (dout scaled by its bag's denominator); order int32
// [B * k] (flat positions sorted by row); bounds int32 [n_rows, 2] (each
// row's run [lo, hi) in order, (0, 0) where empty); chunk_rank int32
// [B * k], slot_row and slot_start int32 [n_slots] (the chunk table, ops.py
// RowPlan); partials fp32 [n_slots, d] scratch; out [n_rows, d], fp32
// (is_bf16 0) or bf16 (1). Launches the chunk pass (when there are slots)
// and the row pass; returns cudaGetLastError().
extern "C" int embedding_bag_bwd_launch(
    const void* g, const void* order, const void* bounds, const void* chunk_rank,
    const void* slot_row, const void* slot_start, void* partials, void* out, int n_rows,
    int n_slots, int k, int d, int chunk, int is_bf16, void* stream) {
  if (n_rows <= 0 || d <= 0 || chunk <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>(g, order, bounds, chunk_rank, slot_row, slot_start, partials, out,
                          n_rows, n_slots, k, d, chunk, s);
  else
    launch<float>(g, order, bounds, chunk_rank, slot_row, slot_start, partials, out, n_rows,
                  n_slots, k, d, chunk, s);
  return (int)cudaGetLastError();
}
