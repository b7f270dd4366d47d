// Segment-sum SpMM (GNN message passing), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_spmm/kernel.py
// (segment_spmm_pallas, body _spmm_kernel). Computes
//   out[v, :] = sum over e in [offs[v], offs[v+1]) of x[src[e], :]
// over edges sorted by destination (a CSR by dst, built by the wrapper in
// repro_torch/kernels/segment_spmm/ops.py), for every row v < n_rows. Rows
// with no edge are written as zeros. Edges past offs[n_rows] (masked edges
// and out-of-range destinations, which the wrapper sorts there) are never
// read. Held to repro_torch/kernels/segment_spmm/ref.py within fp32
// rounding: the sums run in another order than index_add_'s.
//
// What bounds it on this card: bytes. Each kept edge reads one row of x
// (D values) and its source index; each output row is written once. At the
// PNA minibatch_lg shape (x [168,960, 75] fp32, N 169,984) that is ~104 MB,
// ~31 us at 3.35 TB/s; there is one add per value read, far below the
// card's arithmetic rate.
//
// Design: one warp per (output row, tile of 32*K columns). Lane j holds
// columns j, j+32, ..., j+32*(K-1) of the tile in fp32 registers and walks
// the row's edges in sorted order, so neighbouring lanes read neighbouring
// addresses of each source row and the sum order is fixed: the result is
// bit-stable from run to run. The TPU kernel's one-hot MXU matmul and its
// cap of block_e*max_chunks edges per tile are not carried over: the warp
// loops over however many edges its row has. Inputs fp32 or bf16; the sum
// is fp32 and is rounded once to the output type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int K>
__global__ void segment_spmm_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ src,
    const int32_t* __restrict__ offs, T* __restrict__ out,
    int n_rows, int d, int n_tiles) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n_rows * n_tiles) return;
  const int row = (int)(warp / n_tiles);
  const int c0 = (int)(warp % n_tiles) * 32 * K + lane;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int lo = offs[row], hi = offs[row + 1];
  for (int e = lo; e < hi; ++e) {
    const T* xr = x + (long long)src[e] * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + 32 * k;
      if (c < d) acc[k] += to_f32(xr[c]);
    }
  }
  T* orow = out + (long long)row * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + 32 * k;
    if (c < d) orow[c] = from_f32<T>(acc[k]);
  }
}

template <typename T, int K>
static void launch(const void* x, const void* src, const void* offs, void* out,
                   int n_rows, int d, cudaStream_t stream) {
  const int n_tiles = (d + 32 * K - 1) / (32 * K);
  const long long threads = (long long)n_rows * n_tiles * 32;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  segment_spmm_kernel<T, K><<<(unsigned)grid, block, 0, stream>>>(
      (const T*)x, (const int32_t*)src, (const int32_t*)offs, (T*)out, n_rows, d, n_tiles);
}

template <typename T>
static void dispatch(const void* x, const void* src, const void* offs, void* out,
                     int n_rows, int d, cudaStream_t stream) {
  // columns a lane keeps in registers: enough for one tile up to D = 128
  if (d <= 32) launch<T, 1>(x, src, offs, out, n_rows, d, stream);
  else if (d <= 64) launch<T, 2>(x, src, offs, out, n_rows, d, stream);
  else if (d <= 96) launch<T, 3>(x, src, offs, out, n_rows, d, stream);
  else launch<T, 4>(x, src, offs, out, n_rows, d, stream);
}

// is_bf16: 0 for fp32 x/out, 1 for bf16. Returns cudaGetLastError().
extern "C" int segment_spmm_launch(
    const void* x, const void* src, const void* offs, void* out,
    int n_rows, int d, int is_bf16, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) dispatch<__nv_bfloat16>(x, src, offs, out, n_rows, d, s);
  else dispatch<float>(x, src, offs, out, n_rows, d, s);
  return (int)cudaGetLastError();
}
