// Flash attention forward (online softmax, causal and sliding window, GQA),
// hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _attn_kernel), in the layout of
// repro.lm.attention.flash_attention: q [B, Sq, H, dh], k and v
// [B, Sk, KV, dh], out [B, Sq, H, dh], all contiguous, fp32 or bf16. Query
// head h reads KV head h / (H / KV) (a repeat of each KV head over its G
// query heads, as the reference's reshape to [B, S, KV, G, dh]). Query row
// i sits at position q_offset + i; key j is allowed where j <= that
// position (causal) and j > position - window (window > 0). Held to
// repro_torch/kernels/flash_attention/ref.py.
//
// Numerics, as the reference: q * dh^-0.5 is rounded to the input type
// before the product; scores, the running max and sum and the accumulator
// are fp32; disallowed scores are -1e30 (not -inf), and the probabilities
// are rounded to the input type before the product with v; the output is
// acc / max(l, 1e-30) in q's type. Keys past Sk (the ragged last tile) are
// left out entirely (probability 0).
//
// Tile skipping and fully masked rows: a CTA walks only the key range
// [lo, hi) that can hold an allowed key of one of its rows. A skipped key
// would only add -1e30 scores, which give such a row exactly nothing: once
// a row has seen an allowed score its correction factor wipes what came
// before. A row with no allowed key at all gets, in the reference, the mean
// of v over all Sk keys (every score is -1e30, so every exp is 1). Such
// rows lie only at the start (position < 0) or the end (position >= Sk +
// window - 1) of the query range, so the CTA checks its first and last row;
// if either has no allowed key it walks all Sk keys and those rows get that
// same mean.
//
// What bounds it on this card: operations. One Yi-6B layer at B 8, S 4,000
// does ~1.05e12 FLOPs of allowed scores (QK^T and PV), ~1.06 ms at the bf16
// tensor-core peak, against ~0.59 GB of q, k, v and out, ~0.18 ms at
// 3.35 TB/s. This first kernel does not reach the tensor cores: it runs
// fp32 FMAs (67 TFLOP/s peak), so it sits far above that bound.
//
// Design: one CTA of 256 threads per (64 query rows, query head, batch).
// The scaled q tile and each 64-key k / v tile are staged through shared
// memory in fp32 (dynamic shared memory, up to 209 KB at dh 256); thread
// (ty, tx) of the 16 x 16 grid owns query rows ty + 16 i (i < 4) and, for
// the scores, keys tx + 16 j (j < 4), for the output, columns tx + 16 c
// (c < DHP / 16). Row max and sum are reduced over the 16 threads of a row
// by shuffles within the half-warp; the row's m, l and accumulator stay in
// fp32 registers. Head dims up to 256 are padded with zeros to the next of
// 16, 32, 64, 128, 256 (DHP). Making it fast (mma / wgmma, TMA staging) is
// a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 64;     // query rows per CTA
constexpr int kKeys = 64;     // keys per tile
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ int band_lo(int pos, int window) {
  return window > 0 ? max(0, pos - window + 1) : 0;
}
__device__ __forceinline__ int band_hi(int pos, int sk, int causal) {
  return causal ? min(sk, pos + 1) : sk;
}

template <int DHP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kRows * (DHP + 1) + kKeys * DHP + kRows * (kKeys + 1));
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int n_heads, int n_kv, int dh,
    int causal, int window, int q_offset, float scale) {
  constexpr int LD = DHP + 1;  // row stride of Qs and Ks: keys land in distinct banks
  constexpr int NC = DHP / 16;  // output columns a thread owns per row
  extern __shared__ float smem[];
  float* Qs = smem;              // [kRows][LD]
  float* Ks = Qs + kRows * LD;   // [kKeys][LD]
  float* Vs = Ks + kKeys * LD;   // [kKeys][DHP]
  float* Ps = Vs + kKeys * DHP;  // [kRows][kKeys + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (n_heads / n_kv);
  const long long q_stride = (long long)n_heads * dh, kv_stride = (long long)n_kv * dh;
  const T* qb = q + (long long)b * sq * q_stride + (long long)head * dh;
  const T* kb = k + (long long)b * sk * kv_stride + (long long)kvh * dh;
  const T* vb = v + (long long)b * sk * kv_stride + (long long)kvh * dh;

  for (int idx = tid; idx < kRows * DHP; idx += kThreads) {
    const int r = idx / DHP, c = idx % DHP;
    float x = 0.f;
    if (q0 + r < sq && c < dh) x = round_to<T>(to_f32(qb[(q0 + r) * q_stride + c]) * scale);
    Qs[r * LD + c] = x;
  }

  // the key range that can hold an allowed key of this CTA's rows
  const int pf = q_offset + q0, pl = q_offset + min(q0 + kRows, sq) - 1;
  int lo = band_lo(pf, window), hi = band_hi(pl, sk, causal);
  if (band_lo(pf, window) >= band_hi(pf, sk, causal) ||
      band_lo(pl, window) >= band_hi(pl, sk, causal)) {
    lo = 0;  // a row without any allowed key: walk every key
    hi = sk;
  }

  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int kt = lo; kt < hi; kt += kKeys) {
    __syncthreads();  // the last tile's readers are done (and Qs is written)
    for (int idx = tid; idx < kKeys * DHP; idx += kThreads) {
      const int r = idx / DHP, c = idx % DHP, key = kt + r;
      const bool in = key < sk && c < dh;
      Ks[r * LD + c] = in ? to_f32(kb[key * kv_stride + c]) : 0.f;
      Vs[r * DHP + c] = in ? to_f32(vb[key * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt + tx + 16 * j;
        const bool ok = (!causal || key <= pos) && (window <= 0 || key > pos - window);
        s[i][j] = key >= sk ? -INFINITY : (ok ? s[i][j] : kMasked);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (kKeys + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float x = Vs[kk * DHP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], x, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((long long)b * sq + row) * q_stride + (long long)head * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) orow[col] = from_f32<T>(o[i][c] / denom);
    }
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
           int h, int kv, int dh, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, DHP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_attention_kernel<T, DHP><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, h, kv, dh, causal, window,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
             int h, int kv, int dh, int causal, int window, int q_offset, float scale,
             cudaStream_t s) {
  if (dh <= 16) return launch<T, 16>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  if (dh <= 32) return launch<T, 32>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  if (dh <= 64) return launch<T, 64>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  if (dh <= 128) return launch<T, 128>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  return launch<T, 256>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
}

}  // namespace

// q [b, sq, h, dh]; k, v [b, sk, kv, dh]; out [b, sq, h, dh]; dh <= 256.
// window <= 0: none. scale_bits: the fp32 bits of the softmax scale.
// is_bf16: 0 for fp32 tensors, 1 for bf16. Returns a cudaError_t code.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    int b, int sq, int sk, int h, int kv, int dh, int causal, int window, int q_offset,
    int scale_bits, int is_bf16, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || dh <= 0) return 0;
  if (kv <= 0 || h % kv != 0 || dh > 256) return (int)cudaErrorInvalidValue;
  float scale;
  memcpy(&scale, &scale_bits, sizeof scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  return dispatch<float>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
}
