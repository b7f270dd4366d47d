// Flash attention backward (causal and sliding window, GQA, q_offset),
// hand-written for Hopper as two SIMT kernels, for bf16 and fp32 inputs.
//
// Replaces no TPU kernel: the JAX package trains by differentiating the
// plain-JAX repro.lm.attention.flash_attention, and its Pallas kernel
// (repro/kernels/flash_attention/kernel.py) has no backward. The port's
// forward runs the hand-written csrc/flash_attention.cu on the card, so
// training there needs this gradient. Held to
// repro_torch/kernels/flash_attention/ref.py (flash_attention_bwd_ref).
//
// Layout of the forward: q, dq, o, do [B, Sq, H, dh]; k, v, dk, dv
// [B, Sk, KV, dh]; lse and delta [B, H, Sq] fp32. Query head h reads KV
// head h / G, G = H / KV; query row i sits at position q_offset + i; key j
// is allowed where j < Sk, j <= position (causal) and j > position -
// window (window > 0).
//
// The math. With qs = q * scale rounded to the input type (the forward's
// rounding point), s = qs . k, the forward's lse (natural-log units of s),
// p = exp(s - lse) on allowed keys and 0 elsewhere, D = rowsum(do * o):
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - D),
//   dk = ds^T qs,  dq = scale * ds k.
// A row with no allowed key (lse <= -5e29: the forward gave it the mean of
// v over all Sk keys) has p = 1 / Sk on every key and ds = 0, as the
// reference's gradient through its -1e30 scores is. Accumulation is fp32;
// dq, dk and dv are written in the input type.
//
// Design: the simple one, no atomics, so a step is deterministic.
// - flash_attention_bwd_dq_kernel, one CTA of 256 threads per (BT query
//   rows, query head, batch): stages its rows of qs and do in shared
//   memory, computes D for them (writes delta), then walks the key tiles of
//   its band (the forward's key range) and accumulates dq for its rows in
//   registers.
// - flash_attention_bwd_dkdv_kernel, one CTA per (BT keys, KV head,
//   batch), launched after the first (it reads delta): stages its k and v
//   rows once, then walks its G query heads and, for each, the query
//   tiles whose band reaches its keys, recomputing p and ds, and
//   accumulates dk and dv for its keys in registers.
// Every tile is staged through shared memory in fp32 (rows padded to dh + 1
// floats, so the threads of a half-warp read distinct banks). Thread (ty,
// tx) of the 16 x 16 grid owns, for a BT x BT tile of s and dp, rows ty +
// 16 i and keys tx + 16 j; for a BT x DHP accumulator, rows ty + 16 i and
// columns tx + 16 c. BT is 64 up to a head dim of 128 and 32 at 256, so
// that each accumulator is 32 floats a thread; DHP pads dh to 16, 32, 64,
// 128 or 256 with zeros.
//
// What bounds it on this card: operations. A Gemma3-4B global layer (B 1,
// S 4,096, H 8, dh 256, causal) needs 5 products over the allowed half of
// the scores, ~1.7e11 FLOPs: 0.17 ms at the bf16 tensor-core peak, against
// ~0.1 GB of inputs and outputs (0.03 ms at 3.35 TB/s). This SIMT design
// recomputes s and dp in both kernels (7 products) on the fp32 cores and is
// bound by their shared-memory reads (about one load a multiply-add for s
// and dp); moving the products to wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kEmptyLse = 0.5f * kMasked;  // at or below: the row had no allowed key
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to T and back: the forward's rounding of q * scale
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int band_lo(int pos, int window) {
  return window > 0 ? max(0, pos - window + 1) : 0;
}
__device__ __forceinline__ int band_hi(int pos, int sk, int causal) {
  return causal ? min(sk, pos + 1) : sk;
}
// The forward's key range for rows at positions [pf, pl]: every key when
// its first or last row has no allowed key (such rows lie only at the
// start or the end of the query range).
__device__ __forceinline__ int2 key_range(int pf, int pl, int sk, int causal, int window) {
  if (band_lo(pf, window) >= band_hi(pf, sk, causal) ||
      band_lo(pl, window) >= band_hi(pl, sk, causal))
    return make_int2(0, sk);
  return make_int2(band_lo(pf, window), band_hi(pl, sk, causal));
}
__device__ __forceinline__ bool allowed(int key, int pos, int sk, int causal, int window) {
  return key < sk && (!causal || key <= pos) && (window <= 0 || key > pos - window);
}

template <int DHP>
struct Bwd {
  static constexpr int BT = DHP >= 256 ? 32 : 64;  // rows (and keys) of a tile
  static constexpr int LD = DHP + 1;               // row stride of a staged tile
  static constexpr int NR = BT / 16;               // tile rows (keys) a thread owns
  static constexpr int NC = DHP / 16;              // accumulator columns a thread owns
  // four staged [BT][LD] tiles, two [BT][BT + 1] ones, lse and delta
  static constexpr size_t SMEM = sizeof(float) * (4 * BT * LD + 2 * BT * (BT + 1) + 2 * BT);
};

// rows [r0, r0 + BT) of a [rows, heads, dh] sequence (head ``head``) into
// dst [BT][LD] as fp32 times ``mul`` (rounded to T when ``round``); zeros
// past ``rows`` and dh
template <int DHP, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, int r0, int rows, long long stride,
                                      int dh, float mul, bool round) {
  using C = Bwd<DHP>;
  for (int idx = threadIdx.x; idx < C::BT * DHP; idx += kThreads) {
    const int r = idx / DHP, c = idx % DHP;
    float x = 0.f;
    if (r0 + r < rows && c < dh) {
      x = load(base + (long long)(r0 + r) * stride + c) * mul;
      if (round) x = round_as(x, base);
    }
    dst[r * C::LD + c] = x;
  }
}

// s[i][j] = a[row i] . b[key j] over DHP, for rows ty + 16 i, keys tx + 16 j
template <int DHP>
__device__ __forceinline__ void tile_dot(float (&s)[Bwd<DHP>::NR][Bwd<DHP>::NR], const float* a,
                                         const float* b, int ty, int tx) {
  using C = Bwd<DHP>;
#pragma unroll
  for (int i = 0; i < C::NR; ++i)
#pragma unroll
    for (int j = 0; j < C::NR; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DHP; ++d) {
    float av[C::NR], bv[C::NR];
#pragma unroll
    for (int i = 0; i < C::NR; ++i) av[i] = a[(ty + 16 * i) * C::LD + d];
#pragma unroll
    for (int j = 0; j < C::NR; ++j) bv[j] = b[(tx + 16 * j) * C::LD + d];
#pragma unroll
    for (int i = 0; i < C::NR; ++i)
#pragma unroll
      for (int j = 0; j < C::NR; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// p and ds of one score: ``l`` the row's lse (+inf for a row past Sq),
// ``dd`` its delta
__device__ __forceinline__ void prob(float s, float dp, float l, float dd, int key, int pos,
                                     int sk, int causal, int window, float inv_sk, float& p,
                                     float& ds) {
  if (l <= kEmptyLse) {
    p = key < sk ? inv_sk : 0.f;
    ds = 0.f;
  } else if (allowed(key, pos, sk, causal, window)) {
    p = expf(s - l);
    ds = p * (dp - dd);
  } else {
    p = 0.f;
    ds = 0.f;
  }
}

template <int DHP, typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ delta, int sq, int sk, int n_heads, int n_kv, int dh,
    int causal, int window, int q_offset, float scale) {
  using C = Bwd<DHP>;
  constexpr int BT = C::BT, LD = C::LD, NR = C::NR, NC = C::NC;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BT][LD] q * scale, rounded
  float* Os = Qs + BT * LD;       // [BT][LD] do
  float* Ks = Os + BT * LD;       // [BT][LD]
  float* Vs = Ks + BT * LD;       // [BT][LD]
  float* dSs = Vs + BT * LD;      // [BT][BT + 1]
  float* Ls = dSs + 2 * BT * (BT + 1);  // [BT] lse
  float* Ds = Ls + BT;                  // [BT] delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BT, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (n_heads / n_kv);
  const long long q_stride = (long long)n_heads * dh, kv_stride = (long long)n_kv * dh;
  const long long q_off = (long long)b * sq * q_stride + (long long)head * dh;
  const long long kv_off = (long long)b * sk * kv_stride + (long long)kvh * dh;
  const long long row_off = ((long long)b * n_heads + head) * sq;

  stage<DHP>(Qs, q + q_off, q0, sq, q_stride, dh, scale, true);
  stage<DHP>(Os, dout + q_off, q0, sq, q_stride, dh, 1.f, false);
  // delta = rowsum(do * o), a warp a row
  for (int r = warp; r < BT; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sq)
      for (int c = lane; c < dh; c += 32)
        acc += load(dout + q_off + row * q_stride + c) * load(o + q_off + row * q_stride + c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      Ds[r] = acc;
      Ls[r] = row < sq ? lse[row_off + row] : INFINITY;
      if (row < sq) delta[row_off + row] = acc;
    }
  }

  const int2 range = key_range(q_offset + q0, q_offset + min(q0 + BT, sq) - 1, sk, causal, window);
  const float inv_sk = 1.f / (float)max(sk, 1);
  float acc[NR][NC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = range.x; kt < range.y; kt += BT) {
    __syncthreads();  // the last tile's readers are done (and the rows are staged)
    stage<DHP>(Ks, k + kv_off, kt, sk, kv_stride, dh, 1.f, false);
    stage<DHP>(Vs, v + kv_off, kt, sk, kv_stride, dh, 1.f, false);
    __syncthreads();
    float s[NR][NR], dp[NR][NR];
    tile_dot<DHP>(s, Qs, Ks, ty, tx);
    tile_dot<DHP>(dp, Os, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = ty + 16 * i, pos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        float p, ds;
        prob(s[i][j], dp[i][j], Ls[r], Ds[r], kt + tx + 16 * j, pos, sk, causal, window, inv_sk,
             p, ds);
        dSs[r * (BT + 1) + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BT; ++n) {
      float dsv[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) dsv[i] = dSs[(ty + 16 * i) * (BT + 1) + n];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Ks[n * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* drow = dq + q_off + row * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(drow + col, acc[i][c] * scale);
    }
  }
}

template <int DHP, typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int n_heads, int n_kv, int dh,
    int causal, int window, int q_offset, float scale) {
  using C = Bwd<DHP>;
  constexpr int BT = C::BT, LD = C::LD, NR = C::NR, NC = C::NC;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BT][LD] this CTA's keys
  float* Vs = Ks + BT * LD;       // [BT][LD]
  float* Qs = Vs + BT * LD;       // [BT][LD] a query tile's q * scale, rounded
  float* Os = Qs + BT * LD;       // [BT][LD] its do
  float* Ps = Os + BT * LD;       // [BT][BT + 1] p, [query row][key]
  float* dSs = Ps + BT * (BT + 1);  // [BT][BT + 1] ds
  float* Ls = dSs + BT * (BT + 1);  // [BT]
  float* Ds = Ls + BT;              // [BT]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = n_heads / n_kv;
  const long long q_stride = (long long)n_heads * dh, kv_stride = (long long)n_kv * dh;
  const long long kv_off = (long long)b * sk * kv_stride + (long long)kvh * dh;
  const float inv_sk = 1.f / (float)max(sk, 1);

  stage<DHP>(Ks, k + kv_off, k0, sk, kv_stride, dh, 1.f, false);
  stage<DHP>(Vs, v + kv_off, k0, sk, kv_stride, dh, 1.f, false);

  float dka[NR][NC], dva[NR][NC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_qt = (sq + BT - 1) / BT;
  for (int g = 0; g < G; ++g) {
    const int head = kvh * G + g;
    const long long q_off = (long long)b * sq * q_stride + (long long)head * dh;
    const long long row_off = ((long long)b * n_heads + head) * sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      const int2 range =
          key_range(q_offset + q0, q_offset + min(q0 + BT, sq) - 1, sk, causal, window);
      if (range.x >= k0 + BT || range.y <= k0) continue;  // no row of the tile reaches a key here
      __syncthreads();  // the last tile's readers are done (and K, V are staged)
      stage<DHP>(Qs, q + q_off, q0, sq, q_stride, dh, scale, true);
      stage<DHP>(Os, dout + q_off, q0, sq, q_stride, dh, 1.f, false);
      for (int r = tid; r < BT; r += kThreads) {
        const int row = q0 + r;
        Ls[r] = row < sq ? lse[row_off + row] : INFINITY;
        Ds[r] = row < sq ? delta[row_off + row] : 0.f;
      }
      __syncthreads();
      float s[NR][NR], dp[NR][NR];
      tile_dot<DHP>(s, Qs, Ks, ty, tx);
      tile_dot<DHP>(dp, Os, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = ty + 16 * i, pos = q_offset + q0 + r;
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          float p, ds;
          prob(s[i][j], dp[i][j], Ls[r], Ds[r], k0 + tx + 16 * j, pos, sk, causal, window,
               inv_sk, p, ds);
          Ps[r * (BT + 1) + tx + 16 * j] = p;
          dSs[r * (BT + 1) + tx + 16 * j] = ds;
        }
      }
      __syncthreads();
      // dv[key] += sum over rows of p[row][key] do[row]; dk likewise with ds and qs
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pv[NR], dsv[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          pv[i] = Ps[r * (BT + 1) + ty + 16 * i];
          dsv[i] = dSs[r * (BT + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = Os[r * LD + tx + 16 * c], qv = Qs[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            dva[i][c] = fmaf(pv[i], ov, dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv, dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    T* krow = dk + kv_off + key * kv_stride;
    T* vrow = dv + kv_off + key * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) {
        store(krow + col, dka[i][c]);
        store(vrow + col, dva[i][c]);
      }
    }
  }
}

template <int DHP, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq, int sk,
           int h, int kv, int dh, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  using C = Bwd<DHP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<DHP, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<DHP, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid_q((sq + C::BT - 1) / C::BT, h, b);
  flash_attention_bwd_dq_kernel<DHP, T><<<grid_q, kThreads, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, (T*)dq, delta, sq,
      sk, h, kv, dh, causal, window, q_offset, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || sk <= 0) return (int)e;
  const dim3 grid_k((sk + C::BT - 1) / C::BT, kv, b);
  flash_attention_bwd_dkdv_kernel<DHP, T><<<grid_k, kThreads, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, sq, sk,
      h, kv, dh, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq, int sk,
             int h, int kv, int dh, int causal, int window, int q_offset, float scale,
             cudaStream_t s) {
#define FA_BWD(DHP) \
  launch<DHP, T>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kv, dh, causal, window, \
                 q_offset, scale, s)
  if (dh <= 16) return FA_BWD(16);
  if (dh <= 32) return FA_BWD(32);
  if (dh <= 64) return FA_BWD(64);
  if (dh <= 128) return FA_BWD(128);
  return FA_BWD(256);
#undef FA_BWD
}

}  // namespace

// q, o, dout, dq [b, sq, h, dh]; k, v, dk, dv [b, sk, kv, dh]; lse (the
// forward's) and delta (scratch, written here) [b, h, sq] fp32; dh <= 256.
// window <= 0: none. scale_bits: the fp32 bits of the softmax scale.
// is_bf16: 1 for bf16 tensors, 0 for fp32. Launches the dq kernel, then
// the dk / dv kernel, on ``stream``. Returns a cudaError_t code.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* dq, void* dk, void* dv, void* delta,
    int b, int sq, int sk, int h, int kv, int dh, int causal, int window, int q_offset,
    int scale_bits, int is_bf16, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || dh <= 0) return 0;
  if (kv <= 0 || h % kv != 0 || dh > 256) return (int)cudaErrorInvalidValue;
  float scale;
  memcpy(&scale, &scale_bits, sizeof scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse, dq, dk, dv,
                                   (float*)delta, b, sq, sk, h, kv, dh, causal, window, q_offset,
                                   scale, s);
  return dispatch<float>(q, k, v, o, dout, (const float*)lse, dq, dk, dv, (float*)delta, b, sq,
                         sk, h, kv, dh, causal, window, q_offset, scale, s);
}
