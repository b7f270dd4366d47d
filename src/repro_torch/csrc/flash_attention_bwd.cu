// Flash attention backward (causal and sliding window, GQA, q_offset),
// hand-written for Hopper: bf16 tensor-core kernels (wgmma + TMA) and fp32
// SIMT kernels, chosen by the tensors' type. Each route is two kernels,
// launched in order: a dq kernel, then a dk / dv kernel.
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
// dq, dk and dv are written in the input type. The bf16 kernels round p and
// ds to bf16 before their products (the fp32 kernels keep them in fp32).
//
// Both routes are free of atomics, so a backward call repeats bit for bit:
// the dq kernel owns a tile of query rows and accumulates their dq (and
// writes D for the dk / dv kernel); the dk / dv kernel owns a tile of keys
// and one KV head and accumulates their dk and dv over the G query heads
// of its group. The price is 7 products instead of 5: both recompute s and
// dp.
//
// What bounds it on this card: operations. A Gemma3-4B global layer (B 1,
// S 4,096, H 8, KV 4, dh 256, causal) needs 5 products over the allowed
// half of the scores, ~1.7e11 FLOPs: 0.17 ms at the bf16 tensor-core peak
// (989 TFLOP/s), against ~0.1 GB of inputs and outputs (0.03 ms at 3.35
// TB/s). So the products run on the tensor cores, the loads stay off the
// threads that run them, and each operand tile is read from shared memory
// by wgmma, never by the threads.
//
// bf16 design (sm_90a), the forward's (csrc/flash_attention.cu; the PTX
// wrappers and tensor maps are csrc/hopper.cuh). A producer warpgroup
// (its registers given to the consumers by setmaxnreg) loads 64-row tiles
// by TMA into a ring of two stages, with full and empty mbarriers; the 4-d
// tensor maps over [B, S, heads, dh] read 64-column boxes in the 128-byte
// swizzle and zero-fill rows past Sq, keys past Sk and columns past dh up
// to DHP (64, 128 or 256). Every product is a wgmma: S and dP with both
// operands K-major in shared memory (m64n64k16), dQ, dV and dK with A (ds,
// p^T or ds^T rounded to bf16 straight from the accumulators) in registers
// and B read MN-major (m64nDHPk16). The longest walks start first: the
// grids put the row (or key) tiles slowest and the heads fastest.
// - flash_attention_bwd_dq_tc_kernel, one CTA per (64 NWG query rows, query
//   head, batch), the last rows (under a causal mask the longest bands)
//   first. Each consumer warpgroup keeps its 64 rows of q, do and o
//   resident, computes D from do and o there and writes delta, scales q in
//   place (bf16(q * scale), then a proxy fence for wgmma's reads); then, for
//   each 64-key tile of the forward's key range: S = qs K^T and dP = do
//   V^T, the band mask only on a tile that crosses the band edge or Sk, ds
//   = p (dp - D), and dQ += dS K. NWG is 2 up to DHP 128; 1 at DHP 256,
//   where dQ alone is 128 fp32 registers a thread (plus 32 each for S and
//   dP) and shared memory holds q, do and o (96 KB) and two stages of k and
//   v (128 KB).
// - flash_attention_bwd_dkdv_tc_kernel, one CTA of 384 threads per (64
//   keys, KV head, batch), k and v resident, the first keys (the longest
//   causal walks) first. Its items are (query head of the group, query
//   tile) for the tiles whose rows' key range reaches its keys (qtile_walk:
//   up to three runs, computed directly, so that producer and consumers
//   take one list), the last tiles first, so that the CTAs running together
//   read the same q and do tiles from L2. Producer warp 0 starts the loads
//   and stages each item's lse and delta in shared memory; warps 1-3 scale
//   each q tile in place. Consumer 0 forms S^T = K qs^T and p^T (branch-free,
//   so that its exponentials overlap), passes p^T to consumer 1 through
//   shared memory (fp32, in the accumulator layout; negated on a row with no
//   allowed key) and accumulates dV += P^T do; consumer 1 forms dP^T = V
//   do^T, then ds^T = p^T (dP^T - D), and accumulates dK += dS^T qs. Each
//   holds one 64 x DHP accumulator: both in one warpgroup would be 256
//   registers a thread at DHP 256. Shared memory at DHP 256: k and v 64
//   KB, two stages of q and do 128 KB, p^T 16 KB.
//
// fp32 design (SIMT; tensor cores would be TF32, which cannot hold the
// fp32 path to 1e-4 of its largest value). The dq kernel, one CTA of 256
// threads per (BT query rows, query head, batch), stages its rows of qs and
// do in shared memory, computes D, then walks the key tiles of its band;
// the dk / dv kernel, one CTA per (BT keys, KV head, batch), stages k and v
// once and walks its G heads' query tiles that reach its keys. Every tile
// is staged in fp32 (rows padded to dh + 1 floats, so the threads of a
// half-warp read distinct banks); thread (ty, tx) of the 16 x 16 grid owns
// rows ty + 16 i and keys tx + 16 j of a BT x BT tile of s and dp, rows ty
// + 16 i and columns tx + 16 c of a BT x DHP accumulator. BT is 64 up to a
// head dim of 128 and 32 at 256, so that each accumulator is 32 floats a
// thread; DHP pads dh to 16, 32, 64, 128 or 256 with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kMasked = -1e30f;
constexpr float kEmptyLse = 0.5f * kMasked;  // at or below: the row had no allowed key
constexpr int kThreads = 256;

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
// dst [BT][LD] times ``mul``; zeros past ``rows`` and dh
template <int DHP>
__device__ __forceinline__ void stage(float* dst, const float* base, int r0, int rows,
                                      long long stride, int dh, float mul) {
  using C = Bwd<DHP>;
  for (int idx = threadIdx.x; idx < C::BT * DHP; idx += kThreads) {
    const int r = idx / DHP, c = idx % DHP;
    dst[r * C::LD + c] =
        r0 + r < rows && c < dh ? base[(long long)(r0 + r) * stride + c] * mul : 0.f;
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

template <int DHP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ delta, int sq, int sk, int n_heads, int n_kv,
    int dh, int causal, int window, int q_offset, float scale) {
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

  stage<DHP>(Qs, q + q_off, q0, sq, q_stride, dh, scale);
  stage<DHP>(Os, dout + q_off, q0, sq, q_stride, dh, 1.f);
  // delta = rowsum(do * o), a warp a row
  for (int r = warp; r < BT; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sq)
      for (int c = lane; c < dh; c += 32)
        acc += dout[q_off + row * q_stride + c] * o[q_off + row * q_stride + c];
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
    stage<DHP>(Ks, k + kv_off, kt, sk, kv_stride, dh, 1.f);
    stage<DHP>(Vs, v + kv_off, kt, sk, kv_stride, dh, 1.f);
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
    float* drow = dq + q_off + row * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) drow[col] = acc[i][c] * scale;
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int n_heads, int n_kv, int dh,
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

  stage<DHP>(Ks, k + kv_off, k0, sk, kv_stride, dh, 1.f);
  stage<DHP>(Vs, v + kv_off, k0, sk, kv_stride, dh, 1.f);

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
      stage<DHP>(Qs, q + q_off, q0, sq, q_stride, dh, scale);
      stage<DHP>(Os, dout + q_off, q0, sq, q_stride, dh, 1.f);
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
    float* krow = dk + kv_off + key * kv_stride;
    float* vrow = dv + kv_off + key * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) {
        krow[col] = dka[i][c];
        vrow[col] = dva[i][c];
      }
    }
  }
}

template <int DHP>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq,
               int sk, int h, int kv, int dh, int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  using C = Bwd<DHP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid_q((sq + C::BT - 1) / C::BT, h, b);
  flash_attention_bwd_dq_kernel<DHP><<<grid_q, kThreads, C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout, lse,
      (float*)dq, delta, sq,
      sk, h, kv, dh, causal, window, q_offset, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || sk <= 0) return (int)e;
  const dim3 grid_k((sk + C::BT - 1) / C::BT, kv, b);
  flash_attention_bwd_dkdv_kernel<DHP><<<grid_k, kThreads, C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, sq, sk,
      h, kv, dh, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq,
                 int sk, int h, int kv, int dh, int causal, int window, int q_offset, float scale,
                 cudaStream_t s) {
#define FA_BWD(DHP)                                                                    \
  launch_f32<DHP>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kv, dh, causal, \
                  window, q_offset, scale, s)
  if (dh <= 16) return FA_BWD(16);
  if (dh <= 32) return FA_BWD(32);
  if (dh <= 64) return FA_BWD(64);
  if (dh <= 128) return FA_BWD(128);
  return FA_BWD(256);
#undef FA_BWD
}

// ------------------------------------------------- bf16, tensor cores
constexpr int kTile = 64;                  // rows of every tile: query rows or keys
constexpr int kBox = kTile * kSwizzleRow;  // one 64-column chunk of a tile: 8 KB
constexpr int kTcStages = 2;
constexpr int kTcThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
// named barriers of the dk / dv kernel's consumers (0 is __syncthreads):
// p^T written, p^T read
constexpr int kBarP = 1, kBarPRead = 2;

// The dq kernel: NWG consumer warpgroups of 64 query rows each. One at
// DHP 256, where the dq accumulator alone is 128 registers a thread and
// two warpgroups' q, do and o (192 KB) would leave no room for two stages
// of k and v.
template <int DHP>
struct DqShape {
  static constexpr int NCH = DHP / 64;     // 64-column chunks
  static constexpr int TILE = NCH * kBox;  // one 64-row tile of q, do, o, k or v
  static constexpr int NWG = DHP <= 128 ? 2 : 1;
  static constexpr int THREADS = 128 * (1 + NWG);
  static constexpr int BAR_OFF = 3 * NWG * TILE + 2 * kTcStages * TILE;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * kTcStages);  // + alignment slack
};

// The dk / dv kernel: two consumer warpgroups on one 64-key tile, one
// accumulating dV and the other dK, each for the whole head dim (both in
// one warpgroup would be 256 registers a thread at DHP 256); p^T passes
// from the first to the second through shared memory (fp32, in the
// accumulator layout).
template <int DHP>
struct DkvShape {
  static constexpr int NCH = DHP / 64;
  static constexpr int TILE = NCH * kBox;
  static constexpr int X_P = 32 * 128 * 4;  // p^T: 32 floats a consumer thread
  static constexpr int ROWS = 2 * kTcStages * kTile * 4;  // each stage's lse and delta
  static constexpr int BAR_OFF = 2 * TILE + 2 * kTcStages * TILE + X_P + ROWS;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * kTcStages);
};

__device__ __forceinline__ int floor_div64(int a) { return a >> 6; }  // arithmetic shift
__device__ __forceinline__ int ceil_div64(int a) { return -((-a) >> 6); }

// The 64-row query tiles whose key range (key_range of their rows) reaches
// the keys [k0, k0 + 64), in increasing order, as up to three runs:
// [0, n1) the tiles whose first row has no allowed key (key_range gives
// them every key; they lie at the start), [lo2, lo2 + n2) those whose band
// reaches the keys, [lo3, nq) those whose last row has no allowed key (at
// the end). Tile t's rows sit at positions off + 64 t .. off + min(64 t +
// 63, sq - 1).
struct QWalk {
  int n1, lo2, n2, lo3, n;
  __device__ __forceinline__ int at(int i) const {
    return i < n1 ? i : (i < n1 + n2 ? lo2 + i - n1 : lo3 + i - n1 - n2);
  }
};

__device__ __forceinline__ QWalk qtile_walk(int k0, int sq, int sk, int causal, int window,
                                            int off) {
  const int nq = (sq + kTile - 1) / kTile, last = off + sq - 1;  // the last row's position
  // first row before key 0 (causal)
  const int f1 = causal ? min(max(ceil_div64(-off), 0), nq) : 0;
  // last row at or past sk + window - 1: its window has left every key
  int f3 = nq;
  if (window > 0 && last >= sk + window - 1)
    f3 = min(max(ceil_div64(sk + window - 1 - off - (kTile - 1)), 0), nq - 1);
  f3 = max(f3, f1);
  // the band: the last row reaches key k0 (causal), the first row's window
  // reaches key k0 + 63
  int a = 0, b = nq;
  if (causal) a = last >= k0 ? min(max(ceil_div64(k0 - off - (kTile - 1)), 0), nq - 1) : nq;
  if (window > 0) b = min(max(floor_div64(k0 + kTile - 2 + window - off) + 1, 0), nq);
  a = max(a, f1);
  b = min(b, f3);
  QWalk w;
  w.n1 = f1;
  w.lo2 = a;
  w.n2 = max(b - a, 0);
  w.lo3 = f3;
  w.n = f1 + w.n2 + nq - f3;
  return w;
}

// 2^x, approximate (2 ulp), denormals flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// qs = bf16(q * scale) in place over ``bytes`` of a tile, by ``n`` threads
__device__ __forceinline__ void scale_tile(uint8_t* tile, int bytes, int t, int n, float scale) {
  uint4* qv = reinterpret_cast<uint4*>(tile);
  for (int i = t; i < bytes / 16; i += n) {
    uint4 x = qv[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    qv[i] = x;
  }
}

// s (+)= a b^T over DHP for two K-major 64-row tiles in shared memory: 16
// columns a step, 64-column chunks kBox apart
template <int DHP>
__device__ __forceinline__ void tile_product(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64(d, smem_desc(a + off, 16, kSwizzleAtom), smem_desc(b + off, 16, kSwizzleAtom),
                 kk > 0);
  }
}

template <int DHP>
__global__ void __launch_bounds__(DqShape<DHP>::THREADS, 1) flash_attention_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
    int sq, int sk, int n_heads, int n_kv, int dh, int causal, int window, int q_offset,
    float scale) {
  using C = DqShape<DHP>;
  constexpr int NWG = C::NWG, TILE = C::TILE, ROWS = kTile * NWG;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);   // [consumer][chunk][64 rows][128 B]
  const uint32_t sDO = sQ + NWG * TILE;  // the same
  const uint32_t sO = sDO + NWG * TILE;  // the same
  const uint32_t sK = sO + NWG * TILE;   // [stage][chunk][64 keys][128 B]
  const uint32_t sV = sK + kTcStages * TILE;
  const uint32_t bars = sQ + C::BAR_OFF;
  const uint32_t q_full = bars;  // q, do and o
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kTcStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kTcStages + s); };

  // row tiles slowest, heads fastest, in reverse: the longest bands (the
  // last rows under a causal mask) of every head start first
  const int n_rt = gridDim.x / n_heads;
  const int q0 = (n_rt - 1 - (int)blockIdx.x / n_heads) * ROWS, head = blockIdx.x % n_heads;
  const int b = blockIdx.z, kvh = head / (n_heads / n_kv);
  const int2 range = key_range(q_offset + q0, q_offset + min(q0 + ROWS, sq) - 1, sk, causal,
                               window);
  const int n_tiles = range.y > range.x ? (range.y - range.x + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128 * NWG);  // every consumer thread frees the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 3 * NWG * TILE);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(sQ + w * TILE + c * kBox, &tq, q_full, 64 * c, head, q0 + kTile * w, b);
          tma_load_4d(sDO + w * TILE + c * kBox, &tdo, q_full, 64 * c, head, q0 + kTile * w, b);
          tma_load_4d(sO + w * TILE + c * kBox, &to, q_full, 64 * c, head, q0 + kTile * w, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kTcStages, kt = range.x + i * kTile;
        mbar_wait(empty(s), ((i / kTcStages) & 1) ^ 1);  // passes at once on the first round
        mbar_expect_tx(k_full(s), TILE);
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(sK + s * TILE + c * kBox, &tk, k_full(s), 64 * c, kvh, kt, b);
        mbar_expect_tx(v_full(s), TILE);
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(sV + s * TILE + c * kBox, &tv, v_full(s), 64 * c, kvh, kt, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows q0 + 64 w .. + 63
  if constexpr (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int w = wg - 1, t = threadIdx.x - 128 * wg, warp = t / 32, lane = t % 32;
  const uint32_t sQw = sQ + w * TILE, sDOw = sDO + w * TILE;
  const long long q_stride = (long long)n_heads * dh;
  const long long q_base = (long long)b * sq * q_stride + (long long)head * dh;
  const long long row_off = ((long long)b * n_heads + head) * sq;
  const int wr0 = q0 + kTile * w;                // the warpgroup's first row
  const int row0 = wr0 + 16 * warp + lane / 4;  // this thread's rows (the m64nN accumulator
  const int cq = 2 * (lane % 4);                // layout): row0, row0 + 8; columns 8 j + cq, + 1

  // the rows' lse in base 2; +inf for a row past Sq or with no allowed key,
  // whose p (here) and ds are 0
  float l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = row < sq ? lse[row_off + row] : INFINITY;
    l2[r] = l <= kEmptyLse ? INFINITY : l * kLog2e;
  }

  // D = rowsum(do * o) of the thread's two rows from the tiles in shared
  // memory, a quarter of each row a thread, summed over the quad; delta for
  // the dk / dv kernel. Both tiles have one swizzle, so the sum reads each
  // row's 16-byte units in any order: unit u ^ (row % 8) keeps the quad's
  // eight rows on distinct banks.
  mbar_wait(q_full, 0);
  float dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 16 * warp + lane / 4 + 8 * r;  // the row within the warpgroup's tile
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int off =
            w * TILE + c * kBox + rr * kSwizzleRow + ((2 * (lane % 4) + u) ^ (rr % 8)) * 16;
        const uint4 x = *reinterpret_cast<const uint4*>(smem + (sDO - sQ) + off);
        const uint4 y = *reinterpret_cast<const uint4*>(smem + (sO - sQ) + off);
        const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = __bfloat1622float2(xh[j]), e = __bfloat1622float2(yh[j]);
          acc = fmaf(a.x, e.x, fmaf(a.y, e.y, acc));
        }
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dd[r] = acc;
    if (lane % 4 == 0 && row0 + 8 * r < sq) delta[row_off + row0 + 8 * r] = acc;
  }

  // q * scale, rounded to bf16, in place; the proxy fence makes the
  // generic-proxy writes visible to wgmma's async-proxy reads
  scale_tile(smem + w * TILE, TILE, t, 128, scale);
  fence_proxy_async();
  bar_sync(1 + w, 128);

  const int wpf = q_offset + wr0, wpl = wpf + kTile - 1;  // the warpgroup's positions
  float acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages, kt = range.x + it * kTile;
    const uint32_t parity = (it / kTcStages) & 1;
    const uint32_t sKs = sK + s * TILE, sVs = sV + s * TILE;

    // S = qs K^T and dP = do V^T, both operands K-major in shared memory
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    mbar_wait(k_full(s), parity);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    tile_product<DHP>(sc, sQw, sKs);
    wgmma_commit();
    mbar_wait(v_full(s), parity);
    tile_product<DHP>(dp, sDOw, sVs);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // the band mask, only on a tile that crosses the band edge or Sk
    if (kt + kTile > sk || (causal && kt + kTile - 1 > wpf) || (window > 0 && kt <= wpl - window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = kt + 8 * (i / 4) + cq + (i % 2), pos = q_offset + row0 + 8 * ((i % 4) / 2);
        if (!allowed(key, pos, sk, causal, window)) sc[i] = -INFINITY;
      }
    }
    // ds = p (dp - D), rounded to bf16 straight into wgmma's A fragments:
    // 16 keys a step
    uint32_t da[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * ks + 2 * j, r = j % 2;
        const float p0 = ex2(fmaf(sc[i], kLog2e, -l2[r]));
        const float p1 = ex2(fmaf(sc[i + 1], kLog2e, -l2[r]));
        da[ks][j] = pack_bf16(p0 * (dp[i] - dd[r]), p1 * (dp[i + 1] - dd[r]));
      }

    // dQ += dS K, K [keys, dh] read MN-major: 16 keys (2,048 bytes) a step
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Wgmma<DHP>::rs(acc, da[ks], smem_desc(sKs + ks * 16 * kSwizzleRow, kBox, kSwizzleAtom));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* drow = dq + q_base + (long long)row * q_stride;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_bwd_dkdv_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq, int sk, int n_heads,
    int n_kv, int dh, int causal, int window, int q_offset, float scale) {
  using C = DkvShape<DHP>;
  constexpr int TILE = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);        // [chunk][64 keys][128 B], resident
  const uint32_t sV = sK + TILE;
  const uint32_t sQ = sV + TILE;             // [stage][chunk][64 rows][128 B]
  const uint32_t sDO = sQ + kTcStages * TILE;
  float* xp = reinterpret_cast<float*>(smem + 2 * TILE + 2 * kTcStages * TILE);  // [32][128]
  float* sL = xp + 32 * 128;          // [stage][64 rows] lse
  float* sD = sL + kTcStages * kTile;  // [stage][64 rows] delta
  const uint32_t bars = sK + C::BAR_OFF;
  const uint32_t kv_full = bars;
  auto q_full = [&](int s) { return bars + 8 * (1 + s); };
  auto do_full = [&](int s) { return bars + 8 * (1 + kTcStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kTcStages + s); };
  auto q_scaled = [&](int s) { return bars + 8 * (1 + 3 * kTcStages + s); };

  // key tiles slowest, KV heads fastest: under a causal mask the first keys
  // have the longest walks, and those of every KV head start first
  const int k0 = ((int)blockIdx.x / n_kv) * kTile, kvh = blockIdx.x % n_kv, b = blockIdx.z;
  const int G = n_heads / n_kv;
  const QWalk walk = qtile_walk(k0, sq, sk, causal, window, q_offset);
  // the items, (query head of the group, query tile) head-major, the query
  // tiles from the last down: the CTAs that run together then read the
  // same q and do tiles at about the same time, from L2
  const int n_items = G * walk.n;
  auto item_head = [&](int it) { return kvh * G + it / walk.n; };
  auto item_q0 = [&](int it) { return walk.at(walk.n - 1 - it % walk.n) * kTile; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(q_full(s), 1 + 32);  // the TMA's, and each producer lane's for lse
      mbar_init(do_full(s), 1 + 32);  // and for delta
      mbar_init(empty(s), 256);
      mbar_init(q_scaled(s), 96);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: the walk the consumers take, item by item. Lane 0 of
    // warp 0 starts the TMA loads; every lane of warp 0 stages two rows of
    // the item's lse and delta (loaded before the stage frees, so that
    // their latency stays off the consumers' path); warps 1-3 scale each q
    // tile in place, bf16(q * scale), then a proxy fence for wgmma's reads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int lane = threadIdx.x;
    if (lane < 32 && n_items > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * TILE);
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(sK + c * kBox, &tk, kv_full, 64 * c, kvh, k0, b);
          tma_load_4d(sV + c * kBox, &tv, kv_full, 64 * c, kvh, k0, b);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int head = item_head(it), q0 = item_q0(it), s = it % kTcStages;
        const long long row_off = ((long long)b * n_heads + head) * sq;
        float l[2], d[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + lane + 32 * r;
          l[r] = row < sq ? lse[row_off + row] : INFINITY;
          d[r] = row < sq ? delta[row_off + row] : 0.f;
        }
        mbar_wait(empty(s), ((it / kTcStages) & 1) ^ 1);  // passes at once on the first round
        if (lane == 0) {
          mbar_expect_tx(q_full(s), TILE);
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(sQ + s * TILE + c * kBox, &tq, q_full(s), 64 * c, head, q0, b);
          mbar_expect_tx(do_full(s), TILE);
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(sDO + s * TILE + c * kBox, &tdo, do_full(s), 64 * c, head, q0, b);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sL[s * kTile + lane + 32 * r] = l[r];
          sD[s * kTile + lane + 32 * r] = d[r];
        }
        mbar_arrive(q_full(s));
        mbar_arrive(do_full(s));
      }
    } else if (n_items > 0) {
      for (int it = 0; it < n_items; ++it) {
        const int s = it % kTcStages;
        mbar_wait(q_full(s), (it / kTcStages) & 1);
        scale_tile(smem + 2 * TILE + s * TILE, TILE, lane - 32, 96, scale);
        fence_proxy_async();
        mbar_arrive(q_scaled(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup 0 forms p^T and accumulates dV; warpgroup 1
  // forms dp^T, then ds^T from warpgroup 0's p^T, and accumulates dK.
  // Warpgroup 0 never waits for warpgroup 1, except before it overwrites a
  // p^T that warpgroup 1 has not read yet.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int w = wg - 1, t = threadIdx.x - 128 * wg, warp = t / 32, lane = t % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const int cq = 2 * (lane % 4);               // its query rows of a tile: 8 j + cq, + 1
  const float neg_inv_sk = -1.f / (float)sk;
  const bool key_in[2] = {key0 < sk, key0 + 8 < sk};

  float acc[DHP / 2];  // dV (warpgroup 0) or dK (warpgroup 1): 64 keys x DHP
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
  if (n_items > 0) mbar_wait(kv_full, 0);

  for (int it = 0; it < n_items; ++it) {
    const int head = item_head(it), q0 = item_q0(it), s = it % kTcStages;
    const uint32_t parity = (it / kTcStages) & 1;
    const uint32_t sQs = sQ + s * TILE, sDOs = sDO + s * TILE;
    uint32_t fa[4][4];  // p^T or ds^T as A fragments: 16 query rows a step

    if (w == 0) {
      // lse of the tile's rows this thread holds (S^T's columns) in base 2,
      // staged with the q tile; a bit of ``empties`` for a row with no
      // allowed key, whose lse here is +inf
      mbar_wait(q_scaled(s), parity);
      float l2[16];
      uint32_t empties = 0;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float l = sL[s * kTile + 8 * (c / 2) + cq + (c % 2)];
        empties |= (uint32_t)(l <= kEmptyLse) << c;
        l2[c] = l <= kEmptyLse ? INFINITY : l * kLog2e;
      }
      // S^T = K qs^T
      float st[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = 0.f;
      fence_regs(st);
      wgmma_fence();
      tile_product<DHP>(st, sK, sQs);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);

      // p^T = exp(s - lse) on allowed keys, the mask only on a tile that
      // crosses the band edge or Sk; a row with no allowed key has 1 / Sk on
      // keys < Sk, passed negated so that warpgroup 1 gives it ds = 0.
      // Branch-free, so that the 32 exponentials overlap.
      const int pf = q_offset + q0;
      if (k0 + kTile > sk || (causal && k0 + kTile - 1 > pf) ||
          (window > 0 && k0 <= pf + kTile - 1 - window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = key0 + 8 * ((i % 4) / 2), pos = pf + 8 * (i / 4) + cq + (i % 2);
          if (!allowed(key, pos, sk, causal, window)) st[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 2 * (i / 4) + (i % 2);
        const float empty_p = ((empties >> c) & 1u) && key_in[(i % 4) / 2] ? neg_inv_sk : 0.f;
        st[i] = ex2(fmaf(st[i], kLog2e, -l2[c])) + empty_p;
      }
      if (it > 0) bar_sync(kBarPRead, 256);  // warpgroup 1 has read the last item's p^T
#pragma unroll
      for (int i = 0; i < 32; ++i) xp[i * 128 + t] = st[i];
      bar_arrive(kBarP, 256);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fa[ks][j] = pack_bf16(fabsf(st[8 * ks + 2 * j]), fabsf(st[8 * ks + 2 * j + 1]));

      // dV += P^T do: the query rows are the product's K, do [rows, dh] read
      // MN-major
      mbar_wait(do_full(s), parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<DHP>::rs(acc, fa[ks], smem_desc(sDOs + ks * 16 * kSwizzleRow, kBox, kSwizzleAtom));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    } else {
      // dP^T = V do^T
      float dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dpt[i] = 0.f;
      mbar_wait(do_full(s), parity);
      float dd[16];  // delta of the tile's rows, staged with the do tile
#pragma unroll
      for (int c = 0; c < 16; ++c) dd[c] = sD[s * kTile + 8 * (c / 2) + cq + (c % 2)];
      fence_regs(dpt);
      wgmma_fence();
      tile_product<DHP>(dpt, sV, sDOs);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dpt);

      // ds^T = p^T (dp^T - D), rounded to bf16 into A fragments
      bar_sync(kBarP, 256);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * ks + 2 * j, c = 2 * (i / 4);
          const float p0 = xp[i * 128 + t], p1 = xp[(i + 1) * 128 + t];
          fa[ks][j] = pack_bf16(p0 > 0.f ? p0 * (dpt[i] - dd[c]) : 0.f,
                                p1 > 0.f ? p1 * (dpt[i + 1] - dd[c + 1]) : 0.f);
        }
      if (it + 1 < n_items) bar_arrive(kBarPRead, 256);

      // dK += dS^T qs, qs [rows, dh] read MN-major
      mbar_wait(q_scaled(s), parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<DHP>::rs(acc, fa[ks], smem_desc(sQs + ks * 16 * kSwizzleRow, kBox, kSwizzleAtom));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(empty(s));
  }

  __nv_bfloat16* out = w == 0 ? dv : dk;
  const long long kv_stride = (long long)n_kv * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= sk) continue;
    __nv_bfloat16* orow = out + ((long long)b * sk + key) * kv_stride + (long long)kvh * dh;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int DHP>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq, int sk,
              int h, int kv, int dh, int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  using Q = DqShape<DHP>;
  using K = DkvShape<DHP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dq_tc_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_tc_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tdo, to, tk, tv;
  int err = encode_map(enc, &tq, q, b, sq, h, dh, kTile);
  if (!err) err = encode_map(enc, &tdo, dout, b, sq, h, dh, kTile);
  if (!err) err = encode_map(enc, &to, o, b, sq, h, dh, kTile);
  if (!err) err = encode_map(enc, &tk, k, b, sk, kv, dh, kTile);
  if (!err) err = encode_map(enc, &tv, v, b, sk, kv, dh, kTile);
  if (err) return err;
  const dim3 grid_q((sq + kTile * Q::NWG - 1) / (kTile * Q::NWG) * h, 1, b);
  flash_attention_bwd_dq_tc_kernel<DHP><<<grid_q, Q::THREADS, Q::SMEM, stream>>>(
      tq, tdo, to, tk, tv, lse, (__nv_bfloat16*)dq, delta, sq, sk, h, kv, dh, causal, window,
      q_offset, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_k((sk + kTile - 1) / kTile * kv, 1, b);
  flash_attention_bwd_dkdv_tc_kernel<DHP><<<grid_k, kTcThreads, K::SMEM, stream>>>(
      tq, tdo, tk, tv, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, sq, sk, h, kv, dh,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq,
                int sk, int h, int kv, int dh, int causal, int window, int q_offset, float scale,
                cudaStream_t s) {
  if (sk <= 0)  // no key: dq is 0 (a tensor map cannot span an empty sequence)
    return (int)cudaMemsetAsync(dq, 0, (size_t)b * sq * h * dh * sizeof(__nv_bfloat16), s);
#define FA_BWD_TC(DHP) \
  launch_tc<DHP>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kv, dh, causal, window, \
                 q_offset, scale, s)
  if (dh <= 64) return FA_BWD_TC(64);
  if (dh <= 128) return FA_BWD_TC(128);
  return FA_BWD_TC(256);
#undef FA_BWD_TC
}

}  // namespace

// q, o, dout, dq [b, sq, h, dh]; k, v, dk, dv [b, sk, kv, dh]; lse (the
// forward's) and delta (scratch, written here) [b, h, sq] fp32; dh <= 256,
// a multiple of 8. window <= 0: none. scale_bits: the fp32 bits of the
// softmax scale. is_bf16: 1 for bf16 tensors (the tensor-core kernels; q,
// k, v, o and dout 16-byte aligned), 0 for fp32 (the SIMT kernels).
// Launches the dq kernel, then the dk / dv kernel, on ``stream``. Returns a
// cudaError_t code, or 10000 + the CUresult of a refused tensor map.
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
    return dispatch_tc(q, k, v, o, dout, (const float*)lse, dq, dk, dv, (float*)delta, b, sq, sk,
                       h, kv, dh, causal, window, q_offset, scale, s);
  return dispatch_f32(q, k, v, o, dout, (const float*)lse, dq, dk, dv, (float*)delta, b, sq, sk,
                      h, kv, dh, causal, window, q_offset, scale, s);
}
