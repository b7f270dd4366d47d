// Flash attention forward (online softmax, causal and sliding window, GQA),
// hand-written for Hopper: a bf16 tensor-core kernel (wgmma + TMA) and an
// fp32 SIMT kernel, chosen by the tensors' type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _attn_kernel), in the layout of
// repro.lm.attention.flash_attention: q [B, Sq, H, dh], k and v
// [B, Sk, KV, dh], out [B, Sq, H, dh], all contiguous. Query head h reads
// KV head h / (H / KV) (a repeat of each KV head over its G query heads, as
// the reference's reshape to [B, S, KV, G, dh]). Query row i sits at
// position q_offset + i; key j is allowed where j <= that position (causal)
// and j > position - window (window > 0). Held to
// repro_torch/kernels/flash_attention/ref.py.
//
// Numerics, as the reference: q * dh^-0.5 is rounded to the input type
// before the product; scores, the running max and sum and the accumulator
// are fp32; disallowed scores are -1e30 (not -inf), and the probabilities
// are rounded to the input type before the product with v (the sum l adds
// them unrounded); the output is acc / max(l, 1e-30) in q's type. Keys
// past Sk (the ragged last tile) are left out entirely (probability 0).
//
// The row log-sum-exp, for the backward (csrc/flash_attention_bwd.cu):
// when the caller passes an lse pointer (the autograd path), both kernels
// also write lse [B, H, Sq] fp32 = m + ln(l), in natural-log units of the
// scaled scores s = (q * scale) . k, so that the backward recomputes each
// probability as exp(s - lse). The bf16 kernel's exponentials run in base
// 2 (exp2f((s - m) * log2 e)), but its m and l are those of base e: m is
// the largest scaled score and l the sum of e^(s - m). A row with no
// allowed key gets lse = -1e30 (its m; ln l vanishes beside it). Prefill
// passes a null pointer and writes nothing more.
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
// tensor-core peak (989 TFLOP/s), against ~0.59 GB of q, k, v and out,
// ~0.18 ms at 3.35 TB/s. So the products must run on the tensor cores and
// the loads must stay off the threads that run the products.
//
// bf16 design (sm_90a). One CTA of three warpgroups per (128 query rows,
// query head, batch), the row tiles walked in reverse blockIdx.x order so
// that the longest causal tiles start first:
// - Warpgroup 0 is the producer: after setmaxnreg gives its registers to
//   the consumers, one thread starts TMA loads of the CTA's q tile and then
//   of each BK-key k and v tile into a ring of two stages, with a full
//   mbarrier per tile and an empty one per stage. The tensor maps are 4-d
//   over [B, S, heads, dh] with the real strides, built per launch in
//   flash_attention_launch through cuTensorMapEncodeTiled (fetched from the
//   CUDA driver with cudaGetDriverEntryPointByVersion, or cudaGetDriverEntryPoint
//   before CUDA 12.5, so the library needs no -lcuda; csrc/hopper.cuh
//   holds these and the PTX wrappers, shared with the backward). Each box is
//   64 columns (128 bytes, the 128-byte swizzle that the wgmma descriptors
//   read) by 64 or BK rows; TMA zero-fills what lies out of bounds: rows
//   past Sq, keys past Sk, and columns past dh up to DHP.
// - Warpgroups 1 and 2 consume, 64 query rows each. A consumer scales its
//   q rows in shared memory once (bf16(q * scale), then a proxy fence so
//   that wgmma sees the generic-proxy writes), then for each key tile:
//   S = Q K^T with wgmma m64nBKk16 reading both operands from shared memory
//   (K as stored, [keys, dh], is K-major); mask (only on a tile that
//   crosses the band edge or Sk), row max and sum by quad shuffles, in the
//   accumulator's registers; P rounded to bf16 straight into wgmma's
//   A-fragment registers (the m64nN accumulator layout converts to it);
//   O += P V with wgmma m64nDHPk16, A from registers and V, [keys, dh], as
//   an MN-major (transposed) B operand. Then it frees the stage.
// - Epilogue: O / max(l, 1e-30) rounded to bf16, stored straight from the
//   registers for rows < Sq and columns < dh.
// Head dims pad to DHP = 64, 128 or 256 (zero columns from TMA); BK = 128
// keys a tile for DHP <= 128, 64 at DHP 256, where the output accumulator
// alone is 128 registers a thread. Shared memory: q 2 x 64 x DHP, k and v
// 2 stages x BK x DHP, bf16: 80, 160 or 192 KB.
//
// fp32 design (SIMT; tensor cores would be TF32, which cannot hold the
// fp32 path to its 2e-5). One CTA of 256 threads per (64 query rows, query
// head, batch). The scaled q tile and each 64-key k / v tile are staged
// through shared memory in fp32; thread (ty, tx) of the 16 x 16 grid owns
// query rows ty + 16 i (i < 4) and, for the scores, keys tx + 16 j (j < 4),
// for the output, columns tx + 16 c (c < DHP / 16). Row max and sum are
// reduced over the 16 threads of a row by shuffles within the half-warp.
// Head dims up to 256 are padded with zeros to the next of 16, 32, 64,
// 128, 256 (DHP).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kMasked = -1e30f;

__device__ __forceinline__ int band_lo(int pos, int window) {
  return window > 0 ? max(0, pos - window + 1) : 0;
}
__device__ __forceinline__ int band_hi(int pos, int sk, int causal) {
  return causal ? min(sk, pos + 1) : sk;
}

// The key range [lo, hi) a CTA whose valid rows sit at positions [pf, pl]
// walks: every key when its first or last row has no allowed key.
__device__ __forceinline__ int2 key_range(int pf, int pl, int sk, int causal, int window) {
  if (band_lo(pf, window) >= band_hi(pf, sk, causal) ||
      band_lo(pl, window) >= band_hi(pl, sk, causal))
    return make_int2(0, sk);
  return make_int2(band_lo(pf, window), band_hi(pl, sk, causal));
}

// ------------------------------------------------------------ fp32, SIMT
constexpr int kRows = 64;     // query rows per CTA
constexpr int kKeys = 64;     // keys per tile
constexpr int kThreads = 256;

template <int DHP>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * (2 * kRows * (DHP + 1) + kKeys * DHP + kRows * (kKeys + 1));
}

template <int DHP>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int sq, int sk, int n_heads, int n_kv,
    int dh, int causal, int window, int q_offset, float scale) {
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
  const float* qb = q + (long long)b * sq * q_stride + (long long)head * dh;
  const float* kb = k + (long long)b * sk * kv_stride + (long long)kvh * dh;
  const float* vb = v + (long long)b * sk * kv_stride + (long long)kvh * dh;

  for (int idx = tid; idx < kRows * DHP; idx += kThreads) {
    const int r = idx / DHP, c = idx % DHP;
    Qs[r * LD + c] = (q0 + r < sq && c < dh) ? qb[(q0 + r) * q_stride + c] * scale : 0.f;
  }

  const int2 range = key_range(q_offset + q0, q_offset + min(q0 + kRows, sq) - 1, sk, causal,
                               window);

  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int kt = range.x; kt < range.y; kt += kKeys) {
    __syncthreads();  // the last tile's readers are done (and Qs is written)
    for (int idx = tid; idx < kKeys * DHP; idx += kThreads) {
      const int r = idx / DHP, c = idx % DHP, key = kt + r;
      const bool in = key < sk && c < dh;
      Ks[r * LD + c] = in ? kb[key * kv_stride + c] : 0.f;
      Vs[r * DHP + c] = in ? vb[key * kv_stride + c] : 0.f;
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
        Ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = p;
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
    float* orow = out + ((long long)b * sq + row) * q_stride + (long long)head * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) orow[col] = o[i][c] / denom;
    }
    if (lse != nullptr && tx == 0) lse[((long long)b * n_heads + head) * sq + row] = m[i] + logf(l[i]);
  }
}

template <int DHP>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq, int sk,
               int h, int kv, int dh, int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<DHP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_f32_kernel<DHP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_attention_f32_kernel<DHP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, sq, sk, h, kv, dh,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq, int sk,
                 int h, int kv, int dh, int causal, int window, int q_offset, float scale,
                 cudaStream_t s) {
  if (dh <= 16) return launch_f32<16>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  if (dh <= 32) return launch_f32<32>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  if (dh <= 64) return launch_f32<64>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  if (dh <= 128) return launch_f32<128>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  return launch_f32<256>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
}

// ------------------------------------------------- bf16, tensor cores
constexpr int kTcThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTcRows = 128;     // query rows per CTA, 64 per consumer
constexpr int kStages = 2;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int DHP>
struct TcShape {
  static constexpr int NCH = DHP / 64;                 // 64-column chunks
  static constexpr int BK = DHP <= 128 ? 128 : 64;     // keys per tile
  static constexpr int Q_CHUNK = 64 * kSwizzleRow;     // one consumer's 64 rows of a chunk
  static constexpr int Q_WG = NCH * Q_CHUNK;           // one consumer's q
  static constexpr int KV_CHUNK = BK * kSwizzleRow;
  static constexpr int KV_TILE = NCH * KV_CHUNK;       // one k (or v) tile
  static constexpr int BAR_OFF = 2 * Q_WG + 2 * kStages * KV_TILE;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * kStages);  // + alignment slack
};

template <int DHP>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int n_heads, int n_kv, int dh, int causal,
    int window, int q_offset, float scale) {
  using C = TcShape<DHP>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);           // [consumer][chunk][64 rows][128 B]
  const uint32_t sK = sQ + 2 * C::Q_WG;          // [stage][chunk][BK rows][128 B]
  const uint32_t sV = sK + kStages * C::KV_TILE;
  const uint32_t bars = sQ + C::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (n_heads / n_kv);
  const int2 range = key_range(q_offset + q0, q_offset + min(q0 + kTcRows, sq) - 1, sk, causal,
                               window);
  const int n_tiles = range.y > range.x ? (range.y - range.x + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread frees the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::Q_WG);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(sQ + w * C::Q_WG + c * C::Q_CHUNK, &tq, q_full, 64 * c, head, q0 + 64 * w, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, kt = range.x + i * BK;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);  // passes at once on the first round
        mbar_expect_tx(k_full(s), C::KV_TILE);
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(sK + s * C::KV_TILE + c * C::KV_CHUNK, &tk, k_full(s), 64 * c, kvh, kt, b);
        mbar_expect_tx(v_full(s), C::KV_TILE);
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(sV + s * C::KV_TILE + c * C::KV_CHUNK, &tv, v_full(s), 64 * c, kvh, kt, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows q0 + 64 w .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int w = wg - 1, t = threadIdx.x - 128 * wg, warp = t / 32, lane = t % 32;
  const uint32_t sQw = sQ + w * C::Q_WG;

  // q * scale, rounded to bf16, in place; the proxy fence makes the
  // generic-proxy writes visible to wgmma's async-proxy reads
  mbar_wait(q_full, 0);
  {
    uint4* qv = reinterpret_cast<uint4*>(smem + w * C::Q_WG);
    for (int i = t; i < C::Q_WG / 16; i += 128) {
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
  fence_proxy_async();
  bar_sync(1 + w, 128);

  // this thread's two rows (the accumulator layout of m64nN: warp w rows
  // 16 w + lane / 4 and + 8; columns 8 j + 2 (lane % 4) and + 1)
  const int row0 = q0 + 64 * w + 16 * warp + lane / 4;
  const int pos[2] = {q_offset + row0, q_offset + row0 + 8};
  const int wpf = q_offset + q0 + 64 * w, wpl = wpf + 63;  // the warpgroup's positions
  const int cq = 2 * (lane % 4);
  constexpr float kLog2e = 1.4426950408889634f;

  float o[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, kt = range.x + it * BK;
    const uint32_t parity = (it / kStages) & 1;

    // S = (q * scale) K^T over DHP / 16 steps of 16 columns
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full(s), parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns within the 128-byte row
      Wgmma<BK>::ss(sc, smem_desc(sQw + (kk / 4) * C::Q_CHUNK + off, 16, kSwizzleAtom),
                    smem_desc(sK + s * C::KV_TILE + (kk / 4) * C::KV_CHUNK + off, 16, kSwizzleAtom),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // the band mask, only on a tile that crosses the band edge or Sk
    if (kt + BK > sk || (causal && kt + BK - 1 > wpf) || (window > 0 && kt <= wpl - window)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = kt + 8 * (i / 4) + cq + (i % 2), p = pos[(i % 4) / 2];
        const bool ok = (!causal || key <= p) && (window <= 0 || key > p - window);
        sc[i] = key >= sk ? -INFINITY : (ok ? sc[i] : kMasked);
      }
    }
    // online softmax over the tile, two rows a thread, four threads a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i % 4) / 2;
      sc[i] = exp2f((sc[i] - m[r]) * kLog2e);
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] *= corr[(i % 4) / 2];
    // P in bf16, as wgmma's A fragments: 16 keys a step
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[ks][j] = pack_bf16(sc[8 * ks + 2 * j], sc[8 * ks + 2 * j + 1]);

    // O += P V, V [keys, dh] read transposed: 16 keys (2,048 bytes) a step,
    // 64-column chunks KV_CHUNK apart
    mbar_wait(v_full(s), parity);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      Wgmma<DHP>::rs(o, pa[ks], smem_desc(sV + s * C::KV_TILE + ks * 16 * kSwizzleRow,
                                          C::KV_CHUNK, kSwizzleAtom));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty(s));
  }

  const long long q_stride = (long long)n_heads * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && cq == 0) lse[((long long)b * n_heads + head) * sq + row] = m[r] + logf(l[r]);
    __nv_bfloat16* orow = out + ((long long)b * sq + row) * q_stride + (long long)head * dh;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int DHP>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq, int sk,
                int h, int kv, int dh, int causal, int window, int q_offset, float scale,
                cudaStream_t stream) {
  using C = TcShape<DHP>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_bf16_kernel<DHP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  int err = encode_map(enc, &tq, q, b, sq, h, dh, 64);
  if (!err) err = encode_map(enc, &tk, k, b, sk, kv, dh, C::BK);
  if (!err) err = encode_map(enc, &tv, v, b, sk, kv, dh, C::BK);
  if (err) return err;
  const dim3 grid((sq + kTcRows - 1) / kTcRows, h, b);
  flash_attention_bf16_kernel<DHP><<<grid, kTcThreads, C::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, sq, sk, h, kv, dh, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq, int sk,
                  int h, int kv, int dh, int causal, int window, int q_offset, float scale,
                  cudaStream_t s) {
  if (dh <= 64) return launch_bf16<64>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  if (dh <= 128) return launch_bf16<128>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
  return launch_bf16<256>(q, k, v, out, lse, b, sq, sk, h, kv, dh, causal, window, q_offset, scale, s);
}

}  // namespace

// q [b, sq, h, dh]; k, v [b, sk, kv, dh]; out [b, sq, h, dh]; lse null, or
// [b, h, sq] fp32 (see the header); dh <= 256, a multiple of 8. window <= 0:
// none. scale_bits: the fp32 bits of the
// softmax scale. is_bf16: 1 for bf16 tensors (the tensor-core kernel; q,
// k, v 16-byte aligned), 0 for fp32 (the SIMT kernel). Returns a
// cudaError_t code, or 10000 + the CUresult of a refused tensor map.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int b, int sq, int sk, int h, int kv, int dh, int causal, int window, int q_offset,
    int scale_bits, int is_bf16, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || dh <= 0) return 0;
  if (kv <= 0 || h % kv != 0 || dh > 256) return (int)cudaErrorInvalidValue;
  float scale;
  memcpy(&scale, &scale_bits, sizeof scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_bf16(q, k, v, out, (float*)lse, b, sq, sk, h, kv, dh, causal, window,
                         q_offset, scale, s);
  return dispatch_f32(q, k, v, out, (float*)lse, b, sq, sk, h, kv, dh, causal, window, q_offset,
                      scale, s);
}
