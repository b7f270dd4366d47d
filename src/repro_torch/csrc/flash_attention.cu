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
//   before CUDA 12.5, so the library needs no -lcuda). Each box is
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

namespace {

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
// PTX wrappers: shared-memory addresses, mbarriers, TMA, wgmma.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// a box of the 4-d map at coordinates (c0 innermost .. c3) into shared
// memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator registers across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]^T, both from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]^T, both from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D[64 x 256] += A[64 x 16] (registers) * B[16 x 256] (shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  __device__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int s) { wgmma_ss_n64(d, a, b, s); }
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n64(d, a, b, 1); }
};
template <> struct Wgmma<128> {
  __device__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int s) { wgmma_ss_n128(d, a, b, s); }
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n128(d, a, b, 1); }
};
template <> struct Wgmma<256> {
  __device__ static void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n256(d, a, b, 1); }
};

constexpr int kTcThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTcRows = 128;     // query rows per CTA, 64 per consumer
constexpr int kStages = 2;
constexpr int kSwizzleRow = 128;      // bytes: one row of a 64-column chunk
constexpr int kSwizzleAtom = 1024;    // 8 rows of it: the descriptors' stride offset
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
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, found once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

constexpr int kEncodeError = 10000;  // + the CUresult of a refused tensor map

// A 4-d map over a contiguous bf16 [batch, seq, heads, dh] tensor: boxes of
// 64 columns x 1 head x ``rows`` positions x 1 sequence, 128-byte swizzle,
// zeros out of bounds. Returns 0 or kEncodeError + the CUresult.
int encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int b, int s, int heads,
               int dh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)s * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
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
