// Owner-local block gather + predicate filter, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/block_gather/kernel.py
// (block_gather_pallas, body _block_gather_kernel): the partitioned tier's
// miss execution for one orientation of one owner's edge block. For each
// routed row and each of its W = max_deg + R lanes it computes what
// repro_torch/kernels/block_gather/ref.py computes, bit for bit:
//   lanes < max_deg   the row's CSR window: start = indptr[lroot],
//                     deg = indptr[lroot + 1] - start, slot clipped to
//                     [0, EB - 1], open while lane < deg and cvalid;
//   lanes >= max_deg  the block's recent region: roff = clamp(csr_len, 0,
//                     EB - R), sid = roff + (lane - max_deg), a hit where
//                     csr_len <= sid < blk_len, rvalid and key[sid] == root;
// then the liveness chain (edge alive, leaf alive, root alive), the edge
// label, the edge predicate, the leaf predicate and the root gate; and
// trunc = deg > max_deg per row.
//
// The reference specializes each predicate into its trace; a library built
// once cannot be, so every predicate arrives as plain ints (its label, its
// number of conditions and, per condition, lane / prop id / op / value /
// wildcard flag, at most MAX_CONDS = 3) and the kernel branches on them.
// csr_len and blk_len stay on the device: the kernel reads them through
// their pointers, so a launch costs no host read.
//
// What bounds it on this card: bytes. Each lane writes 7 B (leaf 4 B and
// three masks 1 B); at a second hop's 12,288 rows x 1,088 lanes that is
// ~94 MB per launch, ~28 us at 3.35 TB/s, against a few MB of block
// records, vertex attributes and per-row inputs it must read.
//
// Design (block_gather_kernel):
// - Grid: one CTA per tile of kRows rows; its threads walk the tile's
//   (row, 4-lane chunk) tasks, neighbouring threads on neighbouring chunks
//   of a row, stepping (row, chunk) by additions: no division per lane.
// - Per-row inputs are read once a row into shared memory (root, CSR
//   window start and degree, the gates, the root's liveness, both
//   predicates' bound lanes); that thread also writes trunc.
// - The recent window is the same R slots for every row (roff depends on
//   csr_len alone). It is staged once a CTA: key and other in shared
//   memory, padded one word in 32 so that neighbouring threads' reads of
//   their chunks fall in distinct banks, and one bit a slot for "in region,
//   edge alive, leaf alive", packed 32 to a word by ballot. A recent lane
//   then compares its key with the root and reads its leaf from shared
//   memory. A row that is not executed (rmask false) reads nothing past
//   the leaf ids. The staging uses ordinary loads, not cp.async: the ok
//   bit needs valive[other[sid]], an indirect load an async copy cannot
//   make; roff is any int, so the window is only 4-byte aligned, short of
//   a bulk copy's 16 bytes; the padded layout is not a contiguous copy;
//   and key and other are ~8 KB a CTA, read once by its 256 threads
//   before the stores that dominate the kernel.
// - A lane that may be scanned (usually few) loads every record its masks
//   need at once (edge liveness, leaf liveness, the edge's label and
//   properties, the leaf's label and properties), one round trip after
//   its leaf id instead of one per link of the chain. At phase 7's largest
//   call its few executed rows still cost several us over the same call
//   with none executed (PERF.md, the (a)/(b) diagnosis).
// - Stores: a chunk writes its 4 leaf ids as one 16-byte streaming store
//   (st.global.cs) and each mask as one 4-byte store, so a warp's store
//   instruction covers 512 (leaf) or 128 (mask) contiguous bytes, whole
//   32-byte sectors. With 16 lanes a thread, each thread's four leaf
//   stores 64 bytes apart, every store instruction wrote half sectors, and
//   on the card that layout ran slower (PERF.md). Where W % 4 != 0 (the last
//   chunk of a row is short and rows are not 16-byte aligned) or an output
//   is not 16-byte aligned, every chunk writes lane by lane; a chunk that
//   straddles max_deg picks its region lane by lane.
//
// block_gather_lane_kernel is the design before this one (one thread per
// (row, lane), the per-row inputs and the recent window read again by
// every lane). No path launches it: chip_smoke.py times it beside the
// kernel above on the same inputs, in the same process, as the yardstick
// of the (a)/(b)/(c) diagnosis in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CONDS 3
#define PROP_MISSING (-2147483647)

struct Pred {
  int label, n;
  int lane[MAX_CONDS], pid[MAX_CONDS], op[MAX_CONDS], val[MAX_CONDS], wild[MAX_CONDS];
};

// jnp's gather rule: a negative index wraps once, then everything clamps
__device__ __forceinline__ int64_t jidx(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ int32_t clamp32(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ bool cmp_op(int op, int32_t a, int32_t b) {
  switch (op) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    case 5: return a >= b;
    default: return false;  // an unknown op never qualifies
  }
}

__device__ __forceinline__ bool eval_pred(const Pred& p, int32_t lab,
                                          const int32_t* __restrict__ props, int np,
                                          const int32_t* __restrict__ bound) {
  bool ok = p.label < 0 || lab == p.label;
  // unrolled over the fixed MAX_CONDS, so the struct is read with constant
  // indices from the parameter space instead of a local-memory copy
#pragma unroll
  for (int c = 0; c < MAX_CONDS; ++c) {
    if (c < p.n) {
      const int32_t pv = props[p.pid[c] < np - 1 ? p.pid[c] : np - 1];
      const bool cond = p.wild[c] ? pv == bound[p.lane[c]] : cmp_op(p.op[c], pv, p.val[c]);
      ok = ok && pv != PROP_MISSING && cond;
    }
  }
  return ok;
}

namespace {

constexpr int kRows = 16;     // rows a CTA owns
constexpr int kLanes = 4;     // lanes a task owns: one chunk
constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
// per-row gate bits in shared memory
constexpr int kCValid = 1, kRValid = 2, kRMask = 4, kROk = 8, kRAlive = 16;

// shared-memory index of recent-window entry j: one pad word every 32, so
// the 32 chunks a warp reads (entries 4c..4c+3) sit in 32 distinct banks
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

// bits 0..3 of x as four bytes of 0 / 1 (the products cannot carry)
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

}  // namespace

__global__ void __launch_bounds__(kThreads) block_gather_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ key,
    const int32_t* __restrict__ other, const int32_t* __restrict__ label,
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ props,
    const int32_t* __restrict__ vlabel, const uint8_t* __restrict__ valive,
    const int32_t* __restrict__ vprops, const int32_t* __restrict__ csr_len_p,
    const int32_t* __restrict__ blk_len_p, const int32_t* __restrict__ roots,
    const int32_t* __restrict__ lroot, const uint8_t* __restrict__ rvalid,
    const uint8_t* __restrict__ cvalid, const uint8_t* __restrict__ rmask,
    const uint8_t* __restrict__ r_ok, const int32_t* __restrict__ pe_bound,
    const int32_t* __restrict__ pl_bound,
    int32_t* __restrict__ leaf_o, uint8_t* __restrict__ scan_o,
    uint8_t* __restrict__ emask_o, uint8_t* __restrict__ qual_o,
    uint8_t* __restrict__ trunc_o,
    int B, int W, int Vp, int EB, int v_cap, int nep, int nvp,
    int max_deg, int R, int edge_label, int vec, Pred pe, Pred pl) {
  extern __shared__ int32_t smem[];
  const int Rp = pad(R - 1) + 1;
  const int nw = (R + 31) >> 5;  // ok-bit words; one more, zero, past them
  int32_t* s_key = smem;
  int32_t* s_other = smem + Rp;
  uint32_t* s_okw = reinterpret_cast<uint32_t*>(smem + 2 * Rp);
  __shared__ int32_t s_root[kRows], s_start[kRows], s_deg[kRows], s_flags[kRows];
  __shared__ int32_t s_peb[kRows][MAX_CONDS], s_plb[kRows][MAX_CONDS];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  // per-row inputs, one thread a row
  if (tid < nrows) {
    const int row = row0 + tid;
    const int32_t lr = lroot[row];
    const int32_t start = indptr[jidx(lr, Vp)];
    // int32 wrap of lroot + 1, as the reference's int32 add
    const int32_t lr1 = (int32_t)((uint32_t)lr + 1u);
    const int32_t deg = indptr[jidx(lr1, Vp)] - start;
    const int32_t r = roots[row];
    trunc_o[row] = deg > max_deg;
    s_root[tid] = r;
    s_start[tid] = start;
    s_deg[tid] = deg;
    s_flags[tid] = (cvalid[row] ? kCValid : 0) | (rvalid[row] ? kRValid : 0) |
                   (rmask[row] ? kRMask : 0) | (r_ok[row] ? kROk : 0) |
                   (valive[clamp32(r, 0, v_cap - 1)] ? kRAlive : 0);
#pragma unroll
    for (int c = 0; c < MAX_CONDS; ++c) {
      s_peb[tid][c] = pe_bound[row * MAX_CONDS + c];
      s_plb[tid][c] = pl_bound[row * MAX_CONDS + c];
    }
  }

  // the recent window, the same for every row: staged once a CTA. Each
  // warp covers 32 aligned entries a step, so its ballot is one ok word.
  const int32_t cl = *csr_len_p, bl = *blk_len_p;
  const int32_t roff = clamp32(cl, 0, EB - R);
  for (int j = tid; j < nw * 32; j += kThreads) {
    bool ok = false;
    if (j < R) {
      const int32_t sid = roff + j;
      const int32_t o = other[sid];
      s_key[pad(j)] = key[sid];
      s_other[pad(j)] = o;
      if (sid >= cl && sid < bl) ok = (alive[sid] & valive[clamp32(o, 0, v_cap - 1)]) != 0;
    }
    const uint32_t bits = __ballot_sync(kAll, ok);
    if ((tid & 31) == 0) s_okw[j >> 5] = bits;
  }
  if (tid == 0) s_okw[nw] = 0;
  __syncthreads();

  const int nch = (W + kLanes - 1) / kLanes;
  // (row, chunk) of this thread's first task, then advanced by additions
  int tr = tid / nch, tc = tid - tr * nch;
  const int step_r = kThreads / nch, step_c = kThreads - step_r * nch;
  for (int t = tid; t < nrows * nch; t += kThreads) {
    const int lane0 = tc * kLanes;
    const int32_t r = s_root[tr], start = s_start[tr], deg = s_deg[tr];
    const int flags = s_flags[tr];
    // a lane's masks are all false unless its row is executed (rmask) and
    // its root alive; then its gate opens the CSR window or the recent scan
    const bool exec = (flags & kRMask) && (flags & kRAlive);
    const bool csr_open = exec && (flags & kCValid);
    const bool rec_open = exec && (flags & kRValid);
    // ok bits of the recent entries from jb on (jb = 0 for a CSR chunk)
    const int jb = max(lane0 - max_deg, 0);
    const uint32_t okb = __funnelshift_r(s_okw[jb >> 5], s_okw[(jb >> 5) + 1], jb & 31);

    int32_t leafv[kLanes];
    uint32_t scanb = 0, emb = 0, qb = 0;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int lane = lane0 + k;
      int32_t leaf = 0, slot = 0;
      bool cand = false, live = true;
      if (lane < max_deg) {
        slot = clamp32(start + lane, 0, EB - 1);
        leaf = __ldg(other + slot);
        cand = csr_open && lane < deg;
      } else if (lane < W) {
        const int j = lane - max_deg;
        slot = roff + j;
        leaf = s_other[pad(j)];
        // the ok bit holds the region test and both liveness loads
        cand = rec_open && ((okb >> (j - jb)) & 1u) && s_key[pad(j)] == r;
      }
      leafv[k] = leaf;
      if (cand) {
        // every record the lane's masks need, loaded at once: the liveness
        // chain, the edge's label and properties, the leaf's label and
        // properties (read whether or not the edge passes)
        const int32_t leaf_c = clamp32(leaf, 0, v_cap - 1);
        if (lane < max_deg) live = (alive[slot] & valive[leaf_c]) != 0;
        const int32_t elab = label[slot];
        const bool pe_ok = eval_pred(pe, elab, props + (int64_t)slot * nep, nep, s_peb[tr]);
        const bool e_ok = (edge_label < 0 || elab == edge_label) && pe_ok;
        const bool l_ok =
            eval_pred(pl, vlabel[leaf_c], vprops + (int64_t)leaf_c * nvp, nvp, s_plb[tr]);
        scanb |= (uint32_t)live << k;
        emb |= (uint32_t)(live && e_ok) << k;
        qb |= (uint32_t)(live && e_ok && (flags & kROk) && l_ok) << k;
      }
    }

    const int64_t o = (int64_t)(row0 + tr) * W + lane0;
    if (vec) {
      __stcs(reinterpret_cast<int4*>(leaf_o + o), make_int4(leafv[0], leafv[1], leafv[2], leafv[3]));
      __stcs(reinterpret_cast<uint32_t*>(scan_o + o), spread4(scanb));
      __stcs(reinterpret_cast<uint32_t*>(emask_o + o), spread4(emb));
      __stcs(reinterpret_cast<uint32_t*>(qual_o + o), spread4(qb));
    } else {
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        if (lane0 + k < W) {
          leaf_o[o + k] = leafv[k];
          scan_o[o + k] = (scanb >> k) & 1u;
          emask_o[o + k] = (emb >> k) & 1u;
          qual_o[o + k] = (qb >> k) & 1u;
        }
      }
    }

    tc += step_c;
    tr += step_r;
    if (tc >= nch) {
      tc -= nch;
      ++tr;
    }
  }
}

// The per-lane design, kept only as the diagnosis's yardstick (see above).
__global__ void block_gather_lane_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ key,
    const int32_t* __restrict__ other, const int32_t* __restrict__ label,
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ props,
    const int32_t* __restrict__ vlabel, const uint8_t* __restrict__ valive,
    const int32_t* __restrict__ vprops, const int32_t* __restrict__ csr_len_p,
    const int32_t* __restrict__ blk_len_p, const int32_t* __restrict__ roots,
    const int32_t* __restrict__ lroot, const uint8_t* __restrict__ rvalid,
    const uint8_t* __restrict__ cvalid, const uint8_t* __restrict__ rmask,
    const uint8_t* __restrict__ r_ok, const int32_t* __restrict__ pe_bound,
    const int32_t* __restrict__ pl_bound,
    int32_t* __restrict__ leaf_o, uint8_t* __restrict__ scan_o,
    uint8_t* __restrict__ emask_o, uint8_t* __restrict__ qual_o,
    uint8_t* __restrict__ trunc_o,
    int64_t total, int W, int Vp, int EB, int v_cap, int nep, int nvp,
    int max_deg, int R, int edge_label, Pred pe, Pred pl) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / W;
  const int lane = (int)(i - row * W);
  const int32_t r = roots[row];

  int32_t slot = 0;
  bool m = false;
  if (lane < max_deg || lane == 0) {
    const int32_t lr = lroot[row];
    const int32_t start = indptr[jidx(lr, Vp)];
    const int32_t lr1 = (int32_t)((uint32_t)lr + 1u);
    const int32_t deg = indptr[jidx(lr1, Vp)] - start;
    if (lane == 0) trunc_o[row] = deg > max_deg;
    if (lane < max_deg) {
      m = lane < deg && cvalid[row];
      slot = clamp32(start + lane, 0, EB - 1);
    }
  }
  if (lane >= max_deg) {
    const int32_t cl = *csr_len_p;
    const int32_t sid = clamp32(cl, 0, EB - R) + (lane - max_deg);
    slot = sid;
    m = sid >= cl && sid < *blk_len_p && rvalid[row] && key[sid] == r;
  }

  const int32_t leaf = other[slot];
  const int32_t leaf_c = clamp32(leaf, 0, v_cap - 1);
  m = m && alive[slot] && valive[leaf_c] && valive[clamp32(r, 0, v_cap - 1)];
  const bool scan = m && rmask[row];
  bool emask = false, qual = false;
  if (scan) {
    const int32_t elab = label[slot];
    emask = (edge_label < 0 || elab == edge_label) &&
            eval_pred(pe, elab, props + (int64_t)slot * nep, nep, pe_bound + row * MAX_CONDS);
    qual = emask && r_ok[row] &&
           eval_pred(pl, vlabel[leaf_c], vprops + (int64_t)leaf_c * nvp, nvp,
                     pl_bound + row * MAX_CONDS);
  }
  leaf_o[i] = leaf;
  scan_o[i] = scan;
  emask_o[i] = emask;
  qual_o[i] = qual;
}

static Pred make_pred(const int* p) {
  Pred q;
  q.label = p[0];
  q.n = p[1];
  for (int c = 0; c < MAX_CONDS; ++c) {
    q.lane[c] = p[2 + 5 * c];
    q.pid[c] = p[3 + 5 * c];
    q.op[c] = p[4 + 5 * c];
    q.val[c] = p[5 + 5 * c];
    q.wild[c] = p[6 + 5 * c];
  }
  return q;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

#define BG_PARAMS                                                                          \
  const void *indptr, const void *key, const void *other, const void *label,               \
      const void *alive, const void *props, const void *vlabel, const void *valive,        \
      const void *vprops, const void *csr_len, const void *blk_len, const void *roots,     \
      const void *lroot, const void *rvalid, const void *cvalid, const void *rmask,        \
      const void *r_ok, const void *pe_bound, const void *pl_bound, void *leaf, void *scan, \
      void *emask, void *qual, void *trunc, int B, int Vp, int EB, int v_cap, int nep,     \
      int nvp, int max_deg, int R, int edge_label, int pe0, int pe1, int pe2, int pe3,     \
      int pe4, int pe5, int pe6, int pe7, int pe8, int pe9, int pe10, int pe11, int pe12,  \
      int pe13, int pe14, int pe15, int pe16, int pl0, int pl1, int pl2, int pl3, int pl4, \
      int pl5, int pl6, int pl7, int pl8, int pl9, int pl10, int pl11, int pl12, int pl13, \
      int pl14, int pl15, int pl16, void *stream

#define BG_PREDS                                                                          \
  const int pe_i[17] = {pe0, pe1, pe2, pe3, pe4, pe5, pe6, pe7, pe8,                      \
                        pe9, pe10, pe11, pe12, pe13, pe14, pe15, pe16};                   \
  const int pl_i[17] = {pl0, pl1, pl2, pl3, pl4, pl5, pl6, pl7, pl8,                      \
                        pl9, pl10, pl11, pl12, pl13, pl14, pl15, pl16};

#define BG_POINTERS                                                                       \
  (const int32_t*)indptr, (const int32_t*)key, (const int32_t*)other,                    \
      (const int32_t*)label, (const uint8_t*)alive, (const int32_t*)props,               \
      (const int32_t*)vlabel, (const uint8_t*)valive, (const int32_t*)vprops,            \
      (const int32_t*)csr_len, (const int32_t*)blk_len, (const int32_t*)roots,           \
      (const int32_t*)lroot, (const uint8_t*)rvalid, (const uint8_t*)cvalid,             \
      (const uint8_t*)rmask, (const uint8_t*)r_ok, (const int32_t*)pe_bound,             \
      (const int32_t*)pl_bound, (int32_t*)leaf, (uint8_t*)scan, (uint8_t*)emask,         \
      (uint8_t*)qual, (uint8_t*)trunc

// ints: B, Vp, EB, v_cap, nep, nvp, max_deg, R, edge_label, then each
// predicate as label, n, and MAX_CONDS x (lane, pid, op, val, wild).
// Returns cudaGetLastError(), or cudaErrorInvalidValue when the recent
// window does not fit one CTA's shared memory (R above ~27,000).
extern "C" int block_gather_launch(BG_PARAMS) {
  const int W = max_deg + R;
  if (B <= 0 || W <= 0) return 0;
  BG_PREDS
  const size_t smem = (size_t)(2 * (R + ((R - 1) >> 5) + 1) + ((R + 31) >> 5) + 1) * 4;
  // the kernel's static arrays (s_root ... s_plb) count against the same
  // 48 KB default as the dynamic window
  const size_t statics = 4 * kRows * (4 + 2 * MAX_CONDS);
  if (smem + statics > 48 * 1024) {
    int dev, max_optin;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem + statics > (size_t)max_optin) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(block_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int vec = W % kLanes == 0 && aligned16(leaf) && aligned16(scan) && aligned16(emask) &&
                  aligned16(qual);
  const int blocks = (B + kRows - 1) / kRows;
  block_gather_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      BG_POINTERS, B, W, Vp, EB, v_cap, nep, nvp, max_deg, R, edge_label, vec,
      make_pred(pe_i), make_pred(pl_i));
  return (int)cudaGetLastError();
}

// The yardstick's launch: the same arguments.
extern "C" int block_gather_lane_launch(BG_PARAMS) {
  const int W = max_deg + R;
  const int64_t total = (int64_t)B * W;
  if (total <= 0) return 0;
  BG_PREDS
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  block_gather_lane_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      BG_POINTERS, total, W, Vp, EB, v_cap, nep, nvp, max_deg, R, edge_label,
      make_pred(pe_i), make_pred(pl_i));
  return (int)cudaGetLastError();
}
