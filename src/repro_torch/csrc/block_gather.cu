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
// label, the edge predicate, the leaf predicate and the root gate. Lane 0
// writes trunc = deg > max_deg.
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
// Design: one thread per (row, lane), rows laid out lane-contiguous, so a
// warp writes 32 neighbouring lanes of one row (coalesced) and reads one
// row's CSR window contiguously; the recent-region key window and the
// per-row inputs are shared by a row's lanes and come from L1/L2. Each
// lane stops reading as soon as its mask is false: a lane that is not
// scanned reads only the leaf id it must write. Staging the R-wide key
// window in shared memory once per block of rows is left to a later change.

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

__global__ void block_gather_kernel(
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
    // int32 wrap of lroot + 1, as the reference's int32 add
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

// ints: B, Vp, EB, v_cap, nep, nvp, max_deg, R, edge_label, then each
// predicate as label, n, and MAX_CONDS x (lane, pid, op, val, wild)
extern "C" int block_gather_launch(
    const void* indptr, const void* key, const void* other, const void* label,
    const void* alive, const void* props, const void* vlabel, const void* valive,
    const void* vprops, const void* csr_len, const void* blk_len, const void* roots,
    const void* lroot, const void* rvalid, const void* cvalid, const void* rmask,
    const void* r_ok, const void* pe_bound, const void* pl_bound,
    void* leaf, void* scan, void* emask, void* qual, void* trunc,
    int B, int Vp, int EB, int v_cap, int nep, int nvp, int max_deg, int R, int edge_label,
    int pe0, int pe1, int pe2, int pe3, int pe4, int pe5, int pe6, int pe7, int pe8,
    int pe9, int pe10, int pe11, int pe12, int pe13, int pe14, int pe15, int pe16,
    int pl0, int pl1, int pl2, int pl3, int pl4, int pl5, int pl6, int pl7, int pl8,
    int pl9, int pl10, int pl11, int pl12, int pl13, int pl14, int pl15, int pl16,
    void* stream) {
  const int W = max_deg + R;
  const int64_t total = (int64_t)B * W;
  if (total <= 0) return 0;
  const int pe_i[17] = {pe0, pe1, pe2, pe3, pe4, pe5, pe6, pe7, pe8,
                        pe9, pe10, pe11, pe12, pe13, pe14, pe15, pe16};
  const int pl_i[17] = {pl0, pl1, pl2, pl3, pl4, pl5, pl6, pl7, pl8,
                        pl9, pl10, pl11, pl12, pl13, pl14, pl15, pl16};
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  block_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)key, (const int32_t*)other,
      (const int32_t*)label, (const uint8_t*)alive, (const int32_t*)props,
      (const int32_t*)vlabel, (const uint8_t*)valive, (const int32_t*)vprops,
      (const int32_t*)csr_len, (const int32_t*)blk_len, (const int32_t*)roots,
      (const int32_t*)lroot, (const uint8_t*)rvalid, (const uint8_t*)cvalid,
      (const uint8_t*)rmask, (const uint8_t*)r_ok, (const int32_t*)pe_bound,
      (const int32_t*)pl_bound, (int32_t*)leaf, (uint8_t*)scan, (uint8_t*)emask,
      (uint8_t*)qual, (uint8_t*)trunc, total, W, Vp, EB, v_cap, nep, nvp, max_deg, R,
      edge_label, make_pred(pe_i), make_pred(pl_i));
  return (int)cudaGetLastError();
}
