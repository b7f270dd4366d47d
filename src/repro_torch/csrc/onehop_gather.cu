// One-hop gather + predicate filter over a CSR, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/onehop_gather/kernel.py
// (onehop_gather_pallas, body _onehop_kernel). For each root it reads the
// CSR window [start, start + deg) padded to max_deg and keeps a lane when
// eprop == edge_val, vprop[leaf] == leaf_val and root >= 0; kept lanes carry
// the leaf id, the rest -1. Bit-identical to
// repro_torch/kernels/onehop_gather/ref.py, including JAX's index rules:
// a root or leaf index wraps once if negative and then clamps into [0, V),
// and the edge position clamps into [0, E). No read goes out of bounds.
//
// What bounds it on this card: bytes. Each live lane reads 8 B of edge data
// (dst, eprop) and 4 B of vertex data, and every lane writes 5 B; at the
// main path's 512 roots x 64 lanes that is well under a megabyte, so one
// launch costs its launch latency.
//
// Design: one thread per (root, lane). Consecutive threads walk one root's
// window, so the dst/eprop loads of a warp coalesce into a few sectors; the
// vprop lookup of each leaf is a scattered 4-B read. Lanes past the degree,
// and roots < 0, read nothing beyond the root's own row.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int jax_index(int i, int n) {
  long long j = i < 0 ? (long long)i + n : (long long)i;
  return j < 0 ? 0 : (j >= n ? n - 1 : (int)j);
}

__global__ void onehop_gather_kernel(
    const int32_t* __restrict__ start, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ eprop,
    const int32_t* __restrict__ vprop, const int32_t* __restrict__ roots,
    int32_t* __restrict__ leaves, uint8_t* __restrict__ mask,
    int n_roots, int n_vertices, int n_edges, int max_deg, int edge_val,
    int leaf_val) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_roots * max_deg) return;
  const int b = (int)(idx / max_deg);
  const int k = (int)(idx - (long long)b * max_deg);
  const int32_t r = roots[b];
  int32_t leaf = -1;
  uint8_t ok = 0;
  if (r >= 0) {
    const int rc = jax_index(r, n_vertices);
    if (k < deg[rc]) {
      // int32 add with wrap-around, as the reference's jnp arithmetic
      int p = (int)((uint32_t)start[rc] + (uint32_t)k);
      p = p < 0 ? 0 : (p >= n_edges ? n_edges - 1 : p);
      if (eprop[p] == edge_val) {
        const int32_t l = dst[p];
        if (vprop[jax_index(l, n_vertices)] == leaf_val) {
          ok = 1;
          leaf = l;
        }
      }
    }
  }
  leaves[idx] = leaf;
  mask[idx] = ok;
}

extern "C" int onehop_gather_launch(
    const void* start, const void* deg, const void* dst, const void* eprop,
    const void* vprop, const void* roots, void* leaves, void* mask,
    int n_roots, int n_vertices, int n_edges, int max_deg, int edge_val,
    int leaf_val, void* stream) {
  const long long n = (long long)n_roots * max_deg;
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  onehop_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)start, (const int32_t*)deg, (const int32_t*)dst,
      (const int32_t*)eprop, (const int32_t*)vprop, (const int32_t*)roots,
      (int32_t*)leaves, (uint8_t*)mask, n_roots, n_vertices, n_edges, max_deg,
      edge_val, leaf_val);
  return (int)cudaGetLastError();
}
