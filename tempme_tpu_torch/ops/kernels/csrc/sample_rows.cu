// k=1 temporal neighbour sampling over the CSR adjacency, for sm_90a.
//
// Replaces the TPU kernel tempme_tpu/ops/pallas/sample_kernel.py
// (_sample_rows_kernel, entry sample_rows). The Pallas kernel keeps a dense
// [N, C] copy of the adjacency in VMEM and fetches rows by one-hot matmuls;
// here each query reads the CSR directly, so one kernel covers every graph
// size.
//
// One warp per query (node v, cut time t, optional edge id e):
//   * t = edge_ts[e] when edge ids are given, and the row is forced empty
//     when v == 0 or e == 0 (the e-path rule of ops/sampler.py cut_by_edge);
//   * cut = bisect_left of t over ngh_ts[off[v]:off[v+1]] (events strictly
//     before t), searched by lanes 0-30 as a 32-ary lower bound
//     (csr::warp_lower_bound: 31 pivots a round, one load each);
//   * pick j = clip(floor(u[j] * cut), 0, cut - 1), with the product rounded
//     by __fmul_rn so no contraction changes a pick;
//   * the picks are ranked (ties by index), which sorts them as the
//     reference sorts its picks, and each lane writes (node, eid, ts) at
//     its pick's rank, the lanes on consecutive addresses; all zeros where
//     cut == 0. Up to 32 picks are ranked by shuffles, one a lane (3-8%
//     faster than the shared-memory loop at the paths' n 20); more, in
//     shared memory (4 n bytes a warp, opted in above 48 KB a block).
//
// Bound on the H100: bytes. Per query it reads two offsets, the search's
// probes, n draws and 3n table entries, and writes 3n outputs; the
// arithmetic is negligible. Its time is one query's chain of dependent
// loads: the query's ids, then its edge time and offsets, then the search,
// then the gathers. The draws u are loaded with the query, before the
// chain, and the search takes ceil(log32(degree + 1)) rounds where a
// bisect takes log2: 3 in place of 15 at the wikipedia-shaped stream's hub
// (degree 28,332), 1 for a slice of at most 31 events. (Two queries a warp
// in 16-lane halves measured slower at every shape the paths run.)
#include <cuda_runtime.h>

#include "csr.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void sample_rows_kernel(const int* __restrict__ off,
                                   const int* __restrict__ ngh_node,
                                   const int* __restrict__ ngh_eid,
                                   const float* __restrict__ ngh_ts,
                                   const float* __restrict__ edge_ts,
                                   const int* __restrict__ nodes,
                                   const float* __restrict__ times,
                                   const int* __restrict__ eids,
                                   const float* __restrict__ u,
                                   int q, int n, int num_nodes, int num_edges,
                                   int* __restrict__ out_node,
                                   int* __restrict__ out_eid,
                                   float* __restrict__ out_ts) {
  extern __shared__ int picks_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // warp-uniform: the whole warp leaves together
  const long long row = static_cast<long long>(qi) * n;
  const float u0 = lane < n ? u[row + lane] : 0.0f;  // before the chain

  // lanes 0-30 search; lane 31 passes an empty range
  int lo = 0, hi = 0;
  float t = 0.0f;
  if (lane < 31) {
    const int v = min(max(nodes[qi], 0), num_nodes - 1);
    if (eids != nullptr) {
      const int e = min(max(eids[qi], 0), num_edges - 1);
      t = edge_ts[e];
      lo = off[v];
      hi = v == 0 || e == 0 ? lo : off[v + 1];
    } else {
      t = times[qi];
      lo = off[v];
      hi = off[v + 1];
    }
  }
  const int end = csr::warp_lower_bound<31>(lo, hi,
                                            csr::BeforeTime{ngh_ts, t});
  const int start = __shfl_sync(0xffffffffu, lo, 0);
  const int cut = __shfl_sync(0xffffffffu, end, 0) - start;
  // (node, eid, ts) of pick p at output o; zeros where the cut is empty
  const auto put = [&](int p, long long o) {
    if (cut > 0) {
      const int pos = start + p;
      out_node[o] = ngh_node[pos];
      out_eid[o] = ngh_eid[pos];
      out_ts[o] = ngh_ts[pos];
    } else {
      out_node[o] = 0;
      out_eid[o] = 0;
      out_ts[o] = 0.0f;
    }
  };

  if (n <= 32) {
    // a pick a lane, ranked by shuffles
    const int p = lane < n && cut > 0 ? csr::uniform_pick(u0, cut) : 0;
    int rank = 0;
    for (int i = 0; i < n; ++i) {
      const int o = __shfl_sync(0xffffffffu, p, i);
      rank += (o < p) || (o == p && i < lane);
    }
    if (lane < n) put(p, row + rank);
    return;
  }
  int* picks = picks_all + warp * n;
  for (int j = lane; j < n; j += 32) {
    const float uj = j == lane ? u0 : u[row + j];
    picks[j] = cut > 0 ? csr::uniform_pick(uj, cut) : 0;
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    const int p = picks[j];
    int rank = 0;
    for (int i = 0; i < n; ++i) {
      const int o = picks[i];
      rank += (o < p) || (o == p && i < j);
    }
    put(p, row + rank);
  }
}

}  // namespace

extern "C" int sample_rows_launch(const void* off, const void* ngh_node,
                                  const void* ngh_eid, const void* ngh_ts,
                                  const void* edge_ts, const void* nodes,
                                  const void* times, const void* eids,
                                  const void* u, int q, int n, int num_nodes,
                                  int num_edges, void* out_node, void* out_eid,
                                  void* out_ts, void* stream) {
  if (q > 0) {
    const int blocks = (q + kWarps - 1) / kWarps;
    // above 48 KB (n > 3,072) the kernel must opt in to its shared memory;
    // past the card's limit (about 14,500 picks on the H100) the launch
    // fails and the error is returned
    const size_t smem = n <= 32 ? 0 : sizeof(int) * kWarps * n;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sample_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sample_rows_kernel<<<blocks, 32 * kWarps, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(off), static_cast<const int*>(ngh_node),
        static_cast<const int*>(ngh_eid), static_cast<const float*>(ngh_ts),
        static_cast<const float*>(edge_ts), static_cast<const int*>(nodes),
        static_cast<const float*>(times), static_cast<const int*>(eids),
        static_cast<const float*>(u), q, n, num_nodes, num_edges,
        static_cast<int*>(out_node), static_cast<int*>(out_eid),
        static_cast<float*>(out_ts));
  }
  return static_cast<int>(cudaGetLastError());
}
