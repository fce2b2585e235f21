// Walk event 2: n uniform picks from the union of two edge-cut histories,
// for sm_90a.
//
// Replaces the TPU kernel tempme_tpu/ops/pallas/sample_kernel.py
// _sample_union_kernel (call _sample_union_call, entry sample_union), and
// computes what the JAX package's CSR branch computes
// (tempme_tpu/ops/sampler.py _union_uniform_sample). The Pallas kernel keeps
// dense [N, C] copies of the adjacency in VMEM; here each query reads the
// CSR directly (csr.cuh), so one kernel covers every graph size.
//
// One thread per query (node_a, node_b, eid_cut) with n draws u:
//   * cut_a and cut_b count each node's events strictly before edge
//     eid_cut's timestamp, two bisects; a side is empty where its node or
//     eid_cut is 0;
//   * per draw r = clip(floor(u * (cut_a + cut_b)), 0, total - 1), with the
//     product rounded by __fmul_rn;
//   * the event is a's entry r if r < cut_a, else b's entry r - cut_a, and
//     the outputs are (src, ngh, eid, ts) of that event: src is the node
//     whose history it came from; all zeros where the union is empty.
// Outputs are bit-identical to the JAX CSR branch given the same draws.
//
// Bound on the H100: bytes, and in practice latency. Per query it reads
// three ids, two edge times (one, cached), four offsets, about
// log2(degree) timestamps per side, n draws and 3n table entries, and
// writes 4n outputs; the arithmetic is a few integer operations. The two
// bisects are chains of dependent loads, which one thread per query keeps
// in flight across many queries at once.
#include <cuda_runtime.h>

#include "csr.cuh"

namespace {

__global__ void sample_union_kernel(const int* __restrict__ off,
                                    const int* __restrict__ ngh_node,
                                    const int* __restrict__ ngh_eid,
                                    const float* __restrict__ ngh_ts,
                                    const float* __restrict__ edge_ts,
                                    const int* __restrict__ node_a,
                                    const int* __restrict__ node_b,
                                    const int* __restrict__ eid_cut,
                                    const float* __restrict__ u, int q, int n,
                                    int num_nodes, int num_edges,
                                    int* __restrict__ out_src,
                                    int* __restrict__ out_ngh,
                                    int* __restrict__ out_eid,
                                    float* __restrict__ out_ts) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int a = node_a[qi], b = node_b[qi], e = eid_cut[qi];
  const csr::Cut ca = csr::edge_cut(off, ngh_ts, edge_ts, a, e, num_nodes,
                                    num_edges);
  const csr::Cut cb = csr::edge_cut(off, ngh_ts, edge_ts, b, e, num_nodes,
                                    num_edges);
  const int total = ca.count + cb.count;
  const long long row = static_cast<long long>(qi) * n;
  for (int j = 0; j < n; ++j) {
    const long long o = row + j;
    if (total == 0) {
      out_src[o] = 0;
      out_ngh[o] = 0;
      out_eid[o] = 0;
      out_ts[o] = 0.0f;
      continue;
    }
    const int r = csr::uniform_pick(u[o], total);
    const bool from_a = r < ca.count;
    const int pos = from_a ? ca.start + r : cb.start + (r - ca.count);
    out_src[o] = from_a ? a : b;
    out_ngh[o] = ngh_node[pos];
    out_eid[o] = ngh_eid[pos];
    out_ts[o] = ngh_ts[pos];
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int sample_union_launch(const void* off, const void* ngh_node,
                                   const void* ngh_eid, const void* ngh_ts,
                                   const void* edge_ts, const void* node_a,
                                   const void* node_b, const void* eid_cut,
                                   const void* u, int q, int n, int num_nodes,
                                   int num_edges, void* out_src,
                                   void* out_ngh, void* out_eid,
                                   void* out_ts, void* stream) {
  if (q > 0) {
    sample_union_kernel<<<(q + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(off), static_cast<const int*>(ngh_node),
        static_cast<const int*>(ngh_eid), static_cast<const float*>(ngh_ts),
        static_cast<const float*>(edge_ts), static_cast<const int*>(node_a),
        static_cast<const int*>(node_b), static_cast<const int*>(eid_cut),
        static_cast<const float*>(u), q, n, num_nodes, num_edges,
        static_cast<int*>(out_src), static_cast<int*>(out_ngh),
        static_cast<int*>(out_eid), static_cast<float*>(out_ts));
  }
  return static_cast<int>(cudaGetLastError());
}
