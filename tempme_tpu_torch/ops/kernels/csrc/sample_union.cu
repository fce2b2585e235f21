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
// One warp per query (node_a, node_b, eid_cut) with n draws u:
//   * lane j < n loads draw j with the query's ids, before the chain;
//   * cut_a and cut_b count each node's events strictly before edge
//     eid_cut's timestamp: two lower bounds, searched at the same time by
//     lanes 0-15 (side a) and lanes 16-31 (side b), each group a 17-ary
//     search (csr::warp_lower_bound<16>: 16 pivots a round, one load each);
//     a side is empty where its node or eid_cut is 0 (the e-path cut of
//     ops/sampler.py cut_by_edge; the ids clamped to the tables first, as
//     the reference's gathers clamp them);
//   * each side's start and count reach every lane by shuffles, and lane j
//     makes pick j (j = lane, lane + 32, ... for n > 32):
//     r = clip(floor(u * (cut_a + cut_b)), 0, total - 1), the product
//     rounded by __fmul_rn;
//   * the event is a's entry r if r < cut_a, else b's entry r - cut_a, and
//     lane j writes (src, ngh, eid, ts) of that event at q * n + j, the
//     lanes on consecutive addresses: src is the node whose history it came
//     from; all zeros where the union is empty.
// Outputs are bit-identical to the JAX CSR branch given the same draws.
//
// Bound on the H100: bytes, and in practice latency. Per query it reads
// three ids, the edge time, four offsets, about log2(degree + 1)
// timestamps per side (a bisect's probes), n draws and 3n table entries,
// and writes 4n outputs; the arithmetic is a few integer operations. Its
// time is one query's chain of dependent loads: the ids and draws, then
// the edge time and offsets, then the search, then the gathers. The
// search takes ceil(log17(degree + 1)) rounds where a bisect takes log2,
// both sides at once: 4 rounds in place of two chains of 15 at the
// wikipedia-shaped stream's hub (degree 28,332), 1 for a slice of at most
// 16 events. A warp a query, 4 a block, spreads Q 2,000 over 500 blocks
// where a thread a query filled 16.
#include <cuda_runtime.h>

#include "csr.cuh"

namespace {

constexpr int kWarps = 4;  // queries a block

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
  const int qi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qi >= q) return;  // warp-uniform: the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(qi) * n;
  const float u0 = lane < n ? u[row + lane] : 0.0f;  // before the chain
  const int a = node_a[qi], b = node_b[qi];
  const int ec = min(max(eid_cut[qi], 0), num_edges - 1);
  // lanes 0-15: a's history, lanes 16-31: b's
  const int v = min(max(lane < 16 ? a : b, 0), num_nodes - 1);
  const int lo = off[v];
  const int hi = v == 0 || ec == 0 ? lo : off[v + 1];
  const int end = csr::warp_lower_bound<16>(
      lo, hi, csr::BeforeTime{ngh_ts, edge_ts[ec]});
  const int start_a = __shfl_sync(0xffffffffu, lo, 0);
  const int start_b = __shfl_sync(0xffffffffu, lo, 16);
  const int cut_a = __shfl_sync(0xffffffffu, end, 0) - start_a;
  const int total = cut_a + __shfl_sync(0xffffffffu, end, 16) - start_b;
  for (int j = lane; j < n; j += 32) {
    const long long o = row + j;
    if (total == 0) {
      out_src[o] = 0;
      out_ngh[o] = 0;
      out_eid[o] = 0;
      out_ts[o] = 0.0f;
      continue;
    }
    const int r = csr::uniform_pick(j == lane ? u0 : u[o], total);
    const bool from_a = r < cut_a;
    const int pos = from_a ? start_a + r : start_b + (r - cut_a);
    out_src[o] = from_a ? a : b;
    out_ngh[o] = ngh_node[pos];
    out_eid[o] = ngh_eid[pos];
    out_ts[o] = ngh_ts[pos];
  }
}

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
    sample_union_kernel<<<(q + kWarps - 1) / kWarps, 32 * kWarps, 0,
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
