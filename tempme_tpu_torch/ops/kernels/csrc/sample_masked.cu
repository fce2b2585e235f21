// Walk event 3: one pick from the union of two edge-cut histories,
// restricted to candidate neighbours, for sm_90a.
//
// Replaces the TPU kernel tempme_tpu/ops/pallas/sample_kernel.py
// _sample_masked_kernel (call _sample_masked_call, entry
// sample_masked_union). The Pallas kernel takes a Gumbel argmax over each
// node's whole padded row, O(max_degree) per query; this kernel ports the
// JAX package's CSR branch instead (tempme_tpu/ops/sampler.py
// _masked_union_sample, from :454), which counts the candidates exactly in
// O(log degree) and picks one uniformly, and is bit-identical to that
// branch given the same draw. (On graphs small enough for the TPU's VMEM
// gate the Pallas kernel draws with Gumbel noise, so from the same key it
// picks another candidate, equally uniform.)
//
// One thread per query (node_a, node_b, eid_cut, va1, va2, vb1, wildcard,
// u). The candidates are
//   * wildcard rows: every event of a's and b's histories strictly before
//     edge eid_cut's time (two time-CSR bisects, csr::edge_cut);
//   * other rows: a's events with neighbour va1 or va2 and b's events with
//     neighbour vb1, before the same time: three (neighbour, time) ranges of
//     the secondary CSR, each two bisects (csr::lower_bound_nb);
// a side is empty where its node or eid_cut is 0. With m_a and m_b the two
// sides' counts, r = clip(floor(u * (m_a + m_b)), 0, total - 1) picks a's
// candidate r or b's candidate r - m_a, read from ngh_* (wildcard rows) or
// bynb_* (the others). Nothing is read where no candidate exists; the
// outputs are then zero and found is false.
//
// Bound on the H100: bytes, and in practice latency. Per query it reads
// eight inputs, two edge times, offsets and up to six bisects' probes
// (about log2(degree) each), and one table entry of three arrays, and
// writes five outputs. The bisects are chains of dependent loads; one
// thread per query keeps many chains in flight.
#include <cuda_runtime.h>

#include "csr.cuh"

namespace {

__global__ void sample_masked_kernel(
    const int* __restrict__ off, const int* __restrict__ ngh_node,
    const int* __restrict__ ngh_eid, const float* __restrict__ ngh_ts,
    const int* __restrict__ bynb_ngh, const int* __restrict__ bynb_eid,
    const float* __restrict__ bynb_ts, const float* __restrict__ edge_ts,
    const int* __restrict__ node_a, const int* __restrict__ node_b,
    const int* __restrict__ eid_cut, const int* __restrict__ va1,
    const int* __restrict__ va2, const int* __restrict__ vb1,
    const unsigned char* __restrict__ wildcard, const float* __restrict__ u,
    int q, int num_nodes, int num_edges, int* __restrict__ out_src,
    int* __restrict__ out_ngh, int* __restrict__ out_eid,
    float* __restrict__ out_ts, unsigned char* __restrict__ out_found) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int a = node_a[qi], b = node_b[qi], e = eid_cut[qi];
  const bool wild = wildcard[qi] != 0;
  // start_a/b and cnt_* are only read on the branch that sets them
  int start_a = 0, start_b = 0, lo_a1 = 0, lo_a2 = 0, lo_b1 = 0, cnt_a1 = 0;
  int m_a, m_b;
  if (wild) {
    const csr::Cut ca = csr::edge_cut(off, ngh_ts, edge_ts, a, e, num_nodes,
                                      num_edges);
    const csr::Cut cb = csr::edge_cut(off, ngh_ts, edge_ts, b, e, num_nodes,
                                      num_edges);
    start_a = ca.start;
    start_b = cb.start;
    m_a = ca.count;
    m_b = cb.count;
  } else {
    const int ec = min(max(e, 0), num_edges - 1);
    const float t_cut = edge_ts[ec];
    const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
    const int na = min(max(a, 0), num_nodes - 1);
    const int nb = min(max(b, 0), num_nodes - 1);
    m_a = m_b = 0;
    if (a != 0 && e != 0) {
      lo_a1 = csr::lower_bound_nb(off, bynb_ngh, bynb_ts, na, va1[qi],
                                  neg_inf);
      cnt_a1 = csr::lower_bound_nb(off, bynb_ngh, bynb_ts, na, va1[qi],
                                   t_cut) - lo_a1;
      lo_a2 = csr::lower_bound_nb(off, bynb_ngh, bynb_ts, na, va2[qi],
                                  neg_inf);
      m_a = cnt_a1 + csr::lower_bound_nb(off, bynb_ngh, bynb_ts, na, va2[qi],
                                         t_cut) - lo_a2;
    }
    if (b != 0 && e != 0) {
      lo_b1 = csr::lower_bound_nb(off, bynb_ngh, bynb_ts, nb, vb1[qi],
                                  neg_inf);
      m_b = csr::lower_bound_nb(off, bynb_ngh, bynb_ts, nb, vb1[qi], t_cut) -
            lo_b1;
    }
  }
  const int total = m_a + m_b;
  if (total == 0) {
    out_src[qi] = 0;
    out_ngh[qi] = 0;
    out_eid[qi] = 0;
    out_ts[qi] = 0.0f;
    out_found[qi] = 0;
    return;
  }
  const int r = csr::uniform_pick(u[qi], total);
  const bool from_a = r < m_a;
  const int local = from_a ? r : r - m_a;
  if (wild) {
    const int pos = (from_a ? start_a : start_b) + local;
    out_ngh[qi] = ngh_node[pos];
    out_eid[qi] = ngh_eid[pos];
    out_ts[qi] = ngh_ts[pos];
  } else {
    const int pos = !from_a ? lo_b1 + local
                    : local < cnt_a1 ? lo_a1 + local
                                     : lo_a2 + (local - cnt_a1);
    out_ngh[qi] = bynb_ngh[pos];
    out_eid[qi] = bynb_eid[pos];
    out_ts[qi] = bynb_ts[pos];
  }
  out_src[qi] = from_a ? a : b;
  out_found[qi] = 1;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int sample_masked_launch(
    const void* off, const void* ngh_node, const void* ngh_eid,
    const void* ngh_ts, const void* bynb_ngh, const void* bynb_eid,
    const void* bynb_ts, const void* edge_ts, const void* node_a,
    const void* node_b, const void* eid_cut, const void* va1, const void* va2,
    const void* vb1, const void* wildcard, const void* u, int q,
    int num_nodes, int num_edges, void* out_src, void* out_ngh,
    void* out_eid, void* out_ts, void* out_found, void* stream) {
  if (q > 0) {
    sample_masked_kernel<<<(q + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(off), static_cast<const int*>(ngh_node),
        static_cast<const int*>(ngh_eid), static_cast<const float*>(ngh_ts),
        static_cast<const int*>(bynb_ngh), static_cast<const int*>(bynb_eid),
        static_cast<const float*>(bynb_ts),
        static_cast<const float*>(edge_ts), static_cast<const int*>(node_a),
        static_cast<const int*>(node_b), static_cast<const int*>(eid_cut),
        static_cast<const int*>(va1), static_cast<const int*>(va2),
        static_cast<const int*>(vb1),
        static_cast<const unsigned char*>(wildcard),
        static_cast<const float*>(u), q, num_nodes, num_edges,
        static_cast<int*>(out_src), static_cast<int*>(out_ngh),
        static_cast<int*>(out_eid), static_cast<float*>(out_ts),
        static_cast<unsigned char*>(out_found));
  }
  return static_cast<int>(cudaGetLastError());
}
