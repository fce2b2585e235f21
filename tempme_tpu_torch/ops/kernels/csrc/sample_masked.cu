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
// One warp per query (node_a, node_b, eid_cut, va1, va2, vb1, wildcard, u).
// The candidates are
//   * wildcard rows: every event of a's and b's histories strictly before
//     edge eid_cut's time: two time lower bounds (the e-path cut of
//     ops/sampler.py cut_by_edge), searched together by two groups of 16
//     lanes;
//   * other rows: a's events with neighbour va1 or va2 and b's events with
//     neighbour vb1, before the same time: three (neighbour, time) ranges of
//     the secondary CSR, each two lower bounds, the six searched together
//     by six groups of 5 lanes;
// a side is empty where its node or eid_cut is 0 (the clamped ids on
// wildcard rows, clamped to the tables, the given ones on the others).
// With m_a and m_b the two sides' counts, r = clip(floor(u * (m_a + m_b)),
// 0, total - 1) picks a's candidate r or b's candidate r - m_a, read from
// ngh_* (wildcard rows) or bynb_* (the others). Nothing is read where no
// candidate exists; the outputs are then zero and found is false.
//
// Bound on the H100: bytes, and in practice latency. Per query it reads
// eight inputs, an edge time, offsets, the searches' probes and one table
// entry of three arrays, and writes five outputs: under a microsecond of
// the card's memory rate. Its time is the longest chain of dependent loads.
// The walks run through popular nodes (degree 28,332 on the
// wikipedia-shaped stream), where one thread's six bisects in a row made a
// chain of about 90 loads; the lane groups' searches (csr::warp_lower_bound)
// take 6 rounds at that degree, 2 at the median, each probe's neighbour and
// time loaded together. Q 6,000 queries are 6,000 warps, one wave.
#include <cuda_runtime.h>

#include "csr.cuh"

namespace {

constexpr int kWarps = 4;  // queries a block

// below(i) of the secondary CSR: (neighbour, time) at i is below (x, t);
// both loads are issued before either is used
struct BelowPair {
  const int* ngh;
  const float* ts;
  int x;
  float t;
  __device__ bool operator()(int i) const {
    const int nm = ngh[i];
    const float tm = ts[i];
    return (nm < x) | ((nm == x) & (tm < t));
  }
};

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
  const int qi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qi >= q) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int a = node_a[qi], b = node_b[qi], e = eid_cut[qi];
  const bool wild = wildcard[qi] != 0;
  const float uq = u[qi];  // loaded with the query, not after the searches
  const int ec = min(max(e, 0), num_edges - 1);
  const float t_cut = edge_ts[ec];
  const int na = min(max(a, 0), num_nodes - 1);
  const int nb = min(max(b, 0), num_nodes - 1);
  // a's m_a candidates: [lo_a1, lo_a1 + cnt_a1), then [lo_a2, ...); b's
  // m_b: [lo_b1, lo_b1 + m_b) (on wildcard rows lo_a1 and lo_b1 are the
  // histories' starts and cnt_a1 is m_a)
  int lo_a1, cnt_a1, lo_a2, lo_b1, m_a, m_b;
  if (wild) {
    // lanes 0-15: a's history, lanes 16-31: b's
    const int v = lane < 16 ? na : nb;
    const int start = off[v];
    const int end = v == 0 || ec == 0 ? start : off[v + 1];
    const int cnt = csr::warp_lower_bound<16>(
                        start, end, csr::BeforeTime{ngh_ts, t_cut}) -
                    start;
    lo_a1 = __shfl_sync(0xffffffffu, start, 0);
    lo_b1 = __shfl_sync(0xffffffffu, start, 16);
    m_a = __shfl_sync(0xffffffffu, cnt, 0);
    m_b = __shfl_sync(0xffffffffu, cnt, 16);
    cnt_a1 = m_a;
    lo_a2 = 0;
  } else {
    // group g of lanes 5g..5g+4: the lower bound of (va1, -inf), (va1,
    // t_cut), (va2, -inf), (va2, t_cut) in a's slice, (vb1, -inf), (vb1,
    // t_cut) in b's; lanes 30 and 31 idle
    const int g = lane / 5;
    const bool on_b = g >= 4;
    const bool live = g < 6 && (on_b ? b : a) != 0 && e != 0;
    const int v = on_b ? nb : na;
    int lo = 0, hi = 0, x = 0;
    if (live) {
      lo = off[v];
      hi = off[v + 1];
      x = g < 2 ? va1[qi] : g < 4 ? va2[qi] : vb1[qi];
    }
    const float t = (g & 1) ? t_cut
                            : __int_as_float(static_cast<int>(0xff800000u));
    const int at = csr::warp_lower_bound<5>(
        lo, hi, BelowPair{bynb_ngh, bynb_ts, x, t});
    lo_a1 = __shfl_sync(0xffffffffu, at, 0);
    cnt_a1 = __shfl_sync(0xffffffffu, at, 5) - lo_a1;
    lo_a2 = __shfl_sync(0xffffffffu, at, 10);
    m_a = cnt_a1 + __shfl_sync(0xffffffffu, at, 15) - lo_a2;
    lo_b1 = __shfl_sync(0xffffffffu, at, 20);
    m_b = __shfl_sync(0xffffffffu, at, 25) - lo_b1;
  }
  const int total = m_a + m_b;
  if (total == 0) {
    if (lane == 0) {
      out_src[qi] = 0;
      out_ngh[qi] = 0;
      out_eid[qi] = 0;
      out_ts[qi] = 0.0f;
      out_found[qi] = 0;
    }
    return;
  }
  const int r = csr::uniform_pick(uq, total);
  const bool from_a = r < m_a;
  const int local = from_a ? r : r - m_a;
  const int pos = !from_a ? lo_b1 + local
                  : local < cnt_a1 ? lo_a1 + local
                                   : lo_a2 + (local - cnt_a1);
  // the pick's three entries are read by three lanes at once
  if (lane == 0) {
    out_src[qi] = from_a ? a : b;
    out_found[qi] = 1;
  } else if (lane == 1) {
    out_ngh[qi] = (wild ? ngh_node : bynb_ngh)[pos];
  } else if (lane == 2) {
    out_eid[qi] = (wild ? ngh_eid : bynb_eid)[pos];
  } else if (lane == 3) {
    out_ts[qi] = (wild ? ngh_ts : bynb_ts)[pos];
  }
}

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
    sample_masked_kernel<<<(q + kWarps - 1) / kWarps, 32 * kWarps, 0,
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
