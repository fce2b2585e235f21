// Lookups in the CSR temporal adjacency shared by the sampling kernels
// (sample_rows.cu, sample_union.cu, sample_masked.cu). Node v's entries are
// off[v]:off[v+1] of (ngh_node, ngh_eid, ngh_ts), sorted by time; the
// secondary arrays (bynb_ngh, bynb_eid, bynb_ts) hold the same slices sorted
// by (neighbour, time). Each lookup is a bisect, a chain of dependent loads:
// its cost is latency, not bandwidth.
#pragma once

namespace csr {

// First index in [lo, hi) whose timestamp is not below t (bisect_left): the
// count of node v's events strictly before t is the result minus off[v].
__device__ __forceinline__ int lower_bound_ts(const float* __restrict__ ts,
                                             int lo, int hi, float t) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ts[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The e-path cut of ops/sampler.py cut_by_edge: node v's events strictly
// before edge e's timestamp. Ids are clamped to the tables, as the
// reference's gathers clamp; node 0 or edge 0 (padding) forces an empty cut.
struct Cut {
  int start;  // off[v]
  int count;  // events strictly before the cut time
};

__device__ __forceinline__ Cut edge_cut(const int* __restrict__ off,
                                        const float* __restrict__ ngh_ts,
                                        const float* __restrict__ edge_ts,
                                        int node, int eid, int num_nodes,
                                        int num_edges) {
  const int v = min(max(node, 0), num_nodes - 1);
  const int e = min(max(eid, 0), num_edges - 1);
  const int start = off[v];
  if (v == 0 || e == 0) return Cut{start, 0};
  return Cut{start, lower_bound_ts(ngh_ts, start, off[v + 1], edge_ts[e]) -
                        start};
}

// First index in node v's slice of the secondary arrays whose (neighbour,
// time) is not below (x, t): the entries of neighbour x strictly before t
// are [lower_bound_nb(v, x, -inf), lower_bound_nb(v, x, t)).
__device__ __forceinline__ int lower_bound_nb(
    const int* __restrict__ off, const int* __restrict__ bynb_ngh,
    const float* __restrict__ bynb_ts, int v, int x, float t) {
  int lo = off[v], hi = off[v + 1];
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int nm = bynb_ngh[mid];
    if (nm < x || (nm == x && bynb_ts[mid] < t)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// clip(floor(u * total), 0, total - 1) in float32, the product rounded by
// __fmul_rn so that no contraction into an FMA changes a pick.
__device__ __forceinline__ int uniform_pick(float u, int total) {
  const float x = __fmul_rn(u, __int2float_rn(total));
  return min(max(static_cast<int>(floorf(x)), 0), total - 1);
}

}  // namespace csr
