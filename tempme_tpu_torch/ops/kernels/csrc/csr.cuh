// Lookups in the CSR temporal adjacency shared by the sampling kernels
// (sample_rows.cu, sample_union.cu, sample_masked.cu). Node v's entries are
// off[v]:off[v+1] of (ngh_node, ngh_eid, ngh_ts), sorted by time; the
// secondary arrays (bynb_ngh, bynb_eid, bynb_ts) hold the same slices sorted
// by (neighbour, time). Each lookup is a search, a chain of dependent loads:
// its cost is latency, not bandwidth. A warp's lane groups search together,
// W pivots a round (warp_lower_bound, log_{W+1}(degree) rounds where a
// bisect takes log2(degree) loads).
#pragma once

namespace csr {

// A warp's lane groups each search their own range at the same time: lanes
// [g * W, g * W + W) find the first index in [lo, hi) at which below(i) is
// false, where below is true and then false over the range (a lower bound;
// hi when below holds throughout). Each round the group's W lanes test W
// pivots that cut the range into W + 1 parts, vote with __ballot_sync, and
// keep the part in which below turns false; a range of at most W entries is
// tested whole and counted. So a range of n entries takes about
// log_{W+1}(n) rounds of one load each, where a bisect takes log_2(n).
// Every lane of the warp calls it, with lo, hi and below the same on the
// lanes of a group; a lane in no group (lanes 30 and 31 for W 5) passes
// lo == hi.
template <int W, class Below>
__device__ __forceinline__ int warp_lower_bound(int lo, int hi,
                                                const Below& below) {
  static_assert(W >= 1 && W < 32, "a lane group lies within one warp");
  const int lane = threadIdx.x & 31;
  const int rank = lane % W;
  const unsigned group = ((1u << W) - 1u) << (lane - rank);
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int n = hi - lo;
    // part j of W + 1 holds q + 1 entries for j < r, q for the others;
    // pivot j is the last entry of part j
    const int q = n / (W + 1), r = n % (W + 1);
    const bool whole = n <= W;
    const int pos =
        whole ? lo + rank : lo + (rank + 1) * q + min(rank + 1, r) - 1;
    const bool hit = (whole ? rank < n : true) && below(pos);
    const int c = __popc(__ballot_sync(0xffffffffu, hit) & group);
    if (whole) {
      lo += c;
      hi = lo;
    } else {
      // the answer lies after pivot c - 1 and at or before pivot c
      if (c < W) hi = lo + (c + 1) * q + min(c + 1, r) - 1;
      lo += c * q + min(c, r);
    }
  }
  return lo;
}

// below(i) of a time cut: the event at i is strictly before t
struct BeforeTime {
  const float* ts;
  float t;
  __device__ bool operator()(int i) const { return ts[i] < t; }
};

// clip(floor(u * total), 0, total - 1) in float32, the product rounded by
// __fmul_rn so that no contraction into an FMA changes a pick.
__device__ __forceinline__ int uniform_pick(float u, int total) {
  const float x = __fmul_rn(u, __int2float_rn(total));
  return min(max(static_cast<int>(floorf(x)), 0), total - 1);
}

}  // namespace csr
