// Walk -> edge scatter-max and its backward, for sm_90a.
//
// Replaces the TPU kernel tempme_tpu/ops/pallas/kernels.py _w2e_kernel
// (call _w2e_pallas_local, entry walk_to_edge_max) and the jnp VJP it uses
// (_w2e_bwd through tempme_tpu/ops/segment.py walk_to_edge_max_jnp):
//   out[b, t] = max_s (ids[b, s] == tgt[b, t] ? imp[b, s] : 0),
// the explainer's walk importance carried onto each support edge (0 where no
// walk slot carries it; the 0 fill of the non-matching slots takes part in
// the max). The [B, T, S] comparison tensor is never materialised: the
// Pallas kernel keeps it in VMEM tiles; here the forward never forms it and
// the backward keeps it in registers.
//
// Forward: fewer steps than compares. A block takes one row and up to 256
// of its targets, a thread each, and builds in shared memory a table of the
// row's distinct slot ids (open addressing, linear probing, at least twice
// the slots): an id's entry holds its slots' largest importance, kept as an
// order-preserving integer by atomicMax, the number n of its slots and,
// after a second pass over the slots, the number c of them that equal that
// max. A target then takes one lookup: with n slots carrying its id at max
// m, the S - n others hold the 0 fill, so
//   out = n == S ? m : max(m, 0),
//   cnt = [m == out] c + [out == 0] (S - n),
// and out = 0, cnt = S where no slot carries it. Max and integer counts
// do not depend on the order of the atomics, so out is the plain version's
// max bit for bit and cnt (the number of slots that attain it, which the
// backward divides by) is exact. The work is B * (S + T) steps in place of
// the B * T * S compares; the table takes 20 bytes an entry and 4 a slot,
// so a row of up to 4,096 slots fits a block's shared memory (the
// explainer's rows hold 180). Each thread loads its target and its first
// slot before the table is cleared, so those loads overlap the clearing.
// A row of more slots (9 x n_degree above 4,096, n_degree above 455) takes
// the scan path instead: the block stages the row's slots in shared memory
// 2,048 at a time and each thread keeps its target's running max and the
// number of slots that reach it, the B * T * S compares in full. Max and
// count again do not depend on the order, so both paths give the plain
// version's out and cnt exactly.
// (Measured slower: a group of 8 to 32 lanes scanning every slot for each
// target and merging (max, count) pairs by shuffles, 2x at T 400; 1,024
// targets a block, 10%; 128 threads a block, 30%; warp-aggregated
// atomics by __match_any_sync, 2x.)
//
// Backward: the max's VJP as JAX's reduce-max defines it, which splits the
// cotangent evenly over every slot that attains the max, non-matching slots
// whose 0 fill ties with it included:
//   g_imp[b, s] = sum_t [ids[b,s] == tgt[b,t]] [imp[b,s] == out[b,t]]
//                       * ct[b, t] / cnt[b, t].
// A block takes one batch row and 32 of its slots, one slot a lane, so a
// row's slots fill ceil(S / 32) blocks (B 100 rows at S 180: 600 blocks on
// the 132 SMs). The row's (target, max) pairs and ct / cnt are staged in
// shared memory once per block; each of up to 8 warps scans its own
// contiguous share of the T targets for its 32 slots, every load a
// broadcast of one address to the warp, and the block then adds the warps'
// partial sums in warp order. Each slot owns its output, so no atomics are
// used, and the order of the sums is fixed: every launch on the same inputs
// gives the same bits.
//
// Bound on the H100: the forward moves each slot's id and importance and
// each target once and writes out and cnt, about 0.6 MB at the explainer's
// largest shape (B 100, S 180, T 400): 0.19 us at the card's memory rate;
// its time is the chain of the table's three phases, each ended by a
// barrier. The backward's bound is the B * T * S compares at the card's
// integer rate, 1.3 us at that shape; it moves only hundreds of KB, and
// its warps' chains of at most 32 targets each up to T 256 and T / 8
// above set its time. Up to 8 warps a block keep the 600 blocks of the
// explainer's shape in one wave on 132 SMs (13 warps at T 400 left room for
// 4 blocks an SM).
#include <climits>
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;  // and targets a block
constexpr int kMaxTableSlots = 4096;  // rows above take the scan path
constexpr int kScanTile = 2048;       // slots staged a round by the scan
constexpr unsigned long long kEmpty = ~0ull;   // no id: ids are 32-bit

// an int whose order is the float's order (-0 just below +0)
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// the row's table of distinct slot ids: open addressing, linear probing
struct IdTable {
  unsigned long long* keys;
  int mask, shift;

  __device__ unsigned home(int id) const {
    return (static_cast<unsigned>(id) * 0x9e3779b1u) >> shift;
  }
  __device__ int insert(int id) const {
    const unsigned long long k = static_cast<unsigned>(id);
    for (unsigned e = home(id);; e = (e + 1) & mask) {
      const unsigned long long prev = atomicCAS(&keys[e], kEmpty, k);
      if (prev == kEmpty || prev == k) return static_cast<int>(e);
    }
  }
  __device__ int find(int id) const {
    const unsigned long long k = static_cast<unsigned>(id);
    for (unsigned e = home(id);; e = (e + 1) & mask) {
      const unsigned long long cur = keys[e];
      if (cur == k) return static_cast<int>(e);
      if (cur == kEmpty) return -1;
    }
  }
};

__global__ void w2e_fwd_kernel(const int* __restrict__ ids,
                               const float* __restrict__ imp,
                               const int* __restrict__ tgt, int s_len,
                               int t_len, int log2_h, float* __restrict__ out,
                               int* __restrict__ cnt) {
  extern __shared__ unsigned long long smem64[];
  const int h = 1 << log2_h;
  const IdTable table{smem64, h - 1, 32 - log2_h};
  int* top = reinterpret_cast<int*>(smem64 + h);  // [h] order key of the max
  int* n_id = top + h;                            // [h] slots with the id
  int* n_top = n_id + h;                          // [h] slots at the max
  int* slot_e = n_top + h;                        // [s_len] slot's entry
  const long long b = blockIdx.x;
  const int t = blockIdx.y * kFwdThreads + threadIdx.x;
  // this thread's target and first slot, loaded before the table is cleared
  const int x = t < t_len ? tgt[b * t_len + t] : 0;
  const bool own = threadIdx.x < s_len;
  const int id0 = own ? ids[b * s_len + threadIdx.x] : 0;
  const float w0 = own ? imp[b * s_len + threadIdx.x] : 0.0f;
  for (int e = threadIdx.x; e < h; e += kFwdThreads) {
    smem64[e] = kEmpty;
    top[e] = INT_MIN;
    n_id[e] = 0;
    n_top[e] = 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < s_len; s += kFwdThreads) {
    const bool first = s == threadIdx.x;
    const int e = table.insert(first ? id0 : ids[b * s_len + s]);
    slot_e[s] = e;
    atomicMax(&top[e], order_key(first ? w0 : imp[b * s_len + s]));
    atomicAdd(&n_id[e], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < s_len; s += kFwdThreads) {
    const int e = slot_e[s];
    const float w = s == threadIdx.x ? w0 : imp[b * s_len + s];
    if (w == from_order_key(top[e])) atomicAdd(&n_top[e], 1);
  }
  __syncthreads();
  if (t >= t_len) return;
  // the matching slots' max m_id, reached by c_id of their n slots; the
  // S - n others hold the 0 fill
  const int e = table.find(x);
  const int n = e < 0 ? 0 : n_id[e];
  float m = 0.0f;
  int c = s_len - n;
  if (n > 0) {
    const float m_id = from_order_key(top[e]);
    const int c_id = n_top[e];
    if (n == s_len) {
      m = m_id;
      c = c_id;
    } else {
      m = fmaxf(m_id, 0.0f);
      c = (m_id == m ? c_id : 0) + (m == 0.0f ? s_len - n : 0);
    }
  }
  out[b * t_len + t] = m;
  cnt[b * t_len + t] = c;
}

// The scan path for rows of more than kMaxTableSlots slots: each thread
// compares its target with every slot of the row, staged in tiles.
__global__ void w2e_fwd_scan_kernel(const int* __restrict__ ids,
                                    const float* __restrict__ imp,
                                    const int* __restrict__ tgt, int s_len,
                                    int t_len, float* __restrict__ out,
                                    int* __restrict__ cnt) {
  __shared__ int sid[kScanTile];
  __shared__ float simp[kScanTile];
  const long long b = blockIdx.x;
  const int t = blockIdx.y * kFwdThreads + threadIdx.x;
  const int x = t < t_len ? tgt[b * t_len + t] : 0;
  float m = -INFINITY;
  int c = 0;
  for (int s0 = 0; s0 < s_len; s0 += kScanTile) {
    const int len = min(kScanTile, s_len - s0);
    __syncthreads();
    for (int s = threadIdx.x; s < len; s += kFwdThreads) {
      sid[s] = ids[b * s_len + s0 + s];
      simp[s] = imp[b * s_len + s0 + s];
    }
    __syncthreads();
    for (int s = 0; s < len; ++s) {
      const float v = sid[s] == x ? simp[s] : 0.0f;
      if (v > m) {
        m = v;
        c = 1;
      } else if (v == m) {
        ++c;
      }
    }
  }
  if (t >= t_len) return;
  out[b * t_len + t] = m;
  cnt[b * t_len + t] = c;
}

constexpr int kBwdMaxWarps = 8;

__global__ void w2e_bwd_kernel(const int* __restrict__ ids,
                               const float* __restrict__ imp,
                               const int* __restrict__ tgt,
                               const float* __restrict__ out,
                               const int* __restrict__ cnt,
                               const float* __restrict__ ct, int s_len,
                               int t_len, float* __restrict__ g_imp) {
  extern __shared__ unsigned char smem[];
  // [t_len] (target id, max) pairs, [t_len] ct / cnt, [warps][32] partials
  int2* skey = reinterpret_cast<int2*>(smem);
  float* sw = reinterpret_cast<float*>(skey + t_len);
  float* part = sw + t_len;
  const long long b = blockIdx.x;
  for (int t = threadIdx.x; t < t_len; t += blockDim.x) {
    const long long i = b * t_len + t;
    skey[t] = make_int2(tgt[i], __float_as_int(out[i]));
    sw[t] = ct[i] / static_cast<float>(cnt[i]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int s = blockIdx.y * 32 + lane;
  const bool live = s < s_len;
  const int id = live ? ids[b * s_len + s] : 0;
  const float x = live ? imp[b * s_len + s] : 0.0f;
  __syncthreads();
  const int share = (t_len + warps - 1) / warps;
  const int t1 = min(t_len, (warp + 1) * share);
  float acc = 0.0f;
#pragma unroll 4
  for (int t = warp * share; t < t1; ++t) {
    const int2 k = skey[t];
    if (k.x == id && __int_as_float(k.y) == x) acc += sw[t];
  }
  part[warp * 32 + lane] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    float sum = part[lane];
    for (int w = 1; w < warps; ++w) sum += part[w * 32 + lane];
    g_imp[b * s_len + s] = sum;
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
  }
  return 0;
}

}  // namespace

extern "C" int w2e_fwd_launch(const void* ids, const void* imp,
                              const void* tgt, int b, int s_len, int t_len,
                              void* out, void* cnt, void* stream) {
  if (b > 0 && t_len > 0 && s_len > kMaxTableSlots) {
    const dim3 grid(b, (t_len + kFwdThreads - 1) / kFwdThreads);
    w2e_fwd_scan_kernel<<<grid, kFwdThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(imp),
        static_cast<const int*>(tgt), s_len, t_len, static_cast<float*>(out),
        static_cast<int*>(cnt));
  } else if (b > 0 && t_len > 0) {
    int log2_h = 1;  // a table of at least twice the slots
    while ((1 << log2_h) < 2 * s_len) ++log2_h;
    const size_t h = size_t{1} << log2_h;
    const size_t smem = (sizeof(unsigned long long) + 3 * sizeof(int)) * h +
                        sizeof(int) * s_len;
    const int err = set_smem(reinterpret_cast<const void*>(w2e_fwd_kernel),
                             smem);
    if (err != 0) return err;
    const dim3 grid(b, (t_len + kFwdThreads - 1) / kFwdThreads);
    w2e_fwd_kernel<<<grid, kFwdThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(imp),
        static_cast<const int*>(tgt), s_len, t_len, log2_h,
        static_cast<float*>(out), static_cast<int*>(cnt));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int w2e_bwd_launch(const void* ids, const void* imp,
                              const void* tgt, const void* out,
                              const void* cnt, const void* ct, int b,
                              int s_len, int t_len, void* g_imp,
                              void* stream) {
  if (b > 0 && s_len > 0) {
    // a warp for each 32 targets, up to 8 warps
    const int warps = min(kBwdMaxWarps, max(1, (t_len + 31) / 32));
    const size_t smem = (sizeof(int2) + sizeof(float)) * t_len +
                        sizeof(float) * 32 * warps;
    const int err = set_smem(reinterpret_cast<const void*>(w2e_bwd_kernel),
                             smem);
    if (err != 0) return err;
    const dim3 grid(b, (s_len + 31) / 32);
    w2e_bwd_kernel<<<grid, 32 * warps, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(imp),
        static_cast<const int*>(tgt), static_cast<const float*>(out),
        static_cast<const int*>(cnt), static_cast<const float*>(ct), s_len,
        t_len, static_cast<float*>(g_imp));
  }
  return static_cast<int>(cudaGetLastError());
}
