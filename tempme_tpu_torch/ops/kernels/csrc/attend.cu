// Fused 1-query x n-key attention, eval and training forms, for sm_90a.
//
// Replaces the TPU kernels tempme_tpu/ops/pallas/kernels.py _attend_kernel
// (eval form) and _attend_drop_kernel (training form), entry fused_attend.
// For each (batch x query) row and each of its h heads:
//   s_j = scale * q . k_j, s_j = -1e10 where key j is masked,
//   p = softmax(s), [training form: p_j = u_j >= rate ? p_j / (1 - rate) : 0],
//   p *= explain_weight, out = sum_j p_j v_j,
// and both out and p are written. q, k and v are float32 or bf16 (the
// model's projections run in bf16 by default); the kernel is templated on
// their element type and does every sum in float32, as the Pallas body does
// (q_ref[:].astype(jnp.float32)). The training form takes the dropout draws
// u [m, h, n] from the caller, so the backward (attend_bwd.cu) sees the same
// mask. k and v are read in the layout the model makes them, [m, n, h, dk],
// so the head transpose that fused_attend materialises before its call is
// never made. The Pallas kernel's 128-row tiles and VMEM padding do not
// apply and are left out.
//
// Bound on the H100: bytes. Each k and v element is read once and used for
// two flops (about 2 flops a byte in bf16 against the card's balance of
// about 295), so tensor cores do not apply: the work is a batched GEMV with
// each row's own keys. At the explainer's hop level (m 2,000, n 20, h 2, dk
// 172, bf16) k and v are 55 MB, 16 us at 3.35 TB/s. What reaches that rate
// is enough bytes in flight on every SM, about 20-25 KB at the card's
// memory latency, in wide accesses.
//
// Design. One block of 352 threads (11 warps) takes one row with all its h
// heads. Key j of every head is one contiguous run of h * dk elements, so
// the row's k and v are two contiguous slabs of n * h * dk elements (13,760
// bytes each in bf16 at the shape above). Thread 0 starts both before
// anything else, one bulk asynchronous copy each (stage.cuh: cp.async.bulk
// completing on an mbarrier, where the base and the rows are 16-byte
// aligned; 8-, 4- or 2-byte words copied by the threads otherwise, a
// template parameter the launcher picks from the pointers and the row
// length), while the threads read q, the draws, the mask and the explain
// weight (once per row, shared by the heads). The n * h scores are then
// taken from shared memory, each warp four (key, head) pairs at once with
// its lanes across dk, the four sums reduced together in 6 shuffles; one
// warp per head does the softmax, dropout and weight; the value sum reads v
// from shared memory, one thread per element of [h, dk] (352 threads cover
// the paths' 344), four keys' loads ahead of their multiply-adds. A block
// holds about 29 KB of shared memory in bf16 (57 KB in float32) and at most
// 40 registers a thread (__launch_bounds__), so 4 blocks fit an SM, with up
// to 110 KB of loads in flight. What keeps it from the bound is each row's
// chain of latencies, the load and then the three phases in turn, which 4
// blocks an SM overlap only in part. A persistent block with a ring of two
// rows, one loading while the other is computed, was slower at these shapes
// and is not used. A row whose slabs do not fit the block's shared memory is
// done in tiles of keys: the scores over k tiles, then the value sum over v
// tiles (v's first tile is loaded with k's). Every sum is float32 in a fixed
// order; the results equal the earlier one-warp-per-(row, head) kernel's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "stage.cuh"

namespace {

// 11 warps: at the paths' shape (h 2, n 20, dk 172) one thread per element
// of [h, dk] and one group of kPairs (key, head) pairs per warp
constexpr int kThreads = 352;
constexpr int kBlocksPerSM = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 4;   // (key, head) pairs a warp reduces at once
static_assert(kPairs == 4, "reduce4 takes four pairs");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Floats of shared memory after the two tiles: q (then the value sums of
// a row done in tiles) [h * dk], scores then probabilities and the dropout
// draws [h * n each], the explain weight [n]; then the mask [n] bytes.
inline long long fixed_bytes(int h, int n, int dk) {
  return 4LL * (static_cast<long long>(h) * dk + 2LL * h * n + n) + n;
}

// The warp sums of four values at once, by halving exchanges (6 shuffles,
// not 20): lanes 8 g .. 8 g + 7 end with the sum of v[g] over the warp, in
// a fixed order.
__device__ __forceinline__ float reduce4(const float v[4], int lane) {
  const bool hi = lane & 16;
  float a0 = hi ? v[2] : v[0], a1 = hi ? v[3] : v[1];
  a0 += __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 16);
  a1 += __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 16);
  const bool odd = lane & 8;
  float c = odd ? a1 : a0;
  c += __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 8);
  for (int o = 4; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  return c;
}

// The scores of keys j0 .. j0 + cnt - 1 of every head from the staged k
// tile: each warp takes kPairs (key, head) pairs at once, its lanes across
// dk, and reduces them together (the same sums, in the same order, as one
// pair at a time).
template <typename T>
__device__ __forceinline__ void scores(const T* ks, const float* qs,
                                       const unsigned char* ms, float* ps,
                                       int h, int n, int dk, int j0, int cnt,
                                       float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pairs = cnt * h;                             // pr = jl * h + hd
  for (int base = warp; base < pairs; base += kWarps * kPairs) {
    float s[kPairs];
    int off[kPairs], qoff[kPairs];
#pragma unroll
    for (int g = 0; g < kPairs; ++g) {
      const int pr = min(base + g * kWarps, pairs - 1);
      s[g] = 0.0f;
      off[g] = pr * dk;
      qoff[g] = (pr % h) * dk;
    }
    for (int d = lane; d < dk; d += 32) {
#pragma unroll
      for (int g = 0; g < kPairs; ++g)
        if (base + g * kWarps < pairs)
          s[g] = fmaf(qs[qoff[g] + d], to_f32(ks[off[g] + d]), s[g]);
    }
    const float sg = reduce4(s, lane);
    const int pr = base + (lane >> 3) * kWarps;
    if ((lane & 7) == 0 && pr < pairs) {
      const int j = j0 + pr / h;
      ps[(pr % h) * n + j] = ms[j] ? -1e10f : sg * scale;
    }
  }
}

// acc + sum over jl < cnt of ph[jl] * vt[jl * hdk + e], in order of jl,
// four keys' loads issued ahead of their multiply-adds.
template <typename T>
__device__ __forceinline__ float value_sum(const float* ph, const T* vt,
                                           int hdk, int e, int cnt,
                                           float acc) {
  int jl = 0;
  for (; jl + 4 <= cnt; jl += 4) {
    float x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = to_f32(vt[(jl + c) * hdk + e]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc = fmaf(ph[jl + c], x[c], acc);
  }
  for (; jl < cnt; ++jl) acc = fmaf(ph[jl], to_f32(vt[jl * hdk + e]), acc);
  return acc;
}

template <typename T, bool kDrop, int kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const unsigned char* __restrict__ mask,
                  const float* __restrict__ ew, const float* __restrict__ u,
                  int h, int n, int dk, int nt, float scale, float rate,
                  float* __restrict__ out, float* __restrict__ attn) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[2];      // k's tile and v's tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hdk = h * dk;
  const long long tile = stage::round16(
      static_cast<long long>(nt) * hdk * static_cast<long long>(sizeof(T)));
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tile);
  float* qs = reinterpret_cast<float*>(smem + 2 * tile);
  float* ps = qs + hdk;
  float* us = ps + h * n;
  float* ews = us + h * n;
  unsigned char* ms = reinterpret_cast<unsigned char*>(ews + n);

  const long long mi = blockIdx.x;
  const T* krow = k + mi * n * hdk;
  const T* vrow = v + mi * n * hdk;
  const int tiles = (n + nt - 1) / nt;
  const uint32_t key_bytes = static_cast<uint32_t>(hdk * sizeof(T));
  // Thread 0 sets up the barriers and starts k's first tile and v's (the
  // whole row, where it fits) before anything else; meanwhile the threads
  // read q, the draws, the mask and the explain weight.
  stage::init<kVec>(bars, 2);
  const int first = min(nt, n);
  stage::load<kVec>(ks, krow, first * key_bytes, bars);
  stage::load<kVec>(vs, vrow, first * key_bytes, bars + 1);
  for (int e = threadIdx.x; e < hdk; e += kThreads)
    qs[e] = to_f32(q[mi * hdk + e]);
  if (kDrop)
    for (int j = threadIdx.x; j < h * n; j += kThreads)
      us[j] = u[mi * h * n + j];
  for (int j = threadIdx.x; j < n; j += kThreads) {
    ews[j] = ew != nullptr ? ew[mi * n + j] : 1.0f;
    ms[j] = mask != nullptr ? mask[mi * n + j] : 0;
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * nt, cnt = min(nt, n - j0);
    if (t > 0) {
      __syncthreads();
      stage::load<kVec>(ks, krow + static_cast<long long>(j0) * hdk,
                        cnt * key_bytes, bars);
    }
    stage::wait<kVec>(bars, t);
    scores(ks, qs, ms, ps, h, n, dk, j0, cnt, scale);
  }
  __syncthreads();

  for (int hd = warp; hd < h; hd += kWarps) {
    float* ph = ps + hd * n;
    float mx = __int_as_float(static_cast<int>(0xff800000u));  // -inf
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ph[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(ph[j] - mx);
      ph[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const long long r = mi * h + hd;
    for (int j = lane; j < n; j += 32) {
      float p = ph[j] / sum;
      if (kDrop) p = us[hd * n + j] >= rate ? p / (1.0f - rate) : 0.0f;
      if (ew != nullptr) p *= ews[j];
      ph[j] = p;
      attn[r * n + j] = p;
    }
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * nt, cnt = min(nt, n - j0);
    if (t > 0) {
      __syncthreads();
      stage::load<kVec>(vs, vrow + static_cast<long long>(j0) * hdk,
                        cnt * key_bytes, bars + 1);
    }
    stage::wait<kVec>(bars + 1, t);
    for (int e = threadIdx.x; e < hdk; e += kThreads) {
      const float acc = value_sum(ps + (e / dk) * n + j0, vs, hdk, e, cnt,
                                  t == 0 ? 0.0f : qs[e]);
      if (t == tiles - 1)
        out[mi * hdk + e] = acc;
      else
        qs[e] = acc;
    }
  }
}

template <typename T, bool kDrop, int kVec>
int launch_vec(const void* q, const void* k, const void* v, const void* mask,
               const void* ew, const void* u, int m, int h, int n, int dk,
               float scale, float rate, void* out, void* attn,
               cudaStream_t stream) {
  auto kernel = attend_kernel<T, kDrop, kVec>;
  static const int smem_max = stage::max_smem(kernel);
  const long long key = static_cast<long long>(h) * dk * sizeof(T);
  const long long fixed = stage::round16(fixed_bytes(h, n, dk));
  const long long nt =
      std::min<long long>(n, (smem_max - fixed - 32) / (2 * key));
  if (nt < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 2 * stage::round16(nt * key) + fixed;
  kernel<<<static_cast<unsigned>(m), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(ew), static_cast<const float*>(u), h, n, dk,
      static_cast<int>(nt), scale, rate, static_cast<float*>(out),
      static_cast<float*>(attn));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* ew, const void* u, int m, int h, int n, int dk,
           float scale, float rate, void* out, void* attn, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = stage::pick_vec(static_cast<long long>(h) * dk * sizeof(T),
                                  sizeof(T), {k, v});
  switch (vec) {
    case 16:
      return launch_vec<T, kDrop, 16>(q, k, v, mask, ew, u, m, h, n, dk,
                                      scale, rate, out, attn, s);
    case 8:
      return launch_vec<T, kDrop, 8>(q, k, v, mask, ew, u, m, h, n, dk,
                                     scale, rate, out, attn, s);
    case 4:
      return launch_vec<T, kDrop, 4>(q, k, v, mask, ew, u, m, h, n, dk,
                                     scale, rate, out, attn, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, kDrop, 2>(q, k, v, mask, ew, u, m, h, n, dk,
                                       scale, rate, out, attn, s);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 != 0: q, k and v are __nv_bfloat16, else float.
extern "C" int attend_launch(const void* q, const void* k, const void* v,
                             const void* mask, const void* ew, int m, int h,
                             int n, int dk, int bf16, float scale, void* out,
                             void* attn, void* stream) {
  return bf16 ? launch<__nv_bfloat16, false>(q, k, v, mask, ew, nullptr, m,
                                             h, n, dk, scale, 0.0f, out,
                                             attn, stream)
              : launch<float, false>(q, k, v, mask, ew, nullptr, m, h, n, dk,
                                     scale, 0.0f, out, attn, stream);
}

extern "C" int attend_drop_launch(const void* q, const void* k, const void* v,
                                  const void* mask, const void* ew,
                                  const void* u, int m, int h, int n, int dk,
                                  int bf16, float scale, float rate,
                                  void* out, void* attn, void* stream) {
  return bf16 ? launch<__nv_bfloat16, true>(q, k, v, mask, ew, u, m, h, n,
                                            dk, scale, rate, out, attn,
                                            stream)
              : launch<float, true>(q, k, v, mask, ew, u, m, h, n, dk, scale,
                                    rate, out, attn, stream);
}
