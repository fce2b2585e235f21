// Backward of the fused 1-query x n-key attention (attend.cu), both forms,
// for sm_90a.
//
// The TPU package has no backward kernel: its custom VJPs
// (tempme_tpu/ops/pallas/kernels.py _attend_core_bwd and
// _attend_core_drop_bwd) save only the inputs and re-run the jnp reference
// under jax.vjp. This kernel does the same rematerialisation by hand, so the
// probabilities and the [m, h, n] / [m, n, h, dk] intermediates of an
// autograd graph are never stored. Per (batch x query) row and head, with
// p = softmax(s), c_j = keep_j * ew_j (keep_j = 1, or in the training form
// (u_j >= rate) / (1 - rate)) and a_j = p_j * c_j:
//   dv_j = a_j * dout,
//   g_j  = (dout . v_j + dattn_j) * c_j,
//   ds_j = p_j * (g_j - sum_i p_i g_i), and 0 where key j is masked (the
//          forward's -1e10 fill is a constant),
//   dq   = scale * sum_j ds_j k_j,   dk_j = scale * ds_j * q,
//   dew_j = sum over the heads of p_j * keep_j * (dout . v_j + dattn_j),
//          when asked (the explain weight is shared by the heads).
// The draws get no gradient. q, k, v and dq, dk, dv are float32 or bf16
// (templated on the element type); every sum is float32, in a fixed order.
//
// Bound on the H100: bytes. It must read q, k, v and dout (plus the [m, n]
// mask, explain weight and draws) and write dq, dk and dv: at the
// explainer's hop level (m 2,000, n 20, h 2, dk 172, bf16) k, v, dk and dv
// are 110 MB, 33 us at 3.35 TB/s, at about 2 flops a byte.
//
// Design, as attend.cu's: one block takes one row with all its h heads, and
// thread 0 starts its k and v slabs (n * h * dk elements each) with one bulk
// asynchronous copy each (stage.cuh; narrower words where the base or a row
// is not 16-byte aligned) while the threads read q, dout, the draws, attn's
// cotangent, the mask and the explain weight; k is read once. Each warp
// takes four (key, head) pairs at once and computes s_j and dout . v_j from
// shared memory; one warp per head does the softmax's backward; the block,
// which owns every head of its row, sums the explain weight's gradient over
// the heads itself (head 0 first) and writes dew [m, n], with no atomics and
// no second launch. Then one thread per element of [h, dk] walks the keys:
// dq from the staged k, and dk and dv written over the k and v slabs in
// place, which go back to global memory by one bulk store each (a bulk
// asynchronous copy from shared memory). Blocks are 192 threads with at most
// 56 registers each; a bf16 row needs about 32 KB of shared memory (59 KB in
// float32), so 6 blocks fit an SM, up to 165 KB of loads in flight. A row
// whose slabs do not fit is done in tiles of keys: the first pass over k and
// v tiles, the second over the tiles in reverse, so the last tile is still
// staged and only the other tiles' k is read again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "stage.cuh"

namespace {

constexpr int kThreads = 192;
constexpr int kBlocksPerSM = 6;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 4;   // (key, head) pairs a warp reduces at once
static_assert(kPairs == 4, "reduce4 takes four pairs");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// Floats of shared memory after the two tiles: q, dout and dq's partial
// sums [h * dk each]; scores then probabilities, a, dout . v then g then
// scale * ds, the explain weight's per-head terms, the dropout draws and
// attn's cotangent [h * n each]; the explain weight [n]; then the mask [n]
// bytes.
inline long long fixed_bytes(int h, int n, int dk) {
  return 4LL * (3LL * h * dk + 6LL * h * n + n) + n;
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

// s_j = scale * q . k_j (-1e10 where masked) and dout . v_j for keys j0 ..
// j0 + cnt - 1 of every head from the staged tiles: each warp takes kPairs
// (key, head) pairs at once, its lanes across dk, and reduces them together
// (the same sums, in the same order, as one pair at a time).
template <typename T>
__device__ __forceinline__ void scores(const T* ks, const T* vs,
                                       const float* qs, const float* gos,
                                       const unsigned char* ms, float* ps,
                                       float* gs, int h, int n, int dk,
                                       int j0, int cnt, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pairs = cnt * h;                             // pr = jl * h + hd
  for (int base = warp; base < pairs; base += kWarps * kPairs) {
    float s[kPairs], o[kPairs];
    int off[kPairs], qoff[kPairs];
#pragma unroll
    for (int g = 0; g < kPairs; ++g) {
      const int pr = min(base + g * kWarps, pairs - 1);
      s[g] = 0.0f;
      o[g] = 0.0f;
      off[g] = pr * dk;
      qoff[g] = (pr % h) * dk;
    }
    for (int d = lane; d < dk; d += 32) {
#pragma unroll
      for (int g = 0; g < kPairs; ++g) {
        if (base + g * kWarps < pairs) {
          s[g] = fmaf(qs[qoff[g] + d], to_f32(ks[off[g] + d]), s[g]);
          o[g] = fmaf(gos[qoff[g] + d], to_f32(vs[off[g] + d]), o[g]);
        }
      }
    }
    const float sg = reduce4(s, lane), og = reduce4(o, lane);
    const int pr = base + (lane >> 3) * kWarps;
    if ((lane & 7) == 0 && pr < pairs) {
      const int j = j0 + pr / h, at = (pr % h) * n + j;
      ps[at] = ms[j] ? -1e10f : sg * scale;
      gs[at] = og;
    }
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    attend_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ ew,
                      const float* __restrict__ u, int h, int n, int dk,
                      int nt, float scale, float rate,
                      const float* __restrict__ dout,
                      const float* __restrict__ dattn, T* __restrict__ dq,
                      T* __restrict__ dkey, T* __restrict__ dval,
                      float* __restrict__ dew) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[2];      // k's tile and v's tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hdk = h * dk, hn = h * n;
  const long long tile = stage::round16(
      static_cast<long long>(nt) * hdk * static_cast<long long>(sizeof(T)));
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tile);
  float* qs = reinterpret_cast<float*>(smem + 2 * tile);
  float* gos = qs + hdk;     // dout
  float* accs = gos + hdk;   // dq's partial sums over the tiles done
  float* ps = accs + hdk;    // scores, then probabilities
  float* as = ps + hn;       // a_j = p_j c_j
  float* gs = as + hn;       // dout . v_j, then g_j, then scale * ds_j
  float* dws = gs + hn;      // the explain weight's per-head terms
  float* us = dws + hn;      // the dropout draws
  float* das = us + hn;      // attn's cotangent
  float* ews = das + hn;
  unsigned char* ms = reinterpret_cast<unsigned char*>(ews + n);

  const long long mi = blockIdx.x;
  const long long row = mi * n * hdk;
  const int tiles = (n + nt - 1) / nt;
  const uint32_t key_bytes = static_cast<uint32_t>(hdk * sizeof(T));
  // Thread 0 sets up the barriers and starts k's first tile and v's (the
  // whole row, where it fits) before anything else; meanwhile the threads
  // read q, dout, the draws, attn's cotangent, the mask and the weight.
  stage::init<kVec>(bars, 2);
  const int first = min(nt, n);
  stage::load<kVec>(ks, k + row, first * key_bytes, bars);
  stage::load<kVec>(vs, v + row, first * key_bytes, bars + 1);
  for (int e = threadIdx.x; e < hdk; e += kThreads) {
    qs[e] = to_f32(q[mi * hdk + e]);
    gos[e] = dout[mi * hdk + e];
  }
  for (int j = threadIdx.x; j < hn; j += kThreads) {
    us[j] = u != nullptr ? u[mi * hn + j] : 1.0f;
    das[j] = dattn != nullptr ? dattn[mi * hn + j] : 0.0f;
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    ews[j] = ew != nullptr ? ew[mi * n + j] : 1.0f;
    ms[j] = mask != nullptr ? mask[mi * n + j] : 0;
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * nt, cnt = min(nt, n - j0);
    if (t > 0) {
      __syncthreads();
      const long long at = row + static_cast<long long>(j0) * hdk;
      stage::load<kVec>(ks, k + at, cnt * key_bytes, bars);
      stage::load<kVec>(vs, v + at, cnt * key_bytes, bars + 1);
    }
    stage::wait<kVec>(bars, t);
    stage::wait<kVec>(bars + 1, t);
    scores(ks, vs, qs, gos, ms, ps, gs, h, n, dk, j0, cnt, scale);
  }
  __syncthreads();

  for (int hd = warp; hd < h; hd += kWarps) {
    float* ph = ps + hd * n;
    float* ah = as + hd * n;
    float* gh = gs + hd * n;
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
    float pg = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float p = ph[j] / sum;
      float keep = 1.0f;
      if (u != nullptr)
        keep = us[hd * n + j] >= rate ? 1.0f / (1.0f - rate) : 0.0f;
      const float c = ew != nullptr ? keep * ews[j] : keep;
      float g = gh[j];
      if (dattn != nullptr) g += das[hd * n + j];
      dws[hd * n + j] = p * keep * g;
      g *= c;
      ph[j] = p;
      ah[j] = p * c;
      gh[j] = g;
      pg = fmaf(p, g, pg);
    }
    pg = warp_sum(pg);
    for (int j = lane; j < n; j += 32)
      gh[j] = ms[j] ? 0.0f : scale * ph[j] * (gh[j] - pg);
  }
  __syncthreads();

  if (dew != nullptr) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      float s = 0.0f;
      for (int hd = 0; hd < h; ++hd) s += dws[hd * n + j];
      dew[mi * n + j] = s;
    }
  }

  // dq, dk and dv, the tiles in reverse: the last one is still staged
  for (int t = tiles - 1; t >= 0; --t) {
    const int j0 = t * nt, cnt = min(nt, n - j0);
    const long long at = row + static_cast<long long>(j0) * hdk;
    if (t < tiles - 1) {
      stage::load<kVec>(ks, k + at, cnt * key_bytes, bars);
      stage::wait<kVec>(bars, tiles + (tiles - 2 - t));
    }
    for (int e = threadIdx.x; e < hdk; e += kThreads) {
      const int hd = e / dk;
      const float* dsh = gs + hd * n + j0;
      const float* ah = as + hd * n + j0;
      const float qe = qs[e], ge = gos[e];
      float acc = t == tiles - 1 ? 0.0f : accs[e];
      int jl = 0;
      for (; jl + 4 <= cnt; jl += 4) {
        float x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) x[c] = to_f32(ks[(jl + c) * hdk + e]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int y = (jl + c) * hdk + e;
          acc = fmaf(dsh[jl + c], x[c], acc);
          ks[y] = from_f32<T>(dsh[jl + c] * qe);
          vs[y] = from_f32<T>(ah[jl + c] * ge);
        }
      }
      for (; jl < cnt; ++jl) {
        const int y = jl * hdk + e;
        acc = fmaf(dsh[jl], to_f32(ks[y]), acc);
        ks[y] = from_f32<T>(dsh[jl] * qe);
        vs[y] = from_f32<T>(ah[jl] * ge);
      }
      if (t == 0)
        dq[mi * hdk + e] = from_f32<T>(acc);
      else
        accs[e] = acc;
    }
    stage::before_store<kVec>();
    stage::store<kVec>(dkey + at, ks, cnt * key_bytes);
    stage::store<kVec>(dval + at, vs, cnt * key_bytes);
    stage::after_store<kVec>();
  }
}

template <typename T, int kVec>
int launch_vec(const void* q, const void* k, const void* v, const void* mask,
               const void* ew, const void* u, int m, int h, int n, int dk,
               float scale, float rate, const void* dout, const void* dattn,
               void* dq, void* dkey, void* dval, void* dew,
               cudaStream_t stream) {
  auto kernel = attend_bwd_kernel<T, kVec>;
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
      static_cast<int>(nt), scale, rate, static_cast<const float*>(dout),
      static_cast<const float*>(dattn), static_cast<T*>(dq),
      static_cast<T*>(dkey), static_cast<T*>(dval),
      static_cast<float*>(dew));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* ew, const void* u, int m, int h, int n, int dk,
           float scale, float rate, const void* dout, const void* dattn,
           void* dq, void* dkey, void* dval, void* dew, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = stage::pick_vec(static_cast<long long>(h) * dk * sizeof(T),
                                  sizeof(T), {k, v, dkey, dval});
  switch (vec) {
    case 16:
      return launch_vec<T, 16>(q, k, v, mask, ew, u, m, h, n, dk, scale, rate,
                               dout, dattn, dq, dkey, dval, dew, s);
    case 8:
      return launch_vec<T, 8>(q, k, v, mask, ew, u, m, h, n, dk, scale, rate,
                              dout, dattn, dq, dkey, dval, dew, s);
    case 4:
      return launch_vec<T, 4>(q, k, v, mask, ew, u, m, h, n, dk, scale, rate,
                              dout, dattn, dq, dkey, dval, dew, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, 2>(q, k, v, mask, ew, u, m, h, n, dk, scale,
                                rate, dout, dattn, dq, dkey, dval, dew, s);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 != 0: q, k, v, dq, dk and dv are __nv_bfloat16, else float. dew is
// null, or the float [m, n] gradient of the explain weight (summed over the
// heads in the kernel).
extern "C" int attend_bwd_launch(const void* q, const void* k, const void* v,
                                 const void* mask, const void* ew,
                                 const void* u, int m, int h, int n, int dk,
                                 int bf16, float scale, float rate,
                                 const void* dout, const void* dattn,
                                 void* dq, void* dkey, void* dval, void* dew,
                                 void* stream) {
  return bf16 ? launch<__nv_bfloat16>(q, k, v, mask, ew, u, m, h, n, dk,
                                      scale, rate, dout, dattn, dq, dkey,
                                      dval, dew, stream)
              : launch<float>(q, k, v, mask, ew, u, m, h, n, dk, scale, rate,
                              dout, dattn, dq, dkey, dval, dew, stream);
}
