// Backward of the fused 1-query x n-key attention (attend.cu), both forms,
// for sm_90a.
//
// The TPU package has no backward kernel: its custom VJPs
// (tempme_tpu/ops/pallas/kernels.py _attend_core_bwd and
// _attend_core_drop_bwd) save only the inputs and re-run the jnp reference
// under jax.vjp. This kernel does the same rematerialisation by hand, so the
// probabilities and the [m, h, n] / [m, n, h, dk] intermediates of an
// autograd graph are never stored. One row is one (batch x query, head)
// pair. With p = softmax(s), c_j = keep_j * ew_j (keep_j = 1, or in the
// training form (u_j >= rate) / (1 - rate)) and a_j = p_j * c_j:
//   dv_j = a_j * dout,
//   g_j  = (dout . v_j + dattn_j) * c_j,
//   ds_j = p_j * (g_j - sum_i p_i g_i), and 0 where key j is masked (the
//          forward's -1e10 fill is a constant),
//   dq   = scale * sum_j ds_j k_j,   dk_j = scale * ds_j * q,
//   dew_j (per head) = p_j * keep_j * (dout . v_j + dattn_j), when asked.
// Each row owns its slices of dq, dk, dv and of the explain weight's
// per-head partials [m, h, n], whose sum over the heads (the weight is
// shared by them) the wrapper takes: no atomics, and the result does not
// depend on the order in which rows run. The draws get no gradient. q, k, v
// and dq, dk, dv are float32 or bf16 (templated on the element type); every
// sum is float32.
//
// One warp per row, lanes across dk (coalesced rows of k, v, dk and dv, read
// and written through strides in the [m, n, h, dk] layout). Pass 1 reads k
// and v once for the scores and dout . v_j (two warp-shuffle sums per key);
// pass 2 reads k again for dq and writes dk and dv. Shared memory per warp:
// q and dout (dk each), p, a and ds (n each).
//
// Bound on the H100: bytes. It must read q, k, v and dout (plus the [m, n]
// mask, explain weight and draws) and write dq, dk and dv; at the hop level
// (10,240 rows, n 20, dk 172) k, v, dk and dv are 564 MB in float32, about
// 0.17 ms at 3.35 TB/s, and half that in bf16. This first version reads k twice and does the reductions one
// key at a time; it is simple and right, not yet fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;

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

template <typename T>
__global__ void attend_bwd_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ ew,
                                  const float* __restrict__ u,
                                  int m, int h, int n, int dk, float scale,
                                  float rate,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ dattn,
                                  T* __restrict__ dq,
                                  T* __restrict__ dkey,
                                  T* __restrict__ dval,
                                  float* __restrict__ dew) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= static_cast<long long>(m) * h) return;  // warp-uniform
  const long long mi = r / h;
  const int hi = static_cast<int>(r % h);
  float* qs = smem + warp * (2 * dk + 3 * n);
  float* gos = qs + dk;      // dout row
  float* ps = gos + dk;      // scores, then probabilities
  float* as = ps + n;        // a_j = p_j c_j
  float* gs = as + n;        // dout . v_j, then g_j, then scale * ds_j

  for (int d = lane; d < dk; d += 32) {
    qs[d] = to_f32(q[r * dk + d]);
    gos[d] = dout[r * dk + d];
  }
  __syncwarp();

  const long long kstride = static_cast<long long>(h) * dk;   // key j -> j+1
  const long long base = mi * n * kstride + static_cast<long long>(hi) * dk;
  const T* kb = k + base;
  const T* vb = v + base;
  for (int j = 0; j < n; ++j) {
    const T* kr = kb + j * kstride;
    const T* vr = vb + j * kstride;
    float s = 0.0f, t = 0.0f;
    for (int d = lane; d < dk; d += 32) {
      s = fmaf(qs[d], to_f32(kr[d]), s);
      t = fmaf(gos[d], to_f32(vr[d]), t);
    }
    s = warp_sum(s) * scale;
    t = warp_sum(t);
    if (lane == 0) {
      if (mask != nullptr && mask[mi * n + j]) s = -1e10f;
      ps[j] = s;
      gs[j] = t;
    }
  }
  __syncwarp();

  float mx = __int_as_float(static_cast<int>(0xff800000u));  // -inf
  for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[j]);
  mx = warp_max(mx);
  float sum = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(ps[j] - mx);
    ps[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  float pg = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float p = ps[j] / sum;
    float keep = 1.0f;
    if (u != nullptr)
      keep = u[r * n + j] >= rate ? 1.0f / (1.0f - rate) : 0.0f;
    const float c = ew != nullptr ? keep * ew[mi * n + j] : keep;
    float g = gs[j];
    if (dattn != nullptr) g += dattn[r * n + j];
    if (dew != nullptr) dew[r * n + j] = p * keep * g;
    g *= c;
    ps[j] = p;
    as[j] = p * c;
    gs[j] = g;
    pg = fmaf(p, g, pg);
  }
  pg = warp_sum(pg);
  for (int j = lane; j < n; j += 32) {
    const bool masked = mask != nullptr && mask[mi * n + j];
    gs[j] = masked ? 0.0f : scale * ps[j] * (gs[j] - pg);
  }
  __syncwarp();

  for (int d = lane; d < dk; d += 32) {
    const float qd = qs[d], god = gos[d];
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      const long long at = base + j * kstride + d;
      acc = fmaf(gs[j], to_f32(k[at]), acc);
      dkey[at] = from_f32<T>(gs[j] * qd);
      dval[at] = from_f32<T>(as[j] * god);
    }
    dq[r * dk + d] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* ew, const void* u, int m, int h, int n, int dk,
           float scale, float rate, const void* dout, const void* dattn,
           void* dq, void* dkey, void* dval, void* dew, void* stream) {
  const long long rows = static_cast<long long>(m) * h;
  if (rows > 0) {
    const size_t smem = sizeof(float) * kWarps * (2 * dk + 3 * n);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(attend_bwd_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    const long long blocks = (rows + kWarps - 1) / kWarps;
    attend_bwd_kernel<T><<<static_cast<unsigned>(blocks), 32 * kWarps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
        static_cast<const float*>(ew), static_cast<const float*>(u), m, h, n,
        dk, scale, rate, static_cast<const float*>(dout),
        static_cast<const float*>(dattn), static_cast<T*>(dq),
        static_cast<T*>(dkey), static_cast<T*>(dval),
        static_cast<float*>(dew));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: q, k, v, dq, dk and dv are __nv_bfloat16, else float. dew is
// null, or the float [m, h, n] per-head partials of the explain weight's
// gradient.
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
