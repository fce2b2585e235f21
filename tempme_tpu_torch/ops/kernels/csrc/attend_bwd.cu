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
//   dq   = scale * sum_j ds_j k_j,   dk_j = scale * ds_j * q.
// Each row owns its slices of dq, dk and dv, so no atomics are needed. The
// explain weight and the draws get no gradient here.
//
// One warp per row, lanes across dk (coalesced rows of k, v, dk and dv, read
// and written through strides in the [m, n, h, dk] layout). Pass 1 reads k
// and v once for the scores and dout . v_j (two warp-shuffle sums per key);
// pass 2 reads k again for dq and writes dk and dv. Shared memory per warp:
// q and dout (dk each), p, a and ds (n each).
//
// Bound on the H100: bytes. It must read q, k, v and dout (plus the [m, n]
// mask, explain weight and draws) and write dq, dk and dv; at the hop level
// (10,240 rows, n 20, dk 172) k, v, dk and dv are 564 MB, about 0.17 ms at
// 3.35 TB/s. This first version reads k twice and does the reductions one
// key at a time; it is simple and right, not yet fast.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void attend_bwd_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ ew,
                                  const float* __restrict__ u,
                                  int m, int h, int n, int dk, float scale,
                                  float rate,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ dattn,
                                  float* __restrict__ dq,
                                  float* __restrict__ dkey,
                                  float* __restrict__ dval) {
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
    qs[d] = q[r * dk + d];
    gos[d] = dout[r * dk + d];
  }
  __syncwarp();

  const long long kstride = static_cast<long long>(h) * dk;   // key j -> j+1
  const long long base = mi * n * kstride + static_cast<long long>(hi) * dk;
  const float* kb = k + base;
  const float* vb = v + base;
  for (int j = 0; j < n; ++j) {
    const float* kr = kb + j * kstride;
    const float* vr = vb + j * kstride;
    float s = 0.0f, t = 0.0f;
    for (int d = lane; d < dk; d += 32) {
      s = fmaf(qs[d], kr[d], s);
      t = fmaf(gos[d], vr[d], t);
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
    float c = 1.0f;
    if (u != nullptr) c = u[r * n + j] >= rate ? 1.0f / (1.0f - rate) : 0.0f;
    if (ew != nullptr) c *= ew[mi * n + j];
    float g = gs[j];
    if (dattn != nullptr) g += dattn[r * n + j];
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
      acc = fmaf(gs[j], k[at], acc);
      dkey[at] = gs[j] * qd;
      dval[at] = as[j] * god;
    }
    dq[r * dk + d] = acc;
  }
}

}  // namespace

extern "C" int attend_bwd_launch(const void* q, const void* k, const void* v,
                                 const void* mask, const void* ew,
                                 const void* u, int m, int h, int n, int dk,
                                 float scale, float rate, const void* dout,
                                 const void* dattn, void* dq, void* dkey,
                                 void* dval, void* stream) {
  const long long rows = static_cast<long long>(m) * h;
  if (rows > 0) {
    const size_t smem = sizeof(float) * kWarps * (2 * dk + 3 * n);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(attend_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    const long long blocks = (rows + kWarps - 1) / kWarps;
    attend_bwd_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const unsigned char*>(mask),
        static_cast<const float*>(ew), static_cast<const float*>(u), m, h, n,
        dk, scale, rate, static_cast<const float*>(dout),
        static_cast<const float*>(dattn), static_cast<float*>(dq),
        static_cast<float*>(dkey), static_cast<float*>(dval));
  }
  return static_cast<int>(cudaGetLastError());
}
