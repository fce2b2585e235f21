// Fused 1-query x n-key attention, eval and training forms, for sm_90a.
//
// Replaces the TPU kernels tempme_tpu/ops/pallas/kernels.py _attend_kernel
// (eval form) and _attend_drop_kernel (training form), entry fused_attend.
// One row is one (batch x query, head) pair:
//   s_j = scale * q . k_j, s_j = -1e10 where key j is masked,
//   p = softmax(s), [training form: p_j = u_j >= rate ? p_j / (1 - rate) : 0],
//   p *= explain_weight, out = sum_j p_j v_j,
// and both out and p are written. q, k and v are float32 or bf16 (the
// model's projections run in bf16 by default); the kernel is templated on
// their element type and does every sum in float32, as the Pallas body does
// (q_ref[:].astype(jnp.float32)). The training form takes the dropout draws
// u [m, h, n] from the caller, so the backward (attend_bwd.cu) sees the same
// mask. k and v are read in the layout the model makes them, [m, n, h, dk],
// through strides, so the head transpose that fused_attend materialises
// before its call is never made. The Pallas kernel's 128-row tiles and VMEM
// padding do not apply and are left out.
//
// One warp per row. The lanes split dk, so each key's and value's row is
// read coalesced; a key's score is a warp-shuffle sum, kept with the
// probabilities in shared memory (dk + n floats per warp), so any n and dk
// work.
//
// Bound on the H100: bytes. Each k and v element is read once and used for
// two flops, far below the card's flop-per-byte balance; at the hop level
// (10,240 rows, n 20, dk 172) k and v alone are 282 MB in float32, about
// 84 us at 3.35 TB/s, and half that in bf16. The dropout draws add 4 bytes per score. This first version
// does the score reductions one key at a time; it is simple and right, not
// yet fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;

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

template <typename T, bool kDrop>
__global__ void attend_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const unsigned char* __restrict__ mask,
                              const float* __restrict__ ew,
                              const float* __restrict__ u,
                              int m, int h, int n, int dk, float scale,
                              float rate, float* __restrict__ out,
                              float* __restrict__ attn) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= static_cast<long long>(m) * h) return;  // warp-uniform
  const long long mi = r / h;
  const int hi = static_cast<int>(r % h);
  float* qs = smem + warp * (dk + n);
  float* ps = qs + dk;

  const T* qr = q + r * dk;
  for (int d = lane; d < dk; d += 32) qs[d] = to_f32(qr[d]);
  __syncwarp();

  const long long kstride = static_cast<long long>(h) * dk;   // key j -> j+1
  const long long base = mi * n * kstride + static_cast<long long>(hi) * dk;
  const T* kb = k + base;
  for (int j = 0; j < n; ++j) {
    const T* kr = kb + j * kstride;
    float s = 0.0f;
    for (int d = lane; d < dk; d += 32) s = fmaf(qs[d], to_f32(kr[d]), s);
    s = warp_sum(s) * scale;
    if (lane == 0) {
      if (mask != nullptr && mask[mi * n + j]) s = -1e10f;
      ps[j] = s;
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
  for (int j = lane; j < n; j += 32) {
    float p = ps[j] / sum;
    if (kDrop) p = u[r * n + j] >= rate ? p / (1.0f - rate) : 0.0f;
    if (ew != nullptr) p *= ew[mi * n + j];
    ps[j] = p;
    attn[r * n + j] = p;
  }
  __syncwarp();

  const T* vb = v + base;
  for (int d = lane; d < dk; d += 32) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j)
      acc = fmaf(ps[j], to_f32(vb[j * kstride + d]), acc);
    out[r * dk + d] = acc;
  }
}

template <typename T, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* ew, const void* u, int m, int h, int n, int dk,
           float scale, float rate, void* out, void* attn, void* stream) {
  const long long rows = static_cast<long long>(m) * h;
  if (rows > 0) {
    const size_t smem = sizeof(float) * kWarps * (dk + n);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(attend_kernel<T, kDrop>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    const long long blocks = (rows + kWarps - 1) / kWarps;
    attend_kernel<T, kDrop><<<static_cast<unsigned>(blocks), 32 * kWarps,
                              smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
        static_cast<const float*>(ew), static_cast<const float*>(u), m, h, n,
        dk, scale, rate, static_cast<float*>(out), static_cast<float*>(attn));
  }
  return static_cast<int>(cudaGetLastError());
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
