// Walk -> edge scatter-max and its backward, for sm_90a.
//
// Replaces the TPU kernel tempme_tpu/ops/pallas/kernels.py _w2e_kernel
// (call _w2e_pallas_local, entry walk_to_edge_max) and the jnp VJP it uses
// (_w2e_bwd through tempme_tpu/ops/segment.py walk_to_edge_max_jnp):
//   out[b, t] = max_s (ids[b, s] == tgt[b, t] ? imp[b, s] : 0),
// the explainer's walk importance carried onto each support edge (0 where no
// walk slot carries it; the 0 fill of the non-matching slots takes part in
// the max). The [B, T, S] comparison tensor is never materialised: the
// Pallas kernel keeps it in VMEM tiles, here it lives in registers.
//
// Forward: one block per batch row b. The row's S slot ids and importances
// are staged in shared memory; each thread takes targets t, takes the max
// over the S slots and counts the slots that attain it (cnt[b, t], the
// number the backward divides by).
//
// Backward: the max's VJP as JAX's reduce-max defines it, which splits the
// cotangent evenly over every slot that attains the max, non-matching slots
// whose 0 fill ties with it included:
//   g_imp[b, s] = sum_t [ids[b,s] == tgt[b,t]] [imp[b,s] == out[b,t]]
//                       * ct[b, t] / cnt[b, t].
// One block per batch row, the row's targets, maxima and ct / cnt staged in
// shared memory, one thread per slot s looping over t: each slot owns its
// output, so repeated target ids are summed by the loop and no atomics are
// needed.
//
// Bound on the H100: bytes, and at the explainer's shapes (B 100, S 180,
// T 20 or 400) latency: each kernel moves tens to hundreds of KB and does
// B * T * S compares, a few microseconds of the card's integer rate.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void w2e_fwd_kernel(const int* __restrict__ ids,
                               const float* __restrict__ imp,
                               const int* __restrict__ tgt, int s_len,
                               int t_len, float* __restrict__ out,
                               int* __restrict__ cnt) {
  extern __shared__ unsigned char smem[];
  int* sid = reinterpret_cast<int*>(smem);
  float* simp = reinterpret_cast<float*>(sid + s_len);
  const long long b = blockIdx.x;
  for (int s = threadIdx.x; s < s_len; s += blockDim.x) {
    sid[s] = ids[b * s_len + s];
    simp[s] = imp[b * s_len + s];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < t_len; t += blockDim.x) {
    const int x = tgt[b * t_len + t];
    float mx = __int_as_float(static_cast<int>(0xff800000u));  // -inf
    for (int s = 0; s < s_len; ++s)
      mx = fmaxf(mx, sid[s] == x ? simp[s] : 0.0f);
    int c = 0;
    for (int s = 0; s < s_len; ++s) c += (sid[s] == x ? simp[s] : 0.0f) == mx;
    out[b * t_len + t] = mx;
    cnt[b * t_len + t] = c;
  }
}

__global__ void w2e_bwd_kernel(const int* __restrict__ ids,
                               const float* __restrict__ imp,
                               const int* __restrict__ tgt,
                               const float* __restrict__ out,
                               const int* __restrict__ cnt,
                               const float* __restrict__ ct, int s_len,
                               int t_len, float* __restrict__ g_imp) {
  extern __shared__ unsigned char smem[];
  int* stgt = reinterpret_cast<int*>(smem);
  float* sout = reinterpret_cast<float*>(stgt + t_len);
  float* sw = sout + t_len;
  const long long b = blockIdx.x;
  for (int t = threadIdx.x; t < t_len; t += blockDim.x) {
    const long long i = b * t_len + t;
    stgt[t] = tgt[i];
    sout[t] = out[i];
    sw[t] = ct[i] / static_cast<float>(cnt[i]);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < s_len; s += blockDim.x) {
    const int id = ids[b * s_len + s];
    const float x = imp[b * s_len + s];
    float acc = 0.0f;
    for (int t = 0; t < t_len; ++t)
      if (stgt[t] == id && x == sout[t]) acc += sw[t];
    g_imp[b * s_len + s] = acc;
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
  if (b > 0 && t_len > 0) {
    const size_t smem = sizeof(int) * s_len + sizeof(float) * s_len;
    const int err = set_smem(reinterpret_cast<const void*>(w2e_fwd_kernel),
                             smem);
    if (err != 0) return err;
    w2e_fwd_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(imp),
        static_cast<const int*>(tgt), s_len, t_len, static_cast<float*>(out),
        static_cast<int*>(cnt));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int w2e_bwd_launch(const void* ids, const void* imp,
                              const void* tgt, const void* out,
                              const void* cnt, const void* ct, int b,
                              int s_len, int t_len, void* g_imp,
                              void* stream) {
  if (b > 0 && s_len > 0) {
    const size_t smem = (sizeof(int) + 2 * sizeof(float)) * t_len;
    const int err = set_smem(reinterpret_cast<const void*>(w2e_bwd_kernel),
                             smem);
    if (err != 0) return err;
    w2e_bwd_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(imp),
        static_cast<const int*>(tgt), static_cast<const float*>(out),
        static_cast<const int*>(cnt), static_cast<const float*>(ct), s_len,
        t_len, static_cast<float*>(g_imp));
  }
  return static_cast<int>(cudaGetLastError());
}
