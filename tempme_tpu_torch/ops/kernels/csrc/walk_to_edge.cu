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
// Bound on the H100: the B * T * S compares at the card's integer rate,
// about 1.3 us at the explainer's largest shape (B 100, S 180, T 400). Each
// kernel moves only tens to hundreds of KB, and its chains of dependent
// steps set its time: the forward's thread per target scans the S slots in
// a row, the backward's warps at most 32 targets each up to T 256 and T / 8
// above. Up to 8 warps a block keep the 600 blocks of the explainer's shape
// in one wave on 132 SMs (13 warps at T 400 left room for 4 blocks an SM).
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
