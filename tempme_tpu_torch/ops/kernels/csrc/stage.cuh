// Staging of one contiguous run of global memory into shared memory and
// back, for sm_90a, shared by attend.cu and attend_bwd.cu.
//
// kVec is the widest access (16, 8, 4 or 2 bytes) that the run's base, its
// length and every row of it allow; the launcher picks it from the pointers
// and the row length. At 16 bytes one thread issues a bulk asynchronous copy
// (cp.async.bulk, no tensor map) whose completion arrives on an mbarrier, so
// the whole run is in flight at once and no thread spends registers on it;
// writes go back by the same engine (a bulk store into global memory). At 8,
// 4 or 2 bytes (a base or row that is not 16-byte aligned) every thread
// copies kVec-byte words. The call sites are the same for every width.
#pragma once
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace stage {

template <int kVec> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 sets up `count` barriers, each completed by one arrival plus
// the bytes of the copies aimed at it. Thread 0 may load at once; the
// other threads wait on a barrier only after the block has synchronised.
template <int kVec>
__device__ __forceinline__ void init(uint64_t* bars, int count) {
  if (kVec == 16 && threadIdx.x == 0) {
    for (int i = 0; i < count; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Start copying `bytes` from global `src` to shared `dst`. Every thread
// calls it; the buffer must be free (no thread still reads it).
template <int kVec>
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  if constexpr (kVec == 16) {
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar)),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
          "l"(src), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
  } else {
    using W = typename Word<kVec>::type;
    const W* s = static_cast<const W*>(src);
    W* d = static_cast<W*>(dst);
    for (uint32_t i = threadIdx.x; i < bytes / kVec; i += blockDim.x)
      d[i] = s[i];
  }
}

// Every thread waits until the load into bar's buffer that completes the
// barrier's phase of this parity (its uses so far, modulo 2) has landed.
template <int kVec>
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  if constexpr (kVec == 16) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}\n"
          : "=r"(done)
          : "r"(smem_addr(bar)), "r"(parity & 1u)
          : "memory");
    }
  } else {
    __syncthreads();
  }
}

// Every thread's writes to the buffers about to be stored are done.
template <int kVec>
__device__ __forceinline__ void before_store() {
  if constexpr (kVec == 16)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Copy `bytes` from shared `src` to global `dst` (after before_store).
template <int kVec>
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  if constexpr (kVec == 16) {
    if (threadIdx.x == 0)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
              "l"(dst),
          "r"(smem_addr(src)), "r"(bytes)
          : "memory");
  } else {
    using W = typename Word<kVec>::type;
    const W* s = static_cast<const W*>(src);
    W* d = static_cast<W*>(dst);
    for (uint32_t i = threadIdx.x; i < bytes / kVec; i += blockDim.x)
      d[i] = s[i];
  }
}

// The stores have read their buffers, which may be written again.
template <int kVec>
__device__ __forceinline__ void after_store() {
  if (kVec == 16 && threadIdx.x == 0) {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  __syncthreads();
}

// The widest kVec that every pointer and the row length allow (at least
// the element size, which a typed contiguous tensor always meets).
inline int pick_vec(long long row_bytes, int elem,
                    std::initializer_list<const void*> ptrs) {
  for (int vec = 16; vec > elem; vec /= 2) {
    bool ok = row_bytes % vec == 0;
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % vec == 0;
    if (ok) return vec;
  }
  return elem;
}

__host__ __device__ inline long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// The largest dynamic shared memory a block of `kernel` may have, which it
// is then allowed. Each launcher calls it once per kernel (a static).
template <typename Kernel>
int max_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, kernel);
  const int bytes = optin - static_cast<int>(attr.sharedSizeBytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  return bytes;
}

}  // namespace stage
