// What the persistent-block kernels share (wave_level_blocks_kernel in
// wavefront.cu, sweep_warp_kernel in sweep.cuh): 16-byte words and bit
// casts, which a host compiler also builds (tests/test_torch_kernel_source.py
// runs the schedules that use them with g++), and, on the device only, the
// grid barrier of a cooperative launch and the mbarrier of a bulk
// asynchronous copy.
#pragma once

#include <stdint.h>
#include <string.h>

#include "geom.cuh"

// Host and device: shared-memory layouts, which the launchers size.
#ifdef __CUDACC__
#define RTT_HD __host__ __device__ __forceinline__
#else
#define RTT_HD inline
#endif

namespace rtt {

#ifdef __CUDACC__
typedef float4 F4;
#else
struct alignas(16) F4 {
  float x, y, z, w;
};
#endif

RTT_DEV F4 load4(const float* a) {
#ifdef __CUDACC__
  return *reinterpret_cast<const float4*>(a);
#else
  F4 v;
  memcpy(&v, a, sizeof v);
  return v;
#endif
}

// Sixteen bytes of global memory that no thread writes during the launch,
// through the read-only data path on the device.
RTT_DEV F4 ldg4(const float* a) {
#ifdef __CUDACC__
  return __ldg(reinterpret_cast<const float4*>(a));
#else
  return load4(a);
#endif
}

RTT_DEV void store4(float* a, const F4& v) {
#ifdef __CUDACC__
  *reinterpret_cast<float4*>(a) = v;
#else
  memcpy(a, &v, sizeof v);
#endif
}

// Four bytes at a 4-byte aligned address.
RTT_DEV void store_u32(uint8_t* a, uint32_t v) {
#ifdef __CUDACC__
  *reinterpret_cast<uint32_t*>(a) = v;
#else
  memcpy(a, &v, sizeof v);
#endif
}

RTT_DEV float u32_as_f32(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

RTT_DEV uint32_t f32_as_u32(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
}

}  // namespace rtt

#ifdef __CUDACC__

namespace rtt {

static __device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// Wait until the mbarrier at shared address `bar` completes the phase of
// parity `parity`.
static __device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// An mbarrier at shared address `bar` that one arrival completes, made
// visible to the asynchronous proxy.
static __device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on the mbarrier at `bar` that expects `bytes` of
// asynchronous copy before its phase completes.
static __device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// The copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global `src` to shared `dst`, counted on the mbarrier at `bar`.
static __device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                                 uint32_t bar) {
  if (bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
  }
}

// One arrival that expects `bytes` of asynchronous copy, and the copy
// (bulk_load), which completes the barrier's phase; with no bytes, the
// arrival alone completes it.
static __device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                                 uint32_t bar) {
  mbar_expect(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

// All blocks of a cooperative launch meet here.
static __device__ __forceinline__ void grid_barrier(int* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1);
    while (*reinterpret_cast<volatile int*>(arrived) < (int)gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

}  // namespace rtt

#endif  // __CUDACC__
