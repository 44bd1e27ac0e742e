// Brute-force closest hit, closest hit with the winner's normal, and shadow
// any-hit over the kind-sorted geom table, for sm_90a; and the chunked
// brute closest hit over a load-order table of any size.
//
// Replaces the TPU kernels kernels/closest_hit.py::_brute_kernel,
// _brute_n_kernel and _occlusion_kernel of the JAX package; their plain
// PyTorch versions are kernels/closest_hit.py::brute_closest_plain,
// brute_closest_n_plain and occlusion_plain of this package, whose order of
// operations this file (with geom.cuh) follows term by term.
//
// Bound on an H100: operations.  A live ray runs G geom tests of about 80
// f32 operations each (the any-hit loop: up to its first blocker) against
// 8 rows of 4 bytes read and 1 to 5 rows written.
// Design: one thread per ray; the rays are row-major (8, R) [ox oy oz dx
// dy dz time act], ray i of row r at r * R + i, so every load and store of
// a warp is coalesced; the (17, G) table is copied to shared memory once
// per block and read as broadcasts; one kind-specialized loop per
// (kind, start, end) range; a dead ray (act <= 0) writes its miss and runs
// no test; the any-hit loop breaks per thread at its first blocker.  No
// thread returns before the barrier that follows the table copy.  One
// build serves every scene: ranges and the motion flag are runtime
// arguments, uniform over the grid.
//
// brute_closest_chunked replaces kernels/closest_hit.py::
// _brute_chunked_kernel of the JAX package (plain version:
// brute_closest_chunked_plain): the table does not fit shared memory, so
// it is swept in chunks (sweep.cuh, without the cull: every live thread
// runs every chunk); rows stay in load order and are of mixed kinds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/_build.py).
// No fast-math: misses are true +inf, divisions and square roots are IEEE.

#include <stddef.h>
#include <stdint.h>

#include "geom.cuh"
#include "sweep.cuh"

namespace rtt {

constexpr int kTableRows = 17;  // columns of a geom-table row
constexpr int kIdRow = 16;      // the reference's load-order geom id
constexpr int kMaxBruteRanges = 4;

struct BruteParams {
  const float* rays;   // (8, R)
  const float* maxt;   // (R,) any-hit only, else null
  const float* table;  // (17, G) kind-sorted, transposed
  float* t;            // (R,)
  int* id;             // (R,)
  float* n;            // (3, R) or null
  uint8_t* blocked;    // (R,) any-hit only, else null
  long long R;
  int G;
  int n_ranges;
  int kind[kMaxBruteRanges], start[kMaxBruteRanges], end[kMaxBruteRanges];
  int motion;
};

// Closest hit of ray i.  WANT_N also writes the winner's unit normal.
// tab: the block's copy of the table (shared memory on the device).
template <bool WANT_N>
RTT_DEV void closest_lane(const BruteParams& p, const float* tab, size_t i) {
  const size_t R = (size_t)p.R;
  const int G = p.G;
  if (!(p.rays[7 * R + i] > 0.0f)) {
    p.t[i] = kInf;
    p.id[i] = -1;
    if constexpr (WANT_N) {
      p.n[0 * R + i] = 0.0f; p.n[1 * R + i] = 0.0f; p.n[2 * R + i] = 0.0f;
    }
    return;
  }
  const Ray ray = make_ray(p.rays[0 * R + i], p.rays[1 * R + i], p.rays[2 * R + i],
                           p.rays[3 * R + i], p.rays[4 * R + i], p.rays[5 * R + i],
                           p.rays[6 * R + i]);
  Best best;
  best.t = kInf; best.row = -1;
  best.nx = 0.0f; best.ny = 0.0f; best.nz = 0.0f;
  for (int k = 0; k < p.n_ranges; ++k) {
    const int s = p.start[k], e = p.end[k];
    if constexpr (WANT_N) {
      switch (p.kind[k]) {
        case kKindSphere:
          if (p.motion) closest_range<kKindSphere, true>(tab, G, s, e, ray, best);
          else closest_range<kKindSphere>(tab, G, s, e, ray, best);
          break;
        case kKindCube: closest_range<kKindCube>(tab, G, s, e, ray, best); break;
        case kKindRect: closest_range<kKindRect>(tab, G, s, e, ray, best); break;
        default: closest_range<kKindPlane>(tab, G, s, e, ray, best); break;
      }
    } else {
      switch (p.kind[k]) {
        case kKindSphere:
          if (p.motion) closest_range_t<kKindSphere, true>(tab, G, s, e, ray, best.t, best.row);
          else closest_range_t<kKindSphere>(tab, G, s, e, ray, best.t, best.row);
          break;
        case kKindCube: closest_range_t<kKindCube>(tab, G, s, e, ray, best.t, best.row); break;
        case kKindRect: closest_range_t<kKindRect>(tab, G, s, e, ray, best.t, best.row); break;
        default: closest_range_t<kKindPlane>(tab, G, s, e, ray, best.t, best.row); break;
      }
    }
  }
  p.t[i] = best.t;
  // A winner has a finite t (strict < from +inf); its id is column 16 of
  // its row, rounded.
  p.id[i] = (best.row >= 0) ? (int)rintf(tab[kIdRow * G + best.row]) : -1;
  if constexpr (WANT_N) {
    // Normalize the winning normal once (Code/shapes.cpp:186).
    float ln = sqrtf(best.nx * best.nx + best.ny * best.ny + best.nz * best.nz);
    ln = (ln > 0.0f) ? ln : 1.0f;
    p.n[0 * R + i] = best.nx / ln;
    p.n[1 * R + i] = best.ny / ln;
    p.n[2 * R + i] = best.nz / ln;
  }
}

// Shadow any-hit of ray i: blocked iff some geom has t <= maxt[i].  Shadow
// rays carry time 0 (Code/shapes.hpp:28): no origin is shifted.
RTT_DEV void occlusion_lane(const BruteParams& p, const float* tab, size_t i) {
  const size_t R = (size_t)p.R;
  const int G = p.G;
  if (!(p.rays[7 * R + i] > 0.0f)) {
    p.blocked[i] = 0;
    return;
  }
  const Ray ray = make_ray(p.rays[0 * R + i], p.rays[1 * R + i], p.rays[2 * R + i],
                           p.rays[3 * R + i], p.rays[4 * R + i], p.rays[5 * R + i]);
  const float maxt = p.maxt[i];
  bool blocked = false;
  for (int k = 0; k < p.n_ranges && !blocked; ++k) {
    const int s = p.start[k], e = p.end[k];
    switch (p.kind[k]) {
      case kKindSphere: blocked = any_hit_range<kKindSphere>(tab, G, s, e, ray, maxt); break;
      case kKindCube: blocked = any_hit_range<kKindCube>(tab, G, s, e, ray, maxt); break;
      case kKindRect: blocked = any_hit_range<kKindRect>(tab, G, s, e, ray, maxt); break;
      default: blocked = any_hit_range<kKindPlane>(tab, G, s, e, ray, maxt); break;
    }
  }
  p.blocked[i] = blocked ? 1 : 0;
}

// Host side: gather one launch's arguments.  ranges: n_ranges triples
// (kind, start, end).
inline BruteParams make_brute_params(
    const float* rays, const float* maxt, const float* table, float* t, int* id,
    float* n, uint8_t* blocked, long long R, int G, const int* ranges,
    int n_ranges, int motion) {
  BruteParams p;
  p.rays = rays; p.maxt = maxt; p.table = table;
  p.t = t; p.id = id; p.n = n; p.blocked = blocked;
  p.R = R; p.G = G; p.n_ranges = n_ranges;
  for (int k = 0; k < kMaxBruteRanges; ++k) {
    const bool used = k < n_ranges;
    p.kind[k] = used ? ranges[3 * k + 0] : 0;
    p.start[k] = used ? ranges[3 * k + 1] : 0;
    p.end[k] = used ? ranges[3 * k + 2] : 0;
  }
  p.motion = motion;
  return p;
}

}  // namespace rtt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace rtt {

// The block's copy of the table; every thread takes part and passes the
// barrier, whatever its ray.
__device__ __forceinline__ void stage_table(const BruteParams& p, float* tab) {
  const int n_tab = kTableRows * p.G;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) tab[k] = p.table[k];
  __syncthreads();
}

__global__ void brute_closest_kernel(const BruteParams p) {
  extern __shared__ float smem[];
  stage_table(p, smem);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.R) closest_lane<false>(p, smem, (size_t)i);
}

__global__ void brute_closest_n_kernel(const BruteParams p) {
  extern __shared__ float smem[];
  stage_table(p, smem);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.R) closest_lane<true>(p, smem, (size_t)i);
}

__global__ void occlusion_any_kernel(const BruteParams p) {
  extern __shared__ float smem[];
  stage_table(p, smem);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.R) occlusion_lane(p, smem, (size_t)i);
}

// Launch `kernel` over R rays on `stream` without synchronizing; returns
// cudaGetLastError() (0 = launched).
template <typename K>
static int launch_brute(K kernel, const BruteParams& p, int n_ranges, int threads,
                        void* stream) {
  if (n_ranges < 1 || n_ranges > kMaxBruteRanges || p.R < 0 || threads < 1)
    return (int)cudaErrorInvalidValue;
  if (p.R == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)kTableRows * p.G;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (p.R + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace rtt

// Plain C interface (loaded with ctypes).
extern "C" int brute_closest_launch(
    const float* rays, const float* table, float* t, int* id,
    long long R, int G, const int* ranges, int n_ranges, int motion,
    int threads, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, nullptr, table, t, id, nullptr, nullptr, R, G, ranges,
      n_ranges, motion);
  return rtt::launch_brute(rtt::brute_closest_kernel, p, n_ranges, threads, stream);
}

extern "C" int brute_closest_n_launch(
    const float* rays, const float* table, float* t, int* id, float* n,
    long long R, int G, const int* ranges, int n_ranges, int motion,
    int threads, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, nullptr, table, t, id, n, nullptr, R, G, ranges,
      n_ranges, motion);
  return rtt::launch_brute(rtt::brute_closest_n_kernel, p, n_ranges, threads, stream);
}

extern "C" int occlusion_any_launch(
    const float* rays, const float* maxt, const float* table, uint8_t* blocked,
    long long R, int G, const int* ranges, int n_ranges,
    int threads, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, maxt, table, nullptr, nullptr, nullptr, blocked, R, G, ranges,
      n_ranges, 0);
  return rtt::launch_brute(rtt::occlusion_any_kernel, p, n_ranges, threads, stream);
}

extern "C" int brute_closest_chunked_launch(
    const float* rays, const float* table, float* t, int* id,
    long long R, int G, int chunk, int motion, int threads, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, nullptr, nullptr, table, t, id, nullptr, nullptr, R, G, chunk, motion);
  return rtt::launch_sweep(rtt::sweep_kernel<rtt::kSweepClosest, false, false>, p,
                           threads, stream);
}

#endif  // __CUDACC__
