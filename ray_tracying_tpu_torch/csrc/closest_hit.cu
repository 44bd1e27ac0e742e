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
// Design of the closest hits: one thread per ray; the rays are row-major
// (8, R) [ox oy oz dx dy dz time act], ray i of row r at r * R + i, so
// every load and store of a warp is coalesced; the (17, G) table is copied
// to shared memory once per block and read as broadcasts; one
// kind-specialized loop per (kind, start, end) range; a dead ray (act <= 0)
// writes its miss and runs no test.  No thread returns before the barrier
// that follows the table copy.  One build serves every scene: ranges and
// the motion flag are runtime arguments, uniform over the grid.
//
// Design of the shadow any-hit (occlusion_warp_kernel), one cooperative
// launch of persistent blocks of kShadowThreads threads, as many as are
// resident (one a SM: the block holds the SM's 32 warps at 64 registers):
// - The shadow table, staged once a block: the 12 columns a shadow test
//   reads (w2o, or a legacy plane's corners; shadow rays carry time 0, so
//   the velocity is unread, and the kind is uniform over a range), copied
//   from the (17, G) table into row-major rows of 48 bytes, which a test
//   reads as three 16-byte broadcasts (98 KB at 2,049 geoms, 164 KB at
//   the cap, against 139 KB and 232 KB for the 17 columns).
// - Phase 1, scan (sweep.cuh::warp_scan_list): dead lanes get blocked = 0,
//   live ones are listed for the launch.  A grid barrier.
// - Phase 2: warps take warp_task listed lanes at a time from a counter;
//   each lane runs the kind-specialized loops over the ranges and stops at
//   its first blocker, and the warp leaves once none is open.  When the
//   list is short (the deep levels), a warp's few lanes have their rows
//   split over split_lanes(task) helper lanes each, which OR their answers.
//   Blocked iff some t <= maxt is order-free, so any schedule gives
//   occlusion_plain's bits.
// The one-thread-per-lane occlusion_any_kernel (the 17 columns staged by
// every block of 256 rays) is reachable by name (occlusion_any_lane_launch)
// for the measurement that compares the two; the package does not launch
// it.
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

// ------------------------------------------- the shadow any-hit's warp schedule

constexpr int kShadowCols = 12;  // what a shadow test reads of a row

// Bytes of the block's shadow table of G geoms: 48 a row.
RTT_HD size_t shadow_smem_bytes(int G) { return sizeof(float) * kShadowCols * (size_t)G; }

// Entries first, first + step, ... of the 12 x G shadow table copied from the
// (17, G) table into rows of 12 (row g at stab + 12 * g); the reads of
// neighbouring entries are neighbouring.
RTT_DEV void stage_shadow_rows(const float* table, int G, float* stab, int first, int step) {
  const int n = kShadowCols * G;
  for (int k = first; k < n; k += step) {
    const int c = k / G, g = k - c * G;
    stab[kShadowCols * g + c] = table[k];
  }
}

// Hit distance (+inf for a miss) of the staged row `row` (12 floats,
// 16-byte aligned) of kind KIND for a shadow ray: the arithmetic of geom_t
// without the motion shift.
template <int KIND>
RTT_DEV float shadow_t(const float* row, const Ray& r) {
  Xform m;
  const F4 a = load4(row), b = load4(row + 4), c = load4(row + 8);
  m.c[0] = a.x; m.c[1] = a.y; m.c[2] = a.z; m.c[3] = a.w;
  m.c[4] = b.x; m.c[5] = b.y; m.c[6] = b.z; m.c[7] = b.w;
  m.c[8] = c.x; m.c[9] = c.y; m.c[10] = c.z; m.c[11] = c.w;
  float nx, ny, nz;
  if constexpr (KIND == kKindPlane) {
    return plane_t<false>(m.c, 1, 0, r, nx, ny, nz);
  } else {
    return geom_t_x<KIND, false>(m, to_local_x(m, r.ox, r.oy, r.oz, r), r, nx, ny, nz);
  }
}

// Any hit over staged rows start, start + step, ... below end, of kind KIND:
// true at the first with t <= maxt.
template <int KIND>
RTT_DEV bool shadow_range(const float* stab, int start, int end, int step, const Ray& r,
                          float maxt) {
  for (int g = start; g < end; g += step) {
    if (shadow_t<KIND>(stab + kShadowCols * g, r) <= maxt) return true;
  }
  return false;
}

// Phase 2 of listed lane i: its ray (time 0) against rows first, first +
// step, ... of every range of the staged table, up to its first blocker.
// A lane's whole test is first 0, step 1; a helper's share of it, its own
// first and a step of its group's size.  Blocked iff some row has t <=
// maxt, so the shares OR to the whole test's answer.
RTT_DEV bool shadow_blocked(const BruteParams& p, const float* stab, size_t i, int first,
                            int step) {
  const size_t R = (size_t)p.R;
  const Ray ray = make_ray(p.rays[0 * R + i], p.rays[1 * R + i], p.rays[2 * R + i],
                           p.rays[3 * R + i], p.rays[4 * R + i], p.rays[5 * R + i]);
  const float maxt = p.maxt[i];
  bool blocked = false;
  for (int k = 0; k < p.n_ranges && !blocked; ++k) {
    const int s = p.start[k] + first, e = p.end[k];
    switch (p.kind[k]) {
      case kKindSphere: blocked = shadow_range<kKindSphere>(stab, s, e, step, ray, maxt); break;
      case kKindCube: blocked = shadow_range<kKindCube>(stab, s, e, step, ray, maxt); break;
      case kKindRect: blocked = shadow_range<kKindRect>(stab, s, e, step, ray, maxt); break;
      default: blocked = shadow_range<kKindPlane>(stab, s, e, step, ray, maxt); break;
    }
  }
  return blocked;
}

// The scan's view of an any-hit launch (sweep.cuh::sweep_scan4 reads the
// act row and writes `blocked`).
inline SweepParams shadow_scan_params(const BruteParams& p) {
  return make_sweep_params(p.rays, p.maxt, nullptr, nullptr, p.table, nullptr, nullptr, nullptr,
                           p.blocked, p.R, p.G, 1, 0);
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

constexpr int kShadowThreads = 1024;
constexpr int kShadowWarps = kShadowThreads / 32;

// ctr: the five work counters of a cooperative launch (sweep.cuh), zero at
// launch and left zero; live: R ints, the launch's list of live lanes.
// When a warp's task is short (a short list shared over the warps), each
// listed lane's rows are split over split_lanes(task) lanes of the warp,
// which OR their answers.
__global__ void __launch_bounds__(kShadowThreads, 1)
occlusion_warp_kernel(const BruteParams p, const SweepParams scan, int* ctr, int* live) {
  extern __shared__ __align__(16) float stab[];
  stage_shadow_rows(p.table, p.G, stab, threadIdx.x, kShadowThreads);
  warp_scan_list<kSweepAnyHit>(scan, ctr, live);
  grid_barrier(&ctr[2]);  // also: the staged table
  const int lane = threadIdx.x & 31;
  const int n_live = *reinterpret_cast<volatile int*>(&ctr[1]);
  const int task = warp_task(n_live, (long long)gridDim.x * kShadowWarps);
  const int g = split_lanes(task);
  const int q = lane / g, h = lane % g;  // the listed lane this lane serves, its share
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(&ctr[3], task);
    first = __shfl_sync(kFull, first, 0);
    if (first >= n_live) break;
    const int e = first + q;
    const bool mine = q < task && e < n_live;
    const size_t i = mine ? (size_t)live[e] : 0;
    // A lane that is done idles until the warp's last open lane is.
    bool blocked = mine && shadow_blocked(p, stab, i, h, g);
    for (int o = g / 2; o > 0; o >>= 1) blocked |= __shfl_xor_sync(kFull, (int)blocked, o) != 0;
    if (mine && h == 0) p.blocked[i] = blocked ? 1 : 0;
  }
  coop_release(ctr);
}

// The shadow kernel's shared memory for G geoms and coop_plan's answer.
inline int shadow_plan(int G, size_t& bytes, int& per_sm, int& sms) {
  bytes = shadow_smem_bytes(G);
  return coop_plan(occlusion_warp_kernel, kShadowThreads, bytes, per_sm, sms);
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

// ctr: five ints of device memory, zero, that no other launch uses
// meanwhile (the kernel leaves them zero); live: R ints of scratch.
extern "C" int occlusion_any_launch(
    const float* rays, const float* maxt, const float* table, uint8_t* blocked,
    long long R, int G, const int* ranges, int n_ranges, int* ctr, int* live,
    void* stream) {
  if (n_ranges < 1 || n_ranges > rtt::kMaxBruteRanges || R < 0 || R > INT_MAX / 2 || G < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, maxt, table, nullptr, nullptr, nullptr, blocked, R, G, ranges, n_ranges, 0);
  const rtt::SweepParams scan = rtt::shadow_scan_params(p);
  size_t bytes;
  int per_sm, sms;
  const int err = rtt::shadow_plan(G, bytes, per_sm, sms);
  if (err) return err;
  void* args[] = {const_cast<rtt::BruteParams*>(&p), const_cast<rtt::SweepParams*>(&scan),
                  &ctr, &live};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)rtt::occlusion_warp_kernel, dim3((unsigned)(per_sm * sms)),
      dim3(rtt::kShadowThreads), args, bytes, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// What occlusion_any_launch launches with for a table of G geoms: out[0..3]
// = shared memory bytes, resident blocks per SM, SMs, threads per block.
extern "C" int occlusion_any_plan(int G, int* out) {
  size_t bytes = 0;
  int per_sm = 0, sms = 0;
  const int err = rtt::shadow_plan(G, bytes, per_sm, sms);
  out[0] = (int)bytes; out[1] = per_sm; out[2] = sms; out[3] = rtt::kShadowThreads;
  return err;
}

// The one-thread-per-lane schedule it replaced.
extern "C" int occlusion_any_lane_launch(
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
