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
//
// Design of the closest hits (brute_warp_kernel<WANT_N>) and of the shadow
// any-hit (occlusion_warp_kernel): one cooperative launch of persistent
// blocks of kBlockThreads threads, as many as are resident (one a SM: the
// block holds the SM's 32 warps at 64 registers).
// - The table, staged once a block from the (17, G) table (stage_rows) into
//   row-major rows that a test reads as 16-byte broadcasts.  A closest hit
//   reads rows of 16 floats (64 bytes): w2o, or a legacy plane's corners,
//   the velocity, and the load-order id in slot 15 (131 KB at 2,049 geoms,
//   219 KB at the cap); a shadow test reads the first 12 (48 bytes: shadow
//   rays carry time 0, so the velocity is unread).  The kind is uniform over
//   a range and is not staged.
// - Phase 1, scan (sweep.cuh::warp_scan_list): dead lanes get their miss
//   (t = +inf, id = -1, normal 0; not blocked), live ones are listed for the
//   launch.  A grid barrier.
// - Phase 2: warps take warp_task listed lanes at a time from a counter;
//   each lane runs the kind-specialized loops over the ranges.  When the
//   list is short (the deep levels), a warp's few lanes have their rows
//   split over split_lanes(task) helper lanes each, in strided slices.
//   Closest hit: the loop carries (t, row) only, with a strict < in
//   ascending row order; helpers merge by (t, row) through shuffles, which
//   is the single lane's answer because the ranges ascend (the launcher
//   refuses ranges that do not).  The winner's normal is the same geom test
//   run once more on its row, then normalized: the bits the loop would have
//   carried.  Any-hit: each lane stops at its first blocker, and helpers OR
//   their answers; blocked iff some t <= maxt is order-free.
// So every schedule gives the plain versions' bits.  The one-thread-per-lane
// kernels they replaced (the (17, G) table staged by every block of 256 rays:
// brute_closest_kernel, brute_closest_n_kernel, occlusion_any_kernel) are
// reachable by name (*_lane_launch) for the measurement that compares the
// two; the package does not launch them.
//
// brute_closest_chunked replaces kernels/closest_hit.py::
// _brute_chunked_kernel of the JAX package (plain version:
// brute_closest_chunked_plain): the table does not fit shared memory, so
// it is swept in chunks; rows stay in load order and are of mixed kinds.
// It is the chunk sweeps' warp schedule without boxes (sweep.cuh::
// sweep_warp_kernel<closest, COUNT, BOXES = false>): scan and live-lane
// list, warps of 32 listed lanes, every chunk in row order through the
// warp's ring of bulk copies, short tasks split over helper lanes that
// merge by (t, row).  The one-thread-per-lane sweep it replaced
// (sweep_kernel<closest, no cull>: every block stages each chunk behind two
// barriers, dead lanes included) is reachable by name
// (brute_closest_chunked_lane_launch).
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
  if constexpr (WANT_N) store_unit_normal(p.n, R, i, best.nx, best.ny, best.nz);
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

// Do the ranges lie in [0, G), ascending and disjoint?  Then a closest
// hit meets the rows in ascending order, and the warp schedule's helpers,
// which merge by (t, row), give the single lane's answer.
inline bool ranges_ascend(const BruteParams& p) {
  int prev = 0;
  for (int k = 0; k < p.n_ranges; ++k) {
    if (p.start[k] < prev || p.end[k] < p.start[k] || p.end[k] > p.G) return false;
    prev = p.end[k];
  }
  return true;
}

// ------------------------------------------------------ the warp schedule

constexpr int kBruteCols = 16;   // a closest hit's staged row: columns 0-14, the id
constexpr int kShadowCols = 12;  // a shadow test's: columns 0-11
constexpr int kIdSlot = 15;      // where a staged row keeps column 16

// Bytes of a block's staged table of G geoms: 64 a row for a closest hit,
// 48 for a shadow test.
RTT_HD size_t brute_smem_bytes(int G) { return sizeof(float) * kBruteCols * (size_t)G; }
RTT_HD size_t shadow_smem_bytes(int G) { return sizeof(float) * kShadowCols * (size_t)G; }

// Entries first, first + step, ... of the COLS x G staged table copied from
// the (17, G) table into rows of COLS (row g at rows + COLS * g): slot c of a
// row is column c, but slot 15, which is column 16 (the id); the reads of
// neighbouring entries are neighbouring.
template <int COLS>
RTT_DEV void stage_rows(const float* table, int G, float* rows, int first, int step) {
  const int n = COLS * G;
  for (int k = first; k < n; k += step) {
    const int c = k / G, g = k - c * G;
    rows[COLS * g + c] = table[(c == kIdSlot ? kIdRow : c) * G + g];
  }
}

// Hit distance (+inf for a miss) of the staged row `row` (16-byte aligned)
// of kind KIND: geom_t's arithmetic on the row's own layout, which a test
// reads as three 16-byte words (four with MOTION, which also reads the
// velocity).  WANT_N also yields the UNnormalized world normal.
template <int KIND, bool WANT_N = false, bool MOTION = false>
RTT_DEV float row_t(const float* row, const Ray& r, float& nx, float& ny, float& nz) {
  Xform m;
  const F4 a = load4(row), b = load4(row + 4), c = load4(row + 8);
  m.c[0] = a.x; m.c[1] = a.y; m.c[2] = a.z; m.c[3] = a.w;
  m.c[4] = b.x; m.c[5] = b.y; m.c[6] = b.z; m.c[7] = b.w;
  m.c[8] = c.x; m.c[9] = c.y; m.c[10] = c.z; m.c[11] = c.w;
  if constexpr (KIND == kKindPlane) {
    return plane_t<WANT_N>(m.c, 1, 0, r, nx, ny, nz);
  } else {
    float ox = r.ox, oy = r.oy, oz = r.oz;
    if constexpr (MOTION) {
      const F4 v = load4(row + 12);
      ox = r.ox - r.tm * v.x;
      oy = r.oy - r.tm * v.y;
      oz = r.oz - r.tm * v.z;
    }
    return geom_t_x<KIND, WANT_N>(m, to_local_x(m, ox, oy, oz, r), r, nx, ny, nz);
  }
}

// (t, row) over staged rows start, start + step, ... below end, of kind
// KIND: strict < in ascending row order.
template <int KIND, bool MOTION = false>
RTT_DEV void best_range(const float* rows, int start, int end, int step, const Ray& r,
                        Best& best) {
  float nx, ny, nz;
  for (int g = start; g < end; g += step) {
    const float t = row_t<KIND, false, MOTION>(rows + kBruteCols * g, r, nx, ny, nz);
    if (t < best.t) { best.t = t; best.row = g; }
  }
}

// The ray of listed lane i, with its time (a moving sphere's origin shifts).
RTT_DEV Ray brute_ray(const BruteParams& p, size_t i) {
  const size_t R = (size_t)p.R;
  return make_ray(p.rays[0 * R + i], p.rays[1 * R + i], p.rays[2 * R + i], p.rays[3 * R + i],
                  p.rays[4 * R + i], p.rays[5 * R + i], p.rays[6 * R + i]);
}

// Phase 2 of a listed lane's ray: its (t, row) over rows first, first +
// step, ... of every range of the staged table (best starts at a miss).  A
// lane's whole test is first 0, step 1; a helper's share of it, its own
// first and a step of its group's size.
RTT_DEV void brute_best(const BruteParams& p, const float* rows, const Ray& ray, int first,
                        int step, Best& best) {
  for (int k = 0; k < p.n_ranges; ++k) {
    const int s = p.start[k] + first, e = p.end[k];
    switch (p.kind[k]) {
      case kKindSphere:
        if (p.motion) best_range<kKindSphere, true>(rows, s, e, step, ray, best);
        else best_range<kKindSphere>(rows, s, e, step, ray, best);
        break;
      case kKindCube: best_range<kKindCube>(rows, s, e, step, ray, best); break;
      case kKindRect: best_range<kKindRect>(rows, s, e, step, ray, best); break;
      default: best_range<kKindPlane>(rows, s, e, step, ray, best); break;
    }
  }
}

// The outputs of listed lane i from its winner (t, row): t, the id from the
// winner's staged row and, with WANT_N, the winner's normal, which the same
// geom test run on its row yields: the bits the loop would have carried.
template <bool WANT_N>
RTT_DEV void brute_end(const BruteParams& p, const float* rows, size_t i, const Ray& ray,
                       const Best& best) {
  p.t[i] = best.t;
  // A winner has a finite t (strict < from +inf).
  const float* row = rows + kBruteCols * (best.row >= 0 ? best.row : 0);
  p.id[i] = (best.row >= 0) ? (int)rintf(row[kIdSlot]) : -1;
  if constexpr (WANT_N) {
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    for (int k = 0; k < p.n_ranges; ++k) {
      if (best.row < p.start[k] || best.row >= p.end[k]) continue;
      switch (p.kind[k]) {
        case kKindSphere:
          if (p.motion) row_t<kKindSphere, true, true>(row, ray, nx, ny, nz);
          else row_t<kKindSphere, true>(row, ray, nx, ny, nz);
          break;
        case kKindCube: row_t<kKindCube, true>(row, ray, nx, ny, nz); break;
        case kKindRect: row_t<kKindRect, true>(row, ray, nx, ny, nz); break;
        default: row_t<kKindPlane, true>(row, ray, nx, ny, nz); break;
      }
    }
    store_unit_normal(p.n, (size_t)p.R, i, nx, ny, nz);
  }
}

// Any hit over staged rows start, start + step, ... below end, of kind KIND:
// true at the first with t <= maxt.
template <int KIND>
RTT_DEV bool shadow_range(const float* stab, int start, int end, int step, const Ray& r,
                          float maxt) {
  float nx, ny, nz;
  for (int g = start; g < end; g += step) {
    if (row_t<KIND>(stab + kShadowCols * g, r, nx, ny, nz) <= maxt) return true;
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

// The scan's view of a launch (sweep.cuh::sweep_scan4 reads the act row and
// writes the outputs of the launch's mode: t, id[, n], or blocked).
inline SweepParams scan_params(const BruteParams& p) {
  return make_sweep_params(p.rays, p.maxt, nullptr, nullptr, p.table, p.t, p.id, p.n,
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

constexpr int kBlockThreads = 1024;
constexpr int kBlockWarps = kBlockThreads / 32;

// The two warp kernels.  ctr: the five work counters of a cooperative
// launch (sweep.cuh), zero at launch and left zero; live: R ints, the
// launch's list of live lanes.  When a warp's task is short (a short list
// shared over the warps), each listed lane's rows are split over
// split_lanes(task) lanes of the warp, which merge their winners by (t, row)
// or OR their answers.
template <bool WANT_N>
__global__ void __launch_bounds__(kBlockThreads, 1)
brute_warp_kernel(const BruteParams p, const SweepParams scan, int* ctr, int* live) {
  extern __shared__ __align__(16) float rows[];
  stage_rows<kBruteCols>(p.table, p.G, rows, threadIdx.x, kBlockThreads);
  warp_scan_list<WANT_N ? kSweepClosestN : kSweepClosest>(scan, ctr, live);
  grid_barrier(&ctr[2]);  // also: the staged table
  const int lane = threadIdx.x & 31;
  const int n_live = *reinterpret_cast<volatile int*>(&ctr[1]);
  const int task = warp_task(n_live, (long long)gridDim.x * kBlockWarps);
  const int g = split_lanes(task);
  const int q = lane / g, h = lane % g;  // the listed lane this lane serves, its share
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(&ctr[3], task);
    first = __shfl_sync(kFull, first, 0);
    if (first >= n_live) break;
    const int e = first + q;
    const bool mine = q < task && e < n_live;
    // A lane that serves no listed lane reads the task's first ray and runs
    // no test; it only passes its miss through the merge.
    const size_t i = mine ? (size_t)live[e] : (size_t)live[first];
    const Ray ray = brute_ray(p, i);
    Best best;
    best.t = kInf; best.row = -1;
    if (mine) brute_best(p, rows, ray, h, g, best);
    for (int o = g / 2; o > 0; o >>= 1) {
      const float t2 = __shfl_xor_sync(kFull, best.t, o);
      const int row2 = __shfl_xor_sync(kFull, best.row, o);
      best_merge(best, t2, row2);
    }
    if (mine && h == 0) brute_end<WANT_N>(p, rows, i, ray, best);
  }
  coop_release(ctr);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
occlusion_warp_kernel(const BruteParams p, const SweepParams scan, int* ctr, int* live) {
  extern __shared__ __align__(16) float stab[];
  stage_rows<kShadowCols>(p.table, p.G, stab, threadIdx.x, kBlockThreads);
  warp_scan_list<kSweepAnyHit>(scan, ctr, live);
  grid_barrier(&ctr[2]);  // also: the staged table
  const int lane = threadIdx.x & 31;
  const int n_live = *reinterpret_cast<volatile int*>(&ctr[1]);
  const int task = warp_task(n_live, (long long)gridDim.x * kBlockWarps);
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

// What a warp kernel launches with, `bytes` of staged table a block:
// out[0..3] = shared memory bytes, resident blocks per SM, SMs, threads per
// block.  0 or a CUDA error.
template <typename K>
static int warp_plan(K kernel, size_t bytes, int* out) {
  int per_sm = 0, sms = 0;
  const int err = coop_plan(kernel, kBlockThreads, bytes, per_sm, sms);
  out[0] = (int)bytes; out[1] = per_sm; out[2] = sms; out[3] = kBlockThreads;
  return err;
}

// Launch a warp kernel cooperatively on `stream` without synchronizing:
// as many blocks as are resident, `bytes` of staged table each.  Ranges
// that do not ascend within the table are refused (cudaErrorInvalidValue).
// ctr: five ints of device memory, zero, that no other launch uses
// meanwhile (the kernel leaves them zero); live: R ints of scratch.
template <typename K>
static int launch_warp(K kernel, const BruteParams& p, size_t bytes, int* ctr, int* live,
                       void* stream) {
  if (p.n_ranges < 1 || p.n_ranges > kMaxBruteRanges || p.R < 0 || p.R > INT_MAX / 2 ||
      p.G < 0 || !ranges_ascend(p)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.R == 0) return 0;
  const SweepParams scan = scan_params(p);
  int plan[4];
  const int err = warp_plan(kernel, bytes, plan);
  if (err) return err;
  void* args[] = {const_cast<BruteParams*>(&p), const_cast<SweepParams*>(&scan), &ctr, &live};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3((unsigned)(plan[1] * plan[2])), dim3(kBlockThreads), args, bytes,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace rtt

// Plain C interface (loaded with ctypes).  The closest hits and the any-hit
// by the warp kernels; ctr and live as launch_warp says.
extern "C" int brute_closest_launch(
    const float* rays, const float* table, float* t, int* id,
    long long R, int G, const int* ranges, int n_ranges, int motion,
    int* ctr, int* live, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, nullptr, table, t, id, nullptr, nullptr, R, G, ranges, n_ranges, motion);
  return rtt::launch_warp(rtt::brute_warp_kernel<false>, p, rtt::brute_smem_bytes(G), ctr, live,
                          stream);
}

extern "C" int brute_closest_n_launch(
    const float* rays, const float* table, float* t, int* id, float* n,
    long long R, int G, const int* ranges, int n_ranges, int motion,
    int* ctr, int* live, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, nullptr, table, t, id, n, nullptr, R, G, ranges, n_ranges, motion);
  return rtt::launch_warp(rtt::brute_warp_kernel<true>, p, rtt::brute_smem_bytes(G), ctr, live,
                          stream);
}

extern "C" int occlusion_any_launch(
    const float* rays, const float* maxt, const float* table, uint8_t* blocked,
    long long R, int G, const int* ranges, int n_ranges, int* ctr, int* live,
    void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, maxt, table, nullptr, nullptr, nullptr, blocked, R, G, ranges, n_ranges, 0);
  return rtt::launch_warp(rtt::occlusion_warp_kernel, p, rtt::shadow_smem_bytes(G), ctr, live,
                          stream);
}

// What brute_closest_launch (want_n 0), brute_closest_n_launch (want_n 1)
// and occlusion_any_launch launch with for a table of G geoms: out[0..3] =
// shared memory bytes, resident blocks per SM, SMs, threads per block.
extern "C" int brute_closest_plan(int G, int want_n, int* out) {
  const size_t bytes = rtt::brute_smem_bytes(G);
  return want_n ? rtt::warp_plan(rtt::brute_warp_kernel<true>, bytes, out)
                : rtt::warp_plan(rtt::brute_warp_kernel<false>, bytes, out);
}

extern "C" int occlusion_any_plan(int G, int* out) {
  return rtt::warp_plan(rtt::occlusion_warp_kernel, rtt::shadow_smem_bytes(G), out);
}

// The one-thread-per-lane kernels they replaced.
extern "C" int brute_closest_lane_launch(
    const float* rays, const float* table, float* t, int* id,
    long long R, int G, const int* ranges, int n_ranges, int motion,
    int threads, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, nullptr, table, t, id, nullptr, nullptr, R, G, ranges,
      n_ranges, motion);
  return rtt::launch_brute(rtt::brute_closest_kernel, p, n_ranges, threads, stream);
}

extern "C" int brute_closest_n_lane_launch(
    const float* rays, const float* table, float* t, int* id, float* n,
    long long R, int G, const int* ranges, int n_ranges, int motion,
    int threads, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, nullptr, table, t, id, n, nullptr, R, G, ranges,
      n_ranges, motion);
  return rtt::launch_brute(rtt::brute_closest_n_kernel, p, n_ranges, threads, stream);
}

extern "C" int occlusion_any_lane_launch(
    const float* rays, const float* maxt, const float* table, uint8_t* blocked,
    long long R, int G, const int* ranges, int n_ranges,
    int threads, void* stream) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, maxt, table, nullptr, nullptr, nullptr, blocked, R, G, ranges,
      n_ranges, 0);
  return rtt::launch_brute(rtt::occlusion_any_kernel, p, n_ranges, threads, stream);
}

// The chunked brute closest hit by the warp schedule without boxes; ctr and
// live as launch_warp says.  The ring needs a 16-byte aligned table and a
// chunk of whole 16-byte copies: else cudaErrorInvalidValue.
extern "C" int brute_closest_chunked_launch(
    const float* rays, const float* table, float* t, int* id,
    long long R, int G, int chunk, int motion, int* ctr, int* live, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, nullptr, nullptr, table, t, id, nullptr, nullptr, R, G, chunk, motion);
  return rtt::launch_sweep_warp(rtt::sweep_warp_kernel<rtt::kSweepClosest, false, false>, p,
                                ctr, live, stream, false);
}

// What brute_closest_chunked_launch launches with for G rows in chunks of
// `chunk`: out[0..3] = shared memory bytes, resident blocks per SM, SMs,
// threads per block.
extern "C" int brute_closest_chunked_plan(int G, int chunk, int* out) {
  using namespace rtt;
  size_t bytes = 0;
  int per_sm = 0, sms = 0;
  const int err = sweep_warp_plan(sweep_warp_kernel<kSweepClosest, false, false>,
                                  (G + chunk - 1) / chunk, chunk, bytes, per_sm, sms, false);
  out[0] = (int)bytes; out[1] = per_sm; out[2] = sms; out[3] = kSweepThreads;
  return err;
}

// The one-thread-per-lane sweep it replaced.
extern "C" int brute_closest_chunked_lane_launch(
    const float* rays, const float* table, float* t, int* id,
    long long R, int G, int chunk, int motion, int threads, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, nullptr, nullptr, table, t, id, nullptr, nullptr, R, G, chunk, motion);
  return rtt::launch_sweep(rtt::sweep_kernel<rtt::kSweepClosest, false, false>, p,
                           threads, stream);
}

#endif  // __CUDACC__
