// The chunk sweep shared by the chunk-stream kernels (chunk_stream.cu) and
// the chunked brute kernel (closest_hit.cu), for sm_90a: closest hit,
// closest hit with the winner's normal, or shadow any-hit over a row-major
// (rows, 17) geom table of any size, whose rows are of mixed kinds.
//
// Replaces the grid dimension "chunk" of the TPU kernels
// kernels/chunk_stream.py::_closest_kernel, _closest_n_kernel,
// _occlusion_kernel and kernels/closest_hit.py::_brute_chunked_kernel of
// the JAX package, which keep (best t, id) in an output block that stays
// resident while the grid walks the chunks.  Here a thread holds one ray,
// the walk over the chunks is a loop inside the block, and the thread's
// (best t, row[, normal]) stay in registers for the whole sweep.
//
// Per chunk: each thread decides for its own ray whether it wants the
// chunk (CULL: its ray can hit the chunk's AABB no farther than its best t
// so far, or its shadow ray's max t; no CULL: it is live); the block
// stages the chunk's rows in shared memory, one contiguous copy, only if
// some thread wants it; the threads that want it run its rows, read as
// broadcasts.  The any-hit thread stops at its first blocker and wants no
// further chunk.  Rows are swept in ascending order with a strict <, and a
// culled chunk holds no hit at or below the best t, so the winner is the
// lowest row among equal hits: the plain row-order sweep of the whole
// table (kernels/closest_hit.py::mixed_closest_plain).
//
// The lane functions are plain C++ (see geom.cuh): a host compiler builds
// them for the check that runs without a GPU.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "geom.cuh"

namespace rtt {

constexpr int kSweepClosest = 0;   // (t, id)
constexpr int kSweepClosestN = 1;  // (t, id, unit normal)
constexpr int kSweepAnyHit = 2;    // blocked

struct SweepParams {
  const float* rays;   // (8, R)
  const float* maxt;   // (R,) any-hit only, else null
  const float* boxes;  // (NC, 6) one AABB per chunk; null without CULL
  const float* graze;  // (NC,) each box's distance-squared slack (geom.cuh); null without CULL
  const float* table;  // (rows >= G, 17) row-major
  float* t;            // (R,)
  int* id;             // (R,)
  float* n;            // (3, R) or null
  uint8_t* blocked;    // (R,) any-hit only, else null
  long long R;
  int G;               // real rows; the sweep stops here
  int chunk;           // rows per chunk
  int motion;
};

// One thread's state across the sweep.
struct SweepLane {
  Ray ray;
  Best best;     // closest modes: running winner; row = table row
  float maxt;    // any-hit: the shadow ray's reach
  bool open;     // still has tests to run: live and not yet blocked
  bool blocked;
};

template <int MODE>
RTT_DEV void sweep_begin(const SweepParams& p, size_t i, SweepLane& s) {
  const size_t R = (size_t)p.R;
  s.open = p.rays[7 * R + i] > 0.0f;
  s.blocked = false;
  s.best.t = kInf; s.best.row = -1;
  s.best.nx = 0.0f; s.best.ny = 0.0f; s.best.nz = 0.0f;
  // Shadow rays carry time 0 (Code/shapes.hpp:28): no origin is shifted.
  s.ray = make_ray(p.rays[0 * R + i], p.rays[1 * R + i], p.rays[2 * R + i],
                   p.rays[3 * R + i], p.rays[4 * R + i], p.rays[5 * R + i],
                   (MODE == kSweepAnyHit) ? 0.0f : p.rays[6 * R + i]);
  s.maxt = (MODE == kSweepAnyHit) ? p.maxt[i] : kInf;
}

// Does this thread run chunk c's rows?
template <int MODE, bool CULL>
RTT_DEV bool sweep_wants(const SweepParams& p, const SweepLane& s, int c) {
  if (!s.open) return false;
  if constexpr (CULL) {
    return box_hit(p.boxes + 6 * c, s.ray,
                   (MODE == kSweepAnyHit) ? s.maxt : s.best.t, p.graze[c]);
  }
  return true;
}

// Run n_rows rows starting at table row row0; `rows` points at the first
// (the block's staged copy on the device).
template <int MODE>
RTT_DEV void sweep_rows(const SweepParams& p, SweepLane& s, const float* rows,
                        int row0, int n_rows) {
  const bool motion = p.motion != 0;
  float nx, ny, nz;
  for (int j = 0; j < n_rows; ++j) {
    const float* row = rows + kGeomCols * j;
    if constexpr (MODE == kSweepAnyHit) {
      if (geom_t_mixed<false>(row, s.ray, false, nx, ny, nz) <= s.maxt) {
        s.blocked = true;
        s.open = false;
        return;
      }
    } else if constexpr (MODE == kSweepClosestN) {
      const float t = geom_t_mixed<true>(row, s.ray, motion, nx, ny, nz);
      if (t < s.best.t) {
        s.best.t = t; s.best.row = row0 + j;
        s.best.nx = nx; s.best.ny = ny; s.best.nz = nz;
      }
    } else {
      const float t = geom_t_mixed<false>(row, s.ray, motion, nx, ny, nz);
      if (t < s.best.t) { s.best.t = t; s.best.row = row0 + j; }
    }
  }
}

template <int MODE>
RTT_DEV void sweep_end(const SweepParams& p, size_t i, const SweepLane& s) {
  const size_t R = (size_t)p.R;
  if constexpr (MODE == kSweepAnyHit) {
    p.blocked[i] = s.blocked ? 1 : 0;
    return;
  }
  p.t[i] = s.best.t;
  // A winner has a finite t (strict < from +inf); its id is column 16 of
  // its row, rounded.  A dead lane never had a winner.
  p.id[i] = (s.best.row >= 0)
                ? (int)rintf(p.table[(size_t)kGeomCols * s.best.row + kIdCol])
                : -1;
  if constexpr (MODE == kSweepClosestN) {
    // Normalize the winning normal once, after the last chunk
    // (Code/shapes.cpp:186).
    float ln = sqrtf(s.best.nx * s.best.nx + s.best.ny * s.best.ny +
                     s.best.nz * s.best.nz);
    ln = (ln > 0.0f) ? ln : 1.0f;
    p.n[0 * R + i] = s.best.nx / ln;
    p.n[1 * R + i] = s.best.ny / ln;
    p.n[2 * R + i] = s.best.nz / ln;
  }
}

// The whole sweep of ray i over the table in place, chunk by chunk: what
// the kernel below computes for one thread, without the staging.
template <int MODE, bool CULL>
RTT_DEV void sweep_lane(const SweepParams& p, size_t i) {
  SweepLane s;
  sweep_begin<MODE>(p, i, s);
  const int nc = (p.G + p.chunk - 1) / p.chunk;
  for (int c = 0; c < nc; ++c) {
    if (!sweep_wants<MODE, CULL>(p, s, c)) continue;
    const int row0 = c * p.chunk;
    const int n_rows = (p.G - row0 < p.chunk) ? (p.G - row0) : p.chunk;
    sweep_rows<MODE>(p, s, p.table + (size_t)kGeomCols * row0, row0, n_rows);
  }
  sweep_end<MODE>(p, i, s);
}

inline SweepParams make_sweep_params(
    const float* rays, const float* maxt, const float* boxes, const float* graze,
    const float* table, float* t, int* id, float* n, uint8_t* blocked, long long R,
    int G, int chunk, int motion) {
  SweepParams p;
  p.rays = rays; p.maxt = maxt; p.boxes = boxes; p.graze = graze; p.table = table;
  p.t = t; p.id = id; p.n = n; p.blocked = blocked;
  p.R = R; p.G = G; p.chunk = chunk; p.motion = motion;
  return p;
}

}  // namespace rtt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace rtt {

template <int MODE, bool CULL>
__global__ void sweep_kernel(const SweepParams p) {
  extern __shared__ float chunk_rows[];  // (chunk, 17)
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < p.R;
  SweepLane s;
  s.open = false;
  if (in_range) sweep_begin<MODE>(p, (size_t)i, s);
  const int nc = (p.G + p.chunk - 1) / p.chunk;
  for (int c = 0; c < nc; ++c) {
    const bool want = sweep_wants<MODE, CULL>(p, s, c);
    // A barrier too: no thread restages the buffer while another still
    // reads the last chunk.  Every thread of the block reaches it.
    if (!__syncthreads_or(want)) continue;
    const int row0 = c * p.chunk;
    const int n_rows = min(p.chunk, p.G - row0);
    const float* src = p.table + (size_t)kGeomCols * row0;
    for (int k = threadIdx.x; k < kGeomCols * n_rows; k += blockDim.x)
      chunk_rows[k] = src[k];
    __syncthreads();
    if (want) sweep_rows<MODE>(p, s, chunk_rows, row0, n_rows);
  }
  if (in_range) sweep_end<MODE>(p, (size_t)i, s);
}

// Launch `kernel` over R rays on `stream` without synchronizing; returns
// cudaGetLastError() (0 = launched).
template <typename K>
static int launch_sweep(K kernel, const SweepParams& p, int threads, void* stream) {
  if (p.R < 0 || p.G < 1 || p.chunk < 1 || threads < 1)
    return (int)cudaErrorInvalidValue;
  if (p.R == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)kGeomCols * p.chunk;
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

#endif  // __CUDACC__
