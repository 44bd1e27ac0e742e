// The chunk sweeps shared by the chunk-stream kernels (chunk_stream.cu) and
// the chunked brute kernel (closest_hit.cu), for sm_90a: closest hit,
// closest hit with the winner's normal, or shadow any-hit over a row-major
// (rows, 17) geom table of any size, whose rows are of mixed kinds.
//
// Replaces the grid dimension "chunk" of the TPU kernels
// kernels/chunk_stream.py::_closest_kernel, _closest_n_kernel,
// _occlusion_kernel and kernels/closest_hit.py::_brute_chunked_kernel of
// the JAX package, which keep (best t, id) in an output block that stays
// resident while the grid walks the chunks.  Here a lane's (best t,
// row[, normal]) stay in registers for the whole walk, a loop inside the
// kernel.
//
// Two schedules over the same lane functions:
//
// sweep_kernel, one thread per lane over every lane of the tile (the oracle
// and A/B baseline of the schedule below, which the package does not
// launch).  Per
// chunk, in row order: each thread decides for its own ray
// whether it wants the chunk (CULL: its ray can hit the chunk's AABB no
// farther than its best t so far, or its shadow ray's max t; no CULL: it is
// live); the block stages the chunk's rows in shared memory if some thread
// wants it, behind two block barriers; the threads that want it run its
// rows.  What that costs on an H100 (PERF.md §6): dead lanes are
// launched and walk every chunk's barriers; a block with one wanting thread
// stages the chunk and its warp runs 256 rows at 1/32 occupancy (a third of
// the lane slots run a test on level-1 rays); the copy never overlaps
// compute.
//
// sweep_warp_kernel (chunk_closest, chunk_closest_n, chunk_occlusion; and,
// BOXES false, brute_closest_chunked), one cooperative launch of persistent
// blocks:
// - Phase 1, scan.  Warps take steps of kWarpScan lanes from a counter, four
//   lanes a thread.  A dead lane (act <= 0) gets its outputs there (16-byte
//   stores where four neighbours are dead); live lanes are appended to one
//   list for the launch (warp prefix sums of popc, one atomic a step).
// - A grid barrier, then phase 2: warps take 32 lanes of that list at a
//   time from a counter (an equal share when the list is short), so every
//   warp is dense with live rays and no block waits for another.
// - The chunks' boxes and slacks are staged once a block in shared memory.
// - The cull is per warp, without a block barrier: a chunk is run when some
//   lane of the warp wants it (__any_sync); a chunk no lane wants costs the
//   warp one box test a lane.  Rows reach the warp through a ring of two
//   buffers of its own, kRingRows rows each, filled ahead of use by
//   cp.async.bulk on an mbarrier.  Measured on an H100 against warp-uniform
//   loads through L1 (the table of a 20,001-geom scene is 1.4 MB and sits in
//   L2), the ring was the faster at every level and on shadow rays
//   (PERF.md §6).
// - When at most half of the warp wants a chunk (incoherent rays), each
//   wanting lane's rows are split over a group of lanes (split_lanes: up to
//   all 32 for a lone lane), which take its ray by shuffles, run a strided
//   slice of the rows and merge their winners or blocked flags back into
//   it: the lane slots stay full.
// - Closest hit visits the nearest chunk first.  Each lane box-tests every
//   chunk once, the warp keys each chunk by its lanes' least entry distance
//   and ranks the keys (kOrderCap chunks at a time), and visits them in that
//   order; before each chunk each lane re-tests the box against its current
//   best t, and the warp stops a window at the first chunk whose key is
//   beyond every lane's best t.  The running winner merges by (t, row)
//   lexicographically, so the lowest row wins among equal hits whatever the
//   order: the row-order strict-< sweep's answer.  The loop carries no
//   normal: the winner's is computed once, after the last chunk.
// - Any-hit visits chunks in row order; a blocked lane is done, and the
//   warp leaves once no lane is open (__any_sync).
// - BOXES false (brute_closest_chunked: a load-order table without chunk
//   boxes): nothing is staged, keyed or ordered; a warp runs every chunk in
//   row order on its live lanes, through the same ring and the same split of
//   short tasks over helper lanes.
// The cull only removes provable misses (box_hit's slack, geom.cuh), so both
// schedules equal the plain sweep of the whole table in row order
// (kernels/closest_hit.py::mixed_closest_plain) bit for bit.
//
// The lane functions and the warp schedule's steps are plain C++ (see
// geom.cuh): a host compiler builds them, and tests/test_torch_kernel_source.py
// runs both schedules from them with g++.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "geom.cuh"
#include "persist.cuh"

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
  unsigned long long* work;  // (3,) counts of a counting build (sweep_work), else null
  long long R;
  int G;               // real rows; the sweep stops here
  int chunk;           // rows per chunk
  int motion;
  int vec4;            // R % 4 == 0 and the rows 16-byte aligned: the scan's wide stores
};

// One lane's state across the sweep.
struct SweepLane {
  Ray ray;
  Best best;     // closest modes: running winner; row = table row
  float maxt;    // any-hit: the shadow ray's reach
  bool open;     // still has tests to run: live and not yet blocked
  bool blocked;
};

// What a counting build counts (COUNT): per lane the geom tests it ran (an
// any-hit lane up to its blocker) and its box tests; per warp the lane slots
// of the rows it issued (32 x the most rows any of its lanes ran in each
// chunk it entered).  Summed into SweepParams::work[0..2].
struct SweepWork {
  uint32_t tests, boxes, slots;
};

RTT_DEV void sweep_idle(SweepLane& s) {
  s.open = false;
  s.blocked = false;
  s.best.t = kInf; s.best.row = -1;
  s.best.nx = 0.0f; s.best.ny = 0.0f; s.best.nz = 0.0f;
  s.ray = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  s.maxt = kInf;
}

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

// The distance a chunk's box is tested against: the best t so far, or the
// shadow ray's reach.
template <int MODE>
RTT_DEV float sweep_bound(const SweepLane& s) {
  return (MODE == kSweepAnyHit) ? s.maxt : s.best.t;
}

// Does this lane run the rows of the chunk whose box is `box` (6 floats)
// with slack `graze`?
template <int MODE>
RTT_DEV bool sweep_wants_box(const float* box, float graze, const SweepLane& s) {
  return s.open && box_hit(box, s.ray, sweep_bound<MODE>(s), graze);
}

// Does this thread run chunk c's rows?
template <int MODE, bool CULL>
RTT_DEV bool sweep_wants(const SweepParams& p, const SweepLane& s, int c) {
  if constexpr (CULL) return sweep_wants_box<MODE>(p.boxes + 6 * c, p.graze[c], s);
  return s.open;
}

// Run rows first, first + step, ... below n_rows of the n_rows starting at
// table row row0; `rows` points at the first (a staged copy or the table
// itself).  LEX: the winner merges by (t, row) lexicographically, which any
// order of rows needs; without it, by a strict <, which is the same in
// ascending row order.  Returns the rows run (an any-hit lane stops at its
// first blocker).
template <int MODE, bool LEX = false>
RTT_DEV int sweep_rows(const SweepParams& p, SweepLane& s, const float* rows,
                       int row0, int n_rows, int first = 0, int step = 1) {
  const bool motion = p.motion != 0;
  float nx, ny, nz;
  int ran = 0;
  for (int j = first; j < n_rows; j += step) {
    const float* row = rows + kGeomCols * j;
    ++ran;
    if constexpr (MODE == kSweepAnyHit) {
      if (geom_t_mixed<false>(row, s.ray, false, nx, ny, nz) <= s.maxt) {
        s.blocked = true;
        s.open = false;
        return ran;
      }
    } else {
      const float t = geom_t_mixed<MODE == kSweepClosestN>(row, s.ray, motion, nx, ny, nz);
      if (t < s.best.t || (LEX && t == s.best.t && row0 + j < s.best.row)) {
        s.best.t = t; s.best.row = row0 + j;
        if constexpr (MODE == kSweepClosestN) {
          s.best.nx = nx; s.best.ny = ny; s.best.nz = nz;
        }
      }
    }
  }
  return ran;
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
  // The winning normal, normalized once after the last chunk.
  if constexpr (MODE == kSweepClosestN) store_unit_normal(p.n, R, i, s.best.nx, s.best.ny, s.best.nz);
}

// The whole sweep of ray i over the table in place, chunk by chunk: what
// sweep_kernel computes for one thread, without the staging.
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
    int G, int chunk, int motion, unsigned long long* work = nullptr) {
  SweepParams p;
  p.rays = rays; p.maxt = maxt; p.boxes = boxes; p.graze = graze; p.table = table;
  p.t = t; p.id = id; p.n = n; p.blocked = blocked; p.work = work;
  p.R = R; p.G = G; p.chunk = chunk; p.motion = motion;
  const auto al16 = [](const void* a) { return (uintptr_t)a % 16 == 0; };
  p.vec4 = (R % 4 == 0) && al16(rays) && al16(t) && al16(id) && al16(n) &&
           (uintptr_t)blocked % 4 == 0;
  return p;
}

// ------------------------------------------------- the warp schedule's steps

// The warp schedule runs a closest hit's rows without the normal, (t, row)
// only; the winner's normal is the same geom test run once more on its row
// (sweep_winner_normal): the bits the loop would have carried.
template <int MODE>
constexpr int kLoopMode = (MODE == kSweepClosestN) ? kSweepClosest : MODE;

template <int MODE>
RTT_DEV void sweep_winner_normal(const SweepParams& p, SweepLane& s) {
  if constexpr (MODE == kSweepClosestN) {
    if (s.best.row >= 0) {
      geom_t_mixed<true>(p.table + (size_t)kGeomCols * s.best.row, s.ray, p.motion != 0,
                         s.best.nx, s.best.ny, s.best.nz);
    }
  }
}

constexpr int kWarpScan = 128;     // lanes of one scan step: four a thread of one warp
constexpr int kOrderCap = 128;     // chunks a warp orders at once (one window)
constexpr uint32_t kNoKey = 0xffffffffu;
constexpr int kRingRows = 32;      // rows of one bulk copy of the ring route

// A lane that enters dead leaves with a miss: t = +inf, id = -1, normal 0;
// not blocked.
template <int MODE>
RTT_DEV void sweep_dead(const SweepParams& p, size_t i) {
  const size_t R = (size_t)p.R;
  if constexpr (MODE == kSweepAnyHit) {
    p.blocked[i] = 0;
    return;
  }
  p.t[i] = kInf;
  p.id[i] = -1;
  if constexpr (MODE == kSweepClosestN) {
    p.n[0 * R + i] = 0.0f; p.n[1 * R + i] = 0.0f; p.n[2 * R + i] = 0.0f;
  }
}

// Scan of lanes [base, base + 4) within R: writes the outputs of each dead
// one (16-byte stores, or one 4-byte store of `blocked`, when all four are
// dead and the rows allow); returns the live ones as bits 0..3.
template <int MODE>
RTT_DEV unsigned sweep_scan4(const SweepParams& p, long long base) {
  const long long R = p.R;
  if (base >= R) return 0;
  if (p.vec4 && base + 4 <= R) {
    const F4 a = load4(p.rays + 7 * R + base);
    const unsigned live = (a.x > 0.0f ? 1u : 0u) | (a.y > 0.0f ? 2u : 0u) |
                          (a.z > 0.0f ? 4u : 0u) | (a.w > 0.0f ? 8u : 0u);
    if (live == 0) {
      if constexpr (MODE == kSweepAnyHit) {
        store_u32(p.blocked + base, 0u);
      } else {
        const F4 inf = {kInf, kInf, kInf, kInf};
        const float none = u32_as_f32(0xffffffffu);
        const F4 ids = {none, none, none, none};
        store4(p.t + base, inf);
        store4(reinterpret_cast<float*>(p.id) + base, ids);
        if constexpr (MODE == kSweepClosestN) {
          const F4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int row = 0; row < 3; ++row) store4(p.n + row * R + base, zero);
        }
      }
      return 0;
    }
    for (int j = 0; j < 4; ++j) {
      if (!((live >> j) & 1u)) sweep_dead<MODE>(p, (size_t)(base + j));
    }
    return live;
  }
  unsigned live = 0;
  for (int j = 0; j < 4 && base + j < R; ++j) {
    if (p.rays[7 * R + base + j] > 0.0f) live |= 1u << j;
    else sweep_dead<MODE>(p, (size_t)(base + j));
  }
  return live;
}

// When only k lanes of a warp want a chunk, each of them has its rows split
// over a group of lanes: the largest power of two g with g * k <= 32; 1 (no
// split) when more than half want it.
RTT_HD int split_lanes(int k) {
  int g = 1;
  while (g < 32 && 2 * g * k <= 32) g *= 2;
  return g;
}

// A helper's state for one chunk: its owner's ray and reach, a best of its
// own.
RTT_DEV SweepLane sweep_helper(const SweepLane& owner) {
  SweepLane h = owner;
  h.best.t = kInf; h.best.row = -1;
  h.blocked = false;
  return h;
}

// Merge a helper's result into `s`: the lower (t, row), or blocked.  The
// order in which helpers merge does not matter: (t, row) is a total order.
template <int MODE>
RTT_DEV void sweep_merge(SweepLane& s, float t, int row, bool blocked) {
  if constexpr (MODE == kSweepAnyHit) {
    if (blocked) { s.blocked = true; s.open = false; }
  } else {
    best_merge(s.best, t, row);
  }
}

// Lanes of the list a warp takes at a time: 32, or an equal share of a
// short list over the launch's n_warps warps, so that every warp gets some;
// a warp's lanes without a ray of their own help the others by the split.
RTT_HD int warp_task(long long n_live, long long n_warps) {
  const long long share = (n_live + n_warps - 1) / n_warps;
  return (int)(share < 32 ? (share > 0 ? share : 1) : 32);
}

// An f32 as an unsigned int of the same order (-0 just below +0); NaN is
// never keyed.
RTT_DEV uint32_t order_key(float e) {
  const uint32_t b = f32_as_u32(e);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

RTT_DEV float key_dist(uint32_t k) {
  return u32_as_f32((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The lane's key for the chunk whose box is `box`: its entry distance,
// ordered; kNoKey when it cannot want the chunk whatever its best t (not
// open, or box_hit fails at a bound of +inf).  The miss flag is kept apart
// from the distance: a missed box's entry may read +inf, which `<= +inf`
// would take.
RTT_DEV uint32_t sweep_key(const float* box, float graze, const SweepLane& s) {
  if (!s.open) return kNoKey;
  float e;
  return (box_entry(box, s.ray, graze, e) && e <= kInf) ? order_key(e) : kNoKey;
}

// Rank sort of one window of wn keys (keys[j] of chunk w0 + j), by lane
// `lane` of `n_lanes`: the entries j = lane, lane + n_lanes, ... find their
// place among the (key, j) pairs in ascending order and write j there; a
// chunk that no lane wants (kNoKey) gets no place.  Every lane returns how
// many got one.
RTT_DEV int order_window(const uint32_t* keys, uint8_t* order, int wn, int lane, int n_lanes) {
  int wanted = 0;
  for (int i = 0; i < wn; ++i) wanted += keys[i] != kNoKey;
  for (int j = lane; j < wn; j += n_lanes) {
    const uint32_t kj = keys[j];
    if (kj == kNoKey) continue;
    int rank = 0;
    for (int i = 0; i < wn; ++i) {
      const uint32_t ki = keys[i];
      rank += (ki < kj) || (ki == kj && i < j);
    }
    order[rank] = (uint8_t)j;
  }
  return wanted;
}

// Rows of the ring route's bulk copies for this chunk size: a divisor of
// the chunk that keeps each copy a multiple of 16 bytes; 0 when none does.
RTT_HD int ring_rows(int chunk) {
  const int r = chunk < kRingRows ? chunk : kRingRows;
  return (r % 4 == 0 && chunk % r == 0) ? r : 0;
}

// Byte offsets of one block's shared memory: per warp two mbarriers,
// kOrderCap keys and kOrderCap order entries (with boxes only), two ring
// buffers; then the boxes (NC, 6) and slacks (NC,) where they are staged.
struct SweepLayout {
  size_t keys, order, ring, boxes, bytes;
};

constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
// The box table is staged in shared memory up to this many chunks (28 KB);
// beyond, the warps read it from global memory.
constexpr int kStageChunks = 1024;

RTT_HD SweepLayout sweep_layout(int nc, int chunk, bool boxes = true) {
  SweepLayout o;
  o.keys = 16 * kSweepWarps;
  o.order = o.keys + (boxes ? 4 * (size_t)kOrderCap * kSweepWarps : 0);
  o.ring = (o.order + (boxes ? (size_t)kOrderCap * kSweepWarps : 0) + 15) & ~(size_t)15;
  const size_t ring_bytes = 2 * 4 * (size_t)kGeomCols * ring_rows(chunk);
  o.boxes = o.ring + ring_bytes * kSweepWarps;
  o.bytes = o.boxes + (boxes && nc <= kStageChunks ? 28 * (size_t)nc : 0);
  return o;
}

}  // namespace rtt

#ifdef __CUDACC__

#include <cuda_runtime.h>
#include <limits.h>

namespace rtt {

constexpr unsigned kFull = 0xffffffffu;

// Resident blocks per SM the warp kernel is built for: 4 caps it at 64
// registers (a few bytes spill); measured on an H100 it was faster than 3
// (80 registers) and 5 (48, more spills) (PERF.md §6).
constexpr int kSweepMinBlocks = 4;

template <int MODE, bool CULL, bool COUNT>
__global__ void sweep_kernel(const SweepParams p) {
  extern __shared__ float chunk_rows[];  // (chunk, 17)
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < p.R;
  SweepLane s;
  s.open = false;
  if (in_range) sweep_begin<MODE>(p, (size_t)i, s);
  SweepWork w = {0, 0, 0};
  const int nc = (p.G + p.chunk - 1) / p.chunk;
  for (int c = 0; c < nc; ++c) {
    if (COUNT && CULL && s.open) ++w.boxes;
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
    const int ran = want ? sweep_rows<MODE>(p, s, chunk_rows, row0, n_rows) : 0;
    if constexpr (COUNT) {
      w.tests += ran;
      const unsigned most = __reduce_max_sync(kFull, (unsigned)ran);
      if ((threadIdx.x & 31) == 0) w.slots += 32 * most;
    }
  }
  if (in_range) sweep_end<MODE>(p, (size_t)i, s);
  if constexpr (COUNT) {
    const unsigned tests = __reduce_add_sync(kFull, w.tests);
    const unsigned boxes = __reduce_add_sync(kFull, w.boxes);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&p.work[0], (unsigned long long)tests);
      atomicAdd(&p.work[1], (unsigned long long)boxes);
      atomicAdd(&p.work[2], (unsigned long long)w.slots);
    }
  }
}

// Launch `kernel` over R rays on `stream` without synchronizing; returns
// cudaGetLastError() (0 = launched).
template <typename K>
static int launch_sweep(K kernel, const SweepParams& p, int threads, void* stream) {
  if (p.R < 0 || p.G < 1 || p.chunk < 1 || threads < 1 || threads % 32)
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

// ------------------------------------------------------ the warp schedule

// The warp's two ring buffers: rows of the chunk being run arrive
// piece by piece, kRingRows rows a copy, the next copy in flight while the
// warp runs the last.
struct WarpRing {
  float* buf;        // two buffers of `rows` rows
  uint32_t bar;      // two mbarriers, 8 bytes apart
  uint32_t parity;   // bit b: the phase buffer b waits for next
  int rows;
};

// Lane 0: start the copy of piece k (the rows from table row row0 + k *
// rows, at most `rows` of the chunk's n_rows) into buffer k & 1.  The warp
// has stopped reading that buffer (__syncwarp before); the proxy fence
// orders those reads and writes before the asynchronous write.  A piece of a
// table's last rows whose bytes are no multiple of 16 gets its last one to
// three floats by plain stores, which the warp sees after its next
// __syncwarp: no byte past the table's last row is read.
__device__ __forceinline__ void ring_issue(const WarpRing& rg, const float* table, int row0,
                                           int n_rows, int k) {
  const int b = k & 1;
  const int floats = kGeomCols * min(rg.rows, n_rows - k * rg.rows);
  const uint32_t bytes = (4u * floats) & ~15u;
  float* dst = rg.buf + (size_t)b * kGeomCols * rg.rows;
  const float* src = table + (size_t)kGeomCols * (row0 + k * rg.rows);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bulk_copy(smem_u32(dst), src, bytes, rg.bar + 8 * b);
  for (int j = bytes / 4; j < floats; ++j) dst[j] = src[j];
}

// Rows of chunk c for lane state `s`: rows first, first + step, ... of the
// chunk, piece by piece through the ring.  The piece loop is the warp's:
// every lane takes part; `go` says whether this lane runs rows.  Returns the
// rows run.
template <int MODE>
__device__ __forceinline__ int warp_rows(const SweepParams& p, SweepLane& s, WarpRing& rg,
                                         bool go, int c, int first, int step) {
  const int lane = threadIdx.x & 31;
  const int row0 = c * p.chunk;
  const int n_rows = min(p.chunk, p.G - row0);
  int ran = 0;
  const int n_pieces = (n_rows + rg.rows - 1) / rg.rows;
  if (lane == 0) {
    ring_issue(rg, p.table, row0, n_rows, 0);
    if (n_pieces > 1) ring_issue(rg, p.table, row0, n_rows, 1);
  }
  __syncwarp();
  for (int k = 0; k < n_pieces; ++k) {
    const int b = k & 1;
    mbar_wait(rg.bar + 8 * b, (rg.parity >> b) & 1u);
    rg.parity ^= 1u << b;
    const int at = k * rg.rows;
    if (go && s.open) {
      ran += sweep_rows<kLoopMode<MODE>, true>(p, s, rg.buf + (size_t)b * kGeomCols * rg.rows,
                                               row0 + at, min(rg.rows, n_rows - at), first,
                                               step);
    }
    __syncwarp();
    if (lane == 0 && k + 2 < n_pieces) ring_issue(rg, p.table, row0, n_rows, k + 2);
  }
  return ran;
}

// Run chunk c on the lanes that want it (`ball`, __ballot_sync of want).
// When more than half of the warp wants it, each such lane runs all the
// chunk's rows; else each wanting lane's rows are split over a group of
// split_lanes(k) lanes, which take its ray by shuffles and their slice of
// the rows, and merge their winners (or blocked flags) back into it.
template <int MODE, bool COUNT>
__device__ __forceinline__ void warp_chunk(const SweepParams& p, SweepLane& s, WarpRing& rg,
                                           bool want, unsigned ball, int c, SweepWork& w) {
  constexpr int LM = kLoopMode<MODE>;
  const int lane = threadIdx.x & 31;
  const int k = __popc(ball);
  const int g = split_lanes(k);
  int ran;
  if (g == 1) {
    ran = warp_rows<MODE>(p, s, rg, want, c, 0, 1);
  } else {
    const int q = lane / g;
    const bool helps = q < k;
    const int owner = helps ? (int)__fns(ball, 0, q + 1) : lane;
    SweepLane h = sweep_helper(s);
    h.ray.ox = __shfl_sync(kFull, s.ray.ox, owner);
    h.ray.oy = __shfl_sync(kFull, s.ray.oy, owner);
    h.ray.oz = __shfl_sync(kFull, s.ray.oz, owner);
    h.ray.dx = __shfl_sync(kFull, s.ray.dx, owner);
    h.ray.dy = __shfl_sync(kFull, s.ray.dy, owner);
    h.ray.dz = __shfl_sync(kFull, s.ray.dz, owner);
    h.ray.tm = __shfl_sync(kFull, s.ray.tm, owner);
    h.ray.dnorm = __shfl_sync(kFull, s.ray.dnorm, owner);
    h.maxt = __shfl_sync(kFull, s.maxt, owner);
    h.open = helps;
    ran = warp_rows<MODE>(p, h, rg, helps, c, lane % g, g);
    for (int o = g / 2; o > 0; o >>= 1) {
      const float t2 = __shfl_xor_sync(kFull, h.best.t, o);
      const int row2 = __shfl_xor_sync(kFull, h.best.row, o);
      const int b2 = __shfl_xor_sync(kFull, (int)h.blocked, o);
      sweep_merge<LM>(h, t2, row2, b2 != 0);
    }
    // The group's first lane holds the group's result; its owner takes it.
    const int src = want ? g * __popc(ball & ((1u << lane) - 1u)) : lane;
    const float t2 = __shfl_sync(kFull, h.best.t, src);
    const int row2 = __shfl_sync(kFull, h.best.row, src);
    const int b2 = __shfl_sync(kFull, (int)h.blocked, src);
    if (want) sweep_merge<LM>(s, t2, row2, b2 != 0);
  }
  if constexpr (COUNT) {
    w.tests += ran;
    const unsigned most = __reduce_max_sync(kFull, (unsigned)ran);
    if (lane == 0) w.slots += 32 * most;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Phase 2 of one warp's 32 lanes, closest hit: nearest chunk first, window
// by window.
template <int MODE, bool COUNT>
__device__ void warp_closest(const SweepParams& p, SweepLane& s, WarpRing& rg, const float* bx,
                             const float* gz, uint32_t* keys, uint8_t* order, int nc,
                             SweepWork& w) {
  const int lane = threadIdx.x & 31;
  for (int w0 = 0; w0 < nc; w0 += kOrderCap) {
    const int wn = min(kOrderCap, nc - w0);
    for (int j = 0; j < wn; ++j) {
      const uint32_t k = sweep_key(bx + 6 * (w0 + j), gz[w0 + j], s);
      const uint32_t least = __reduce_min_sync(kFull, k);
      if (lane == (j & 31)) keys[j] = least;
    }
    if (COUNT && s.open) w.boxes += wn;
    __syncwarp();
    const int m = order_window(keys, order, wn, lane, 32);
    __syncwarp();
    float reach = warp_max(s.open ? s.best.t : -kInf);
    for (int q = 0; q < m; ++q) {
      const int j = order[q];
      // Every lane's entry into this chunk and all later ones of the window
      // lies beyond its best t: none wants them.
      if (key_dist(keys[j]) > reach) break;
      const int c = w0 + j;
      if (COUNT && s.open) ++w.boxes;
      const bool want = sweep_wants_box<MODE>(bx + 6 * c, gz[c], s);
      const unsigned ball = __ballot_sync(kFull, want);
      if (!ball) continue;
      warp_chunk<MODE, COUNT>(p, s, rg, want, ball, c, w);
      reach = warp_max(s.open ? s.best.t : -kInf);
    }
    __syncwarp();  // keys and order are read no more
  }
}

// Phase 2 of one warp's 32 lanes, any-hit: chunks in row order until no
// lane is open.
template <bool COUNT>
__device__ void warp_any_hit(const SweepParams& p, SweepLane& s, WarpRing& rg, const float* bx,
                             const float* gz, int nc, SweepWork& w) {
  for (int c = 0; c < nc; ++c) {
    if (!__any_sync(kFull, s.open)) break;
    if (COUNT && s.open) ++w.boxes;
    const bool want = sweep_wants_box<kSweepAnyHit>(bx + 6 * c, gz[c], s);
    const unsigned ball = __ballot_sync(kFull, want);
    if (!ball) continue;
    warp_chunk<kSweepAnyHit, COUNT>(p, s, rg, want, ball, c, w);
  }
}

// Phase 2 of one warp's 32 lanes without boxes: every chunk in row order,
// on the lanes that are live.
template <int MODE, bool COUNT>
__device__ void warp_sweep_all(const SweepParams& p, SweepLane& s, WarpRing& rg, int nc,
                               SweepWork& w) {
  const unsigned ball = __ballot_sync(kFull, s.open);
  if (!ball) return;
  for (int c = 0; c < nc; ++c) warp_chunk<MODE, COUNT>(p, s, rg, s.open, ball, c, w);
}

// Phase 1 of a cooperative launch, scan: warps take steps of kWarpScan
// lanes from ctr[0]; dead lanes get their outputs here (sweep_scan4), live
// ones are appended to `live` (warp prefix sums of popc, one atomic on
// ctr[1] a step).  Also the scan of occlusion_any's warp kernel
// (closest_hit.cu), in the any-hit mode.
template <int MODE>
__device__ __forceinline__ void warp_scan_list(const SweepParams& p, int* ctr, int* live) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int step = 0;
    if (lane == 0) step = atomicAdd(&ctr[0], 1);
    step = __shfl_sync(kFull, step, 0);
    const long long base = (long long)step * kWarpScan;
    if (base >= p.R) break;
    const unsigned live4 = sweep_scan4<MODE>(p, base + 4 * lane);
    const int cnt = __popc(live4);
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int pos = 0;
    if (lane == 0 && total) pos = atomicAdd(&ctr[1], total);
    pos = __shfl_sync(kFull, pos, 0) + incl - cnt;
    for (int j = 0; j < 4; ++j) {
      if ((live4 >> j) & 1u) live[pos++] = (int)(base + 4 * lane + j);
    }
  }
}

// The end of a cooperative launch: the last block to leave zeroes the five
// counters again.
__device__ __forceinline__ void coop_release(int* ctr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's last take comes before its count
    if (atomicAdd(&ctr[4], 1) == (int)gridDim.x - 1) {
      for (int k = 0; k < 4; ++k) atomicExch(&ctr[k], 0);
      atomicExch(&ctr[4], 0);
    }
  }
}

// ctr: five ints, zero at launch; the last block to leave zeroes them
// again: [0] next scan step, [1] lanes listed, [2] blocks past the scan,
// [3] next lane of the list to take, [4] blocks done.  live: R ints, the
// launch's list of live lanes.  Launched cooperatively: every block is
// resident, so the grid barrier cannot wait on a block that never runs.
template <int MODE, bool COUNT, bool BOXES = true>
__global__ void __launch_bounds__(kSweepThreads, kSweepMinBlocks)
sweep_warp_kernel(const SweepParams p, int* ctr, int* live) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (p.G + p.chunk - 1) / p.chunk;
  const SweepLayout lay = sweep_layout(nc, p.chunk, BOXES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The boxes and slacks, once a block.
  const bool staged = BOXES && nc <= kStageChunks;
  float* sbox = reinterpret_cast<float*>(smem_raw + lay.boxes);
  if (staged) {
    for (int k = tid; k < 6 * nc; k += kSweepThreads) sbox[k] = p.boxes[k];
    for (int k = tid; k < nc; k += kSweepThreads) sbox[6 * nc + k] = p.graze[k];
  }
  const float* bx = staged ? sbox : p.boxes;
  const float* gz = staged ? sbox + 6 * nc : p.graze;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw + lay.keys) + warp * kOrderCap;
  uint8_t* order = smem_raw + lay.order + warp * kOrderCap;
  WarpRing rg;
  rg.rows = ring_rows(p.chunk);
  rg.buf = reinterpret_cast<float*>(smem_raw + lay.ring) + (size_t)warp * 2 * kGeomCols * rg.rows;
  rg.bar = smem_u32(smem_raw + 16 * warp);
  rg.parity = 0;
  if (lane == 0) {
    mbar_init(rg.bar);
    mbar_init(rg.bar + 8);
  }

  warp_scan_list<MODE>(p, ctr, live);

  // Phase 2, after every lane is listed: warps take warp_task lanes at a
  // time.
  grid_barrier(&ctr[2]);  // also: the staged boxes and the barriers' init
  const int n_live = *reinterpret_cast<volatile int*>(&ctr[1]);
  const int task = warp_task(n_live, (long long)gridDim.x * kSweepWarps);
  SweepWork w = {0, 0, 0};
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(&ctr[3], task);
    first = __shfl_sync(kFull, first, 0);
    if (first >= n_live) break;
    const int e = first + lane;
    const bool mine = lane < task && e < n_live;
    SweepLane s;
    sweep_idle(s);
    const size_t i = mine ? (size_t)live[e] : 0;
    if (mine) sweep_begin<MODE>(p, i, s);
    if constexpr (!BOXES) {
      warp_sweep_all<MODE, COUNT>(p, s, rg, nc, w);
    } else if constexpr (MODE == kSweepAnyHit) {
      warp_any_hit<COUNT>(p, s, rg, bx, gz, nc, w);
    } else {
      warp_closest<MODE, COUNT>(p, s, rg, bx, gz, keys, order, nc, w);
    }
    if (mine) {
      sweep_winner_normal<MODE>(p, s);
      sweep_end<MODE>(p, i, s);
    }
  }
  if constexpr (COUNT) {
    const unsigned tests = __reduce_add_sync(kFull, w.tests);
    const unsigned boxes = __reduce_add_sync(kFull, w.boxes);
    if (lane == 0) {
      atomicAdd(&p.work[0], (unsigned long long)tests);
      atomicAdd(&p.work[1], (unsigned long long)boxes);
      atomicAdd(&p.work[2], (unsigned long long)w.slots);
    }
  }
  coop_release(ctr);
}

// A cooperative kernel of `threads` threads a block with `bytes` of
// dynamic shared memory: the attribute set, its resident blocks per SM and
// the SM count.  0 or a CUDA error.
template <typename K>
inline int coop_plan(K kernel, int threads, size_t bytes, int& per_sm, int& sms) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  }
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  return (int)e;
}

// The warp kernel's shared memory for this table and coop_plan's answer.
template <typename K>
inline int sweep_warp_plan(K kernel, int nc, int chunk, size_t& bytes, int& per_sm, int& sms,
                           bool boxes = true) {
  bytes = sweep_layout(nc, chunk, boxes).bytes;
  if (ring_rows(chunk) == 0) return (int)cudaErrorInvalidValue;
  return coop_plan(kernel, kSweepThreads, bytes, per_sm, sms);
}

// Launch the warp schedule cooperatively on `stream` without
// synchronizing; returns cudaGetLastError() (0 = launched).  The ring's
// bulk copies need a 16-byte aligned table and a chunk of whole 16-byte
// copies (ring_rows > 0, checked by the plan): else cudaErrorInvalidValue.
// boxes: the kernel's BOXES.
template <typename K>
static int launch_sweep_warp(K kernel, const SweepParams& p, int* ctr, int* live,
                             void* stream, bool boxes = true) {
  if (p.R < 0 || p.R > INT_MAX / 2 || p.G < 1 || p.chunk < 1 ||
      (uintptr_t)p.table % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.R == 0) return 0;
  size_t bytes;
  int per_sm, sms;
  const int nc = (p.G + p.chunk - 1) / p.chunk;
  const int err = sweep_warp_plan(kernel, nc, p.chunk, bytes, per_sm, sms, boxes);
  if (err) return err;
  SweepParams q = p;
  void* args[] = {&q, &ctr, &live};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3((unsigned)(per_sm * sms)), dim3(kSweepThreads), args, bytes,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace rtt

#endif  // __CUDACC__
