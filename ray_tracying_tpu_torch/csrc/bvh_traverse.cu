// Closest hit by LBVH traversal, for sm_90a: bvh_closest (t, id) and
// bvh_closest_n (t, id, the winner's unit normal).
//
// Replaces the TPU kernel kernels/bvh_traverse.py::_bvh_kernel of the JAX
// package, which shares one scalar stack among the 2048 rays of a block
// and orders children by the block's mean direction because a stack per
// lane does not vectorize there.  On this card a stack per thread is the
// natural form.  The plain PyTorch version is
// kernels/bvh_traverse.py::bvh_closest_plain of this package: the row-order
// sweep of the same Morton-ordered table, no tree.  The TPU kernel has no
// normal-carrying form: under use_bvh the JAX package rebuilds the normal
// in pass 2, whose arithmetic differs in the last bit from the fused-normal
// brute kernel's, so its two images of one scene are not byte-equal.
// bvh_closest_n gives the normal brute_closest_n gives (same geom test,
// same normalization), which makes them so.
//
// Bound on an H100: operations on coherent rays (the box tests and geom
// tests a ray cannot prune, about 28 and 80 f32 operations each), memory
// latency on incoherent ones (each lane walks its own nodes).
//
// Design (bvh_warp_kernel<WANT_N, COUNT>), one cooperative launch of
// persistent blocks:
// - Phase 1, the scan of the sweeps (sweep.cuh::warp_scan_list): dead lanes
//   get their miss (t = +inf, id = -1, normal 0), live ones are listed.  A
//   grid barrier; then warps take warp_task listed lanes at a time, so that
//   neighbours in the tile (coherent camera rays) share a warp.
// - The tree as the kernel reads it (accel/lbvh.py::pack_bvh, built once on
//   the host): one 64-byte record per inner node with both children's boxes,
//   their slacks and their references (an inner node's record index, or a
//   leaf's ~(first << 3 | count)), and the Morton-ordered table as 64-byte
//   rows (columns 0-14, then id * 4 + kind).  A visit is four 16-byte
//   read-only loads and two box_entry calls, each on the child's own box and
//   slack: the pop test of the one-thread-per-lane kernel, so the box
//   slack's guarantee (geom.cuh) is the same.  The root's own box is tested
//   once per ray from the tree's arrays (boxes, topo, graze).
// - Order by entry distance: the lane goes on into the hit child that it
//   enters first and pushes the other (node, e); a popped entry whose e lies
//   beyond best t is dropped without a memory read (<=, so a tie is still
//   visited).  The stack holds kBvhStackMax entries, one per level of the
//   path; a deeper tree is refused where it is attached to a scene
//   (accel/lbvh.py::check_depth).
// - While-while (Aila & Laine, HPG 2009), speculative: a lane walks inner
//   nodes; one that comes to a leaf holds it back and walks on until every
//   lane of the warp holds one (or has nothing left), then the warp runs its
//   lanes' leaf rows together.  The stack lives in local memory.
// - The loop carries (t, row) only and merges by (t, row) (geom.cuh::
//   best_merge); the winner's normal is the same geom test run once more
//   on its row, then normalized: the bits a normal-carrying loop gives.
// Lanes visit rows in different orders, and the winner is order-free: t <
// best t, or t == best t and a lower table row.  That is the winner of a
// strict-< sweep in row order, whatever the traversal prunes.
//
// The one-thread-per-lane kernel it replaced (bvh_closest_kernel,
// bvh_closest_n_kernel: one thread per lane over every lane, nodes read from
// (M, 6) boxes and (M, 4) topo, children ordered by their centres'
// projection, (17, G)-strided rows) is reachable by name (*_lane_launch) for
// the measurement that compares them; the package does not launch it.
//
// The launch shape (kBvhThreads, kBvhMinBlocks), the stack's home and the
// loop's form were chosen by measurement on an H100; PERF.md §6 keeps the
// times of the variants they beat (other shapes, a stack in shared memory, a
// lane's inner loop ending at its first leaf).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/_build.py).

#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "geom.cuh"
#include "persist.cuh"
#include "sweep.cuh"

namespace rtt {

constexpr int kBvhStackMax = 64;  // accel/lbvh.py::BVH_STACK_MAX

// ------------------------------------------ the one-thread-per-lane kernel

struct BvhParams {
  const float* rays;   // (8, R)
  const float* table;  // (G, 17) row-major, Morton order
  const float* boxes;  // (M, 6)
  const int* topo;     // (M, 4)
  const float* graze;  // (M,) each box's distance-squared slack (geom.cuh)
  float* t;            // (R,)
  int* id;             // (R,)
  float* n;            // (3, R) or null
  long long R;
  int G, M;
  int motion;
};

template <bool WANT_N>
RTT_DEV void bvh_lane(const BvhParams& p, size_t i) {
  const size_t R = (size_t)p.R;
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
  const bool motion = p.motion != 0;
  Best best;
  best.t = kInf; best.row = -1;
  best.nx = 0.0f; best.ny = 0.0f; best.nz = 0.0f;
  int stack[kBvhStackMax];
  int sp = 0;
  stack[sp++] = 0;  // root
  while (sp > 0) {
    const int node = stack[--sp];
    if (!box_hit(p.boxes + 6 * (size_t)node, ray, best.t, p.graze[node])) continue;
    const int* tp = p.topo + 4 * (size_t)node;
    const int left = tp[0];
    if (left < 0) {
      const int first = tp[2], count = tp[3];
      float nx, ny, nz;
      for (int row = first; row < first + count; ++row) {
        const float t = geom_t_mixed<WANT_N>(p.table + (size_t)kGeomCols * row,
                                             ray, motion, nx, ny, nz);
        if (t < best.t || (t == best.t && row < best.row)) {
          best.t = t;
          best.row = row;
          if constexpr (WANT_N) { best.nx = nx; best.ny = ny; best.nz = nz; }
        }
      }
    } else {
      const int right = tp[1];
      const float* bl = p.boxes + 6 * (size_t)left;
      const float* br = p.boxes + 6 * (size_t)right;
      const float pl = 0.5f * (bl[0] + bl[3]) * ray.dx + 0.5f * (bl[1] + bl[4]) * ray.dy +
                       0.5f * (bl[2] + bl[5]) * ray.dz;
      const float pr = 0.5f * (br[0] + br[3]) * ray.dx + 0.5f * (br[1] + br[4]) * ray.dy +
                       0.5f * (br[2] + br[5]) * ray.dz;
      const bool left_near = pl <= pr;
      // The far child goes on first, so that the near one comes off first
      // and tightens best t before the far one is looked at.
      stack[sp++] = left_near ? right : left;
      stack[sp++] = left_near ? left : right;
    }
  }
  p.t[i] = best.t;
  p.id[i] = (best.row >= 0)
                ? (int)rintf(p.table[(size_t)kGeomCols * best.row + kIdCol])
                : -1;
  if constexpr (WANT_N) store_unit_normal(p.n, R, i, best.nx, best.ny, best.nz);
}

inline BvhParams make_bvh_params(
    const float* rays, const float* table, const float* boxes, const int* topo,
    const float* graze, float* t, int* id, float* n, long long R, int G, int M,
    int motion) {
  BvhParams p;
  p.rays = rays; p.table = table; p.boxes = boxes; p.topo = topo; p.graze = graze;
  p.t = t; p.id = id; p.n = n; p.R = R; p.G = G; p.M = M; p.motion = motion;
  return p;
}

// ------------------------------------------------------ the warp kernel

// Threads a block and the resident blocks per SM it is built for (64
// registers a thread).
constexpr int kBvhThreads = 512;
constexpr int kBvhMinBlocks = 2;

constexpr int kBvhWarps = kBvhThreads / 32;
constexpr int kBvhCols = 16;           // floats of an inner-node record and of a row
constexpr int kLeafCountBits = 3;      // accel/lbvh.py::LEAF_COUNT_BITS
constexpr int kBvhMaxGeoms = 1 << 22;  // accel/lbvh.py::BVH_MAX_GEOMS: id * 4 + kind exact
constexpr int kBvhNone = INT_MIN;      // no node: neither an inner index nor a leaf code

struct BvhWarpParams {
  const float* rays;   // (8, R)
  const float* boxes;  // (M, 6): the root's box, boxes[0..5]
  const int* topo;     // (M, 4): the root's [left, right, first, count]
  const float* graze;  // (M,): the root's slack, graze[0]
  const float* inner;  // (n_inner, 16) inner-node records (accel/lbvh.py::pack_bvh)
  const float* rows;   // (G, 16) the Morton-ordered table's rows
  float* t;            // (R,)
  int* id;             // (R,)
  float* n;            // (3, R) or null
  unsigned long long* work;  // (4,) counts of a counting build (BvhWork), else null
  long long R;
  int G;
  int motion;
};

// What a counting build counts: per lane the inner nodes it visited, its
// box tests (the root's and two a visit) and its geom tests; and the lane
// slots of the steps the warp issued (32 for each step of the inner-node
// loop, 32 x the most rows any lane ran in each leaf step), each counted by
// the first lane of the group of lanes that issued it.  Each summed over
// the warp, then into BvhWarpParams::work[0..3].
struct BvhWork {
  uint32_t visits, boxes, tests, slots;
};

// One lane's walk.  cur: the node it visits next (an inner record index or
// a leaf code) or kBvhNone; leaf: a leaf it holds back or kBvhNone; sp: the
// (node, entry distance) pairs on its stack.
struct BvhLane {
  Ray ray;
  Best best;  // (t, row) only in the loop
  int cur, leaf, sp;
};

// The lane's stack, apart from the lane's scalars: indexed at run time, it
// lives in local memory, and a struct that held it would take the scalars
// there too.
struct BvhStack {
  int ref[kBvhStackMax];
  float e[kBvhStackMax];
};

RTT_DEV bool bvh_is_inner(int ref) { return ref >= 0; }
RTT_DEV bool bvh_is_leaf(int ref) { return ref < 0 && ref != kBvhNone; }

RTT_DEV void bvh_push(BvhLane& s, BvhStack& st, int ref, float e) {
  st.ref[s.sp] = ref;
  st.e[s.sp] = e;
  ++s.sp;
}

// The next stacked node the ray can still enter no farther than its best t,
// or kBvhNone; the entries above it are dropped.
RTT_DEV int bvh_pop(BvhLane& s, const BvhStack& st) {
  while (s.sp > 0) {
    --s.sp;
    if (st.e[s.sp] <= s.best.t) return st.ref[s.sp];
  }
  return kBvhNone;
}

// Listed lane i's ray (a lane without one: no node) and the root's test.
template <bool COUNT>
RTT_DEV void bvh_begin(const BvhWarpParams& p, size_t i, bool mine, BvhLane& s, BvhWork& w) {
  const size_t R = (size_t)p.R;
  s.best.t = kInf; s.best.row = -1;
  s.best.nx = 0.0f; s.best.ny = 0.0f; s.best.nz = 0.0f;
  s.sp = 0;
  s.leaf = kBvhNone;
  s.cur = kBvhNone;
  if (!mine) {
    s.ray = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  s.ray = make_ray(p.rays[0 * R + i], p.rays[1 * R + i], p.rays[2 * R + i],
                   p.rays[3 * R + i], p.rays[4 * R + i], p.rays[5 * R + i],
                   p.rays[6 * R + i]);
  float e;
  if (box_entry(p.boxes, s.ray, p.graze[0], e) && e <= kInf) {
    s.cur = p.topo[0] >= 0 ? 0
                           : ~((p.topo[2] << kLeafCountBits) | p.topo[3]);
  }
  if constexpr (COUNT) ++w.boxes;
}

// Visit inner node s.cur: test both children's boxes against best t, go on
// into the hit one the ray enters first and push the other with its entry
// distance; with neither hit, pop.
template <bool COUNT>
RTT_DEV void bvh_visit(const float* inner, BvhLane& s, BvhStack& st, BvhWork& w) {
  const float* rec = inner + (size_t)kBvhCols * s.cur;
  const F4 a = ldg4(rec), b = ldg4(rec + 4), c = ldg4(rec + 8), d = ldg4(rec + 12);
  const float box_l[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
  const float box_r[6] = {b.z, b.w, c.x, c.y, c.z, c.w};
  float e_l, e_r;
  const bool hit_l = box_entry(box_l, s.ray, d.x, e_l) && e_l <= s.best.t;
  const bool hit_r = box_entry(box_r, s.ray, d.y, e_r) && e_r <= s.best.t;
  const int ref_l = (int)f32_as_u32(d.z), ref_r = (int)f32_as_u32(d.w);
  if (hit_l && hit_r) {
    const bool left_first = e_l <= e_r;
    bvh_push(s, st, left_first ? ref_r : ref_l, left_first ? e_r : e_l);
    s.cur = left_first ? ref_l : ref_r;
  } else if (hit_l || hit_r) {
    s.cur = hit_l ? ref_l : ref_r;
  } else {
    s.cur = bvh_pop(s, st);
  }
  if constexpr (COUNT) { ++w.visits; w.boxes += 2; }
}

// A lane that has come to a leaf holds it back and goes on to its next
// node, once.
RTT_DEV void bvh_postpone(BvhLane& s, const BvhStack& st) {
  if (bvh_is_leaf(s.cur) && s.leaf == kBvhNone) {
    s.leaf = s.cur;
    s.cur = bvh_pop(s, st);
  }
}

// Hit distance (+inf for a miss) of a 64-byte row: geom_t_mixed's arithmetic
// on the row's own layout, read as four 16-byte words; the kind is slot 15's
// low two bits.  WANT_N also yields the UNnormalized world normal.
template <bool WANT_N>
RTT_DEV float bvh_row_t(const float* row, const Ray& r, bool motion, float& nx, float& ny,
                        float& nz) {
  const F4 a = ldg4(row), b = ldg4(row + 4), c = ldg4(row + 8), v = ldg4(row + 12);
  Xform m;
  m.c[0] = a.x; m.c[1] = a.y; m.c[2] = a.z; m.c[3] = a.w;
  m.c[4] = b.x; m.c[5] = b.y; m.c[6] = b.z; m.c[7] = b.w;
  m.c[8] = c.x; m.c[9] = c.y; m.c[10] = c.z; m.c[11] = c.w;
  const int kind = (int)v.w & 3;
  if (kind == kKindPlane) return plane_t<WANT_N>(m.c, 1, 0, r, nx, ny, nz);
  // Only spheres carry velocity (Code/json_loader.cpp:215-223).
  float ox = r.ox, oy = r.oy, oz = r.oz;
  if (motion && kind == kKindSphere) {
    ox = r.ox - r.tm * v.x;
    oy = r.oy - r.tm * v.y;
    oz = r.oz - r.tm * v.z;
  }
  const LocalRay l = to_local_x(m, ox, oy, oz, r);
  if (kind == kKindSphere) return geom_t_x<kKindSphere, WANT_N>(m, l, r, nx, ny, nz);
  if (kind == kKindCube) return geom_t_x<kKindCube, WANT_N>(m, l, r, nx, ny, nz);
  return geom_t_x<kKindRect, WANT_N>(m, l, r, nx, ny, nz);
}

// The leaf step: run the rows of the leaf the lane holds back or stands on,
// merging by (t, row); standing on it, pop afterwards, against the new best
// t.  Returns the rows run.
RTT_DEV int bvh_leaf_step(const float* rows, BvhLane& s, const BvhStack& st, bool motion) {
  const bool on_leaf = s.leaf == kBvhNone && bvh_is_leaf(s.cur);
  const int leaf = on_leaf ? s.cur : s.leaf;
  int count = 0;
  if (leaf != kBvhNone) {
    const int code = ~leaf;
    const int first = code >> kLeafCountBits;
    count = code & ((1 << kLeafCountBits) - 1);
    float nx, ny, nz;
    for (int row = first; row < first + count; ++row) {
      best_merge(s.best, bvh_row_t<false>(rows + (size_t)kBvhCols * row, s.ray, motion,
                                          nx, ny, nz), row);
    }
  }
  s.leaf = kBvhNone;
  if (on_leaf) s.cur = bvh_pop(s, st);
  return count;
}

RTT_DEV bool bvh_open(const BvhLane& s) { return s.cur != kBvhNone || s.leaf != kBvhNone; }

// The outputs of listed lane i: t, the id from the winner's row and, with
// WANT_N, the winner's normal, which the same geom test run on its row
// yields.
template <bool WANT_N>
RTT_DEV void bvh_end(const BvhWarpParams& p, size_t i, const BvhLane& s) {
  p.t[i] = s.best.t;
  const float* row = p.rows + (size_t)kBvhCols * (s.best.row >= 0 ? s.best.row : 0);
  // A winner has a finite t (strict < from +inf).
  p.id[i] = (s.best.row >= 0) ? ((int)row[15] >> 2) : -1;
  if constexpr (WANT_N) {
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (s.best.row >= 0) bvh_row_t<true>(row, s.ray, p.motion != 0, nx, ny, nz);
    store_unit_normal(p.n, (size_t)p.R, i, nx, ny, nz);
  }
}

// The scan's view of a launch (sweep.cuh::sweep_scan4 reads the act row and
// writes a dead lane's t, id[, n]).
inline SweepParams bvh_scan_params(const BvhWarpParams& p) {
  return make_sweep_params(p.rays, nullptr, nullptr, nullptr, p.rows, p.t, p.id, p.n, nullptr,
                           p.R, p.G, 1, 0);
}

inline BvhWarpParams make_bvh_warp_params(
    const float* rays, const float* boxes, const int* topo, const float* graze,
    const float* inner, const float* rows, float* t, int* id, float* n, long long R, int G,
    int motion, unsigned long long* work) {
  BvhWarpParams p;
  p.rays = rays; p.boxes = boxes; p.topo = topo; p.graze = graze;
  p.inner = inner; p.rows = rows; p.t = t; p.id = id; p.n = n; p.work = work;
  p.R = R; p.G = G; p.motion = motion;
  return p;
}

}  // namespace rtt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace rtt {

__global__ void bvh_closest_kernel(const BvhParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.R) bvh_lane<false>(p, (size_t)i);
}

__global__ void bvh_closest_n_kernel(const BvhParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.R) bvh_lane<true>(p, (size_t)i);
}

// Launch on `stream` without synchronizing; returns cudaGetLastError()
// (0 = launched).
template <typename K>
static int launch_bvh(K kernel, const BvhParams& p, int threads, void* stream) {
  if (p.R < 0 || p.G < 1 || p.M < 1 || threads < 1)
    return (int)cudaErrorInvalidValue;
  if (p.R == 0) return 0;
  const long long blocks = (p.R + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// One lane's walk: inner nodes until every lane of the warp holds a leaf
// back (or has nothing left), then the leaf step, until nothing is left.
template <bool COUNT>
__device__ __forceinline__ void bvh_walk(const BvhWarpParams& p, BvhLane& s, BvhStack& st,
                                         BvhWork& w) {
  const bool motion = p.motion != 0;
  const int lane = threadIdx.x & 31;
  while (bvh_open(s)) {
    while (bvh_is_inner(s.cur)) {
      if constexpr (COUNT) {
        if (lane == __ffs(__activemask()) - 1) w.slots += 32;
      }
      bvh_visit<COUNT>(p.inner, s, st, w);
      bvh_postpone(s, st);
      if (!__any_sync(__activemask(), s.leaf == kBvhNone)) break;
    }
    const int ran = bvh_leaf_step(p.rows, s, st, motion);
    if constexpr (COUNT) {
      const unsigned m = __activemask();
      const unsigned most = __reduce_max_sync(m, (unsigned)ran);
      w.tests += ran;
      if (lane == __ffs(m) - 1) w.slots += 32 * most;
    }
  }
}

// ctr: the five work counters of a cooperative launch (sweep.cuh), zero at
// launch and left zero; live: R ints, the launch's list of live lanes.
template <bool WANT_N, bool COUNT>
__global__ void __launch_bounds__(kBvhThreads, kBvhMinBlocks)
bvh_warp_kernel(const BvhWarpParams p, const SweepParams scan, int* ctr, int* live) {
  warp_scan_list<WANT_N ? kSweepClosestN : kSweepClosest>(scan, ctr, live);
  grid_barrier(&ctr[2]);
  const int lane = threadIdx.x & 31;
  const int n_live = *reinterpret_cast<volatile int*>(&ctr[1]);
  const int task = warp_task(n_live, (long long)gridDim.x * kBvhWarps);
  BvhWork w = {0, 0, 0, 0};
  BvhStack st;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(&ctr[3], task);
    first = __shfl_sync(kFull, first, 0);
    if (first >= n_live) break;
    const int e = first + lane;
    const bool mine = lane < task && e < n_live;
    const size_t i = mine ? (size_t)live[e] : 0;
    BvhLane s;
    bvh_begin<COUNT>(p, i, mine, s, w);
    bvh_walk<COUNT>(p, s, st, w);
    if (mine) bvh_end<WANT_N>(p, i, s);
    __syncwarp();
  }
  if constexpr (COUNT) {
    const unsigned visits = __reduce_add_sync(kFull, w.visits);
    const unsigned boxes = __reduce_add_sync(kFull, w.boxes);
    const unsigned tests = __reduce_add_sync(kFull, w.tests);
    const unsigned slots = __reduce_add_sync(kFull, w.slots);
    if (lane == 0) {
      atomicAdd(&p.work[0], (unsigned long long)visits);
      atomicAdd(&p.work[1], (unsigned long long)boxes);
      atomicAdd(&p.work[2], (unsigned long long)tests);
      atomicAdd(&p.work[3], (unsigned long long)slots);
    }
  }
  coop_release(ctr);
}

// What the warp kernel launches with: out[0..3] = shared memory bytes,
// resident blocks per SM, SMs, threads per block.  0 or a CUDA error.
template <typename K>
static int bvh_warp_plan(K kernel, int* out) {
  int per_sm = 0, sms = 0;
  const int err = coop_plan(kernel, kBvhThreads, 0, per_sm, sms);
  out[0] = 0; out[1] = per_sm; out[2] = sms; out[3] = kBvhThreads;
  return err;
}

// Launch the warp kernel cooperatively on `stream` without synchronizing:
// as many blocks as are resident.  Refused (cudaErrorInvalidValue): more
// than kBvhMaxGeoms rows, records or rows not 16-byte aligned.  ctr: five
// ints of device memory, zero, that no other launch uses meanwhile (the
// kernel leaves them zero); live: R ints of scratch.
template <bool WANT_N>
static int launch_bvh_warp(const BvhWarpParams& p, int* ctr, int* live, void* stream) {
  if (p.R < 0 || p.R > INT_MAX / 2 || p.G < 1 || p.G > kBvhMaxGeoms ||
      (uintptr_t)p.inner % 16 != 0 || (uintptr_t)p.rows % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.R == 0) return 0;
  const auto kernel = p.work ? bvh_warp_kernel<WANT_N, true> : bvh_warp_kernel<WANT_N, false>;
  int plan[4];
  const int err = bvh_warp_plan(kernel, plan);
  if (err) return err;
  const SweepParams scan = bvh_scan_params(p);
  void* args[] = {const_cast<BvhWarpParams*>(&p), const_cast<SweepParams*>(&scan), &ctr, &live};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3((unsigned)(plan[1] * plan[2])), dim3(kBvhThreads), args,
      0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace rtt

// Plain C interface (loaded with ctypes).  The closest hits by the warp
// kernel; work: four unsigned 64-bit ints to count into (the counting
// build), or null; ctr and live as launch_bvh_warp says.
extern "C" int bvh_closest_launch(
    const float* rays, const float* boxes, const int* topo, const float* graze,
    const float* inner, const float* rows, float* t, int* id, long long R, int G, int motion,
    unsigned long long* work, int* ctr, int* live, void* stream) {
  const rtt::BvhWarpParams p = rtt::make_bvh_warp_params(
      rays, boxes, topo, graze, inner, rows, t, id, nullptr, R, G, motion, work);
  return rtt::launch_bvh_warp<false>(p, ctr, live, stream);
}

extern "C" int bvh_closest_n_launch(
    const float* rays, const float* boxes, const int* topo, const float* graze,
    const float* inner, const float* rows, float* t, int* id, float* n, long long R, int G,
    int motion, unsigned long long* work, int* ctr, int* live, void* stream) {
  const rtt::BvhWarpParams p = rtt::make_bvh_warp_params(
      rays, boxes, topo, graze, inner, rows, t, id, n, R, G, motion, work);
  return rtt::launch_bvh_warp<true>(p, ctr, live, stream);
}

// What bvh_closest_launch (want_n 0) or bvh_closest_n_launch (want_n 1)
// launches with: out[0..3] = shared memory bytes, resident blocks per SM,
// SMs, threads per block.
extern "C" int bvh_closest_plan(int want_n, int* out) {
  return want_n ? rtt::bvh_warp_plan(rtt::bvh_warp_kernel<true, false>, out)
                : rtt::bvh_warp_plan(rtt::bvh_warp_kernel<false, false>, out);
}

// The one-thread-per-lane kernels they replaced.
extern "C" int bvh_closest_lane_launch(
    const float* rays, const float* table, const float* boxes, const int* topo,
    const float* graze, float* t, int* id, long long R, int G, int M, int motion,
    int threads, void* stream) {
  const rtt::BvhParams p = rtt::make_bvh_params(
      rays, table, boxes, topo, graze, t, id, nullptr, R, G, M, motion);
  return rtt::launch_bvh(rtt::bvh_closest_kernel, p, threads, stream);
}

extern "C" int bvh_closest_n_lane_launch(
    const float* rays, const float* table, const float* boxes, const int* topo,
    const float* graze, float* t, int* id, float* n, long long R, int G, int M,
    int motion, int threads, void* stream) {
  const rtt::BvhParams p = rtt::make_bvh_params(
      rays, table, boxes, topo, graze, t, id, n, R, G, M, motion);
  return rtt::launch_bvh(rtt::bvh_closest_n_kernel, p, threads, stream);
}

#endif  // __CUDACC__
