// Closest hit by LBVH traversal, one short stack per thread, for sm_90a:
// bvh_closest (t, id) and bvh_closest_n (t, id, the winner's unit normal).
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
// bvh_closest_n carries the normal as brute_closest_n does (same geom_t,
// same normalization), which makes them so.
//
// Bound on an H100: operations on coherent rays (the AABB and geom tests
// a ray cannot prune, about 30 and 80 f32 operations each), memory latency
// on incoherent ones (every thread of a warp walks its own nodes).
// Design: one thread per ray; nodes (boxes (M, 6), topo (M, 4) [left,
// right, first, count], left = -1 for a leaf) and the row-major (G, 17)
// table are read from global memory through L1/L2, so no shared-memory cap
// applies; the stack lives in local memory, kBvhStackMax entries, and a
// tree deeper than that is refused where it is attached to a scene
// (accel/lbvh.py::check_depth); a node is entered when the
// ray's own slab test passes with t_near * |d| <= best t; of two children
// the one whose box centre lies nearer along the ray's own direction is
// taken first; a leaf's rows go through the mixed-kind test.
//
// Threads visit rows in different orders, so the winner is order-free:
// t < best t, or t == best t and a lower table row.  That is the winner of
// a strict-< sweep in row order, whatever the traversal prunes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/_build.py).

#include <stddef.h>
#include <stdint.h>

#include "geom.cuh"

namespace rtt {

constexpr int kBvhStackMax = 64;  // accel/lbvh.py::BVH_STACK_MAX

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

}  // namespace rtt

// Plain C interface (loaded with ctypes).
extern "C" int bvh_closest_launch(
    const float* rays, const float* table, const float* boxes, const int* topo,
    const float* graze, float* t, int* id, long long R, int G, int M, int motion,
    int threads, void* stream) {
  const rtt::BvhParams p = rtt::make_bvh_params(
      rays, table, boxes, topo, graze, t, id, nullptr, R, G, M, motion);
  return rtt::launch_bvh(rtt::bvh_closest_kernel, p, threads, stream);
}

extern "C" int bvh_closest_n_launch(
    const float* rays, const float* table, const float* boxes, const int* topo,
    const float* graze, float* t, int* id, float* n, long long R, int G, int M,
    int motion, int threads, void* stream) {
  const rtt::BvhParams p = rtt::make_bvh_params(
      rays, table, boxes, topo, graze, t, id, n, R, G, M, motion);
  return rtt::launch_bvh(rtt::bvh_closest_n_kernel, p, threads, stream);
}

#endif  // __CUDACC__
