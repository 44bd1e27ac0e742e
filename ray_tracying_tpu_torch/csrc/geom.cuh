// Per-geom intersection math shared by the CUDA kernels: the device twins
// of kernels/closest_hit.py (geom_t, geom_step, geom_step_n).
//
// Replaces the TPU device functions kernels/closest_hit.py::geom_t /
// geom_step / geom_step_n of the JAX package: sphere, cube, rect, the
// legacy plane, the motion-blur origin shift, the dispatch on a row's own
// kind (its column 15) for tables whose rows are of mixed kinds, and the
// AABB slab test of the chunk and BVH kernels
// (kernels/chunk_stream.py::_chunk_any_hit, kernels/bvh_traverse.py:68-92).
//
// One thread holds one ray; a geom-table row is read from the block's
// shared-memory copy of the table, stored transposed (columns, G): every
// thread of a warp reads the same address, a broadcast.  The order of
// operations is that of the plain PyTorch version, term by term, so that
// with FMA contraction off (--fmad=false) both give the same bits.
//
// The functions are plain C++: with a host compiler (no __CUDACC__) the
// same source builds as CPU code, which lets the lane arithmetic be
// emulated and held against the plain version without a GPU
// (tests/test_torch_kernel_source.py).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define RTT_DEV __device__ __forceinline__
#else
#define RTT_DEV inline
#endif

namespace rtt {

// Semantics constants (core/constants.py), each the f32 nearest to the
// double literal, as PyTorch rounds a Python float.
constexpr float kInf = INFINITY;
constexpr float kEpsTMin = (float)1e-3;      // sphere / rect minimum t
constexpr float kEpsParallel = (float)1e-6;  // slab / plane denominators
constexpr float kEpsPlaneEdge = (float)-1e-6;  // point-in-triangle edge sign

constexpr int kKindSphere = 0;
constexpr int kKindCube = 1;
constexpr int kKindRect = 2;
constexpr int kKindPlane = 3;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, dnorm;
};

RTT_DEV Ray make_ray(float ox, float oy, float oz, float dx, float dy, float dz,
                     float tm = 0.0f) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.tm = tm;
  r.dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  return r;
}

// Object-space ray of a row: o_l = w2o * (o, 1), d_l = w2o * (d, 0).
struct LocalRay {
  float olx, oly, olz, dlx, dly, dlz;
};

// The 12 floats of a row's w2o (row-major 3x4: table columns 0..11).  A
// kernel loads them from its own layout of the table: 12 scalar reads of a
// transposed table (load_xform), or three 16-byte words (csrc/wavefront.cu).
struct Xform {
  float c[12];
};

RTT_DEV Xform load_xform(const float* tab, int G, int g) {
  Xform m;
  for (int k = 0; k < 12; ++k) m.c[k] = tab[k * G + g];
  return m;
}

// o_l and d_l of the ray with origin (ox, oy, oz) and r's direction.
RTT_DEV LocalRay to_local_x(const Xform& m, float ox, float oy, float oz, const Ray& r) {
  const float* c = m.c;
  LocalRay l;
  l.olx = ox * c[0] + oy * c[1] + oz * c[2] + c[3];
  l.oly = ox * c[4] + oy * c[5] + oz * c[6] + c[7];
  l.olz = ox * c[8] + oy * c[9] + oz * c[10] + c[11];
  l.dlx = r.dx * c[0] + r.dy * c[1] + r.dz * c[2];
  l.dly = r.dx * c[4] + r.dy * c[5] + r.dz * c[6];
  l.dlz = r.dx * c[8] + r.dy * c[9] + r.dz * c[10];
  return l;
}

// One slab axis of the unit cube: entry/exit parameters and the sign of
// the entry face; returns true when the ray is parallel to the slab and
// outside it.
RTT_DEV bool slab_axis(float oo, float dd, float& ent, float& ext, float& sgn) {
  const bool par = fabsf(dd) < kEpsParallel;
  const float inv_d = 1.0f / (par ? 1.0f : dd);
  const float s1 = (-0.5f - oo) * inv_d;
  const float s2 = (0.5f - oo) * inv_d;
  ent = par ? -kInf : fminf(s1, s2);
  ext = par ? kInf : fmaxf(s1, s2);
  sgn = (s1 < s2) ? -1.0f : 1.0f;
  return par && ((oo < -0.5f) || (oo > 0.5f));
}

// One edge of the legacy plane's two-triangle test: the sign of
// cross(p1 - p0, p - p0) . n against the reference's -1e-6 tolerance
// (Code/shapes.cpp:24-40).
RTT_DEV bool plane_edge(float x0, float y0, float z0, float x1, float y1, float z1,
                        float px, float py, float pz, float nx, float ny, float nz) {
  const float ux = x1 - x0, uy = y1 - y0, uz = z1 - z0;
  const float wx = px - x0, wy = py - y0, wz = pz - z0;
  const float cxv = wz * uy - wy * uz;
  const float cyv = wx * uz - wz * ux;
  const float czv = wy * ux - wx * uy;
  return (cxv * nx + cyv * ny + czv * nz) >= kEpsPlaneEdge;
}

// Legacy quad, PARAMETRIC t (Code/shapes.cpp:444-483); the 12 matrix slots
// of the row (the Xform of its columns 0..11) hold the 4 corners.  The
// normal is already in world space.
template <bool WANT_N>
RTT_DEV float plane_t_x(const Xform& m, const Ray& r, float& nwx, float& nwy, float& nwz) {
  const float* k = m.c;
  const float ax = k[0], ay = k[1], az = k[2];
  const float bx = k[3], by = k[4], bz = k[5];
  const float cx = k[6], cy = k[7], cz = k[8];
  const float ex = k[9], ey = k[10], ez = k[11];
  const float e1x = bx - ax, e1y = by - ay, e1z = bz - az;
  const float e2x = cx - ax, e2y = cy - ay, e2z = cz - az;
  float nx = e1y * e2z - e1z * e2y;
  float ny = e1z * e2x - e1x * e2z;
  float nz = e1x * e2y - e1y * e2x;
  const float n2 = nx * nx + ny * ny + nz * nz;
  const float ln = (n2 > 0.0f) ? sqrtf(n2) : 0.0f;
  const bool degen = ln < kEpsParallel;
  const float ln_safe = degen ? 1.0f : ln;
  nx = nx / ln_safe; ny = ny / ln_safe; nz = nz / ln_safe;
  const float denom = r.dx * nx + r.dy * ny + r.dz * nz;
  const bool par = fabsf(denom) < kEpsParallel;
  const float t = ((ax - r.ox) * nx + (ay - r.oy) * ny + (az - r.oz) * nz) /
                  (par ? 1.0f : denom);
  const float px = r.ox + t * r.dx;
  const float py = r.oy + t * r.dy;
  const float pz = r.oz + t * r.dz;
  const bool in_t1 = plane_edge(bx, by, bz, ex, ey, ez, px, py, pz, nx, ny, nz) &&
                     plane_edge(ex, ey, ez, cx, cy, cz, px, py, pz, nx, ny, nz) &&
                     plane_edge(cx, cy, cz, bx, by, bz, px, py, pz, nx, ny, nz);
  const bool in_t2 = plane_edge(ax, ay, az, bx, by, bz, px, py, pz, nx, ny, nz) &&
                     plane_edge(bx, by, bz, cx, cy, cz, px, py, pz, nx, ny, nz) &&
                     plane_edge(cx, cy, cz, ax, ay, az, px, py, pz, nx, ny, nz);
  const bool ok = !degen && !par && (t >= 0.0f) && (in_t1 || in_t2);
  if constexpr (WANT_N) { nwx = nx; nwy = ny; nwz = nz; }
  return ok ? t : kInf;
}

// plane_t_x of row g of a transposed table.
template <bool WANT_N>
RTT_DEV float plane_t(const float* tab, int G, int g, const Ray& r,
                      float& nwx, float& nwy, float& nwz) {
  return plane_t_x<WANT_N>(load_xform(tab, G, g), r, nwx, nwy, nwz);
}

// Hit distance (+inf for a miss) of a transformed prim of kind KIND
// (sphere, cube, rect) with transform m, for the ray r whose object-space
// form is l: Euclidean = t_loc * |d|.  WANT_N also yields the UNnormalized
// world-space normal (sphere: local hit point, cube: entry face, rect: +z,
// each mapped by w2o^T).
template <int KIND, bool WANT_N>
RTT_DEV float geom_t_x(const Xform& m, const LocalRay& l, const Ray& r,
                       float& nwx, float& nwy, float& nwz) {
  float t_geom;
  float nlx = 0.0f, nly = 0.0f, nlz = 0.0f;
  if constexpr (KIND == kKindSphere) {
    // (Code/shapes.cpp:219-232)
    const float a = l.dlx * l.dlx + l.dly * l.dly + l.dlz * l.dlz;
    const float b = (l.olx * l.dlx + l.oly * l.dly + l.olz * l.dlz) * 2.0f;
    const float cc = l.olx * l.olx + l.oly * l.oly + l.olz * l.olz - 1.0f;
    const float disc = b * b - a * 4.0f * cc;
    const float sq = (disc > 0.0f) ? sqrtf(disc) : 0.0f;
    const float a_safe = (a > 0.0f) ? a : 1.0f;
    const float inv_2a = 1.0f / (a_safe * 2.0f);
    const float t1 = (-b - sq) * inv_2a;
    const float t2 = (-b + sq) * inv_2a;
    float t_loc = (t1 > kEpsTMin) ? t1 : ((t2 > kEpsTMin) ? t2 : kInf);
    t_loc = ((disc >= 0.0f) && (a > 0.0f)) ? t_loc : kInf;
    t_geom = t_loc * r.dnorm;
    if constexpr (WANT_N) {
      const float tl = (t_loc < kInf) ? t_loc : 0.0f;
      nlx = l.olx + tl * l.dlx;
      nly = l.oly + tl * l.dly;
      nlz = l.olz + tl * l.dlz;
    }
  } else if constexpr (KIND == kKindCube) {
    // Slab test with t > 0, no 1e-3 epsilon (Code/shapes.cpp:361-393).
    float e0, e1, e2, x0, x1, x2, g0, g1, g2;
    bool miss = slab_axis(l.olx, l.dlx, e0, x0, g0);
    miss = slab_axis(l.oly, l.dly, e1, x1, g1) || miss;
    miss = slab_axis(l.olz, l.dlz, e2, x2, g2) || miss;
    const float t_near = fmaxf(fmaxf(fmaxf(-kInf, e0), e1), e2);
    const float t_far = fminf(fminf(fminf(kInf, x0), x1), x2);
    miss = miss || (t_near > t_far) || (t_far < 0.0f);
    float t_cub = (t_near > 0.0f) ? t_near : t_far;
    t_cub = (miss || (t_cub < 0.0f)) ? kInf : t_cub;
    t_geom = t_cub * r.dnorm;
    if constexpr (WANT_N) {
      // Entry face: first axis whose slab entry is the max (strict >).
      const bool win1 = e1 > e0;
      const float axv = win1 ? e1 : e0;
      const bool win2 = e2 > axv;
      nlx = (win1 || win2) ? 0.0f : g0;
      nly = win2 ? 0.0f : (win1 ? g1 : 0.0f);
      nlz = win2 ? g2 : 0.0f;
    }
  } else {
    // Unit square on z = 0 (Code/shapes.cpp:305-315).
    const bool par_z = fabsf(l.dlz) < kEpsParallel;
    const float t_r = -l.olz / (par_z ? 1.0f : l.dlz);
    const float hx = l.olx + t_r * l.dlx;
    const float hy = l.oly + t_r * l.dly;
    const bool ok = !par_z && (t_r >= kEpsTMin) && (hx >= -0.5f) &&
                    (hx <= 0.5f) && (hy >= -0.5f) && (hy <= 0.5f);
    t_geom = (ok ? t_r : kInf) * r.dnorm;
    if constexpr (WANT_N) nlz = 1.0f;
  }
  if constexpr (WANT_N) {
    // n_w = w2o^T n_loc (Code/shapes.cpp:178-187); normalization deferred.
    nwx = nlx * m.c[0] + nly * m.c[4] + nlz * m.c[8];
    nwy = nlx * m.c[1] + nly * m.c[5] + nlz * m.c[9];
    nwz = nlx * m.c[2] + nly * m.c[6] + nlz * m.c[10];
  }
  return t_geom;
}

// Hit distance (+inf for a miss) of table row g of kind KIND: Euclidean
// for the transformed prims, parametric for the plane.  WANT_N also yields
// the UNnormalized world-space normal (geom_t_x; plane: its face normal).
template <int KIND, bool WANT_N, bool MOTION = false>
RTT_DEV float geom_t(const float* tab, int G, int g, const Ray& r,
                     float& nwx, float& nwy, float& nwz) {
  if constexpr (KIND == kKindPlane) {
    return plane_t<WANT_N>(tab, G, g, r, nwx, nwy, nwz);
  } else {
    // MOTION shifts the origin by -velocity * time (Code/shapes.cpp:201-210).
    float ox = r.ox, oy = r.oy, oz = r.oz;
    if constexpr (MOTION) {
      ox = r.ox - r.tm * tab[12 * G + g];
      oy = r.oy - r.tm * tab[13 * G + g];
      oz = r.oz - r.tm * tab[14 * G + g];
    }
    const Xform m = load_xform(tab, G, g);
    return geom_t_x<KIND, WANT_N>(m, to_local_x(m, ox, oy, oz, r), r, nwx, nwy, nwz);
  }
}

// A row-major (rows, 17) table, as the scene holds its Morton-ordered
// tables: row g is `table + kGeomCols * g`, and reads through the functions
// above as a one-geom transposed table (G = 1, g = 0).
constexpr int kGeomCols = 17;
constexpr int kKindCol = 15;
constexpr int kIdCol = 16;

// geom_t of one row-major row whose kind is its own column 15: the tables
// of the chunk and BVH kernels are Morton-ordered, so their rows are of
// mixed kinds.  `motion` shifts the origin of sphere rows only (only
// spheres carry velocity, Code/json_loader.cpp:215-223).
template <bool WANT_N>
RTT_DEV float geom_t_mixed(const float* row, const Ray& r, bool motion,
                           float& nwx, float& nwy, float& nwz) {
  switch ((int)rintf(row[kKindCol])) {
    case kKindSphere:
      return motion ? geom_t<kKindSphere, WANT_N, true>(row, 1, 0, r, nwx, nwy, nwz)
                    : geom_t<kKindSphere, WANT_N, false>(row, 1, 0, r, nwx, nwy, nwz);
    case kKindCube: return geom_t<kKindCube, WANT_N>(row, 1, 0, r, nwx, nwy, nwz);
    case kKindRect: return geom_t<kKindRect, WANT_N>(row, 1, 0, r, nwx, nwy, nwz);
    default: return geom_t<kKindPlane, WANT_N>(row, 1, 0, r, nwx, nwy, nwz);
  }
}

// One axis of the AABB slab test (Code/shapes.cpp:55-72); returns true
// when the ray is parallel to the slab and outside it.
RTT_DEV bool box_axis(float oo, float dd, float mn, float mx, float& t_near,
                      float& t_far) {
  const bool par = fabsf(dd) < kEpsParallel;
  const float d_safe = par ? 1.0f : dd;
  const float s1 = (mn - oo) / d_safe;
  const float s2 = (mx - oo) / d_safe;
  t_near = fmaxf(t_near, par ? -kInf : fminf(s1, s2));
  t_far = fminf(t_far, par ? kInf : fmaxf(s1, s2));
  return par && ((oo < mn) || (oo > mx));
}

// Slack of the box test.  The boxes are exact in real arithmetic, but the
// geom tests are rounded in f32 in each geom's object space, and a cull
// must only ever remove what the geom tests themselves would miss:
//   - every test carries a few ulp of the coordinates it handles, so a box
//     is grown by kBoxSlack (32 ulp) times the largest coordinate involved;
//   - the sphere test cancels: its discriminant b*b - 4*a*c is the
//     difference of two numbers of size 4*a*D^2 (D the origin's distance in
//     object units), so at D in the hundreds a ray that passes outside the
//     sphere by a relative K*u*D^2/2 (u = 6e-8, K about 10) can still test
//     as a grazing hit.  Measured on an H100 with exact boxes: 18 of
//     8,294,400 camera rays of a 20,001-sphere scene lost such a hit to the
//     tight box of a BVH leaf.
//     In world units the sphere swells by at most K*u/2 * dist^2 * coef,
//     with coef = |w2o|_F^4 / |det w2o| (9 / r for a sphere of radius r),
//     so a box is also grown by `graze` * (distance to its farthest
//     corner)^2.  `graze` is the box's own: the largest coef of the spheres
//     that this chunk or this node's subtree holds, times 1.2e-7, computed
//     once where the structure is built (accel/lbvh.py::chunk_graze,
//     node_graze); 0 for a box without spheres.
constexpr float kBoxSlack = (float)4e-6;

// The slab test of the box (6 floats, min | max), grown by the slack above,
// without a bound: true when the ray meets the box ahead of its origin, with
// `e` the Euclidean distance at which it enters (negative when the origin is
// inside).  A miss leaves `e` meaningless: keep the flag apart from it.  The
// unshifted origin is right for a moving sphere too: its box holds its
// time-1 extent.
RTT_DEV bool box_entry(const float* box, const Ray& r, float graze, float& e) {
  // Per axis, the distance from the origin to the box's farther face.
  const float fx = fabsf(0.5f * (box[0] + box[3]) - r.ox) + 0.5f * (box[3] - box[0]);
  const float fy = fabsf(0.5f * (box[1] + box[4]) - r.oy) + 0.5f * (box[4] - box[1]);
  const float fz = fabsf(0.5f * (box[2] + box[5]) - r.oz) + 0.5f * (box[5] - box[2]);
  const float mo = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  const float pad = kBoxSlack * (mo + fx + fy + fz) + graze * (fx * fx + fy * fy + fz * fz);
  float t_near = -kInf, t_far = kInf;
  bool miss = box_axis(r.ox, r.dx, box[0] - pad, box[3] + pad, t_near, t_far);
  miss = box_axis(r.oy, r.dy, box[1] - pad, box[4] + pad, t_near, t_far) || miss;
  miss = box_axis(r.oz, r.dz, box[2] - pad, box[5] + pad, t_near, t_far) || miss;
  e = t_near * r.dnorm;
  return !miss && (t_near <= t_far) && (t_far >= 0.0f);
}

// Can the ray hit the box at a Euclidean distance <= bound?  bound is the
// ray's best t so far or a shadow ray's max t; <=, so a box that can only
// tie is still visited.
RTT_DEV bool box_hit(const float* box, const Ray& r, float bound, float graze) {
  float e;
  return box_entry(box, r, graze, e) && (e <= bound);
}

// Running closest hit with the winner's table row and world normal.
struct Best {
  float t, nx, ny, nz;
  int row;
};

// Merge another winner (t, row) into `b`: the lower (t, row).  A total
// order, so winners of any slices of the rows merge in any order to the
// winner of a strict-< sweep in ascending row order.
RTT_DEV void best_merge(Best& b, float t, int row) {
  if (t < b.t || (t == b.t && row < b.row)) { b.t = t; b.row = row; }
}

// Normalize a winner's world normal once (Code/shapes.cpp:186) and store it
// as lane i of the (3, R) rows `n`; a zero normal (no winner) stays zero.
RTT_DEV void store_unit_normal(float* n, size_t R, size_t i, float nx, float ny, float nz) {
  float ln = sqrtf(nx * nx + ny * ny + nz * nz);
  ln = (ln > 0.0f) ? ln : 1.0f;
  n[0 * R + i] = nx / ln;
  n[1 * R + i] = ny / ln;
  n[2 * R + i] = nz / ln;
}

// Closest hit over rows [start, end) of kind KIND, in table order, with
// the strict-< first-wins tie-break (Code/acceleration.cpp:112,133).
template <int KIND, bool MOTION = false>
RTT_DEV void closest_range(const float* tab, int G, int start, int end,
                           const Ray& r, Best& best) {
  for (int g = start; g < end; ++g) {
    float nx, ny, nz;
    const float t = geom_t<KIND, true, MOTION>(tab, G, g, r, nx, ny, nz);
    if (t < best.t) {
      best.t = t; best.row = g;
      best.nx = nx; best.ny = ny; best.nz = nz;
    }
  }
}

// The same without the normal: (t, row) only.
template <int KIND, bool MOTION = false>
RTT_DEV void closest_range_t(const float* tab, int G, int start, int end,
                             const Ray& r, float& best_t, int& best_row) {
  float nx, ny, nz;
  for (int g = start; g < end; ++g) {
    const float t = geom_t<KIND, false, MOTION>(tab, G, g, r, nx, ny, nz);
    if (t < best_t) { best_t = t; best_row = g; }
  }
}

// Any hit over rows [start, end) of kind KIND: true at the first geom
// with t <= maxt; the thread leaves the loop there.
template <int KIND>
RTT_DEV bool any_hit_range(const float* tab, int G, int start, int end,
                           const Ray& r, float maxt) {
  float nx, ny, nz;
  for (int g = start; g < end; ++g) {
    if (geom_t<KIND, false>(tab, G, g, r, nx, ny, nz) <= maxt) return true;
  }
  return false;
}

}  // namespace rtt
