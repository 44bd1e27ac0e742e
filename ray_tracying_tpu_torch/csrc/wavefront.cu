// Fused wavefront level for sm_90a: one whole bounce level per launch —
// closest hit with the winner's normal and table row, material record,
// ambient + Blinn-Phong per light, shadow any-hit with per-thread early
// exit, per-kind texture UV, nearest texel, glossy reflection spawn.
//
// Replaces the TPU kernel kernels/wavefront.py::_wave_kernel (with
// _any_hit) of the JAX package; its plain PyTorch version is
// kernels/wavefront.py::wave_level_plain of this package, whose order of
// operations this file follows term by term.
//
// Bound on an H100: operations.  A live lane runs G geom tests for the
// closest hit and up to n_lights * G for its shadow rays, about 80 f32
// operations each, against (9 + F) * 4 bytes read and 13 * 4 written.
// Design: one thread per ray lane; tensors are row-major (rows, R), lane
// i of row r at r * R + i, so every load and store of a warp is
// coalesced; the shaded table (columns, G) and the light table are copied
// to shared memory once per block and read as broadcasts; the winner's
// record is read back from shared memory by its row (a column of all
// geoms is contiguous, so lanes with different winners spread over
// banks); texels are single 32-bit loads from the u8 atlas in global
// memory; a lane that enters dead writes zeros and returns before any
// arithmetic.  One build serves every scene: kinds, light count, glossy
// and texture flags are runtime arguments, uniform over the grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/_build.py).
// No fast-math: misses are true +inf, the specular power is
// expf(shin * logf(.)), divisions and square roots are IEEE.

#include <stddef.h>
#include <stdint.h>

#include "geom.cuh"

namespace rtt {

constexpr float kTiny = (float)1e-20;
constexpr float kEpsNormalOffset = (float)1e-4;
constexpr float kEpsGlossyDir2 = (float)1e-3;
constexpr float kBackground = (float)0.1;
constexpr float kAttenNum = 10.0f, kAttenC0 = 25.0f, kAttenC1 = 10.0f, kAttenC2 = 150.0f;
constexpr float kInv255 = (float)(1.0 / 255.0);

// kGeomCols (geom.cuh) is also the first material column of a shaded row.
constexpr int kSlotCol = kGeomCols + 14;
constexpr int kOutRows = 13;
constexpr int kMaxRanges = 3;

struct WaveParams {
  const float* q;         // (>= 9, R) previous level / bootstrap
  const float* fuzz;      // (>= 3, R) unit-ball rows (glossy) or null
  const float* table;     // (n_cols, G) shaded table, transposed
  const float* lights;    // (8, L)
  const uint8_t* tex;     // (T, H, W, 4) u8 texels or null
  const float* twh;       // (2, T) true (w, h) per slot or null
  float* out;             // (13, R)
  long long R;
  int G, n_cols, n_lights;
  int n_ranges;
  int kind[kMaxRanges], start[kMaxRanges], end[kMaxRanges];
  int glossy, has_tex;
  int n_tex, tex_h, tex_w;
  float min_tp;
};

// One ray lane of one level.  tab / lights: the block's copies (shared
// memory on the device).
RTT_DEV void wave_lane(const WaveParams& p, const float* tab,
                       const float* lights, size_t i) {
  const size_t R = (size_t)p.R;
  const int G = p.G;
  float* out = p.out;
  const float act = p.q[7 * R + i];
  if (!(act > 0.0f)) {
    // Dead lane: every row zero.
    for (int row = 0; row < kOutRows; ++row) out[row * R + i] = 0.0f;
    return;
  }
  const Ray ray = make_ray(p.q[0 * R + i], p.q[1 * R + i], p.q[2 * R + i],
                           p.q[3 * R + i], p.q[4 * R + i], p.q[5 * R + i]);
  const float tp = p.q[8 * R + i];

  // --- closest hit, ranges in order, rows in table order.
  Best best;
  best.t = kInf; best.row = -1;
  best.nx = 0.0f; best.ny = 0.0f; best.nz = 0.0f;
  for (int k = 0; k < p.n_ranges; ++k) {
    switch (p.kind[k]) {
      case kKindSphere: closest_range<kKindSphere>(tab, G, p.start[k], p.end[k], ray, best); break;
      case kKindCube: closest_range<kKindCube>(tab, G, p.start[k], p.end[k], ray, best); break;
      default: closest_range<kKindRect>(tab, G, p.start[k], p.end[k], ray, best); break;
    }
  }
  const bool hit = isfinite(best.t);
  const float w_miss = hit ? 0.0f : tp;

  const float ln = sqrtf(best.nx * best.nx + best.ny * best.ny + best.nz * best.nz);
  const float inv_n = 1.0f / fmaxf(ln, kTiny);
  const float nx = best.nx * inv_n, ny = best.ny * inv_n, nz = best.nz * inv_n;

  // --- winner record (all zero without a winner).
  const int row = best.row;
#define RTT_REC(col) ((row >= 0) ? tab[(col) * G + row] : 0.0f)
  const float dr = RTT_REC(kGeomCols + 0), dg = RTT_REC(kGeomCols + 1), db = RTT_REC(kGeomCols + 2);
  const float sr = RTT_REC(kGeomCols + 3), sg = RTT_REC(kGeomCols + 4), sb = RTT_REC(kGeomCols + 5);
  const float ka = RTT_REC(kGeomCols + 6), kd = RTT_REC(kGeomCols + 7), ks = RTT_REC(kGeomCols + 8);
  const float shin = RTT_REC(kGeomCols + 9), rough = RTT_REC(kGeomCols + 10), refl = RTT_REC(kGeomCols + 11);

  // --- hit point; V = -d for unit d (Code/raytracer.cpp:197).
  const float t_fin = hit ? best.t : 0.0f;
  const float px = ray.ox + t_fin * ray.dx;
  const float py = ray.oy + t_fin * ray.dy;
  const float pz = ray.oz + t_fin * ray.dz;
  const float vx = -ray.dx, vy = -ray.dy, vz = -ray.dz;

  // local weight max(0, 1 - refl) (Code/raytracer.cpp:346-350).
  const float w_local = hit ? tp * fmaxf(1.0f - refl, 0.0f) : 0.0f;

  const float amb = ka * w_local;
  float d_r = dr * amb, d_g = dg * amb, d_b = db * amb;
  float s_r = w_miss * kBackground, s_g = w_miss * kBackground, s_b = w_miss * kBackground;

  const float sox = px + nx * kEpsNormalOffset;
  const float soy = py + ny * kEpsNormalOffset;
  const float soz = pz + nz * kEpsNormalOffset;

  // --- per light: Blinn-Phong (Code/raytracer.cpp:244-262) times the
  // visibility of one hard-shadow ray (:199-236).  A lane without a hit
  // has w_local == 0 and every product below exactly 0: skip the loop.
  if (hit) {
    const int L = p.n_lights;
    for (int li = 0; li < L; ++li) {
      const float lpx = lights[0 * L + li], lpy = lights[1 * L + li], lpz = lights[2 * L + li];
      const float lr = lights[3 * L + li], lg = lights[4 * L + li], lb = lights[5 * L + li];
      const float num = kAttenNum * lights[6 * L + li];
      const float lvx = lpx - px, lvy = lpy - py, lvz = lpz - pz;
      const float d2 = lvx * lvx + lvy * lvy + lvz * lvz;
      const float dist = sqrtf(d2);
      const float inv_d = 1.0f / fmaxf(dist, kTiny);
      const float lcx = lvx * inv_d, lcy = lvy * inv_d, lcz = lvz * inv_d;
      const float ndotl = fmaxf(nx * lcx + ny * lcy + nz * lcz, 0.0f);
      const float hx = lcx + vx, hy = lcy + vy, hz = lcz + vz;
      const float hn = sqrtf(hx * hx + hy * hy + hz * hz);
      const float inv_h = 1.0f / fmaxf(hn, kTiny);
      const float ndoth = fmaxf(nx * hx * inv_h + ny * hy * inv_h + nz * hz * inv_h, 0.0f);
      // pow(0, s) == 0, guarded; expf/logf, never __powf (shininess
      // reaches 5e6).
      const float spec_i = (ndoth > 0.0f) ? expf(shin * logf(fmaxf(ndoth, (float)1e-12))) : 0.0f;
      const float atten = num / (kAttenC0 + dist * kAttenC1 + d2 * kAttenC2);
      const float scale = atten * w_local;
      const float dif = kd * ndotl * scale;
      const float spc = ks * spec_i * scale;
      const float pr = dr * lr * dif, pg = dg * lg * dif, pb = db * lb * dif;
      const float qr = sr * lr * spc, qg = sg * lg * spc, qb = sb * lb * spc;
      const bool needs = (pr != 0.0f) || (pg != 0.0f) || (pb != 0.0f) ||
                         (qr != 0.0f) || (qg != 0.0f) || (qb != 0.0f);
      if (!needs) continue;
      // any-hit: blocked iff some geom has t <= dist.
      const Ray sray = make_ray(sox, soy, soz, lcx, lcy, lcz);
      bool blocked = false;
      for (int k = 0; k < p.n_ranges && !blocked; ++k) {
        switch (p.kind[k]) {
          case kKindSphere: blocked = any_hit_range<kKindSphere>(tab, G, p.start[k], p.end[k], sray, dist); break;
          case kKindCube: blocked = any_hit_range<kKindCube>(tab, G, p.start[k], p.end[k], sray, dist); break;
          default: blocked = any_hit_range<kKindRect>(tab, G, p.start[k], p.end[k], sray, dist); break;
        }
      }
      const float vis = blocked ? 0.0f : 1.0f;
      d_r = d_r + pr * vis; d_g = d_g + pg * vis; d_b = d_b + pb * vis;
      s_r = s_r + qr * vis; s_g = s_g + qg * vis; s_b = s_b + qb * vis;
    }
  }

  // --- texture: per-kind UV of the winner (Code/shapes.cpp:396-407 cube
  // entry face, :318-321 rect), nearest texel with v flipped
  // (Code/material.hpp:122-133).  Lanes without a texel keep texel 1.
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  if (p.has_tex && hit) {
    const float slot = RTT_REC(kSlotCol);
    if (slot >= 0.0f) {
      const float kindv = RTT_REC(15);
      const LocalRay l = to_local(tab, G, row, ray);
      // best.t is Euclidean = t_loc * |d| (Code/shapes.cpp:251-253).
      const float t_loc = t_fin / fmaxf(ray.dnorm, kTiny);
      const float plx = l.olx + t_loc * l.dlx;
      const float ply = l.oly + t_loc * l.dly;
      const float plz = l.olz + t_loc * l.dlz;
      float u = 0.0f, v = 0.0f;
      if (kindv == (float)kKindCube) {
        // Entry face, recomputed with true divisions as the plain version
        // does; ties break first-wins (strict >).
        float ent[3], sgn[3];
        const float oo[3] = {l.olx, l.oly, l.olz};
        const float dd[3] = {l.dlx, l.dly, l.dlz};
        for (int a = 0; a < 3; ++a) {
          const bool par = fabsf(dd[a]) < kEpsParallel;
          const float d_safe = par ? 1.0f : dd[a];
          const float s1 = (-0.5f - oo[a]) / d_safe;
          const float s2 = (0.5f - oo[a]) / d_safe;
          ent[a] = par ? -kInf : fminf(s1, s2);
          sgn[a] = (s1 < s2) ? -1.0f : 1.0f;
        }
        const bool win1 = ent[1] > ent[0];
        const float axv = win1 ? ent[1] : ent[0];
        const bool win2 = ent[2] > axv;
        const bool ax0 = !win1 && !win2;
        const bool ax1 = win1 && !win2;
        const float sg_f = win2 ? sgn[2] : (win1 ? sgn[1] : sgn[0]);
        const bool pos = sg_f > 0.0f;
        const float uc = plx + 0.5f, vc = ply + 0.5f, wc = plz + 0.5f;
        u = ax0 ? (pos ? wc : 1.0f - wc) : (ax1 ? uc : (pos ? uc : 1.0f - uc));
        v = ax0 ? vc : (ax1 ? (pos ? wc : 1.0f - wc) : vc);
      } else if (kindv == (float)kKindRect) {
        u = plx + 0.5f;
        v = ply + 0.5f;
      }
      const int si = (int)slot;
      const float twid = p.twh[0 * p.n_tex + si];
      const float thgt = p.twh[1 * p.n_tex + si];
      const float xx = fminf(fmaxf(floorf(u * (twid - 1.0f)), 0.0f), fmaxf(twid - 1.0f, 0.0f));
      const float yy = fminf(fmaxf(floorf((1.0f - v) * (thgt - 1.0f)), 0.0f), fmaxf(thgt - 1.0f, 0.0f));
      const size_t texel = ((size_t)si * p.tex_h + (size_t)yy) * p.tex_w + (size_t)xx;
      const uint32_t rgba = reinterpret_cast<const uint32_t*>(p.tex)[texel];
      tr = (float)(rgba & 0xffu) * kInv255;
      tg = (float)((rgba >> 8) & 0xffu) * kInv255;
      tb = (float)((rgba >> 16) & 0xffu) * kInv255;
    }
  }
#undef RTT_REC
  const float c_r = p.has_tex ? d_r * tr + s_r : d_r + s_r;
  const float c_g = p.has_tex ? d_g * tg + s_g : d_g + s_g;
  const float c_b = p.has_tex ? d_b * tb + s_b : d_b + s_b;

  // --- reflection continuation (Code/raytracer.cpp:307-333).
  const float ddn = ray.dx * nx + ray.dy * ny + ray.dz * nz;
  float rdx = ray.dx - ddn * 2.0f * nx;
  float rdy = ray.dy - ddn * 2.0f * ny;
  float rdz = ray.dz - ddn * 2.0f * nz;
  if (p.glossy && rough > 0.0f) {
    // normalize(R + roughness * unit_ball); rays perturbed below the
    // surface are absorbed (raytracer.cpp:312-327).
    float gx = rdx + rough * p.fuzz[0 * R + i];
    float gy = rdy + rough * p.fuzz[1 * R + i];
    float gz = rdz + rough * p.fuzz[2 * R + i];
    const float gn = sqrtf(gx * gx + gy * gy + gz * gz);
    const float inv_g = 1.0f / fmaxf(gn, kTiny);
    gx = gx * inv_g; gy = gy * inv_g; gz = gz * inv_g;
    const bool below = (gx * nx + gy * ny + gz * nz) < 0.0f;
    rdx = below ? 0.0f : gx;
    rdy = below ? 0.0f : gy;
    rdz = below ? 0.0f : gz;
  }
  const float rd2 = rdx * rdx + rdy * rdy + rdz * rdz;
  const float tp2 = tp * refl;
  bool ok = hit && (refl > 0.0f) && (rd2 > kEpsGlossyDir2);
  if (p.min_tp > 0.0f) ok = ok && (tp2 > p.min_tp);

  out[0 * R + i] = sox;
  out[1 * R + i] = soy;
  out[2 * R + i] = soz;
  out[3 * R + i] = rdx;
  out[4 * R + i] = rdy;
  out[5 * R + i] = rdz;
  out[6 * R + i] = 0.0f;  // secondary rays carry time 0 (Code/shapes.hpp:28)
  out[7 * R + i] = ok ? 1.0f : 0.0f;
  out[8 * R + i] = ok ? tp2 : 0.0f;
  out[9 * R + i] = c_r;
  out[10 * R + i] = c_g;
  out[11 * R + i] = c_b;
  out[12 * R + i] = hit ? 1.0f : 0.0f;
}

// Host side: gather one launch's arguments.  ranges: n_ranges triples
// (kind, start, end).
inline WaveParams make_params(
    const float* q, const float* fuzz, const float* table, const float* lights,
    const uint8_t* tex, const float* twh, float* out,
    long long R, int G, int n_cols, int n_lights,
    const int* ranges, int n_ranges, int glossy, int has_tex,
    int n_tex, int tex_h, int tex_w, float min_tp) {
  WaveParams p;
  p.q = q; p.fuzz = fuzz; p.table = table; p.lights = lights;
  p.tex = tex; p.twh = twh; p.out = out;
  p.R = R; p.G = G; p.n_cols = n_cols; p.n_lights = n_lights;
  p.n_ranges = n_ranges;
  for (int k = 0; k < kMaxRanges; ++k) {
    const bool used = k < n_ranges;
    p.kind[k] = used ? ranges[3 * k + 0] : 0;
    p.start[k] = used ? ranges[3 * k + 1] : 0;
    p.end[k] = used ? ranges[3 * k + 2] : 0;
  }
  p.glossy = glossy; p.has_tex = has_tex;
  p.n_tex = n_tex; p.tex_h = tex_h; p.tex_w = tex_w;
  p.min_tp = min_tp;
  return p;
}

}  // namespace rtt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace rtt {

__global__ void wave_level_kernel(const WaveParams p) {
  extern __shared__ float smem[];
  float* tab = smem;
  float* lights = smem + (size_t)p.n_cols * p.G;
  const int n_tab = p.n_cols * p.G;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) tab[k] = p.table[k];
  for (int k = threadIdx.x; k < 8 * p.n_lights; k += blockDim.x) lights[k] = p.lights[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.R) wave_lane(p, tab, lights, (size_t)i);
}

}  // namespace rtt

// Plain C interface (loaded with ctypes).  Launches one level on `stream`
// without synchronizing and returns cudaGetLastError() (0 = launched).
extern "C" int wave_level_launch(
    const float* q, const float* fuzz, const float* table, const float* lights,
    const uint8_t* tex, const float* twh, float* out,
    long long R, int G, int n_cols, int n_lights,
    const int* ranges, int n_ranges, int glossy, int has_tex,
    int n_tex, int tex_h, int tex_w, float min_tp, int threads, void* stream) {
  if (n_ranges > rtt::kMaxRanges || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const rtt::WaveParams p = rtt::make_params(
      q, fuzz, table, lights, tex, twh, out, R, G, n_cols, n_lights, ranges,
      n_ranges, glossy, has_tex, n_tex, tex_h, tex_w, min_tp);
  const size_t smem = sizeof(float) * ((size_t)n_cols * G + 8 * (size_t)n_lights);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rtt::wave_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (R + threads - 1) / threads;
  rtt::wave_level_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* wave_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // __CUDACC__
