// Fused wavefront level for sm_90a: one whole bounce level per launch —
// closest hit (moving spheres at the ray's time), material record,
// ambient + Blinn-Phong per light, shadow any-hit with per-thread early
// exit (one ray per point light, nss jittered rays per area light),
// per-kind texture UV (spherical, cube entry face, rect, projective
// plane), nearest texel, glossy reflection or one-way refraction spawn.
//
// Replaces the TPU kernel kernels/wavefront.py::_wave_kernel (with
// _any_hit) of the JAX package; its plain PyTorch version is
// kernels/wavefront.py::wave_level_plain of this package, whose order of
// operations this file follows term by term.
//
// What bounds a level on an H100.  Where most lanes are live (level 0):
// operations — a live lane runs G geom tests for its closest hit and, for
// each light whose term is not zero, a shadow ray of up to G more, about 80
// f32 operations a test, against ~100 bytes of its own.  Where few are
// (the deep levels): bytes — every lane's act is read and its 13 rows are
// written, dead or not.  What stood between the one-thread-per-lane
// schedule and those bounds: every block staged the whole table whatever
// its lanes; a warp with one live lane ran the whole table; shadow rays
// sat scattered over warps whose other lanes cast none.
//
// Design (wave_level_blocks_kernel), one cooperative launch a level:
// - Persistent blocks.  The grid is the resident block count.  A block
//   stages the shaded table, the light table and the table's windows
//   (below) in shared memory once: columns 12.. and the windows' permuted
//   rows by bulk asynchronous copies on an mbarrier, while its threads lay
//   out the transforms (three 16-byte words a geom) and the window records,
//   and scan.  A table over what a block can stage (up to the gate's 6,144
//   geoms) stays in global memory; the schedule is the same.
// - Phase 1, scan.  Blocks take steps of kScanLanes lanes from a counter,
//   four lanes a thread.  A dead lane gets its 13 zero rows at once, as
//   16-byte stores where four neighbours are dead, and costs nothing more.
//   Live lanes are staged in shared memory (warp prefix sums of popc) and
//   flushed to one list for the launch.
// - Phase 2, after a grid barrier.  Blocks take chunks of that list from a
//   counter (kChunk lanes, or fewer when the list is short, so that every
//   block gets one): live lanes clustered in a few scan steps spread over
//   every SM.  A chunk runs on dense warps in three stages.  hit: closest
//   (t, row), the loop carries no normal; a thread runs two lanes' tests
//   side by side on each geom it reads; a short chunk splits each lane's
//   rows over up to kMaxSplit threads.  shadow: each lane's
//   shadow rays of each light whose term is not zero (one for a point
//   light, nss toward points jittered by the fuzz rows for an area light)
//   are queued in shared memory and tested by dense warps with per-thread
//   early exit, in rounds as the queue fills; the lane gets a count of its
//   blocked rays per light (one byte a light).
//   finish: the winner's normal from the same geom test on its row,
//   shading in light order with those counts, texture, spawn, 13 rows.
// The window cull, for every table.  Where every lane tests every geom, a
// level is bound by those tests (141 a ray on the flagship's table,
// 2,049-6,144 on the wide ones, and as many a shadow ray), and where the
// table lies costs little beside them; only fewer tests help.  So the host
// sorts each kind range's rows by the Morton code of their boxes and cuts
// them into windows of kWinRows rows, each with its box and graze
// (kernels/wavefront.py::window_arrays), and packs a permuted geom-major
// copy of the rows; a block stages the window records, and the permuted
// rows where they fit.  In the hit stage a warp walks the windows of
// each range in Morton order: each lane box-tests the window against its
// rays' best t so far (box_hit, geom.cuh: the slack keeps every hit the
// geom test could report), and the warp runs the window's rows (shared
// memory, or 16-byte read-only loads) when some lane wants it; the winner merges by (t,
// original row), so the visiting order changes nothing.  The shadow
// queue's rays walk the windows in row order, each lane until its first
// blocker, the warp until no lane is open.  The shading and finish stages
// read the table in its own row order.
// Only who computes which lane, and when, differs from wave_lane (one
// thread, one lane, all three stages), and the windowed builds only skip
// rows whose hit is provably farther than the bound: every lane's
// arithmetic is the same, so every build equals the plain version bit for
// bit.  The stage functions
// are plain C++; a host compiler builds them, and
// tests/test_torch_kernel_source.py runs this block schedule with g++.
// One build serves every scene: kinds, light count, glossy, texture,
// motion and refraction flags, the area lights and their sample count are
// runtime arguments, uniform over the grid.
//
// Record mode (`record`, differentiable rendering) writes the level's
// discrete decisions after the 13 rows (record_none, wave_finish) and casts
// the shadow ray of every hit lane and light (shadow_cast); rows 0-12 are
// those of the inference launch, bit for bit.  The record rows go to
// global memory only: shared memory is what it is without them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/_build.py).
// No fast-math: misses are true +inf, the specular power is
// expf(shin * logf(.)), the spherical UV atan2f / asinf (never the __
// intrinsics), divisions and square roots are IEEE.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "geom.cuh"
#include "persist.cuh"

namespace rtt {

constexpr float kTiny = (float)1e-20;
constexpr float kEpsNormalOffset = (float)1e-4;
constexpr float kEpsGlossyDir2 = (float)1e-3;
constexpr float kBackground = (float)0.1;
constexpr float kAttenNum = 10.0f, kAttenC0 = 25.0f, kAttenC1 = 10.0f, kAttenC2 = 150.0f;
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kEpsRefractDir2 = (float)1e-6;
constexpr float kPi = (float)3.14159265358979;
constexpr float kTwoPi = 2.0f * kPi;

// kGeomCols (geom.cuh) is also the first material column of a shaded row.
constexpr int kSlotCol = kGeomCols + 14;
constexpr int kOutRows = 13;
constexpr int kMaxRanges = 4;  // sphere, cube, rect, legacy plane
constexpr int kMaxLights = 8;

// The block schedule of wave_level_blocks_kernel.  List and queue
// capacities are in entries: the preferred ones, and the least ones, which
// the choice of build (kernels/wavefront.py::wave_smem_bytes) assumes.
constexpr int kWaveThreads = 256;
constexpr int kWaveWarps = kWaveThreads / 32;
constexpr int kScanLanes = 4 * kWaveThreads;
// The scan stages live lanes in a list of list_cap entries, flushed to the
// launch's global list when the next step could overflow it; the lanes then
// run in chunks of up to kChunk, two lanes a thread in the hit stage.
constexpr int kChunk = 2 * kWaveThreads;
constexpr int kListCap = 2 * kScanLanes, kQueueCap = 512;
constexpr int kListCapMin = kScanLanes, kQueueCapMin = kWaveThreads;
// Up to kMaxSplit threads share one entry of a short list or queue, each
// taking a slice of every range (wave_split).
constexpr int kMaxSplit = 8;
constexpr int kSmemHeader = 256;  // mbarrier, per-warp counts
constexpr uint32_t kNoRow = 0xffffu;

// Builds of wave_level_blocks_kernel: the table staged in each block and
// read whole by every lane (kept as the reference the culled builds are
// held to); a wide table read whole by every lane (the first wide build,
// kept only to be measured against); a table culled by window, its rows
// read by 16-byte read-only loads (a table over what a block stages); the
// same counting the tests it runs (WinWork); a table culled by window with
// the table, its window records and its permuted rows staged in each block
// (every table a block stages whole: the package's build for them).
constexpr int kBuildStaged = 0;
constexpr int kBuildUnculled = 1;
constexpr int kBuildWindows = 2;
constexpr int kBuildWindowsCount = 3;
constexpr int kBuildStagedWindows = 4;
RTT_HD constexpr bool build_windowed(int b) { return b >= kBuildWindows; }
RTT_HD constexpr bool build_stages_table(int b) {
  return b == kBuildStaged || b == kBuildStagedWindows;
}

// A table's windows (kernels/wavefront.py::window_arrays): within each
// kind range the rows in the Morton order of their boxes, kWinRows
// consecutive ones a window.  A permuted row is kWinCols floats (transform
// 12 | velocity 3 | its original row, int bits); a window's record kWinRec
// (box 6 | graze | first permuted row | count << 16, int bits).  Up to the
// gate's 6,144 geoms: 192 full windows and a partial one a range.
constexpr int kWinRows = 32;
constexpr int kWinCols = 16;
constexpr int kWinRec = 8;
constexpr int kMaxWindows = 6144 / kWinRows + kMaxRanges;
// The counting build's counters (kernels/wavefront.py::WINDOW_WORK).
constexpr int kWinWork = 5;

struct WaveParams {
  const float* q;         // (>= 9, R) previous level / bootstrap
  const float* fuzz;      // (>= 3, R) unit-ball rows (glossy) or null
  const float* table;     // (n_cols, G) shaded table, transposed
  const float* xf;        // (G, 12) geom-major transforms of a wide table, else null
  const float* lights;    // (8, L)
  const uint8_t* tex;     // (T, H, W, 4) u8 texels or null
  const float* twh;       // (2, T) true (w, h) per slot or null
  float* out;             // (13, R), or (13 + n_rec, R) in record mode
  float* rec;             // record rows (out + 13 * R) in record mode, else null
  long long R;
  int G, n_cols, n_lights;
  int n_ranges;
  int kind[kMaxRanges], start[kMaxRanges], end[kMaxRanges];
  int glossy, has_tex;
  int n_tex, tex_h, tex_w;
  float min_tp;
  int vec4;               // R % 4 == 0 and q, out 16-byte aligned
  int motion;             // spheres move: origin - velocity * time
  int refraction;         // some material refracts (one-way)
  uint32_t area;          // bit li: light li is an area light
  int nss;                // shadow rays per area light
  float inv_nss;          // 1 / nss, in f32
  int fuzz_row[kMaxLights];  // fuzz row of sample 0 of each area light
  // A windowed build's operands, else null / 0: the permuted rows (G,
  // kWinCols), the window records (n_win, kWinRec), range r's windows
  // [wbeg[r], wbeg[r + 1]); the counting build's kWinWork counters.
  const float* xp;
  const float* win;
  int n_win;
  int wbeg[kMaxRanges + 1];
  unsigned long long* work;
};

// Shadow rays of light li: nss for an area light, one for a point light.
RTT_HD int light_rays(const WaveParams& p, int li) {
  return ((p.area >> li) & 1u) ? p.nss : 1;
}

// Visibility of light li from the count of its blocked rays: 0 or 1 for a
// point light; for an area light (nss - blocked) / nss, the sum of each
// ray's (1 - blocked) times 1 / nss as the plain version adds them.
RTT_HD float light_vis(const WaveParams& p, int li, uint32_t blocked) {
  if ((p.area >> li) & 1u) return (float)(p.nss - (int)blocked) * p.inv_nss;
  return blocked ? 0.0f : 1.0f;
}

// Record mode (differentiable rendering): after the 13 rows, 1 + n_lights
// (+ 3 when textured) rows of the level's discrete decisions, which the
// backward replays (kernels/wave_ref.py): the winner's geom id (table
// column 16), the raw geometric visibility of each light, the texel rgb
// the diffuse part was multiplied by.  A lane without a hit (dead or a
// miss) records id -1, visibility 0, texel 1.
RTT_DEV void record_none(const WaveParams& p, size_t i) {
  const size_t R = (size_t)p.R;
  p.rec[i] = -1.0f;
  for (int li = 0; li < p.n_lights; ++li) p.rec[(1 + li) * R + i] = 0.0f;
  if (p.has_tex) {
    for (int c = 0; c < 3; ++c) p.rec[(1 + p.n_lights + c) * R + i] = 1.0f;
  }
}

// The shaded table as the tensor holds it: (n_cols, G), transposed.
struct TabT {
  const float* tab;
  int G;
  RTT_DEV Xform xf(int g) const { return load_xform(tab, G, g); }
  RTT_DEV float col(int c, int g) const { return tab[c * G + g]; }
};

// A transform from its three 16-byte words.
RTT_DEV Xform xform_of(const F4& a, const F4& b, const F4& c) {
  Xform m;
  m.c[0] = a.x; m.c[1] = a.y; m.c[2] = a.z; m.c[3] = a.w;
  m.c[4] = b.x; m.c[5] = b.y; m.c[6] = b.z; m.c[7] = b.w;
  m.c[8] = c.x; m.c[9] = c.y; m.c[10] = c.z; m.c[11] = c.w;
  return m;
}

// A block's staged copy: geom g's 12 transform floats as the 16-byte words
// xf4[3g .. 3g+2] (a warp at one g reads three broadcasts), then columns
// 12.. transposed as the tensor holds them (a column of all geoms is
// contiguous, so lanes reading different winner rows spread over banks).
struct TabS {
  const F4* xf4;
  const float* rest;
  int G;
  RTT_DEV Xform xf(int g) const { return xform_of(xf4[3 * g], xf4[3 * g + 1], xf4[3 * g + 2]); }
  RTT_DEV float col(int c, int g) const { return rest[(c - 12) * G + g]; }
};

// A wide table (over the staged build's cap) where the launch left it, in
// global memory (6,144 geoms of 32 columns are 786 KB, which the L2 holds):
// geom g's transform as three 16-byte read-only loads of the geom-major copy
// xf[12g .. 12g+11] (the launcher's copy of the table's rows 0..11), every
// other column from the transposed table.
struct TabW {
  const float* xf12;
  TabT t;
  RTT_DEV Xform xf(int g) const {
    const float* a = xf12 + 12 * (size_t)g;
    return xform_of(ldg4(a), ldg4(a + 4), ldg4(a + 8));
  }
  RTT_DEV float col(int c, int g) const { return t.col(c, g); }
};

// Word k of TabS::xf4, from the transposed table.
RTT_DEV F4 staged_xf(const float* table, int G, int k) {
  const int g = k / 3, c = 4 * (k % 3);
  F4 v;
  v.x = table[c * G + g];
  v.y = table[(c + 1) * G + g];
  v.z = table[(c + 2) * G + g];
  v.w = table[(c + 3) * G + g];
  return v;
}

// Lane i's ray; its time (row 6) is read only where spheres move (the
// hit stage's MOTION: without it the time is the constant 0, and no
// register holds it through the stage's loops).
template <bool MOTION>
RTT_DEV Ray lane_ray_m(const WaveParams& p, size_t i) {
  const size_t R = (size_t)p.R;
  return make_ray(p.q[0 * R + i], p.q[1 * R + i], p.q[2 * R + i],
                  p.q[3 * R + i], p.q[4 * R + i], p.q[5 * R + i],
                  MOTION ? p.q[6 * R + i] : 0.0f);
}

RTT_DEV Ray lane_ray(const WaveParams& p, size_t i) {
  return p.motion ? lane_ray_m<true>(p, i) : lane_ray_m<false>(p, i);
}

// A lane that enters dead leaves with every row zero.
RTT_DEV void wave_dead(const WaveParams& p, size_t i) {
  const size_t R = (size_t)p.R;
  for (int row = 0; row < kOutRows; ++row) p.out[row * R + i] = 0.0f;
  if (p.rec) record_none(p, i);
}

// ---------------------------------------------------------------- hit stage

// The geom test of table row g of kind KIND (geom.cuh's geom_t on a
// table layout `Tab`): MOTION shifts the origin by -velocity * time
// (Code/shapes.cpp:201-210; spheres only carry velocity, columns 12..14);
// a legacy plane reads its corners from the row's Xform, which is columns
// 0..11 as the table holds them (TabS stages them as they are).
template <int KIND, bool WANT_N, bool MOTION, class Tab>
RTT_DEV float tab_geom_t(const Tab& tb, int g, const Ray& r, float& nx, float& ny, float& nz) {
  const Xform m = tb.xf(g);
  if constexpr (KIND == kKindPlane) {
    return plane_t_x<WANT_N>(m, r, nx, ny, nz);
  } else {
    float ox = r.ox, oy = r.oy, oz = r.oz;
    if constexpr (MOTION) {
      ox = r.ox - r.tm * tb.col(12, g);
      oy = r.oy - r.tm * tb.col(13, g);
      oz = r.oz - r.tm * tb.col(14, g);
    }
    return geom_t_x<KIND, WANT_N>(m, to_local_x(m, ox, oy, oz, r), r, nx, ny, nz);
  }
}

template <int KIND, bool MOTION, class Tab>
RTT_DEV void closest_t_range(const Tab& tb, int start, int end, const Ray& r,
                             float& best_t, int& best_row) {
  float nx, ny, nz;
  for (int g = start; g < end; ++g) {
    const float t = tab_geom_t<KIND, false, MOTION>(tb, g, r, nx, ny, nz);
    if (t < best_t) { best_t = t; best_row = g; }
  }
}

// Calls FN<KIND, MOTION>(args...) for range r's kind: spheres move when
// the scene has motion blur (MOTION, a constant of the caller); every
// other kind is still.
#define RTT_KIND_DISPATCH(p, r, FN, ...)                                  \
  switch ((p).kind[r]) {                                                  \
    case kKindSphere: FN<kKindSphere, MOTION>(__VA_ARGS__); break;        \
    case kKindCube: FN<kKindCube, false>(__VA_ARGS__); break;             \
    case kKindRect: FN<kKindRect, false>(__VA_ARGS__); break;             \
    default: FN<kKindPlane, false>(__VA_ARGS__); break;                   \
  }

// Rows [lo, hi) of slice j of k of rows [start, end).
RTT_HD void slice_rows(int start, int end, int j, int k, int& lo, int& hi) {
  lo = start + (end - start) * j / k;
  hi = start + (end - start) * (j + 1) / k;
}

// How many threads share one of n entries (a power of two up to
// kMaxSplit; n * split <= kWaveThreads): a short list or queue runs on as
// many threads as a long one.
RTT_HD int wave_split(int n) {
  int k = 1;
  while (k < kMaxSplit && 2 * k * n <= kWaveThreads) k *= 2;
  return k;
}

// Closest (t, row) over slice j of k of every range: ranges in order, rows
// in table order, strict < (first wins, Code/acceleration.cpp:112,133).
// The ranges are sorted by row, so the merge below of the k slices' winners
// (the lower t, at equal t the lower row) is the winner of the whole loop.
template <bool MOTION, class Tab>
RTT_DEV void wave_hit_part(const WaveParams& p, const Tab& tb, const Ray& ray, int j, int k,
                           float& t, int& row) {
  for (int r = 0; r < p.n_ranges; ++r) {
    int lo, hi;
    slice_rows(p.start[r], p.end[r], j, k, lo, hi);
    RTT_KIND_DISPATCH(p, r, closest_t_range, tb, lo, hi, ray, t, row)
  }
}

RTT_DEV void merge_hit(float& t, int& row, float t2, int row2) {
  if (t2 < t || (t2 == t && row2 < row)) { t = t2; row = row2; }
}

// Two rays through the same rows: closest_t_range for each, one read of
// each geom's transform.
template <int KIND, bool MOTION, class Tab>
RTT_DEV void closest_t_range2(const Tab& tb, int start, int end, const Ray& a, const Ray& b,
                              float& ta, int& rowa, float& tb_, int& rowb) {
  float nx, ny, nz;
  for (int g = start; g < end; ++g) {
    const float t1 = tab_geom_t<KIND, false, MOTION>(tb, g, a, nx, ny, nz);
    const float t2 = tab_geom_t<KIND, false, MOTION>(tb, g, b, nx, ny, nz);
    if (t1 < ta) { ta = t1; rowa = g; }
    if (t2 < tb_) { tb_ = t2; rowb = g; }
  }
}

// ------------------------------------------------------ the windowed tables

RTT_DEV int win_first(const float* rec) { return (int)(f32_as_u32(rec[7]) & 0xffffu); }
RTT_DEV int win_count(const float* rec) { return (int)(f32_as_u32(rec[7]) >> 16); }

// Permuted rows as a table view: row j (a permuted index) at rows +
// kWinCols * j, in global memory read by 16-byte read-only loads (TabP), or
// staged in a block's shared memory (TabPS: a warp that walks a window
// reads one row at a time, a broadcast).  col() serves the velocity columns
// 12..14 of a moving sphere's test.
template <bool STAGED>
struct TabPerm {
  const float* rows;
  RTT_DEV const float* at(int j) const { return rows + kWinCols * (size_t)j; }
  RTT_DEV F4 word(const float* a) const { return STAGED ? load4(a) : ldg4(a); }
  RTT_DEV Xform xf(int j) const {
    const float* a = at(j);
    return xform_of(word(a), word(a + 4), word(a + 8));
  }
  RTT_DEV float col(int c, int j) const { return at(j)[c]; }
  RTT_DEV int orig(int j) const { return (int)f32_as_u32(at(j)[15]); }
};
typedef TabPerm<false> TabP;
typedef TabPerm<true> TabPS;

// Rows first + j0, first + j0 + step, ... below first + count of a window
// for ray r: the running closest (t, original row), merged by (t, row)
// lexicographically (merge_hit), so that whatever order the rows come in
// the winner is the row-order strict-< loop's.  Returns the rows run.
template <int KIND, bool MOTION, class TP>
RTT_DEV int win_closest(const TP& tp, int first, int count, int j0, int step, const Ray& r,
                        float& t, int& row) {
  float nx, ny, nz;
  int ran = 0;
  for (int j = first + j0; j < first + count; j += step, ++ran) {
    const float tt = tab_geom_t<KIND, false, MOTION>(tp, j, r, nx, ny, nz);
    if (tt < t || (tt == t && tp.orig(j) < row)) { t = tt; row = tp.orig(j); }
  }
  return ran;
}

// Two rays through every row of a window, one read of each row.
template <int KIND, bool MOTION, class TP>
RTT_DEV void win_closest2(const TP& tp, int first, int count, const Ray& a, const Ray& b,
                          float& ta, int& ra, float& tb, int& rb) {
  float nx, ny, nz;
  for (int j = first; j < first + count; ++j) {
    const float t1 = tab_geom_t<KIND, false, MOTION>(tp, j, a, nx, ny, nz);
    const float t2 = tab_geom_t<KIND, false, MOTION>(tp, j, b, nx, ny, nz);
    if (t1 < ta || (t1 == ta && tp.orig(j) < ra)) { ta = t1; ra = tp.orig(j); }
    if (t2 < tb || (t2 == tb && tp.orig(j) < rb)) { tb = t2; rb = tp.orig(j); }
  }
}

// A thread's rows of a window in the hit stage: both rays (vb; then j0 = 0,
// step = 1), or ray a's slice.  Returns the rows run for each valid ray.
template <int KIND, bool MOTION, class TP>
RTT_DEV int win_rows_hit(const TP& tp, int first, int count, const Ray& a, bool va,
                         const Ray& b, bool vb, int j0, int step, float& ta, int& ra,
                         float& tb, int& rb) {
  if (vb) {
    win_closest2<KIND, MOTION>(tp, first, count, a, b, ta, ra, tb, rb);
    return count;
  }
  return va ? win_closest<KIND, MOTION>(tp, first, count, j0, step, a, ta, ra) : 0;
}

// A shadow ray's slice of a window: true at its first blocker (t <= maxt),
// where it leaves.  Shadow rays carry time 0: nothing moves.  Returns the
// rows run.
template <int KIND, class TP>
RTT_DEV int win_any(const TP& tp, int first, int count, int j0, int step, const Ray& r,
                    float maxt, bool& blocked) {
  float nx, ny, nz;
  int ran = 0;
  for (int j = first + j0; j < first + count; j += step) {
    ++ran;
    if (tab_geom_t<KIND, false, false>(tp, j, r, nx, ny, nz) <= maxt) {
      blocked = true;
      return ran;
    }
  }
  return ran;
}

// Table row of the closest hit, -1 for none.
template <class Tab>
RTT_DEV int wave_hit(const WaveParams& p, const Tab& tb, const Ray& ray) {
  float t = kInf;
  int row = -1;
  if (p.motion) wave_hit_part<true>(p, tb, ray, 0, 1, t, row);
  else wave_hit_part<false>(p, tb, ray, 0, 1, t, row);
  return row;
}

// The winner's t and UNnormalized world normal: the geom test that won the
// loop, run again on its row with the normal; +inf and 0 for no winner.
template <class Tab>
RTT_DEV float winner_t(const WaveParams& p, const Tab& tb, int row, const Ray& r,
                       float& nx, float& ny, float& nz) {
  nx = 0.0f; ny = 0.0f; nz = 0.0f;
  if (row < 0) return kInf;
  int kind = kKindRect;
  for (int k = 0; k < p.n_ranges; ++k) {
    if (row >= p.start[k] && row < p.end[k]) kind = p.kind[k];
  }
  switch (kind) {
    case kKindSphere:
      return p.motion ? tab_geom_t<kKindSphere, true, true>(tb, row, r, nx, ny, nz)
                      : tab_geom_t<kKindSphere, true, false>(tb, row, r, nx, ny, nz);
    case kKindCube: return tab_geom_t<kKindCube, true, false>(tb, row, r, nx, ny, nz);
    case kKindRect: return tab_geom_t<kKindRect, true, false>(tb, row, r, nx, ny, nz);
    default: return tab_geom_t<kKindPlane, true, false>(tb, row, r, nx, ny, nz);
  }
}

// What the shadow and finish stages know of a live lane: its ray, winner,
// unit normal, record (all zero without a winner), hit point and weights.
struct WaveShade {
  Ray ray;
  float tp;
  int row;
  bool hit;
  float nx, ny, nz;
  float dr, dg, db, sr, sg, sb, ka, kd, ks, shin, rough, refl;
  float t_fin, px, py, pz;
  float w_local, w_miss;
  float sox, soy, soz;
};

template <class Tab>
RTT_DEV WaveShade wave_shade(const WaveParams& p, const Tab& tb, size_t i, int row) {
  const size_t R = (size_t)p.R;
  WaveShade s;
  s.ray = lane_ray(p, i);
  s.tp = p.q[8 * R + i];
  s.row = row;
  float bnx, bny, bnz;
  const float best_t = winner_t(p, tb, row, s.ray, bnx, bny, bnz);
  s.hit = isfinite(best_t);
  s.w_miss = s.hit ? 0.0f : s.tp;

  const float ln = sqrtf(bnx * bnx + bny * bny + bnz * bnz);
  const float inv_n = 1.0f / fmaxf(ln, kTiny);
  s.nx = bnx * inv_n; s.ny = bny * inv_n; s.nz = bnz * inv_n;

#define RTT_REC(c_) ((row >= 0) ? tb.col((c_), row) : 0.0f)
  s.dr = RTT_REC(kGeomCols + 0); s.dg = RTT_REC(kGeomCols + 1); s.db = RTT_REC(kGeomCols + 2);
  s.sr = RTT_REC(kGeomCols + 3); s.sg = RTT_REC(kGeomCols + 4); s.sb = RTT_REC(kGeomCols + 5);
  s.ka = RTT_REC(kGeomCols + 6); s.kd = RTT_REC(kGeomCols + 7); s.ks = RTT_REC(kGeomCols + 8);
  s.shin = RTT_REC(kGeomCols + 9); s.rough = RTT_REC(kGeomCols + 10); s.refl = RTT_REC(kGeomCols + 11);
  // transparency: read only when the scene refracts (0 otherwise)
  const float trans = p.refraction ? RTT_REC(kGeomCols + 12) : 0.0f;
#undef RTT_REC

  // hit point; V = -d for unit d (Code/raytracer.cpp:197).
  s.t_fin = s.hit ? best_t : 0.0f;
  s.px = s.ray.ox + s.t_fin * s.ray.dx;
  s.py = s.ray.oy + s.t_fin * s.ray.dy;
  s.pz = s.ray.oz + s.t_fin * s.ray.dz;
  // local weight max(0, 1 - refl - trans) (Code/raytracer.cpp:346-350).
  s.w_local = s.hit ? s.tp * fmaxf(1.0f - s.refl - trans, 0.0f) : 0.0f;
  s.sox = s.px + s.nx * kEpsNormalOffset;
  s.soy = s.py + s.ny * kEpsNormalOffset;
  s.soz = s.pz + s.nz * kEpsNormalOffset;
  return s;
}

// ------------------------------------------------------------- shadow stage

// Blinn-Phong of one light (Code/raytracer.cpp:244-262, from the light's
// centre even for an area light) before visibility, and the direction and
// distance of the centre.  A lane whose products are all zero casts no
// shadow ray (`needs`), except in record mode, where every hit lane casts
// every ray of each light (`shadow_cast`): the recorded visibility is the
// raw geometric one, so that a term that is zero here still gets its
// gradient.
struct LightTerm {
  float pr, pg, pb, qr, qg, qb;
  float lcx, lcy, lcz, dist;
  bool needs;
};

RTT_DEV LightTerm light_term(const WaveShade& s, const float* lights, int L, int li) {
  LightTerm o;
  const float lpx = lights[0 * L + li], lpy = lights[1 * L + li], lpz = lights[2 * L + li];
  const float lr = lights[3 * L + li], lg = lights[4 * L + li], lb = lights[5 * L + li];
  const float num = kAttenNum * lights[6 * L + li];
  const float lvx = lpx - s.px, lvy = lpy - s.py, lvz = lpz - s.pz;
  const float d2 = lvx * lvx + lvy * lvy + lvz * lvz;
  o.dist = sqrtf(d2);
  const float inv_d = 1.0f / fmaxf(o.dist, kTiny);
  o.lcx = lvx * inv_d; o.lcy = lvy * inv_d; o.lcz = lvz * inv_d;
  const float ndotl = fmaxf(s.nx * o.lcx + s.ny * o.lcy + s.nz * o.lcz, 0.0f);
  const float hx = o.lcx + -s.ray.dx, hy = o.lcy + -s.ray.dy, hz = o.lcz + -s.ray.dz;
  const float hn = sqrtf(hx * hx + hy * hy + hz * hz);
  const float inv_h = 1.0f / fmaxf(hn, kTiny);
  const float ndoth = fmaxf(s.nx * hx * inv_h + s.ny * hy * inv_h + s.nz * hz * inv_h, 0.0f);
  // pow(0, s) == 0, guarded; expf/logf, never __powf (shininess reaches
  // 5e6).
  const float spec_i = (ndoth > 0.0f) ? expf(s.shin * logf(fmaxf(ndoth, (float)1e-12))) : 0.0f;
  const float atten = num / (kAttenC0 + o.dist * kAttenC1 + d2 * kAttenC2);
  const float scale = atten * s.w_local;
  const float dif = s.kd * ndotl * scale;
  const float spc = s.ks * spec_i * scale;
  o.pr = s.dr * lr * dif; o.pg = s.dg * lg * dif; o.pb = s.db * lb * dif;
  o.qr = s.sr * lr * spc; o.qg = s.sg * lg * spc; o.qb = s.sb * lb * spc;
  o.needs = (o.pr != 0.0f) || (o.pg != 0.0f) || (o.pb != 0.0f) ||
            (o.qr != 0.0f) || (o.qg != 0.0f) || (o.qb != 0.0f);
  return o;
}

// Whether a hit lane casts the shadow rays of light term lt.
RTT_DEV bool shadow_cast(const WaveParams& p, const LightTerm& lt) {
  return lt.needs || p.rec != nullptr;
}

// Direction and length of shadow ray k of light li from lane i's hit
// point (Code/raytracer.cpp:199-236): toward the centre for a point light;
// for an area light toward lp + radius * (the lane's fuzz rows of sample
// k), normalized as the plain version does.
struct ShadowDir {
  float dx, dy, dz, maxt;
};

RTT_DEV ShadowDir shadow_dir(const WaveParams& p, const WaveShade& s, const LightTerm& lt,
                             const float* lights, int li, int k, size_t i) {
  ShadowDir o;
  if (!((p.area >> li) & 1u)) {
    o.dx = lt.lcx; o.dy = lt.lcy; o.dz = lt.lcz; o.maxt = lt.dist;
    return o;
  }
  const int L = p.n_lights;
  const size_t R = (size_t)p.R;
  const float lrad = lights[7 * L + li];
  const float* f = p.fuzz + (size_t)(p.fuzz_row[li] + 3 * k) * R + i;
  const float txp = lights[0 * L + li] + lrad * f[0];
  const float typ = lights[1 * L + li] + lrad * f[R];
  const float tzp = lights[2 * L + li] + lrad * f[2 * R];
  const float svx = txp - s.px, svy = typ - s.py, svz = tzp - s.pz;
  o.maxt = sqrtf(svx * svx + svy * svy + svz * svz);
  const float inv_s = 1.0f / fmaxf(o.maxt, kTiny);
  o.dx = svx * inv_s; o.dy = svy * inv_s; o.dz = svz * inv_s;
  return o;
}

template <int KIND, bool MOTION, class Tab>
RTT_DEV void any_hit_t_range(const Tab& tb, int start, int end, const Ray& r, float maxt,
                             bool& blocked) {
  float nx, ny, nz;
  for (int g = start; g < end; ++g) {
    if (tab_geom_t<KIND, false, MOTION>(tb, g, r, nx, ny, nz) <= maxt) {
      blocked = true;
      return;
    }
  }
}

// A shadow ray (Code/raytracer.cpp:199-236): blocked iff some geom has
// t <= maxt.  Shadow rays carry time 0 (Code/shapes.hpp:28): nothing
// moves.  Over slice j of k of every range; the ray is blocked iff some
// slice is.  The thread leaves at its first blocker.
template <class Tab>
RTT_DEV bool wave_blocked(const WaveParams& p, const Tab& tb, float ox, float oy, float oz,
                          float dx, float dy, float dz, float maxt, int j = 0, int k = 1) {
  const Ray sray = make_ray(ox, oy, oz, dx, dy, dz);
  bool blocked = false;
  for (int r = 0; r < p.n_ranges && !blocked; ++r) {
    int lo, hi;
    slice_rows(p.start[r], p.end[r], j, k, lo, hi);
    switch (p.kind[r]) {
      case kKindSphere: any_hit_t_range<kKindSphere, false>(tb, lo, hi, sray, maxt, blocked); break;
      case kKindCube: any_hit_t_range<kKindCube, false>(tb, lo, hi, sray, maxt, blocked); break;
      case kKindRect: any_hit_t_range<kKindRect, false>(tb, lo, hi, sray, maxt, blocked); break;
      default: any_hit_t_range<kKindPlane, false>(tb, lo, hi, sray, maxt, blocked); break;
    }
  }
  return blocked;
}

// ------------------------------------------------------------- finish stage

// A lane's counts of blocked shadow rays, byte li for light li: in two
// words of a chunk entry in shared memory (the block schedule) or in one
// register pair (one thread, one lane).
struct CountWords {
  const uint32_t* w;
  RTT_DEV uint32_t get(int li) const { return (w[li >> 2] >> (8 * (li & 3))) & 0xffu; }
};
struct CountBytes {
  uint64_t v;
  RTT_DEV uint32_t get(int li) const { return (uint32_t)(v >> (8 * li)) & 0xffu; }
};

// Shading in light order with the counts of blocked shadow rays, texture,
// spawn; writes lane i's 13 rows.  A light whose products are all zero is
// skipped, not added as zero: a zero product could turn -0 into +0.
template <class Tab, class Counts>
RTT_DEV void wave_finish(const WaveParams& p, const Tab& tb, const float* lights, size_t i,
                         const WaveShade& s, const Counts& blocked) {
  const size_t R = (size_t)p.R;
  float* out = p.out;
  const int row = s.row;
  const float amb = s.ka * s.w_local;
  float d_r = s.dr * amb, d_g = s.dg * amb, d_b = s.db * amb;
  float s_r = s.w_miss * kBackground, s_g = s.w_miss * kBackground, s_b = s.w_miss * kBackground;
  // A lane without a hit has w_local == 0 and every product exactly 0.
  if (s.hit) {
    for (int li = 0; li < p.n_lights; ++li) {
      const LightTerm lt = light_term(s, lights, p.n_lights, li);
      if (!lt.needs) continue;
      const float vis = light_vis(p, li, blocked.get(li));
      d_r = d_r + lt.pr * vis; d_g = d_g + lt.pg * vis; d_b = d_b + lt.pb * vis;
      s_r = s_r + lt.qr * vis; s_g = s_g + lt.qg * vis; s_b = s_b + lt.qb * vis;
    }
  }

  // --- texture: per-kind UV of the winner (Code/shapes.cpp:257-259
  // sphere, :396-407 cube entry face, :318-321 rect, :470-481 plane),
  // nearest texel with v flipped (Code/material.hpp:122-133).  Lanes
  // without a texel keep texel 1.
  float tr = 1.0f, tg = 1.0f, tb_ = 1.0f;
  if (p.has_tex && s.hit) {
    const float slot = tb.col(kSlotCol, row);
    if (slot >= 0.0f) {
      const float kindv = tb.col(kKindCol, row);
      const Ray& ray = s.ray;
      // the winner's object space at the ray's time (row 6, read here)
      float ox = ray.ox, oy = ray.oy, oz = ray.oz;
      if (p.motion) {
        const float tm = p.q[6 * R + i];
        ox = ray.ox - tm * tb.col(12, row);
        oy = ray.oy - tm * tb.col(13, row);
        oz = ray.oz - tm * tb.col(14, row);
      }
      const LocalRay l = to_local_x(tb.xf(row), ox, oy, oz, ray);
      // best t is Euclidean = t_loc * |d| (Code/shapes.cpp:251-253).
      const float t_loc = s.t_fin / fmaxf(ray.dnorm, kTiny);
      const float plx = l.olx + t_loc * l.dlx;
      const float ply = l.oly + t_loc * l.dly;
      const float plz = l.olz + t_loc * l.dlz;
      float u = 0.0f, v = 0.0f;
      if (kindv == (float)kKindSphere) {
        // atan2f / asinf and true divisions, as the plain version's
        // torch.atan2 / torch.asin
        u = 0.5f + atan2f(plz, plx) / kTwoPi;
        v = 0.5f - asinf(fminf(fmaxf(ply, -1.0f), 1.0f)) / kPi;
      } else if (kindv == (float)kKindCube) {
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
      } else if (kindv == (float)kKindPlane) {
        // projective UV: the world hit point onto the corner-0 -> 1 and
        // corner-0 -> 3 edges, clamped to [0, 1]
        const Xform m = tb.xf(row);
        const float* c = m.c;
        const float eux = c[3] - c[0], euy = c[4] - c[1], euz = c[5] - c[2];
        const float evx = c[9] - c[0], evy = c[10] - c[1], evz = c[11] - c[2];
        const float hvx = (ray.ox + s.t_fin * ray.dx) - c[0];
        const float hvy = (ray.oy + s.t_fin * ray.dy) - c[1];
        const float hvz = (ray.oz + s.t_fin * ray.dz) - c[2];
        const float eu2 = fmaxf(eux * eux + euy * euy + euz * euz, kTiny);
        const float ev2 = fmaxf(evx * evx + evy * evy + evz * evz, kTiny);
        u = fminf(fmaxf((hvx * eux + hvy * euy + hvz * euz) / eu2, 0.0f), 1.0f);
        v = fminf(fmaxf((hvx * evx + hvy * evy + hvz * evz) / ev2, 0.0f), 1.0f);
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
      tb_ = (float)((rgba >> 16) & 0xffu) * kInv255;
    }
  }
  const float c_r = p.has_tex ? d_r * tr + s_r : d_r + s_r;
  const float c_g = p.has_tex ? d_g * tg + s_g : d_g + s_g;
  const float c_b = p.has_tex ? d_b * tb_ + s_b : d_b + s_b;

  // --- reflection continuation (Code/raytracer.cpp:307-333).
  const Ray& ray = s.ray;
  const float nx = s.nx, ny = s.ny, nz = s.nz;
  const float ddn = ray.dx * nx + ray.dy * ny + ray.dz * nz;
  float rdx = ray.dx - ddn * 2.0f * nx;
  float rdy = ray.dy - ddn * 2.0f * ny;
  float rdz = ray.dz - ddn * 2.0f * nz;
  if (p.glossy && s.rough > 0.0f) {
    // normalize(R + roughness * unit_ball); rays perturbed below the
    // surface are absorbed (raytracer.cpp:312-327).
    float gx = rdx + s.rough * p.fuzz[0 * R + i];
    float gy = rdy + s.rough * p.fuzz[1 * R + i];
    float gz = rdz + s.rough * p.fuzz[2 * R + i];
    const float gn = sqrtf(gx * gx + gy * gy + gz * gz);
    const float inv_g = 1.0f / fmaxf(gn, kTiny);
    gx = gx * inv_g; gy = gy * inv_g; gz = gz * inv_g;
    const bool below = (gx * nx + gy * ny + gz * nz) < 0.0f;
    rdx = below ? 0.0f : gx;
    rdy = below ? 0.0f : gy;
    rdz = below ? 0.0f : gz;
  }
  const float rd2 = rdx * rdx + rdy * rdy + rdz * rdz;
  float tp2 = s.tp * s.refl;
  bool ok = s.hit && (s.refl > 0.0f) && (rd2 > kEpsGlossyDir2);
  float cox = s.sox, coy = s.soy, coz = s.soz;
  const float trans = (p.refraction && s.hit) ? tb.col(kGeomCols + 12, row) : 0.0f;
  if (trans > 0.0f) {
    // --- refraction continuation (Code/raytracer.cpp:118-150): the outer
    // medium is n = 1 (:121); leaving the object swaps the indices and
    // flips the normal (:126-129); total internal reflection gives a zero
    // direction (:136-139); the direction is renormalized (:149) and the
    // origin offset by -1e-4 along the normal used (:147).  A material
    // that refracts never also reflects (the gate refuses two-way ones).
    const float ior = tb.col(kGeomCols + 13, row);
    const bool exiting = ddn > 0.0f;
    const float eta = (exiting ? ior : 1.0f) / (exiting ? 1.0f : fmaxf(ior, kTiny));
    const float nsg = exiting ? -1.0f : 1.0f;
    const float nex = nsg * nx, ney = nsg * ny, nez = nsg * nz;
    const float cos_abs = fabsf(ddn);
    const float disc = 1.0f - eta * eta * (1.0f - cos_abs * cos_abs);
    const float cos_t = sqrtf(fmaxf(disc, 0.0f));
    const float kk = eta * cos_abs - cos_t;
    const float tx = eta * ray.dx + kk * nex;
    const float ty = eta * ray.dy + kk * ney;
    const float tz = eta * ray.dz + kk * nez;
    const float tn2 = tx * tx + ty * ty + tz * tz;
    const float inv_t = 1.0f / sqrtf(tn2 > 0.0f ? tn2 : 1.0f);
    const bool live_t = (disc >= 0.0f) && (tn2 > kEpsRefractDir2);
    ok = s.hit && live_t;
    tp2 = s.tp * trans;
    // the hit point, recomputed as wave_shade computes it (no register
    // holds it through the texture stage)
    cox = (ray.ox + s.t_fin * ray.dx) - nex * kEpsNormalOffset;
    coy = (ray.oy + s.t_fin * ray.dy) - ney * kEpsNormalOffset;
    coz = (ray.oz + s.t_fin * ray.dz) - nez * kEpsNormalOffset;
    rdx = live_t ? tx * inv_t : 0.0f;
    rdy = live_t ? ty * inv_t : 0.0f;
    rdz = live_t ? tz * inv_t : 0.0f;
  }
  if (p.min_tp > 0.0f) ok = ok && (tp2 > p.min_tp);

  out[0 * R + i] = cox;
  out[1 * R + i] = coy;
  out[2 * R + i] = coz;
  out[3 * R + i] = rdx;
  out[4 * R + i] = rdy;
  out[5 * R + i] = rdz;
  out[6 * R + i] = 0.0f;  // secondary rays carry time 0 (Code/shapes.hpp:28)
  out[7 * R + i] = ok ? 1.0f : 0.0f;
  out[8 * R + i] = ok ? tp2 : 0.0f;
  out[9 * R + i] = c_r;
  out[10 * R + i] = c_g;
  out[11 * R + i] = c_b;
  out[12 * R + i] = s.hit ? 1.0f : 0.0f;
  if (p.rec) {
    if (!s.hit) {
      record_none(p, i);
    } else {
      p.rec[i] = tb.col(kIdCol, row);
      for (int li = 0; li < p.n_lights; ++li) {
        p.rec[(1 + li) * R + i] = light_vis(p, li, blocked.get(li));
      }
      if (p.has_tex) {
        p.rec[(1 + p.n_lights) * R + i] = tr;
        p.rec[(2 + p.n_lights) * R + i] = tg;
        p.rec[(3 + p.n_lights) * R + i] = tb_;
      }
    }
  }
}

// One ray lane of one level, all three stages in one thread: the schedule
// of wave_level_lane_kernel.  tab / lights: the block's copies, the table
// transposed (n_cols, G).
RTT_DEV void wave_lane(const WaveParams& p, const float* tab, const float* lights, size_t i) {
  const size_t R = (size_t)p.R;
  if (!(p.q[7 * R + i] > 0.0f)) {
    wave_dead(p, i);
    return;
  }
  const TabT tb{tab, p.G};
  const WaveShade s = wave_shade(p, tb, i, wave_hit(p, tb, lane_ray(p, i)));
  CountBytes blocked{0};
  if (s.hit) {
    for (int li = 0; li < p.n_lights; ++li) {
      const LightTerm lt = light_term(s, lights, p.n_lights, li);
      if (!shadow_cast(p, lt)) continue;
      for (int k = 0; k < light_rays(p, li); ++k) {
        const ShadowDir sd = shadow_dir(p, s, lt, lights, li, k, i);
        if (wave_blocked(p, tb, s.sox, s.soy, s.soz, sd.dx, sd.dy, sd.dz, sd.maxt)) {
          blocked.v += (uint64_t)1 << (8 * li);
        }
      }
    }
  }
  wave_finish(p, tb, lights, i, s, blocked);
}

// ------------------------------------------------------ the block schedule

// Byte offsets of one block's shared memory: header (mbarrier at 0, the
// per-warp counts of a scan step at 16 and of a queue fill at 80, each
// double-buffered; at 144 the next scan step (double-buffered) or chunk,
// and a list base),
// staged table (TabS; none for a wide table, G = 0 here), lights, the list
// of lanes (list_cap), the chunk's
// meta (kChunk: winner row in bits 0-15, kNoRow for none), the chunk's
// counts of blocked shadow rays (kChunk entries of two words, one byte a
// light: an area light's nss <= 32 rays fit), the queue (two 16-byte words
// a shadow ray: origin and d.x; d.y, d.z, max t, and the chunk entry |
// light << 16), a windowed build's window records (n_win) and, where the
// block stages them, its permuted rows (n_perm of kWinCols floats).
struct WaveLayout {
  size_t xf4, rest, lights, list_lane, list_meta, blocked, queue, win, perm, bytes;
};

RTT_HD WaveLayout wave_layout(int G, int n_cols, int n_lights, int list_cap, int queue_cap,
                              int n_win, int n_perm) {
  WaveLayout o;
  o.xf4 = kSmemHeader;
  o.rest = o.xf4 + 48 * (size_t)G;
  o.lights = o.rest + 4 * (size_t)(n_cols - 12) * G;
  const size_t end_lights = o.lights + 32 * (size_t)(n_lights > 0 ? n_lights : 1);
  o.list_lane = (end_lights + 15) & ~(size_t)15;
  o.list_meta = o.list_lane + 4 * (size_t)list_cap;
  o.blocked = o.list_meta + 4 * (size_t)kChunk;
  o.queue = o.blocked + 8 * (size_t)kChunk;
  o.win = o.queue + 32 * (size_t)queue_cap;
  o.perm = o.win + 4 * (size_t)kWinRec * n_win;
  o.bytes = o.perm + 4 * (size_t)kWinCols * n_perm;
  return o;
}

// The layout of a build at the given capacities: the table staged by the
// staged builds (G rows), window records by the windowed ones (n_win),
// permuted rows by kBuildStagedWindows.
RTT_HD WaveLayout build_layout(int build, int G, int n_cols, int n_lights, int n_win,
                               int list_cap, int queue_cap) {
  return wave_layout(build_stages_table(build) ? G : 0, n_cols, n_lights, list_cap, queue_cap,
                     build_windowed(build) ? n_win : 0, build == kBuildStagedWindows ? G : 0);
}

// A build's layout at the preferred capacities where they fit `limit`
// bytes, else at the least.
RTT_HD WaveLayout build_plan(int build, int G, int n_cols, int n_lights, int n_win, size_t limit,
                             int& list_cap, int& queue_cap) {
  list_cap = kListCap;
  queue_cap = kQueueCap;
  WaveLayout o = build_layout(build, G, n_cols, n_lights, n_win, list_cap, queue_cap);
  if (o.bytes > limit) {
    list_cap = kListCapMin;
    queue_cap = kQueueCapMin;
    o = build_layout(build, G, n_cols, n_lights, n_win, list_cap, queue_cap);
  }
  return o;
}

struct WaveSmem {
  uint64_t* bar;
  int* scan_tot;
  int* queue_tot;
  long long* next;
  F4* xf4;
  float* rest;
  float* lights;
  int* list_lane;
  uint32_t* list_meta;
  uint32_t* blocked;  // entry e: words 2e (lights 0-3) and 2e + 1 (4-7)
  F4* queue;
  float* win;
  float* perm;
};

RTT_DEV WaveSmem wave_smem(unsigned char* base, const WaveLayout& o) {
  WaveSmem s;
  s.bar = reinterpret_cast<uint64_t*>(base);
  s.scan_tot = reinterpret_cast<int*>(base + 16);
  s.queue_tot = reinterpret_cast<int*>(base + 16 + 8 * kWaveWarps);
  s.next = reinterpret_cast<long long*>(base + 16 + 16 * kWaveWarps);
  s.xf4 = reinterpret_cast<F4*>(base + o.xf4);
  s.rest = reinterpret_cast<float*>(base + o.rest);
  s.lights = reinterpret_cast<float*>(base + o.lights);
  s.list_lane = reinterpret_cast<int*>(base + o.list_lane);
  s.list_meta = reinterpret_cast<uint32_t*>(base + o.list_meta);
  s.blocked = reinterpret_cast<uint32_t*>(base + o.blocked);
  s.queue = reinterpret_cast<F4*>(base + o.queue);
  s.win = reinterpret_cast<float*>(base + o.win);
  s.perm = reinterpret_cast<float*>(base + o.perm);
  return s;
}

RTT_DEV int meta_row(uint32_t m) {
  const uint32_t r = m & 0xffffu;
  return r == kNoRow ? -1 : (int)r;
}

// Scan of lanes [base, base + 4) within R: writes the 13 zero rows of each
// dead one (16-byte stores when all four are dead and the rows allow);
// returns the live ones as bits 0..3.
RTT_DEV unsigned scan_group(const WaveParams& p, long long base) {
  const long long R = p.R;
  if (base >= R) return 0;
  if (p.vec4 && base + 4 <= R) {
    const F4 a = load4(p.q + 7 * R + base);
    const unsigned live = (a.x > 0.0f ? 1u : 0u) | (a.y > 0.0f ? 2u : 0u) |
                          (a.z > 0.0f ? 4u : 0u) | (a.w > 0.0f ? 8u : 0u);
    if (live == 0) {
      const F4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int row = 0; row < kOutRows; ++row) store4(p.out + row * R + base, zero);
      if (p.rec) {
        for (int j = 0; j < 4; ++j) record_none(p, (size_t)(base + j));
      }
      return 0;
    }
    for (int j = 0; j < 4; ++j) {
      if (!((live >> j) & 1u)) wave_dead(p, (size_t)(base + j));
    }
    return live;
  }
  unsigned live = 0;
  for (int j = 0; j < 4 && base + j < R; ++j) {
    if (p.q[7 * R + base + j] > 0.0f) live |= 1u << j;
    else wave_dead(p, (size_t)(base + j));
  }
  return live;
}

// Slice j of k of list entry e's closest hit, merged into (t, row).
template <class Tab>
RTT_DEV void hit_entry(const WaveParams& p, const Tab& tb, const WaveSmem& s, int e, int j,
                       int k, float& t, int& row) {
  const size_t i = (size_t)s.list_lane[e];
  if (p.motion) wave_hit_part<true>(p, tb, lane_ray_m<true>(p, i), j, k, t, row);
  else wave_hit_part<false>(p, tb, lane_ray_m<false>(p, i), j, k, t, row);
}

RTT_DEV uint32_t meta_of(int row) { return row < 0 ? kNoRow : (uint32_t)row; }

// List entries e0 and e1 side by side, each over every row.
template <bool MOTION, class Tab>
RTT_DEV void hit_pair_m(const WaveParams& p, const Tab& tb, const WaveSmem& s, int e0, int e1) {
  const Ray a = lane_ray_m<MOTION>(p, (size_t)s.list_lane[e0]);
  const Ray b = lane_ray_m<MOTION>(p, (size_t)s.list_lane[e1]);
  float ta = kInf, tb_ = kInf;
  int rowa = -1, rowb = -1;
  for (int r = 0; r < p.n_ranges; ++r) {
    RTT_KIND_DISPATCH(p, r, closest_t_range2, tb, p.start[r], p.end[r], a, b, ta, rowa, tb_, rowb)
  }
  s.list_meta[e0] = meta_of(rowa);
  s.list_meta[e1] = meta_of(rowb);
}

template <class Tab>
RTT_DEV void hit_pair(const WaveParams& p, const Tab& tb, const WaveSmem& s, int e0, int e1) {
  if (p.motion) hit_pair_m<true>(p, tb, s, e0, e1);
  else hit_pair_m<false>(p, tb, s, e0, e1);
}

// Lanes a chunk takes from a list of n_live over `grid` blocks: kChunk,
// or an equal share when the list is short.
RTT_HD int wave_chunk(long long n_live, int grid) {
  const long long share = (n_live + grid - 1) / grid;
  return (int)(share < kChunk ? (share > 0 ? share : 1) : kChunk);
}

RTT_DEV void queue_put(const WaveSmem& s, int pos, const WaveShade& sh, const ShadowDir& sd,
                       int e, int li) {
  const F4 a = {sh.sox, sh.soy, sh.soz, sd.dx};
  const F4 b = {sd.dy, sd.dz, sd.maxt, u32_as_f32((uint32_t)e | ((uint32_t)li << 16))};
  s.queue[2 * pos] = a;
  s.queue[2 * pos + 1] = b;
}

// Word of entry e's count of light li, and the count's one in it.
RTT_HD int blocked_word(int e, int li) { return 2 * e + (li >> 2); }
RTT_HD uint32_t blocked_one(int li) { return 1u << (8 * (li & 3)); }

// Slice j of `split` of queued shadow ray q: true when blocked there, with
// the ray's list entry and light.
template <class Tab>
RTT_DEV bool queue_blocked(const WaveParams& p, const Tab& tb, const WaveSmem& s, int q,
                           int j, int split, int& e, int& li) {
  const F4 a = s.queue[2 * q], b = s.queue[2 * q + 1];
  const uint32_t tag = f32_as_u32(b.w);
  e = (int)(tag & 0xffffu);
  li = (int)(tag >> 16);
  return wave_blocked(p, tb, a.x, a.y, a.z, a.w, b.x, b.y, b.z, j, split);
}

// Queued shadow ray q as a ray (time 0) and its reach, with its list entry
// and light.
RTT_DEV void queue_ray(const WaveSmem& s, int q, Ray& r, float& maxt, int& e, int& li) {
  const F4 a = s.queue[2 * q], b = s.queue[2 * q + 1];
  const uint32_t tag = f32_as_u32(b.w);
  e = (int)(tag & 0xffffu);
  li = (int)(tag >> 16);
  r = make_ray(a.x, a.y, a.z, a.w, b.x, b.y);
  maxt = b.z;
}

template <class Tab>
RTT_DEV void finish_entry(const WaveParams& p, const Tab& tb, const WaveSmem& s, int e) {
  const size_t i = (size_t)s.list_lane[e];
  wave_finish(p, tb, s.lights, i, wave_shade(p, tb, i, meta_row(s.list_meta[e])),
              CountWords{s.blocked + 2 * e});
}

// Host side: gather one launch's arguments.  ranges: n_ranges triples
// (kind, start, end).  area: bit li for an area light, each casting nss
// shadow rays whose jitter is read from the fuzz rows after the glossy
// ones (3 * nss rows an area light, in light order).  record: out has the
// record rows after row 12.
inline WaveParams make_params(
    const float* q, const float* fuzz, const float* table, const float* lights,
    const uint8_t* tex, const float* twh, float* out,
    long long R, int G, int n_cols, int n_lights,
    const int* ranges, int n_ranges, int glossy, int has_tex,
    int n_tex, int tex_h, int tex_w, float min_tp,
    int motion, int refraction, int area, int nss, int record = 0) {
  WaveParams p;
  p.q = q; p.fuzz = fuzz; p.table = table; p.lights = lights;
  p.xf = nullptr;
  p.tex = tex; p.twh = twh; p.out = out;
  p.rec = record ? out + kOutRows * R : nullptr;
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
  p.vec4 = (R % 4 == 0) && ((uintptr_t)q % 16 == 0) && ((uintptr_t)out % 16 == 0);
  p.motion = motion; p.refraction = refraction;
  p.area = (uint32_t)area;
  p.nss = nss > 0 ? nss : 1;
  p.inv_nss = 1.0f / (float)p.nss;
  int row = glossy ? 3 : 0;
  for (int li = 0; li < kMaxLights; ++li) {
    p.fuzz_row[li] = row;
    if (li < n_lights && ((p.area >> li) & 1u)) row += 3 * p.nss;
  }
  p.xp = nullptr; p.win = nullptr; p.n_win = 0; p.work = nullptr;
  for (int k = 0; k <= kMaxRanges; ++k) p.wbeg[k] = 0;
  return p;
}

}  // namespace rtt

#ifdef __CUDACC__

#include <cuda_runtime.h>
#include <limits.h>

namespace rtt {

// The one-thread-per-lane schedule: every block stages the whole table,
// one thread runs one lane.  The package launches wave_level_blocks_kernel;
// this one stays to be measured against it (chip_smoke.py, phase
// wave_redesign_ab).
__global__ void wave_level_lane_kernel(const WaveParams p) {
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

// ------------------------------------------------ the windowed builds

constexpr unsigned kFullMask = 0xffffffffu;

// The permuted rows a windowed build walks: where the launch left them
// (TabP), or kBuildStagedWindows's copy in the block's shared memory (TabPS).
template <int BUILD> struct WinRows {
  static __device__ __forceinline__ TabP view(const WaveParams& p, const WaveSmem&) {
    return TabP{p.xp};
  }
};
template <> struct WinRows<kBuildStagedWindows> {
  static __device__ __forceinline__ TabPS view(const WaveParams&, const WaveSmem& s) {
    return TabPS{s.perm};
  }
};

// A lane's share of what the counting build counts in one walk.
struct WinCount {
  uint32_t tests, wanted, boxes;
};

__device__ __forceinline__ void win_flush(const WaveParams& p, int at, uint32_t x) {
  const uint32_t sum = __reduce_add_sync(kFullMask, x);
  if ((threadIdx.x & 31) == 0 && sum) atomicAdd(&p.work[at], (unsigned long long)sum);
}

// The hit stage of a windowed build, by a warp, over the windows of ranges
// of kind KIND [w0, w1): each lane box-tests each window against its rays'
// best t so far (box_hit: <=, so a window that can only tie is run), and
// the warp runs the window's rows when some lane wants it; otherwise the
// window cost a box test a ray.  Windows in Morton order, the running
// best; the merge by (t, original row) makes the order free.
template <int BUILD, int KIND, bool MOTION>
__device__ void win_hit_range(const WaveParams& p, const WaveSmem& s, int w0,
                              int w1, const Ray& a, bool va, const Ray& b, bool vb, int j0,
                              int step, float& ta, int& ra, float& tb, int& rb, WinCount& c) {
  for (int w = w0; w < w1; ++w) {
    const float* rec = s.win + kWinRec * w;
    const bool wa = va && box_hit(rec, a, ta, rec[6]);
    const bool wb = vb && box_hit(rec, b, tb, rec[6]);
    if constexpr (BUILD == kBuildWindowsCount) c.boxes += (uint32_t)va + (uint32_t)vb;
    if (!__any_sync(kFullMask, wa || wb)) continue;
    const int ran = win_rows_hit<KIND, MOTION>(WinRows<BUILD>::view(p, s), win_first(rec),
                                               win_count(rec), a, va, b, vb, j0, step, ta, ra,
                                               tb, rb);
    if constexpr (BUILD == kBuildWindowsCount) {
      c.tests += (uint32_t)ran * ((uint32_t)va + (uint32_t)vb);
      c.wanted += (uint32_t)ran * ((uint32_t)wa + (uint32_t)wb);
    }
  }
}

// A warp's hit stage over every range: rays a (va) and b (vb), or ray a's
// slice j0 of `step` of each window's rows.
template <int BUILD, bool MOTION>
__device__ void win_hit(const WaveParams& p, const WaveSmem& s, const Ray& a,
                        bool va, const Ray& b, bool vb, int j0, int step, float& ta, int& ra,
                        float& tb, int& rb) {
  WinCount c = {0, 0, 0};
  for (int r = 0; r < p.n_ranges; ++r) {
    const int w0 = p.wbeg[r], w1 = p.wbeg[r + 1];
    switch (p.kind[r]) {
      case kKindSphere:
        win_hit_range<BUILD, kKindSphere, MOTION>(p, s, w0, w1, a, va, b, vb, j0, step, ta,
                                                  ra, tb, rb, c);
        break;
      case kKindCube:
        win_hit_range<BUILD, kKindCube, false>(p, s, w0, w1, a, va, b, vb, j0, step, ta, ra,
                                               tb, rb, c);
        break;
      case kKindRect:
        win_hit_range<BUILD, kKindRect, false>(p, s, w0, w1, a, va, b, vb, j0, step, ta, ra,
                                               tb, rb, c);
        break;
      default:
        win_hit_range<BUILD, kKindPlane, false>(p, s, w0, w1, a, va, b, vb, j0, step, ta,
                                                ra, tb, rb, c);
        break;
    }
  }
  if constexpr (BUILD == kBuildWindowsCount) {
    win_flush(p, 0, c.tests);
    win_flush(p, 1, c.wanted);
    win_flush(p, 2, c.boxes);
  }
}

// Any-hit over the windows [w0, w1) of a range of kind KIND, in row order:
// a window is skipped unless some open lane enters its box within its
// reach; a blocked lane is done.  False once no lane of the warp is open.
template <int BUILD, int KIND>
__device__ bool win_any_range(const WaveParams& p, const WaveSmem& s, int w0,
                              int w1, const Ray& r, float maxt, bool& open, bool& blocked,
                              int j0, int step, WinCount& c) {
  for (int w = w0; w < w1; ++w) {
    if (!__any_sync(kFullMask, open)) return false;
    const float* rec = s.win + kWinRec * w;
    const bool want = open && box_hit(rec, r, maxt, rec[6]);
    if constexpr (BUILD == kBuildWindowsCount) c.boxes += (uint32_t)open;
    if (!__any_sync(kFullMask, want)) continue;
    bool hit = false;
    const int ran =
        want ? win_any<KIND>(WinRows<BUILD>::view(p, s), win_first(rec), win_count(rec), j0,
                             step, r, maxt, hit)
             : 0;
    if (hit) {
      blocked = true;
      open = false;
    }
    if constexpr (BUILD == kBuildWindowsCount) c.tests += (uint32_t)ran;
  }
  return true;
}

// A warp's shadow rays (one a lane, or lane's slice j0 of `step`): blocked
// iff some geom has t <= maxt; the warp leaves once no lane is open.
template <int BUILD>
__device__ bool win_blocked(const WaveParams& p, const WaveSmem& s, const Ray& r,
                            float maxt, bool open, int j0, int step) {
  WinCount c = {0, 0, 0};
  bool blocked = false, more = true;
  for (int k = 0; k < p.n_ranges && more; ++k) {
    const int w0 = p.wbeg[k], w1 = p.wbeg[k + 1];
    switch (p.kind[k]) {
      case kKindSphere:
        more = win_any_range<BUILD, kKindSphere>(p, s, w0, w1, r, maxt, open, blocked, j0,
                                                 step, c);
        break;
      case kKindCube:
        more = win_any_range<BUILD, kKindCube>(p, s, w0, w1, r, maxt, open, blocked, j0,
                                               step, c);
        break;
      case kKindRect:
        more = win_any_range<BUILD, kKindRect>(p, s, w0, w1, r, maxt, open, blocked, j0,
                                               step, c);
        break;
      default:
        more = win_any_range<BUILD, kKindPlane>(p, s, w0, w1, r, maxt, open, blocked, j0,
                                                step, c);
        break;
    }
  }
  if constexpr (BUILD == kBuildWindowsCount) {
    win_flush(p, 3, c.tests);
    win_flush(p, 4, c.boxes);
  }
  return blocked;
}

// Block-wide, a windowed build's hit stage on the n lanes of the list.  A
// long list: each warp takes 64 neighbouring entries (two a thread, 32
// apart); a list of kWaveThreads or fewer: one entry a thread; a short one
// (split > 1): each entry's rows of every window split over `split`
// neighbouring threads, merged by (t, row).  Every thread takes part in
// its warp's walk.
template <int BUILD, bool MOTION>
__device__ void win_hit_stage(const WaveParams& p, const WaveSmem& s, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = wave_split(n);
  const Ray none = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  float ta = kInf, tb = kInf;
  int ra = -1, rb = -1;
  if (split == 1) {
    const int ea = n > kWaveThreads ? 64 * warp + lane : tid;
    const int eb = n > kWaveThreads ? ea + 32 : n;
    const bool va = ea < n, vb = eb < n;
    const Ray a = va ? lane_ray_m<MOTION>(p, (size_t)s.list_lane[ea]) : none;
    const Ray b = vb ? lane_ray_m<MOTION>(p, (size_t)s.list_lane[eb]) : none;
    win_hit<BUILD, MOTION>(p, s, a, va, b, vb, 0, 1, ta, ra, tb, rb);
    if (va) s.list_meta[ea] = meta_of(ra);
    if (vb) s.list_meta[eb] = meta_of(rb);
    return;
  }
  const bool va = tid < n * split;
  const Ray a = va ? lane_ray_m<MOTION>(p, (size_t)s.list_lane[tid / split]) : none;
  win_hit<BUILD, MOTION>(p, s, a, va, none, false, tid % split, split, ta, ra, tb, rb);
  for (int o = split / 2; o > 0; o >>= 1) {
    merge_hit(ta, ra, __shfl_xor_sync(kFullMask, ta, o), __shfl_xor_sync(kFullMask, ra, o));
  }
  if (va && tid % split == 0) s.list_meta[tid / split] = meta_of(ra);
}

// Block-wide: test the n queued shadow rays on dense warps and count the
// blocked ones of each lane and light.  A windowed build walks the windows
// with a warp's cull; the others run every row of `tb`.
template <int BUILD, class Tab>
__device__ void drain_queue(const WaveParams& p, const Tab& tb, const WaveSmem& s, int n) {
  __syncthreads();  // the queue is complete
  const int split = wave_split(n);
  const int t = threadIdx.x;
  if constexpr (build_windowed(BUILD)) {
    const Ray none = make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
    if (split == 1) {
      // rounds of one ray a thread; every thread of a warp walks together
      for (int base = 0; base < n; base += kWaveThreads) {
        const int q = base + t;
        int e = 0, li = 0;
        Ray r = none;
        float maxt = 0.0f;
        if (q < n) queue_ray(s, q, r, maxt, e, li);
        if (win_blocked<BUILD>(p, s, r, maxt, q < n, 0, 1)) {
          atomicAdd(&s.blocked[blocked_word(e, li)], blocked_one(li));
        }
      }
    } else {
      int e = 0, li = 0;
      Ray r = none;
      float maxt = 0.0f;
      const bool mine = t < n * split;
      if (mine) queue_ray(s, t / split, r, maxt, e, li);
      unsigned blocked = win_blocked<BUILD>(p, s, r, maxt, mine, t % split, split);
      for (int o = split / 2; o > 0; o >>= 1) blocked |= __shfl_xor_sync(kFullMask, blocked, o);
      if (mine && t % split == 0 && blocked) {
        atomicAdd(&s.blocked[blocked_word(e, li)], blocked_one(li));
      }
    }
  } else if (split == 1) {
    for (int q = t; q < n; q += kWaveThreads) {
      int e, li;
      if (queue_blocked(p, tb, s, q, 0, 1, e, li)) {
        atomicAdd(&s.blocked[blocked_word(e, li)], blocked_one(li));
      }
    }
  } else {
    // n * split <= kWaveThreads: one pass; the `split` lanes of a ray are
    // neighbours in one warp, and every lane takes part in the OR.
    int e = 0, li = 0;
    unsigned blocked = 0;
    if (t < n * split) blocked = queue_blocked(p, tb, s, t / split, t % split, split, e, li);
    for (int o = split / 2; o > 0; o >>= 1) blocked |= __shfl_xor_sync(0xffffffffu, blocked, o);
    if (t < n * split && t % split == 0 && blocked) {
      atomicAdd(&s.blocked[blocked_word(e, li)], blocked_one(li));
    }
  }
  __syncthreads();  // the counts are in; the queue is free
}

// Block-wide: the three stages on the n lanes of the list.
template <int BUILD, class Tab>
__device__ void run_list(const WaveParams& p, const Tab& tb, const WaveSmem& s, int n,
                         int queue_cap) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the list is complete
  for (int k = tid; k < 2 * n; k += kWaveThreads) s.blocked[k] = 0u;
  const int split = wave_split(n);
  if constexpr (build_windowed(BUILD)) {
    if (p.motion) win_hit_stage<BUILD, true>(p, s, n);
    else win_hit_stage<BUILD, false>(p, s, n);
  } else if (split == 1) {
    // n <= kChunk = 2 * kWaveThreads: entries tid and tid + kWaveThreads
    if (tid + kWaveThreads < n) {
      hit_pair(p, tb, s, tid, tid + kWaveThreads);
    } else if (tid < n) {
      float best_t = kInf;
      int row = -1;
      hit_entry(p, tb, s, tid, 0, 1, best_t, row);
      s.list_meta[tid] = meta_of(row);
    }
  } else {
    // As in drain_queue: one pass, every lane in the merge.
    float best_t = kInf;
    int row = -1;
    if (tid < n * split) hit_entry(p, tb, s, tid / split, tid % split, split, best_t, row);
    for (int o = split / 2; o > 0; o >>= 1) {
      merge_hit(best_t, row, __shfl_xor_sync(0xffffffffu, best_t, o),
                __shfl_xor_sync(0xffffffffu, row, o));
    }
    if (tid < n * split && tid % split == 0) s.list_meta[tid / split] = meta_of(row);
  }
  __syncthreads();
  // Shadow rays, T entries at a time, lights in order, an area light's
  // rays in sample order; the queue is drained whenever it could not take
  // one more ray from every thread.
  int qn = 0, fill = 0;
  for (int seg = 0; seg < n; seg += kWaveThreads) {
    const int e = seg + tid;
    const int row = e < n ? meta_row(s.list_meta[e]) : -1;
    WaveShade sh{};
    if (row >= 0) sh = wave_shade(p, tb, (size_t)s.list_lane[e], row);
    for (int li = 0; li < p.n_lights; ++li) {
      for (int k = 0; k < light_rays(p, li); ++k) {
        if (qn + kWaveThreads > queue_cap) {
          drain_queue<BUILD>(p, tb, s, qn);
          qn = 0;
        }
        // The light's term again for each of an area light's rays: nothing
        // of it is live across a drain (the any-hit loops), which would
        // spill at the block's 80 registers.
        LightTerm lt{};
        if (row >= 0) lt = light_term(sh, s.lights, p.n_lights, li);
        const bool need = row >= 0 && shadow_cast(p, lt);
        const unsigned ball = __ballot_sync(0xffffffffu, need);
        int* tot = s.queue_tot + (fill & 1) * kWaveWarps;
        if (lane == 0) tot[warp] = __popc(ball);
        __syncthreads();
        int before = 0, total = 0;
        for (int w = 0; w < kWaveWarps; ++w) {
          const int x = tot[w];
          before += (w < warp) ? x : 0;
          total += x;
        }
        if (need) {
          queue_put(s, qn + before + __popc(ball & ((1u << lane) - 1u)), sh,
                    shadow_dir(p, sh, lt, s.lights, li, k, (size_t)s.list_lane[e]), e, li);
        }
        qn += total;
        ++fill;
      }
    }
  }
  if (qn > 0) drain_queue<BUILD>(p, tb, s, qn);
  for (int e = tid; e < n; e += kWaveThreads) finish_entry(p, tb, s, e);
  __syncthreads();  // the list is free
}

// Block-wide: append the n staged lanes to the launch's list.
__device__ void flush_list(const WaveSmem& s, int n, int* listed, int* live) {
  if (threadIdx.x == 0) s.next[2] = atomicAdd(listed, n);
  __syncthreads();
  const long long base = s.next[2];
  for (int k = threadIdx.x; k < n; k += kWaveThreads) live[base + k] = s.list_lane[k];
  __syncthreads();  // the staging list is free
}

// ctr: five ints, zero at launch; the last block to leave zeroes them
// again: [0] next scan step, [1] lanes listed, [2] blocks past the scan,
// [3] next chunk, [4] blocks done.  live: R ints, the launch's list of live
// lanes.  Launched cooperatively: every block is resident, so the grid
// barrier between the two phases cannot wait on a block that never runs.
//
// The builds (kBuild*), one schedule.  Where the table, its window records
// and its permuted rows fit a block's shared memory beside the rest
// (kernels/wavefront.py::wave_cap_geoms), each block stages all three
// (kBuildStagedWindows, the package's build): columns 12.. and the
// permuted rows by bulk asynchronous copies on one mbarrier, the
// transforms and the window records by the threads.  Over that cap, up to
// the gate's WAVE_MAX_GEOMS, the table stays in global memory and a block
// stages the lights, its list, a chunk's meta and counts, the shadow queue
// and the window records (kBuildWindows; 28 bytes of box and graze a
// window, 6.3 KB at the most).  In both the hit stage and the shadow queue
// walk the windows with a per-warp box cull (win_hit_stage, drain_queue);
// the shading and finish stages read the table in its own row order (TabS
// staged, TabT where it lies).  Staged: the staged table, every lane
// testing every row, the reference the culled builds are held to.
// Unculled: the same over a wide table in global memory (TabW).
// Every lane's arithmetic is the same in all: the cull drops only rows
// whose hit is provably farther than the bound (box_hit's slack), and the
// winner merges by (t, original row).
template <int BUILD> struct WaveTab {
  typedef TabT type;
  static RTT_DEV TabT view(const WaveParams& p, const WaveSmem&) { return TabT{p.table, p.G}; }
};
template <> struct WaveTab<kBuildStaged> {
  typedef TabS type;
  static RTT_DEV TabS view(const WaveParams& p, const WaveSmem& s) { return TabS{s.xf4, s.rest, p.G}; }
};
template <> struct WaveTab<kBuildStagedWindows> : WaveTab<kBuildStaged> {};
template <> struct WaveTab<kBuildUnculled> {
  typedef TabW type;
  static RTT_DEV TabW view(const WaveParams& p, const WaveSmem&) {
    return TabW{p.xf, TabT{p.table, p.G}};
  }
};

template <int BUILD>
__global__ void __launch_bounds__(kWaveThreads, 3)
wave_level_blocks_kernel(const WaveParams p, int list_cap, int queue_cap, int* ctr, int* live) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WaveLayout lay = build_layout(BUILD, p.G, p.n_cols, p.n_lights, p.n_win, list_cap,
                                      queue_cap);
  const WaveSmem s = wave_smem(smem_raw, lay);
  const typename WaveTab<BUILD>::type tb = WaveTab<BUILD>::view(p, s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Stage the tables once.  Columns 12.. (their 16-byte multiple) and, for
  // kBuildStagedWindows, the permuted rows by bulk asynchronous copies on
  // one mbarrier; meanwhile the threads lay out the transforms, copy the
  // tail, the lights and the window records, and scan.  A wide table
  // stages the lights alone, and the windowed build its window records.
  const uint32_t bar = smem_u32(s.bar);
  if (tid == 0) {
    if constexpr (build_stages_table(BUILD)) mbar_init(bar);
    s.next[0] = atomicAdd(&ctr[0], 1);
  }
  __syncthreads();
  if constexpr (build_stages_table(BUILD)) {
    const int n_rest = (p.n_cols - 12) * p.G;
    const uint32_t bulk = (uint32_t)(4 * n_rest) & ~15u;
    if (tid == 0) {
      const uint32_t rows = BUILD == kBuildStagedWindows ? 4u * kWinCols * (uint32_t)p.G : 0u;
      mbar_expect(bar, bulk + rows);
      bulk_load(smem_u32(s.rest), p.table + 12 * (size_t)p.G, bulk, bar);
      if constexpr (BUILD == kBuildStagedWindows) bulk_load(smem_u32(s.perm), p.xp, rows, bar);
    }
    for (int k = tid; k < 3 * p.G; k += kWaveThreads) s.xf4[k] = staged_xf(p.table, p.G, k);
    for (int k = (int)(bulk / 4) + tid; k < n_rest; k += kWaveThreads) {
      s.rest[k] = p.table[12 * (size_t)p.G + k];
    }
  }
  if constexpr (build_windowed(BUILD)) {
    for (int k = tid; k < kWinRec * p.n_win; k += kWaveThreads) s.win[k] = p.win[k];
  }
  for (int k = tid; k < 8 * p.n_lights; k += kWaveThreads) s.lights[k] = p.lights[k];

  // Phase 1, scan.  Steps are taken one at a time from a counter; dead
  // lanes are written here, live ones staged and flushed to `live`.
  int n_list = 0;  // the same in every thread
  const long long n_steps = (p.R + kScanLanes - 1) / kScanLanes;
  for (int step = 0;; ++step) {
    const long long c = s.next[step & 1];
    if (c >= n_steps) break;
    const long long base = c * kScanLanes + 4 * tid;
    const unsigned live4 = scan_group(p, base);
    const int cnt = __popc(live4);
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int* tot = s.scan_tot + (step & 1) * kWaveWarps;
    if (lane == 31) tot[warp] = incl;
    if (tid == 0) s.next[(step + 1) & 1] = atomicAdd(&ctr[0], 1);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWaveWarps; ++w) {
      const int x = tot[w];
      before += (w < warp) ? x : 0;
      total += x;
    }
    if (n_list + total > list_cap) {
      flush_list(s, n_list, &ctr[1], live);
      n_list = 0;
    }
    int pos = n_list + before + incl - cnt;
    for (int j = 0; j < 4; ++j) {
      if ((live4 >> j) & 1u) s.list_lane[pos++] = (int)(base + j);
    }
    n_list += total;
  }
  __syncthreads();
  if (n_list > 0) flush_list(s, n_list, &ctr[1], live);

  // Phase 2: every block takes chunks of the whole launch's list, so that
  // lanes clustered in a few scan steps spread over the card.
  grid_barrier(&ctr[2]);  // also: the window records are in
  const long long n_live = *reinterpret_cast<volatile int*>(&ctr[1]);
  if constexpr (build_stages_table(BUILD)) mbar_wait(bar, 0);  // the bulk copies have landed
  const int chunk = wave_chunk(n_live, (int)gridDim.x);
  for (;;) {
    if (tid == 0) s.next[0] = atomicAdd(&ctr[3], 1);
    __syncthreads();
    const long long first = s.next[0] * chunk;
    if (first >= n_live) break;
    const int n = (int)(n_live - first < chunk ? n_live - first : chunk);
    for (int k = tid; k < n; k += kWaveThreads) s.list_lane[k] = live[first + k];
    run_list<BUILD>(p, tb, s, n, queue_cap);
  }
  if (tid == 0) {
    __threadfence();  // this block's last take comes before its count
    if (atomicAdd(&ctr[4], 1) == (int)gridDim.x - 1) {
      for (int k = 0; k < 4; ++k) atomicExch(&ctr[k], 0);
      atomicExch(&ctr[4], 0);
    }
  }
}

// The kernel of a build.
inline const void* wave_blocks_fn(int build) {
  switch (build) {
    case kBuildStaged: return (const void*)wave_level_blocks_kernel<kBuildStaged>;
    case kBuildUnculled: return (const void*)wave_level_blocks_kernel<kBuildUnculled>;
    case kBuildWindows: return (const void*)wave_level_blocks_kernel<kBuildWindows>;
    case kBuildWindowsCount: return (const void*)wave_level_blocks_kernel<kBuildWindowsCount>;
    default: return (const void*)wave_level_blocks_kernel<kBuildStagedWindows>;
  }
}

// The kernel's shared memory plan for this table and build on the current
// device, its dynamic shared memory attribute set: capacities, bytes,
// resident blocks per SM and the SM count.  0 or a CUDA error.  A winner
// row must fit the 16 bits of a chunk's meta (kNoRow).
inline int wave_blocks_plan(int G, int n_cols, int n_lights, int build, int n_win,
                            int& list_cap, int& queue_cap, size_t& bytes, int& per_sm,
                            int& sms) {
  if (build < kBuildStaged || build > kBuildStagedWindows) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  bytes = build_plan(build, G, n_cols, n_lights, n_win, (size_t)optin, list_cap, queue_cap).bytes;
  if (bytes > (size_t)optin || G >= (int)kNoRow) return (int)cudaErrorInvalidValue;
  const void* fn = wave_blocks_fn(build);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWaveThreads, bytes);
  }
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  return (int)e;
}

}  // namespace rtt

// Plain C interface (loaded with ctypes).  The launchers start one level on
// `stream` without synchronizing and return cudaGetLastError() (0 =
// launched).

// The package's level: persistent blocks (wave_level_blocks_kernel),
// launched cooperatively.  record: 1 for record mode (out then holds the
// record rows after row 12).  build: kBuild*, with its operands, each
// 16-byte aligned: the unculled build's xf, the (G, 12) geom-major
// transforms; a windowed build's xp (G, kWinCols) permuted rows, win
// (n_win, kWinRec) window records and wbeg (n_ranges + 1 ints: range r's
// windows [wbeg[r], wbeg[r + 1]), from 0 to n_win); the counting build's
// work (kWinWork counters it adds to).  ctr: five ints of device memory,
// zero, that no other launch uses meanwhile (the kernel leaves them zero);
// live: R ints of scratch.
extern "C" int wave_level_launch(
    const float* q, const float* fuzz, const float* table, const float* lights,
    const uint8_t* tex, const float* twh, float* out,
    long long R, int G, int n_cols, int n_lights,
    const int* ranges, int n_ranges, int glossy, int has_tex,
    int n_tex, int tex_h, int tex_w, float min_tp,
    int motion, int refraction, int area, int nss, int record, int build, const float* xf,
    const float* xp, const float* win, const int* wbeg, int n_win, unsigned long long* work,
    int* ctr, int* live, void* stream) {
  const auto al16 = [](const void* a) { return (uintptr_t)a % 16 == 0; };
  if (n_ranges > rtt::kMaxRanges || R < 0 || R > INT_MAX || n_lights > rtt::kMaxLights ||
      n_cols < 12 || !al16(table) || nss < 1 || nss > 255) {
    return (int)cudaErrorInvalidValue;
  }
  const bool windowed = rtt::build_windowed(build);
  if ((build == rtt::kBuildUnculled) != (xf != nullptr) || !al16(xf) ||
      windowed != (xp != nullptr) || windowed != (win != nullptr) || !al16(xp) || !al16(win) ||
      (build == rtt::kBuildWindowsCount) != (work != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (windowed) {
    if (wbeg == nullptr || n_win < n_ranges || n_win > rtt::kMaxWindows || wbeg[0] != 0 ||
        wbeg[n_ranges] != n_win) {
      return (int)cudaErrorInvalidValue;
    }
    for (int k = 0; k < n_ranges; ++k) {
      if (wbeg[k + 1] <= wbeg[k]) return (int)cudaErrorInvalidValue;
    }
  }
  if (R == 0) return 0;
  int list_cap, queue_cap, per_sm, sms;
  size_t bytes;
  const int err = rtt::wave_blocks_plan(G, n_cols, n_lights, build, n_win, list_cap, queue_cap,
                                        bytes, per_sm, sms);
  if (err) return err;
  rtt::WaveParams p = rtt::make_params(
      q, fuzz, table, lights, tex, twh, out, R, G, n_cols, n_lights, ranges,
      n_ranges, glossy, has_tex, n_tex, tex_h, tex_w, min_tp, motion, refraction, area, nss,
      record);
  p.xf = xf;
  if (windowed) {
    p.xp = xp;
    p.win = win;
    p.n_win = n_win;
    for (int k = 0; k <= n_ranges; ++k) p.wbeg[k] = wbeg[k];
    p.work = work;
  }
  void* args[] = {&p, &list_cap, &queue_cap, &ctr, &live};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      rtt::wave_blocks_fn(build), dim3((unsigned)(per_sm * sms)),
      dim3(rtt::kWaveThreads), args, bytes, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// What wave_level_launch would launch for this table and build (n_win: a
// windowed build's windows): out[0..5] = list capacity, queue capacity,
// shared memory bytes, resident blocks per SM, SMs, threads per block.
extern "C" int wave_level_plan(int G, int n_cols, int n_lights, int build, int n_win, int* out) {
  int list_cap = 0, queue_cap = 0, per_sm = 0, sms = 0;
  size_t bytes = 0;
  const int err = rtt::wave_blocks_plan(G, n_cols, n_lights, build, n_win, list_cap, queue_cap,
                                        bytes, per_sm, sms);
  out[0] = list_cap; out[1] = queue_cap; out[2] = (int)bytes;
  out[3] = per_sm; out[4] = sms; out[5] = rtt::kWaveThreads;
  return err;
}

// The one-thread-per-lane schedule (wave_level_lane_kernel), for the
// measurement that compares the two; the package never calls it.
extern "C" int wave_level_lane_launch(
    const float* q, const float* fuzz, const float* table, const float* lights,
    const uint8_t* tex, const float* twh, float* out,
    long long R, int G, int n_cols, int n_lights,
    const int* ranges, int n_ranges, int glossy, int has_tex,
    int n_tex, int tex_h, int tex_w, float min_tp,
    int motion, int refraction, int area, int nss, int threads, void* stream) {
  if (n_ranges > rtt::kMaxRanges || R < 0 || n_lights > rtt::kMaxLights || nss < 1 ||
      nss > 255) {
    return (int)cudaErrorInvalidValue;
  }
  if (R == 0) return 0;
  const rtt::WaveParams p = rtt::make_params(
      q, fuzz, table, lights, tex, twh, out, R, G, n_cols, n_lights, ranges,
      n_ranges, glossy, has_tex, n_tex, tex_h, tex_w, min_tp, motion, refraction, area, nss);
  const size_t smem = sizeof(float) * ((size_t)n_cols * G + 8 * (size_t)n_lights);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rtt::wave_level_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (R + threads - 1) / threads;
  rtt::wave_level_lane_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* wave_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // __CUDACC__
