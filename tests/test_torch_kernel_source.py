"""The arithmetic of csrc/wavefront.cu, csrc/closest_hit.cu, csrc/sweep.cuh
(chunk_stream.cu and the chunked brute kernel) and csrc/bvh_traverse.cu,
checked without a GPU.

The CUDA sources keep their per-lane functions (`rtt::wave_lane` and the
stages it composes, `rtt::closest_lane`, `rtt::occlusion_lane`,
`rtt::sweep_lane`, `rtt::bvh_lane`) free of CUDA constructs, so a host C++
compiler builds them.  Here g++ compiles each behind a short loop over
lanes, with FMA contraction off as in the nvcc build, and every level of a
trace goes through it and through `wave_level_plain` on the same rays and
fuzz rows; the fused level's block schedule also runs from the same stage
functions behind a host loop (HOST_BLOCKS: every build, the windowed ones'
warps of 32 threads in a loop), and so do the warp schedule of
the chunk sweeps (WARP_HOST: scan, live-lane list, warps of 32 lanes run in a
loop, nearest chunk first) and that of the shadow any-hit (SHADOW_HOST: the
12-column table staged by a block's threads, scan, list, warps of 32).  This
holds the two
sources to the same arithmetic (the closest-hit and any-hit lane functions
likewise go through seeded rays beside `brute_closest_plain`,
`brute_closest_n_plain` and `occlusion_plain`, and the chunk sweep and the
BVH traversal beside the plain row-order sweeps of kernels/chunk_stream.py
and kernels/bvh_traverse.py); it says nothing of the launch, the
shared-memory copy or the device's math library, which chip_smoke.py
checks on the card.

Tolerance: decision rows (act, act_hit) equal; float rows rtol 2e-5,
atol 1e-5.  On the card the two are bit-equal; here torch's vectorized CPU
sqrt and exp/log differ from libm's in the last bit, and an origin of
magnitude ~10 carried over 11 levels shows that as a few 1e-6.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ray_tracying_tpu_torch as rt
from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
from ray_tracying_tpu_torch.kernels import closest_hit as CH
from ray_tracying_tpu_torch.kernels import wavefront as W
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.render.pipeline import tile_rays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ray_tracying_tpu_torch", "csrc")
RTOL, ATOL = 2e-5, 1e-5

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs g++ to compile the lane function"
)

HOST_LOOP = """
#include "wavefront.cu"
extern "C" void wave_level_host(
    const float* q, const float* fuzz, const float* table, const float* lights,
    const uint8_t* tex, const float* twh, float* out,
    long long R, int G, int n_cols, int n_lights,
    const int* ranges, int n_ranges, int glossy, int has_tex,
    int n_tex, int tex_h, int tex_w, float min_tp,
    int motion, int refraction, int area, int nss) {
  const rtt::WaveParams p = rtt::make_params(
      q, fuzz, table, lights, tex, twh, out, R, G, n_cols, n_lights, ranges,
      n_ranges, glossy, has_tex, n_tex, tex_h, tex_w, min_tp, motion, refraction, area, nss);
  for (long long i = 0; i < R; ++i) rtt::wave_lane(p, table, lights, (size_t)i);
}
"""


@pytest.fixture(scope="module")
def host_level(tmp_path_factory):
    """`wave_level`'s signature over the g++ build of the lane function."""
    d = tmp_path_factory.mktemp("wave_host")
    src, out = str(d / "wave_host.cpp"), str(d / "libwave_host.so")
    with open(src, "w") as f:
        f.write(HOST_LOOP)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wave_level_host.argtypes = [
        p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i,
        ctypes.POINTER(ctypes.c_int), i, i, i, i, i, i, ctypes.c_float, i, i, i, i,
    ]
    lib.wave_level_host.restype = None

    def level(out_prev, fuzz, tables, min_tp=0.0):
        r = out_prev.shape[1]
        n_cols, g = tables.table.shape
        out = torch.empty((W.OUT_ROWS, r), dtype=torch.float32)
        lib.wave_level_host(
            out_prev.data_ptr(), *host_operands(fuzz, tables), out.data_ptr(), r, g,
            n_cols, tables.n_lights, *host_flags(tables, min_tp),
        )
        return out

    return level


def host_operands(fuzz, tables):
    """(fuzz, table, lights, tex, twh) pointers of a level's operands."""
    if tables.has_tex:
        tex, twh = tables.tex.data_ptr(), tables.twh.data_ptr()
    else:
        tex = twh = None
    return (fuzz.data_ptr() if W.fuzz_rows(tables) else None, tables.table.data_ptr(),
            tables.lights.data_ptr(), tex, twh)


def host_flags(tables, min_tp):
    """The level's arguments after n_lights: ranges ... nss."""
    flat = [x for rng in tables.ranges for x in rng]
    ranges = (ctypes.c_int * 12)(*(flat + [0] * (12 - len(flat))))
    n_tex, th, tw = tables.tex.shape[:3] if tables.has_tex else (0, 0, 0)
    area = sum(1 << li for li, a in enumerate(tables.area) if a)
    return (ranges, len(tables.ranges), int(tables.glossy), int(tables.has_tex),
            n_tex, th, tw, float(min_tp), int(tables.motion), int(tables.refraction),
            area, tables.nss)


# Light samples of the scenes with an area light (softshadow l4; cornell's
# light has a radius too).
LIGHT_SAMPLES = {"scenes/softshadow.json": 4, "cornell": 4}


def load_case(path):
    if path == "cornell":
        from ray_tracying_tpu_torch import models

        return models.get("cornell", res=(48, 48), device="cpu")
    scene = rt.load_scene(
        os.path.join(REPO, path), device="cpu",
        textures_dir=os.path.join(REPO, "golden", "Textures"),
    )
    return scene


def scene_and_rays(path, rows, spp_sqrt, seed):
    """(scene, o, d, tm, trace keywords: the glossy fuzz and area-light
    jitter of 11 levels and the light samples) of `rows` rows two thirds
    down the image."""
    scene = load_case(path)
    gen = torch.Generator().manual_seed(seed)
    w, h = scene.camera.resolution
    o, d, tm = tile_rays(scene.camera, (2 * h) // 3, rows, w, spp_sqrt, generator=gen)
    n = o.shape[0]
    ls = LIGHT_SAMPLES.get(path, 1)
    fuzz = [uniform_in_unit_sphere(gen, (n,), device="cpu").T.contiguous()
            for _ in range(11)]
    jitter = [[uniform_in_unit_sphere(gen, (n, ls), device="cpu") if a else None
               for a in scene.lights.is_area] for _ in range(11)]
    return scene, o, d, tm, dict(fuzz=fuzz, light_jitter=jitter, light_samples=ls)


def n_levels(scene):
    """11 levels for a scene that spawns continuations, else 1."""
    return 11 if (scene.has_reflection or scene.has_refraction) else 1


def assert_same(host, plain):
    host, plain = host.numpy(), plain.numpy()
    np.testing.assert_array_equal(host[7], plain[7])
    np.testing.assert_array_equal(host[12], plain[12])
    np.testing.assert_allclose(host, plain, rtol=RTOL, atol=ATOL)


# Cubes + rect, textured: glossy (the flagship's specialisation) and the
# flagship itself; spheres + rect: glossy and mirror; every kind with glass
# and a plane (det_basic), moving spheres (motion), an area light
# (softshadow, 4 samples), planes + glass + mirror + area light (cornell),
# a textured sphere (texture: spherical UV).
WAVE_CASES = [
    ("scenes/bvh_glossy.json", 3, 2),
    ("golden/ASCII/scene.json", 1, 1),
    ("scenes/glossy.json", 3, 2),
    ("scenes/det_mirrors.json", 3, 2),
    ("scenes/det_basic.json", 3, 2),
    ("scenes/motion.json", 3, 2),
    ("scenes/softshadow.json", 2, 2),
    ("cornell", 3, 2),
    ("scenes/texture.json", 3, 2),
]


@pytest.mark.parametrize("path,rows,spp_sqrt", WAVE_CASES)
def test_lane_function_equals_plain_on_every_level(host_level, path, rows, spp_sqrt):
    scene, o, d, tm, draws = scene_and_rays(path, rows, spp_sqrt, seed=0)
    common = dict(draws, device="cpu", return_levels=True)
    _, plain = trace_wavefront(scene, o, d, tm, level_fn=W.wave_level_plain, **common)
    _, host = trace_wavefront(scene, o, d, tm, level_fn=host_level, **common)
    assert len(host) == len(plain) == n_levels(scene)
    if len(plain) > 1:
        assert int((plain[0][7] > 0).sum()) > 0  # some rays go on past level 0
    for a, b in zip(host, plain):
        assert_same(a, b)


def test_lane_function_mixed_mask(host_level):
    """Dead and live lanes side by side: a dead lane is all zeros."""
    scene, o, d, tm, draws = scene_and_rays("scenes/bvh_glossy.json", 2, 1, seed=1)
    fuzz = draws["fuzz"]
    tables = W.wave_tables(scene)
    n = o.shape[0]
    act = torch.from_numpy(
        (np.random.default_rng(2).random(n) < 0.5).astype(np.float32)
    )
    boot = torch.cat([o.T, d.T, tm[None], act[None], torch.ones((1, n))]).contiguous()
    a = host_level(boot, fuzz[0], tables)
    b = W.wave_level_plain(boot, fuzz[0], tables)
    assert_same(a, b)
    assert not a[:, act <= 0].any()
    assert a[:, act > 0].any()


# ---------------------------------------------------------------------------
# The block schedule of csrc/wavefront.cu (wave_level_blocks_kernel), run
# sequentially on the host from the same stage functions: scan steps of
# kScanLanes lanes taken by the blocks in turn, dead lanes written at the
# scan (16-byte stores where the rows allow), live lanes staged in each
# block's list at its real capacity and flushed to the launch's list, then
# that list in chunks: the hit stage (split over threads for a short
# chunk), the shadow queue drained in rounds as it fills, the visibility
# bits, the finish stage.  Threads of a block run one after another, in
# thread order, which is the order the kernel's prefix sums give the list
# and the queue.
# ---------------------------------------------------------------------------

HOST_BLOCKS = """
#include "wavefront.cu"
#include <algorithm>
#include <vector>

namespace {
struct Counts { long long lists, drains, queued, max_queue; };

// The windowed builds' warp walks (csrc/wavefront.cu: win_hit_range,
// win_any_range), one warp's 32 threads in a loop: every thread box-tests
// each window against its rays' bounds, the warp runs the window when some
// thread wants it, reading its rows where the build has them (the launch's
// permuted rows, or the block's staged copy).  work: the counting build's
// counters.
struct HitThread { rtt::Ray a, b; bool va, vb; int j0, step; float ta, tb; int ra, rb; };
struct AnyThread { rtt::Ray r; float maxt; bool open, blocked; int j0, step; };

struct WinCtx {
  const rtt::WaveParams& p;
  const float* win;
  long long* work;
  const float* perm;  // the permuted rows the build reads
  bool staged;        // through TabPS (a block's copy), else TabP
};

template <int KIND, bool MOTION>
int rows_hit(WinCtx& x, int first, int count, HitThread& t) {
  if (x.staged) {
    return rtt::win_rows_hit<KIND, MOTION>(rtt::TabPS{x.perm}, first, count, t.a, t.va, t.b, t.vb,
                                           t.j0, t.step, t.ta, t.ra, t.tb, t.rb);
  }
  return rtt::win_rows_hit<KIND, MOTION>(rtt::TabP{x.perm}, first, count, t.a, t.va, t.b, t.vb,
                                         t.j0, t.step, t.ta, t.ra, t.tb, t.rb);
}

template <int KIND>
int rows_any(WinCtx& x, int first, int count, AnyThread& t, bool& hit) {
  if (x.staged) {
    return rtt::win_any<KIND>(rtt::TabPS{x.perm}, first, count, t.j0, t.step, t.r, t.maxt, hit);
  }
  return rtt::win_any<KIND>(rtt::TabP{x.perm}, first, count, t.j0, t.step, t.r, t.maxt, hit);
}

template <int KIND, bool MOTION>
void hit_range(WinCtx& x, int w0, int w1, HitThread* th) {
  for (int w = w0; w < w1; ++w) {
    const float* rec = x.win + rtt::kWinRec * w;
    bool wa[32], wb[32], any = false;
    for (int l = 0; l < 32; ++l) {
      wa[l] = th[l].va && rtt::box_hit(rec, th[l].a, th[l].ta, rec[6]);
      wb[l] = th[l].vb && rtt::box_hit(rec, th[l].b, th[l].tb, rec[6]);
      any = any || wa[l] || wb[l];
      x.work[2] += th[l].va + th[l].vb;
    }
    if (!any) continue;
    const int first = rtt::win_first(rec), count = rtt::win_count(rec);
    for (int l = 0; l < 32; ++l) {
      HitThread& t = th[l];
      const int ran = rows_hit<KIND, MOTION>(x, first, count, t);
      x.work[0] += (long long)ran * (t.va + t.vb);
      x.work[1] += (long long)ran * (wa[l] + wb[l]);
    }
  }
}

template <bool MOTION>
void hit_warp(WinCtx& x, HitThread* th) {
  const rtt::WaveParams& p = x.p;
  for (int r = 0; r < p.n_ranges; ++r) {
    const int w0 = p.wbeg[r], w1 = p.wbeg[r + 1];
    switch (p.kind[r]) {
      case rtt::kKindSphere: hit_range<rtt::kKindSphere, MOTION>(x, w0, w1, th); break;
      case rtt::kKindCube: hit_range<rtt::kKindCube, false>(x, w0, w1, th); break;
      case rtt::kKindRect: hit_range<rtt::kKindRect, false>(x, w0, w1, th); break;
      default: hit_range<rtt::kKindPlane, false>(x, w0, w1, th); break;
    }
  }
}

template <int KIND>
bool any_range(WinCtx& x, int w0, int w1, AnyThread* th) {
  for (int w = w0; w < w1; ++w) {
    bool open = false, want[32], any = false;
    for (int l = 0; l < 32; ++l) open = open || th[l].open;
    if (!open) return false;
    const float* rec = x.win + rtt::kWinRec * w;
    for (int l = 0; l < 32; ++l) {
      want[l] = th[l].open && rtt::box_hit(rec, th[l].r, th[l].maxt, rec[6]);
      any = any || want[l];
      x.work[4] += th[l].open;
    }
    if (!any) continue;
    const int first = rtt::win_first(rec), count = rtt::win_count(rec);
    for (int l = 0; l < 32; ++l) {
      if (!want[l]) continue;
      AnyThread& t = th[l];
      bool hit = false;
      x.work[3] += rows_any<KIND>(x, first, count, t, hit);
      if (hit) { t.blocked = true; t.open = false; }
    }
  }
  return true;
}

void any_warp(WinCtx& x, AnyThread* th) {
  const rtt::WaveParams& p = x.p;
  bool more = true;
  for (int k = 0; k < p.n_ranges && more; ++k) {
    const int w0 = p.wbeg[k], w1 = p.wbeg[k + 1];
    switch (p.kind[k]) {
      case rtt::kKindSphere: more = any_range<rtt::kKindSphere>(x, w0, w1, th); break;
      case rtt::kKindCube: more = any_range<rtt::kKindCube>(x, w0, w1, th); break;
      case rtt::kKindRect: more = any_range<rtt::kKindRect>(x, w0, w1, th); break;
      default: more = any_range<rtt::kKindPlane>(x, w0, w1, th); break;
    }
  }
}

// The windowed hit stage (win_hit_stage): a long list gives each warp 64
// neighbouring entries (two a thread, 32 apart), a list of kWaveThreads or
// fewer one entry a thread, a short one each entry's rows split over
// `split` neighbouring threads, merged by (t, row).
void win_hit_list(WinCtx& x, const rtt::WaveSmem& s, int n) {
  const rtt::WaveParams& p = x.p;
  const int T = rtt::kWaveThreads, split = rtt::wave_split(n);
  const rtt::Ray none = rtt::make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  const auto ray = [&](int e) {
    return p.motion ? rtt::lane_ray_m<true>(p, (size_t)s.list_lane[e])
                    : rtt::lane_ray_m<false>(p, (size_t)s.list_lane[e]);
  };
  for (int warp = 0; warp < rtt::kWaveWarps; ++warp) {
    HitThread th[32];
    int ea[32], eb[32];
    for (int l = 0; l < 32; ++l) {
      const int tid = 32 * warp + l;
      HitThread& t = th[l];
      t.ta = t.tb = rtt::kInf;
      t.ra = t.rb = -1;
      if (split == 1) {
        ea[l] = n > T ? 64 * warp + l : tid;
        eb[l] = n > T ? ea[l] + 32 : n;
        t.va = ea[l] < n; t.vb = eb[l] < n;
        t.j0 = 0; t.step = 1;
      } else {
        ea[l] = tid / split; eb[l] = n;
        t.va = tid < n * split; t.vb = false;
        t.j0 = tid % split; t.step = split;
      }
      t.a = t.va ? ray(ea[l]) : none;
      t.b = t.vb ? ray(eb[l]) : none;
    }
    if (p.motion) hit_warp<true>(x, th);
    else hit_warp<false>(x, th);
    for (int l = 0; l < 32; ++l) {
      if (split == 1) {
        if (th[l].va) s.list_meta[ea[l]] = rtt::meta_of(th[l].ra);
        if (th[l].vb) s.list_meta[eb[l]] = rtt::meta_of(th[l].rb);
      } else if (th[l].va && th[l].j0 == 0) {
        float t = rtt::kInf;
        int row = -1;
        for (int j = 0; j < split; ++j) rtt::merge_hit(t, row, th[l + j].ta, th[l + j].ra);
        s.list_meta[ea[l]] = rtt::meta_of(row);
      }
    }
  }
}

// The windowed drain (drain_queue): rounds of one queued ray a thread, or
// each ray's windows split over `split` neighbouring threads, OR-ed.
void win_drain(WinCtx& x, const rtt::WaveSmem& s, int n) {
  const int T = rtt::kWaveThreads, split = rtt::wave_split(n);
  for (int base = 0; base < (split == 1 ? n : 1); base += T) {
    for (int warp = 0; warp < rtt::kWaveWarps; ++warp) {
      AnyThread th[32];
      int e[32], li[32];
      for (int l = 0; l < 32; ++l) {
        const int t = 32 * warp + l;
        const int q = split == 1 ? base + t : t / split;
        th[l].open = split == 1 ? q < n : t < n * split;
        th[l].blocked = false;
        th[l].j0 = split == 1 ? 0 : t % split;
        th[l].step = split;
        th[l].maxt = 0.0f;
        th[l].r = rtt::make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
        e[l] = li[l] = 0;
        if (th[l].open) rtt::queue_ray(s, q, th[l].r, th[l].maxt, e[l], li[l]);
      }
      any_warp(x, th);
      for (int l = 0; l < 32; ++l) {
        if (split > 1 && th[l].j0 != 0) continue;
        bool blocked = false;
        for (int j = 0; j < split; ++j) blocked = blocked || th[l + j].blocked;
        if (blocked) s.blocked[rtt::blocked_word(e[l], li[l])] += rtt::blocked_one(li[l]);
      }
    }
  }
}

template <class Tab>
void drain(const rtt::WaveParams& p, const Tab& tb, const rtt::WaveSmem& s, int n,
           Counts& c, WinCtx* x) {
  const int split = rtt::wave_split(n);
  if (x) {
    win_drain(*x, s, n);
  } else {
    for (int q = 0; q < n; ++q) {
      int e = 0, li = 0;
      bool blocked = false;
      for (int j = 0; j < split; ++j) blocked = rtt::queue_blocked(p, tb, s, q, j, split, e, li) || blocked;
      if (blocked) s.blocked[rtt::blocked_word(e, li)] += rtt::blocked_one(li);
    }
  }
  c.drains += 1; c.queued += n;
  if (n > c.max_queue) c.max_queue = n;
}

template <class Tab>
void run_list(const rtt::WaveParams& p, const Tab& tb, const rtt::WaveSmem& s, int n,
              int queue_cap, Counts& c, WinCtx* x) {
  const int T = rtt::kWaveThreads;
  const int split = rtt::wave_split(n);
  for (int k = 0; k < 2 * n; ++k) s.blocked[k] = 0u;
  if (x) {
    win_hit_list(*x, s, n);
  } else {
    for (int e = 0; e < n && e < T; ++e) {
      if (split == 1 && e + T < n) {  // a thread's two lanes side by side
        rtt::hit_pair(p, tb, s, e, e + T);
        continue;
      }
      for (int e1 = e; e1 < n; e1 += T) {
        float t = rtt::kInf;
        int row = -1;
        for (int j = 0; j < split; ++j) {
          float tj = rtt::kInf;
          int rj = -1;
          rtt::hit_entry(p, tb, s, e1, j, split, tj, rj);
          rtt::merge_hit(t, row, tj, rj);
        }
        s.list_meta[e1] = rtt::meta_of(row);
      }
    }
  }
  int qn = 0;
  for (int seg = 0; seg < n; seg += T) {
    std::vector<rtt::WaveShade> sh(T);
    std::vector<int> row(T, -1);
    for (int t = 0; t < T && seg + t < n; ++t) {
      row[t] = rtt::meta_row(s.list_meta[seg + t]);
      if (row[t] >= 0) sh[t] = rtt::wave_shade(p, tb, (size_t)s.list_lane[seg + t], row[t]);
    }
    for (int li = 0; li < p.n_lights; ++li) {
      for (int k = 0; k < rtt::light_rays(p, li); ++k) {
        if (qn + T > queue_cap) { drain(p, tb, s, qn, c, x); qn = 0; }
        for (int t = 0; t < T; ++t) {
          if (row[t] < 0) continue;
          const rtt::LightTerm lt = rtt::light_term(sh[t], s.lights, p.n_lights, li);
          if (!rtt::shadow_cast(p, lt)) continue;
          const size_t i = (size_t)s.list_lane[seg + t];
          rtt::queue_put(s, qn++, sh[t], rtt::shadow_dir(p, sh[t], lt, s.lights, li, k, i),
                         seg + t, li);
        }
      }
    }
  }
  if (qn > 0) drain(p, tb, s, qn, c, x);
  for (int e = 0; e < n; ++e) rtt::finish_entry(p, tb, s, e);
  c.lists += 1;
}
}  // namespace

// build: csrc/wavefront.cu's kBuild*; the unculled build takes xf, a
// windowed one xp, win, wbeg and n_win; work: the counting build's five
// counters (every windowed build counts).  The staged builds copy the table
// into the block's buffer, kBuildStagedWindows its permuted rows too.
extern "C" void wave_level_blocks_host(
    const float* q, const float* fuzz, const float* table, const float* lights,
    const uint8_t* tex, const float* twh, float* out,
    long long R, int G, int n_cols, int n_lights,
    const int* ranges, int n_ranges, int glossy, int has_tex,
    int n_tex, int tex_h, int tex_w, float min_tp,
    int motion, int refraction, int area, int nss,
    int n_blocks, int list_cap, int queue_cap, long long* counts, int record, int build,
    const float* xf, const float* xp, const float* win, const int* wbeg, int n_win,
    long long* work) {
  rtt::WaveParams p = rtt::make_params(
      q, fuzz, table, lights, tex, twh, out, R, G, n_cols, n_lights, ranges,
      n_ranges, glossy, has_tex, n_tex, tex_h, tex_w, min_tp, motion, refraction, area, nss,
      record);
  p.xf = xf;  // the unculled build's transforms, or null
  const bool windowed = rtt::build_windowed(build);
  if (windowed) {
    p.xp = xp; p.win = win; p.n_win = n_win;
    for (int k = 0; k <= n_ranges; ++k) p.wbeg[k] = wbeg[k];
  }
  const rtt::WaveLayout lay =
      rtt::build_layout(build, G, n_cols, n_lights, n_win, list_cap, queue_cap);
  const int T = rtt::kWaveThreads;
  // one shared memory per block; blocks take scan steps in turn
  std::vector<std::vector<rtt::F4>> bufs(n_blocks, std::vector<rtt::F4>(lay.bytes / sizeof(rtt::F4) + 1));
  std::vector<rtt::WaveSmem> smem;
  for (auto& b : bufs) smem.push_back(rtt::wave_smem(reinterpret_cast<unsigned char*>(b.data()), lay));
  std::vector<int> n_list(n_blocks, 0);
  std::vector<int> live;  // the launch's list
  const long long n_steps = (R + rtt::kScanLanes - 1) / rtt::kScanLanes;
  for (long long step = 0; step < n_steps; ++step) {
    const int b = (int)(step % n_blocks);
    const rtt::WaveSmem& s = smem[b];
    std::vector<unsigned> live4(T);
    int total = 0;
    for (int t = 0; t < T; ++t) {
      live4[t] = rtt::scan_group(p, step * rtt::kScanLanes + 4 * t);
      total += __builtin_popcount(live4[t]);
    }
    if (n_list[b] + total > list_cap) {
      live.insert(live.end(), s.list_lane, s.list_lane + n_list[b]);
      n_list[b] = 0;
    }
    for (int t = 0; t < T; ++t)
      for (int j = 0; j < 4; ++j)
        if ((live4[t] >> j) & 1u) s.list_lane[n_list[b]++] = (int)(step * rtt::kScanLanes + 4 * t + j);
  }
  for (int b = 0; b < n_blocks; ++b) live.insert(live.end(), smem[b].list_lane, smem[b].list_lane + n_list[b]);
  // chunks of the whole list, each by one block with the table staged
  // (or, wide, read where it lies)
  const rtt::WaveSmem& s = smem[0];
  for (int k = 0; k < 8 * n_lights; ++k) s.lights[k] = lights[k];
  Counts c = {0, 0, 0, 0};
  const size_t chunk = (size_t)rtt::wave_chunk((long long)live.size(), n_blocks);
  const bool staged_rows = build == rtt::kBuildStagedWindows;
  WinCtx x{p, s.win, work, staged_rows ? s.perm : xp, staged_rows};
  auto run_all = [&](const auto& tb) {
    for (size_t first = 0; first < live.size(); first += chunk) {
      const int n = (int)std::min<size_t>(chunk, live.size() - first);
      for (int k = 0; k < n; ++k) s.list_lane[k] = live[first + k];
      run_list(p, tb, s, n, queue_cap, c, windowed ? &x : nullptr);
    }
  };
  if (windowed) {
    for (int k = 0; k < rtt::kWinRec * n_win; ++k) s.win[k] = win[k];
  }
  if (build == rtt::kBuildUnculled) {
    run_all(rtt::TabW{xf, rtt::TabT{table, G}});
  } else if (rtt::build_stages_table(build)) {
    for (int k = 0; k < 3 * G; ++k) s.xf4[k] = rtt::staged_xf(table, G, k);
    for (int k = 0; k < (n_cols - 12) * G; ++k) s.rest[k] = table[12 * G + k];
    if (staged_rows) memcpy(s.perm, xp, sizeof(float) * rtt::kWinCols * G);
    run_all(rtt::TabS{s.xf4, s.rest, G});
  } else {
    run_all(rtt::TabT{table, G});
  }
  counts[0] = c.lists; counts[1] = c.drains; counts[2] = c.queued; counts[3] = c.max_queue;
}

// build_plan: list and queue capacities and bytes a block of `build` takes
// within `limit` (n_win: a windowed build's window records).
extern "C" void wave_plan_host(int build, int G, int n_cols, int n_lights, long long limit,
                               int n_win, long long* out) {
  int list_cap, queue_cap;
  out[2] = (long long)rtt::build_plan(build, G, n_cols, n_lights, n_win, (size_t)limit, list_cap,
                                      queue_cap).bytes;
  out[0] = list_cap; out[1] = queue_cap;
  out[3] = rtt::kWaveThreads; out[4] = rtt::kListCapMin; out[5] = rtt::kQueueCapMin;
}

// The window constants and the build codes, for the packer's to be held to.
extern "C" void wave_window_consts(long long* out) {
  out[0] = rtt::kWinRows; out[1] = rtt::kWinCols; out[2] = rtt::kWinRec;
  out[3] = rtt::kMaxWindows; out[4] = rtt::kWinWork;
  out[5] = rtt::kBuildStaged; out[6] = rtt::kBuildUnculled; out[7] = rtt::kBuildWindows;
  out[8] = rtt::kBuildWindowsCount; out[9] = rtt::kBuildStagedWindows;
}
"""


@pytest.fixture(scope="module")
def host_blocks(tmp_path_factory):
    """`wave_level`'s signature over the g++ build of the block schedule;
    the level also takes the grid, the capacities, the build (None: the
    one the launcher picks, `package_build`; or a key of W.WAVE_BUILDS) and
    dicts that receive what the schedule did (chunks run, queue drains,
    rays queued, the fullest drain) and, for a windowed build, what it ran
    (the counting build's counters, W.WINDOW_WORK).  Capacities default to
    what the kernel takes for the table and build."""
    d = tmp_path_factory.mktemp("wave_blocks")
    src, out = str(d / "wave_blocks.cpp"), str(d / "libwave_blocks.so")
    with open(src, "w") as f:
        f.write(HOST_BLOCKS)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wave_level_blocks_host.argtypes = [
        p, p, p, p, p, p, p, ll, i, i, i,
        ctypes.POINTER(ctypes.c_int), i, i, i, i, i, i, ctypes.c_float, i, i, i, i,
        i, i, i, ctypes.POINTER(ll), i, i, p, p, p, ctypes.POINTER(ctypes.c_int), i, p,
    ]
    lib.wave_plan_host.argtypes = [i, i, i, i, ll, i, ctypes.POINTER(ll)]
    lib.wave_window_consts.argtypes = [ctypes.POINTER(ll)]
    lib.wave_level_blocks_host.restype = lib.wave_plan_host.restype = None
    lib.wave_window_consts.restype = None

    def plan(g, n_cols, n_lights, limit=W.WAVE_MAX_SMEM_BYTES, build="staged", n_win=0):
        res = (ll * 6)()
        lib.wave_plan_host(W.WAVE_BUILDS[build], g, n_cols, n_lights, limit, n_win, res)
        return dict(zip(("list_cap", "queue_cap", "bytes", "threads", "list_min",
                         "queue_min"), list(res)))

    def level(out_prev, fuzz, tables, min_tp=0.0, n_blocks=3, list_cap=None,
              queue_cap=None, counts=None, record=False, build=None, work=None):
        r = out_prev.shape[1]
        n_cols, g = tables.table.shape
        build = build or W.package_build(tables)
        xf = tables.table[:12].T.contiguous() if build == "unculled" else None
        windowed = W.WAVE_BUILDS[build] >= W.WAVE_BUILDS["windows"]
        n_win = tables.windows.shape[0] if windowed else 0
        wbeg = (ctypes.c_int * (W.WAVE_MAX_RANGES + 1))(*tables.window_ranges) if windowed \
            else None
        chosen = plan(g, n_cols, tables.n_lights, build=build, n_win=n_win)
        rows = W.OUT_ROWS + (W.record_rows(tables.n_lights, tables.has_tex) if record else 0)
        out = torch.full((rows, r), float("nan"), dtype=torch.float32)
        did = (ll * 4)()
        ran = torch.zeros(len(W.WINDOW_WORK), dtype=torch.int64)
        lib.wave_level_blocks_host(
            out_prev.data_ptr(), *host_operands(fuzz, tables), out.data_ptr(), r, g,
            n_cols, tables.n_lights, *host_flags(tables, min_tp), n_blocks,
            list_cap or chosen["list_cap"], queue_cap or chosen["queue_cap"], did,
            int(record), W.WAVE_BUILDS[build], None if xf is None else xf.data_ptr(),
            tables.perm_rows.data_ptr() if windowed else None,
            tables.windows.data_ptr() if windowed else None, wbeg, n_win, ran.data_ptr(),
        )
        if counts is not None:
            counts.update(zip(("lists", "drains", "queued", "max_queue"), list(did)))
        if work is not None:
            work.update(zip(W.WINDOW_WORK, ran.tolist()))
        return out

    def consts():
        res = (ll * 10)()
        lib.wave_window_consts(res)
        return dict(zip(("rows", "cols", "rec", "max_windows", "work",
                         "staged", "unculled", "windows", "windows_count", "staged_windows"),
                        list(res)))

    level.plan = plan
    level.consts = consts
    return level


# The builds a table a block stages is run by: the package's (None: the
# window cull, `package_build`), and the staged build it is held to on the card.
STAGED_TABLE_BUILDS = [None, "staged"]


@pytest.mark.parametrize("build", STAGED_TABLE_BUILDS, ids=["package", "staged"])
@pytest.mark.parametrize("path,rows,spp_sqrt", WAVE_CASES)
def test_block_schedule_equals_plain_on_every_level(host_blocks, path, rows, spp_sqrt, build):
    """Every level of a trace through the block schedule (three blocks,
    the kernel's capacities) against wave_level_plain; every output row is
    written (the host buffer starts as NaN).  Each scene by the package's
    build, the window cull over the staged table, windows and rows (cubes,
    rects, legacy planes, glass, area lights, moving spheres, spherical
    UV), and by the unculled staged build."""
    scene, o, d, tm, draws = scene_and_rays(path, rows, spp_sqrt, seed=0)
    common = dict(draws, device="cpu", return_levels=True)
    tables = W.wave_tables(scene, light_samples=draws["light_samples"])
    assert W.package_build(tables) == "staged_windows"

    def level(out_prev, fuzz, tables_, min_tp=0.0):
        return host_blocks(out_prev, fuzz, tables_, min_tp, build=build)

    _, plain = trace_wavefront(scene, o, d, tm, level_fn=W.wave_level_plain, **common)
    _, host = trace_wavefront(scene, o, d, tm, level_fn=level, **common)
    assert len(host) == len(plain) == n_levels(scene)
    if len(plain) > 1:
        assert int((plain[0][7] > 0).sum()) > 0
    for a, b in zip(host, plain):
        assert not torch.isnan(a).any()
        assert_same(a, b)


def block_case(act, seed=1, rows=2):
    """(tables, bootstrap tensor with the given act row, fuzz) on
    bvh_glossy (cubes + rect, two lights, textured, glossy); the width is
    act's, rays repeated as needed."""
    scene, o, d, tm, draws = scene_and_rays("scenes/bvh_glossy.json", rows, 1, seed=seed)
    fuzz = draws["fuzz"]
    n = act.shape[0]
    idx = torch.arange(n) % o.shape[0]
    boot = torch.cat([o[idx].T, d[idx].T, tm[idx][None], act[None],
                      torch.ones((1, n))]).contiguous()
    return W.wave_tables(scene), boot, fuzz[0][:, idx].contiguous()


def random_act(n, share, seed):
    return torch.from_numpy((np.random.default_rng(seed).random(n) < share).astype(np.float32))


@pytest.mark.parametrize("case", [
    "mixed_mask", "all_dead", "live_not_multiple_of_32", "ragged_width_odd",
    "ragged_width_vec4",
])
def test_block_schedule_tiles(host_blocks, case):
    """The scan's edge cases against wave_level_plain: a random mask (dead
    and live lanes in every warp), an all-dead tile (no list runs, every
    row zero), a live count that is not a multiple of 32, and widths that
    are not a multiple of the scan step, with and without 16-byte rows."""
    n = {"ragged_width_odd": 3 * 1024 + 517, "ragged_width_vec4": 4 * 1024 + 36}.get(case, 3000)
    if case == "all_dead":
        act = torch.zeros(n)
    elif case == "live_not_multiple_of_32":
        act = torch.zeros(n)
        act[torch.from_numpy(np.random.default_rng(3).choice(n, 37, replace=False))] = 1.0
    else:
        act = random_act(n, 0.5, seed=2)
    tables, boot, fz = block_case(act)
    counts = {}
    a = host_blocks(boot, fz, tables, counts=counts)
    b = W.wave_level_plain(boot, fz, tables)
    assert_same(a, b)
    assert not a[:, act <= 0].any()
    if case == "all_dead":
        assert counts["lists"] == 0 and not a.any()
    else:
        assert a[:, act > 0].any() and counts["lists"] >= 1
    if case == "live_not_multiple_of_32":   # three short chunks (13, 13, 11), split
        assert int((act > 0).sum()) % 32 and counts["lists"] == 3


@pytest.mark.parametrize("build", STAGED_TABLE_BUILDS, ids=["package", "staged"])
@pytest.mark.parametrize("case", ["mixed_mask_vec4", "ragged_width_odd"])
def test_block_schedule_record_rows_equal_plain(host_blocks, case, build):
    """Record mode through the block schedule (every hit lane queues every
    light's shadow ray, the finish stage writes the record rows, the scan
    writes a dead lane's) against wave_level_plain(record=True): rows 0..12
    those of the inference schedule, the winner ids and visibility equal,
    the texel within float tolerance; every row written.  By the package's
    build and by the staged one."""
    n = {"ragged_width_odd": 3 * 1024 + 517}.get(case, 4 * 1024)
    act = random_act(n, 0.6, seed=5)
    tables, boot, fz = block_case(act, seed=3)
    counts, again = {}, {}
    a = host_blocks(boot, fz, tables, counts=counts, record=True, build=build)
    b = W.wave_level_plain(boot, fz, tables, record=True)
    L = tables.n_lights
    assert a.shape == b.shape == (13 + 1 + L + 3, n) and not torch.isnan(a).any()
    assert torch.equal(a[:13], host_blocks(boot, fz, tables, counts=again, build=build))
    assert_same(a[:13], b[:13])
    assert torch.equal(a[13 : 14 + L], b[13 : 14 + L])
    np.testing.assert_allclose(a[14 + L :].numpy(), b[14 + L :].numpy(), rtol=RTOL, atol=ATOL)
    hit = b[12] > 0
    assert (b[13, ~hit] == -1).all() and hit.any() and (b[14 : 14 + L, hit] == 1).any()
    # record mode casts a shadow ray per hit lane and light
    assert counts["queued"] == L * int(hit.sum()) > again["queued"]


def test_block_schedule_shadow_queue_fills_in_rounds(host_blocks):
    """All lanes live, the least capacities (a staging list of one scan
    step, a queue of one ray a thread): the queue is drained several times
    per chunk, and the visibility bits still land on the right lanes and
    lights."""
    n = 4 * 1024 + 300
    tables, boot, fz = block_case(torch.ones(n), seed=4, rows=4)
    plan = host_blocks.plan(*tables.table.shape[::-1], tables.n_lights)
    counts = {}
    a = host_blocks(boot, fz, tables, n_blocks=2, list_cap=plan["list_min"],
                    queue_cap=plan["queue_min"], counts=counts)
    b = W.wave_level_plain(boot, fz, tables)
    assert_same(a, b)
    assert counts["drains"] > counts["lists"] >= 4
    assert counts["max_queue"] <= plan["queue_min"]
    # the same level with the preferred capacities: fewer, fuller drains
    again = {}
    assert_same(host_blocks(boot, fz, tables, n_blocks=2, counts=again), b)
    assert again["drains"] < counts["drains"]


def test_smem_formula_is_the_kernels(host_blocks):
    """kernels/wavefront.py::wave_smem_bytes is the layout of
    csrc/wavefront.cu at its least capacities, the kernel takes the
    preferred ones where they fit, and the cap in geoms sits at the edge.
    The staged build's layout holds the table alone; the package's build
    for a table a block stages (staged_windows) also its window records and
    permuted rows (`staged_smem_bytes` at the most windows a table of that
    size can have); the wide builds' layout is the staged one's without the
    table (`wave_smem_bytes(0, ...)`, whatever the table's size), and they
    take their preferred capacities in a few tens of KB.  The package's
    build switches from staged_windows to windows exactly past
    `wave_cap_geoms`; `stages_table` (the unculled staged build's and the
    lane schedule's table alone) exactly past 1,723 / 1,669 geoms."""
    import dataclasses

    for g, n_cols, lights in [(0, 31, 1), (141, 32, 2), (1000, 31, 8), (1700, 32, 3)]:
        least = host_blocks.plan(g, n_cols, lights, limit=0)
        assert least["list_cap"] == W.WAVE_LIST_MIN and least["queue_cap"] == W.WAVE_QUEUE_MIN
        assert least["bytes"] == W.wave_smem_bytes(g, n_cols, lights)
        assert host_blocks.plan(g, n_cols, lights, limit=least["bytes"]) == least
        big = host_blocks.plan(g, n_cols, lights, limit=10 ** 9)
        assert big["list_cap"] > least["list_cap"] and big["bytes"] > least["bytes"]
    for g, n_cols, lights in [(1, 31, 1), (141, 32, 2), (1000, 31, 8), (1106, 32, 3)]:
        n_win = W.max_windows(g)
        least = host_blocks.plan(g, n_cols, lights, limit=0, build="staged_windows", n_win=n_win)
        assert least["list_cap"] == W.WAVE_LIST_MIN and least["queue_cap"] == W.WAVE_QUEUE_MIN
        assert least["bytes"] == W.staged_smem_bytes(g, n_cols, lights) \
            == W.wave_smem_bytes(g, n_cols, lights, n_win, g)
    for g, n_cols, lights in [(1724, 31, 2), (3001, 32, 2), (6144, 32, 8)]:
        least = host_blocks.plan(g, n_cols, lights, limit=0, build="unculled")
        assert least["list_cap"] == W.WAVE_LIST_MIN and least["queue_cap"] == W.WAVE_QUEUE_MIN
        assert least["bytes"] == W.wave_smem_bytes(0, n_cols, lights)
        wide = host_blocks.plan(g, n_cols, lights, build="unculled")
        assert wide["list_cap"] > least["list_cap"] and wide["bytes"] <= 32 * 1024
    from ray_tracying_tpu_torch import models

    base = W.wave_tables(models.get("sphere_field", n=8, res=(8, 6), device="cpu"))

    def sized(g, n_cols, lights):
        return dataclasses.replace(base, table=torch.zeros((n_cols, g)), n_lights=lights)

    for n_cols in (31, 32):
        for lights in (1, 2, 8):
            cap = W.wave_cap_geoms(n_cols, lights)
            assert W.staged_smem_bytes(cap, n_cols, lights) <= W.WAVE_MAX_SMEM_BYTES
            assert W.staged_smem_bytes(cap + 1, n_cols, lights) > W.WAVE_MAX_SMEM_BYTES
            assert W.package_build(sized(cap, n_cols, lights)) == "staged_windows"
            assert W.package_build(sized(cap + 1, n_cols, lights)) == "windows"
            assert W.package_build(sized(W.WAVE_MAX_GEOMS, n_cols, lights)) == "windows"
        alone = {31: 1723, 32: 1669}[n_cols]
        assert W.stages_table(sized(alone, n_cols, 1))
        assert not W.stages_table(sized(alone + 1, n_cols, 1))

    lights = models.get("sphere_field", n=8, res=(8, 6), device="cpu").n_lights
    cap = W.wave_cap_geoms(31, lights)
    assert cap == 1130
    for n, variant in ((cap - 1, "staged"), (cap, "wide")):
        tables = W.wave_tables(models.get("sphere_field", n=n, res=(8, 6), device="cpu"))
        assert W.package_build(tables) == ("staged_windows" if variant == "staged" else "windows")


def test_windowed_smem_layout(host_blocks):
    """The wide windowed build's shared memory is the unculled wide build's
    plus its window records (WIN_REC floats a window); at the gate's edge it
    still leaves room for three blocks of the level an SM (227 KB of 256 KB
    with 1 KB reserved a block).  The staged windowed build's is the staged
    build's plus the window records and the permuted rows (WIN_COLS floats a
    row), at the same capacities; on the flagship's table (141 geoms,
    textured, two lights) it also leaves room for three blocks an SM."""
    for g, n_cols, lights in [(1724, 31, 2), (3001, 32, 2), (6144, 32, 8)]:
        n_win = -(-g // W.WAVE_WINDOW) + 1
        wide = host_blocks.plan(g, n_cols, lights, build="unculled")
        win = host_blocks.plan(g, n_cols, lights, build="windows", n_win=n_win)
        assert win["list_cap"] == wide["list_cap"] and win["queue_cap"] == wide["queue_cap"]
        assert win["bytes"] == wide["bytes"] + 4 * W.WIN_REC * n_win
        assert 3 * (win["bytes"] + 1024) <= 228 * 1024
        least = host_blocks.plan(g, n_cols, lights, limit=0, build="windows", n_win=n_win)
        assert least["bytes"] == W.wave_smem_bytes(0, n_cols, lights) + 4 * W.WIN_REC * n_win
    for g, n_cols, lights, n_win in [(141, 32, 2, 6), (1000, 31, 8, 33)]:
        staged = host_blocks.plan(g, n_cols, lights)
        both = host_blocks.plan(g, n_cols, lights, build="staged_windows", n_win=n_win)
        assert both["list_cap"] == staged["list_cap"] and both["queue_cap"] == staged["queue_cap"]
        assert both["bytes"] == staged["bytes"] + 4 * W.WIN_REC * n_win + 4 * W.WIN_COLS * g
        if g == 141:
            assert 3 * (both["bytes"] + 1024) <= 228 * 1024


def test_block_schedule_wide_table_equals_plain_on_every_level(host_blocks):
    """A table over the staged cap (sphere_field(n=1800): 1,801 geoms,
    untextured, over the 1,723 a block stages) through the build the
    launcher takes for it, the windowed block schedule (the table's rows in
    Morton windows, each run by a warp when one of its rays enters the
    window's box), every level of a trace against wave_level_plain."""
    from test_torch_wave_wide import live_lanes_only

    from ray_tracying_tpu_torch import models

    scene = models.get("sphere_field", n=1800, res=(48, 27), device="cpu")
    tables = W.wave_tables(scene)
    assert tables.table.shape == (31, 1801)
    assert W.package_build(tables) == "windows" and tables.windows.shape[0] == 57 + 1
    o, d, tm = tile_rays(scene.camera, 6, 2, 48, 1, generator=torch.Generator().manual_seed(0))
    common = dict(device="cpu", return_levels=True, tables=tables)
    # the plain version on the lanes that enter live (lane-wise: the same
    # function), so that the deep levels with no live lane cost nothing
    _, plain = trace_wavefront(scene, o, d, tm, level_fn=live_lanes_only(W.wave_level_plain, []),
                               **common)
    _, host = trace_wavefront(scene, o, d, tm, level_fn=host_blocks, **common)
    assert len(host) == len(plain) == 11
    assert int((plain[0][7] > 0).sum()) > 1 and int((plain[1][7] > 0).sum()) > 0
    for a, b in zip(host, plain):
        assert not torch.isnan(a).any()
        assert_same(a, b)


def test_block_schedule_wide_edge_splits_short_chunks(host_blocks):
    """The gate's edge, 6,144 geoms (sphere_field(n=6143)), one level of 40
    live lanes through the windowed block schedule: three blocks make chunks
    of 14 lanes, whose rows split over 8 threads each (every eighth row of
    each window a warp runs, merged by (t, row)); against wave_level_plain,
    and torch.equal to the unculled schedule, whose threads take slices of
    up to 768 rows of every range."""
    from ray_tracying_tpu_torch import models

    scene = models.get("sphere_field", n=6143, res=(40, 27), device="cpu")
    tables = W.wave_tables(scene)
    assert tables.table.shape[1] == W.WAVE_MAX_GEOMS
    assert W.package_build(tables) == "windows"
    o, d, tm = tile_rays(scene.camera, 8, 1, 40, 1, generator=torch.Generator().manual_seed(0))
    n = o.shape[0]
    boot = torch.cat([o.T, d.T, tm[None], torch.ones((2, n))]).contiguous()
    counts, ran = {}, {}
    a = host_blocks(boot, None, tables, counts=counts, work=ran)
    b = W.wave_level_plain(boot, None, tables)
    assert_same(a, b)
    assert torch.equal(a, host_blocks(boot, None, tables, build="unculled"))
    assert counts["lists"] == 3  # chunks of 14, 14 and 12 lanes
    assert int((b[12] > 0).sum()) > 0
    assert 0 < ran["closest_tests"] < n * W.WAVE_MAX_GEOMS // 4


def wide_boot(o, d, tm, act=None):
    """A bootstrap (9, R) queue of the rays (o, d, tm), all live unless
    `act` says otherwise, throughput 1."""
    n = o.shape[0]
    act = torch.ones(n) if act is None else act
    return torch.cat([o.T, d.T, tm[None], act[None], torch.ones((1, n))]).contiguous()


def windowed_against_unculled(host_blocks, boot, fuzz, tables, record=False, **kw):
    """The windowed schedule and the unculled one on the same level:
    torch.equal, on the host as on the card.  Returns the windowed output
    and what it ran."""
    work = {}
    a = host_blocks(boot, fuzz, tables, build="windows", record=record, work=work, **kw)
    assert not torch.isnan(a).any()
    assert torch.equal(a, host_blocks(boot, fuzz, tables, build="unculled", record=record,
                                      **kw))
    return a, work


def test_window_build_is_the_kernels(host_blocks):
    """The windows of a wide table (`window_arrays`): the constants are the
    kernel's (rows a window, row and record widths, most windows, counters,
    build codes); the permuted rows are a permutation of the table's rows,
    each carrying columns 0..14 and its original row; every window lies in
    one kind range (a range is cut into full windows and one partial one;
    cube_city's floor is a window of its own); a window's box is the union
    of its members' `geom_aabbs` boxes (a moving sphere's time-1 extent
    included) and its graze their largest `row_graze`.  A table a block
    stages gets its windows too (the package's build culls by them)."""
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.accel.lbvh import geom_aabbs, row_graze

    k = host_blocks.consts()
    assert (k["rows"], k["cols"], k["rec"], k["max_windows"], k["work"]) == (
        W.WAVE_WINDOW, W.WIN_COLS, W.WIN_REC, W.WAVE_MAX_WINDOWS, len(W.WINDOW_WORK))
    assert {b: k[b] for b in W.WAVE_BUILDS} == W.WAVE_BUILDS
    assert W.WAVE_WINDOW in (32, 64)
    small = W.wave_tables(models.get("sphere_field", n=1000, res=(8, 6), device="cpu"))
    assert small.windows is not None and W.package_build(small) == "staged_windows"
    moving = moving_field(1800)
    for scene in (models.get("cube_city", n=2048, res=(8, 6), device="cpu"), moving,
                  models.get("sphere_field", n=6143, res=(8, 6), device="cpu")):
        tables = W.wave_tables(scene)
        t = tables.table.T.numpy()
        g = t.shape[0]
        perm = tables.perm_rows[:, 15].contiguous().view(torch.int32).numpy().astype(np.int64)
        assert sorted(perm.tolist()) == list(range(g))
        assert np.array_equal(tables.perm_rows[:, :15].numpy(), t[perm, :15])
        first, count = W.window_spans(tables)
        assert tables.windows.shape == (len(first), W.WIN_REC) <= (W.WAVE_MAX_WINDOWS, 8)
        assert tables.window_ranges[0] == 0 and tables.window_ranges[-1] == len(first)
        boxes = geom_aabbs(scene)[np.rint(t[:, 16]).astype(np.int64)]
        graze = row_graze(np.ascontiguousarray(t[:, :17]))
        for (kind, start, end), w0, w1 in zip(tables.ranges, tables.window_ranges,
                                              tables.window_ranges[1:]):
            assert first[w0] == start and first[w1 - 1] + count[w1 - 1] == end
            assert (first[w0 + 1:w1] == first[w0:w1 - 1] + W.WAVE_WINDOW).all()
            assert (count[w0:w1 - 1] == W.WAVE_WINDOW).all() and 1 <= count[w1 - 1] <= W.WAVE_WINDOW
            for w in range(w0, w1):
                members = perm[first[w]:first[w] + count[w]]
                assert (np.rint(t[members, 15]) == kind).all()
                assert ((start <= members) & (members < end)).all()
                box = tables.windows[w].numpy()
                assert np.array_equal(box[:3], boxes[members, :3].min(axis=0))
                assert np.array_equal(box[3:6], boxes[members, 3:].max(axis=0))
                assert box[6] == graze[members].max()
        if scene is moving:   # the time-1 extent is in the boxes
            vel = scene.prims.velocity.numpy()
            assert np.abs(vel).max() > 0.5
            assert (boxes[:, 3:] - boxes[:, :3]).max() > 2 * 0.4 + 0.5
    city = W.wave_tables(models.get("cube_city", n=2048, res=(8, 6), device="cpu"))
    assert [k_ for k_, _, _ in city.ranges] == [1, 2]
    assert city.window_ranges == (0, 64, 65) and W.window_spans(city)[1][-1] == 1


def test_windows_refuse_another_table():
    """The windowed builds read the transforms from the permuted copy that
    `with_windows` made, the shading and finish stages from the table:
    `check_windows`, which the launcher runs before every windowed launch,
    passes the table the windows were built from and a detached view of it
    (what `WaveLevelFn` hands the kernel, a differentiable table too), and
    refuses another table, the same table edited in place since, and a
    table without windows (every table of `wave_tables` has them)."""
    import dataclasses

    from ray_tracying_tpu_torch import models

    scene = models.get("cube_city", n=2048, res=(8, 6), device="cpu")
    tables = W.wave_tables(scene)
    W.check_windows(tables)
    W.check_windows(dataclasses.replace(tables, table=tables.table.detach()))
    diff = W.wave_tables(scene, differentiable=True)
    W.check_windows(dataclasses.replace(diff, table=diff.table.detach()))
    with pytest.raises(ValueError, match="another table"):
        W.check_windows(dataclasses.replace(tables, table=tables.table.clone()))
    small = W.wave_tables(models.get("sphere_field", n=100, res=(8, 6), device="cpu"))
    W.check_windows(small)
    with pytest.raises(ValueError, match="with_windows"):
        W.check_windows(dataclasses.replace(small, windows=None))
    tables.table[0, 0] += 1.0
    with pytest.raises(ValueError, match="changed since"):
        W.check_windows(tables)
    W.check_windows(W.with_windows(tables, scene))


def moving_field(n, res=(8, 6), seed=3):
    """sphere_field(n=n) with every sphere moving: velocities up to 1.5 a
    unit time in each axis (the boxes hold the time-1 extent)."""
    import dataclasses

    from ray_tracying_tpu_torch import models

    scene = models.get("sphere_field", n=n, res=res, device="cpu")
    rng = np.random.default_rng(seed)
    vel = torch.from_numpy(rng.uniform(-1.5, 1.5, (scene.n_prims, 3)).astype(np.float32))
    vel[scene.prims.kind != 0] = 0.0
    return dataclasses.replace(scene, prims=dataclasses.replace(scene.prims, velocity=vel),
                               has_motion=True)


@pytest.mark.parametrize("n_rays,n_blocks", [(600, 1), (200, 1), (100, 1), (40, 1), (40, 3)],
                         ids=["two_a_thread", "one_a_thread", "split2", "split4", "split8"])
def test_windowed_tie_keeps_the_lower_row_under_every_split(host_blocks, n_rays, n_blocks):
    """Two identical spheres at table rows i < j, in different windows,
    the window of j visited first (their boxes grown, which only weakens
    the cull, so that j's centroid sorts first and i's last): every ray
    that hits them hits both at the same t, and the lower row i wins as in
    the row-order loop, whether a thread runs two lanes, one, or a slice of
    a lane's rows (split 2, 4, 8).  Record mode's winner ids say so; the
    windowed and unculled schedules are torch.equal, and equal the plain
    version."""
    import dataclasses

    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.accel.lbvh import geom_aabbs

    scene = models.get("sphere_field", n=1800, res=(8, 6), device="cpu")
    i, j = 100, 1500
    prims = scene.prims
    w2o, o2w = prims.w2o.clone(), prims.o2w.clone()
    w2o[j], o2w[j] = w2o[i], o2w[i]
    scene = dataclasses.replace(scene, prims=dataclasses.replace(prims, w2o=w2o, o2w=o2w))
    tables = W.wave_tables(scene)
    t = tables.table.T.numpy()
    ids = np.rint(t[:, 16]).astype(np.int64)
    ri, rj = int(np.nonzero(ids == i)[0][0]), int(np.nonzero(ids == j)[0][0])
    assert ri < rj and np.array_equal(t[ri, :12], t[rj, :12])
    boxes = geom_aabbs(scene)[ids]
    far = np.abs(boxes).max() + 100.0
    boxes[ri, 3:] = far       # i's centroid sorts last ...
    boxes[rj, :3] = -far      # ... and j's first
    perm_rows, windows, bounds = W.window_arrays(t.T, tables.ranges, boxes)
    tables = dataclasses.replace(tables, perm_rows=torch.from_numpy(perm_rows),
                                 windows=torch.from_numpy(windows), window_ranges=bounds)
    perm = perm_rows[:, 15].view(np.int32)
    pi, pj = int(np.nonzero(perm == ri)[0][0]), int(np.nonzero(perm == rj)[0][0])
    assert pj < W.WAVE_WINDOW <= pi   # j in the first window, i in a later one
    # rays from just off sphere i toward it
    rng = np.random.default_rng(5)
    c = o2w[i][:, 3].numpy()
    r = float(np.linalg.norm(o2w[i][:, 0].numpy()))
    u = rng.normal(size=(n_rays, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = torch.from_numpy((c - 1.5 * r * u).astype(np.float32))
    d = u + 0.3 * rng.normal(size=(n_rays, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    boot = wide_boot(o, d, torch.zeros(n_rays))
    a, _ = windowed_against_unculled(host_blocks, boot, None, tables, record=True,
                                     n_blocks=n_blocks)
    b = W.wave_level_plain(boot, None, tables, record=True)
    assert_same(a[:13], b[:13])
    assert torch.equal(a[13], b[13])
    assert int((a[13] == i).sum()) > n_rays // 4 and not (a[13] == j).any()


def test_windowed_moving_spheres_equal_plain(host_blocks):
    """A wide table of moving spheres (sphere_field(n=1800), every sphere
    with a velocity, ray times drawn in [0, 1]): each window's box holds its
    members' time-1 extent, so the cull at any time keeps every hit; levels
    0 and 1 through the windowed schedule against wave_level_plain."""
    from test_torch_wave_wide import live_lanes_only

    scene = moving_field(1800, res=(48, 27))
    tables = W.wave_tables(scene)
    assert tables.motion and tables.windows is not None
    o, d, _ = tile_rays(scene.camera, 6, 2, 48, 1, generator=torch.Generator().manual_seed(0))
    tm = torch.from_numpy(np.random.default_rng(7).random(o.shape[0]).astype(np.float32))
    prev = wide_boot(o, d, tm)
    plain_level = live_lanes_only(W.wave_level_plain, [])
    for lv in range(2):
        a, _ = windowed_against_unculled(host_blocks, prev, None, tables)
        b = plain_level(prev, None, tables)
        assert_same(a, b)
        assert int((b[12] > 0).sum()) > (10 if lv == 0 else 0)
        prev = b


def test_windowed_keeps_the_fuzzy_grazing_hits_of_far_spheres(host_blocks):
    """Queue 3's far spheres on a wide table, through the window cull: a
    sphere of radius 0.12 at 150 units among eight others, a sphere of
    radius 0.001 beside it (32 copies, which fill one window, so that the
    window's box is the sphere's own), 1,800 spheres behind the camera to
    make the table wide, and spheres at one far corner that line the copies
    up with a window.  At that distance the sphere test's discriminant
    cancels: rays on a ring at 0.9-1.3 radii around the larger sphere, and
    at 9-13 radii around the tiny one, still test as hits.  The windowed
    schedule keeps every such hit (torch.equal to the unculled one, equal to
    the plain version); the tiny sphere's wide graze stays on its own
    window; with every window's graze zeroed, the cull loses the tiny
    sphere's far hits."""
    import dataclasses

    rng = np.random.default_rng(4)
    far = [[0.0, 150.0, 0.0]] + rng.uniform([-40, 100, -20], [40, 160, 20], (8, 3)).tolist()
    tiny = [3.0, 150.0, 2.0]
    behind = rng.uniform([-60, -80, -30], [60, -20, 30], (1800, 3)).tolist()
    tiny_id = len(far)   # the lowest of its copies wins

    def field(pad):
        spheres = ([{"location": c, "radius": 0.12} for c in far]
                   + [{"location": tiny, "radius": 0.001}] * 32
                   + [{"location": c, "radius": 0.3} for c in behind]
                   + [{"location": [-70.0, -90.0, -40.0], "radius": 0.3}] * (1 + pad))
        return W.wave_tables(rt.load_scene_dict(camera_dict(spheres=spheres), device="cpu"))

    def perm_of(tables):
        return tables.perm_rows[:, 15].contiguous().view(torch.int32).numpy()

    pad = -int(np.nonzero(perm_of(field(0)) == tiny_id)[0][0]) % W.WAVE_WINDOW
    tables = field(pad)
    perm = perm_of(tables)
    first, count = W.window_spans(tables)
    w_tiny = int(np.nonzero(first == int(np.nonzero(perm == tiny_id)[0][0]))[0][0])
    assert sorted(perm[first[w_tiny]:first[w_tiny] + count[w_tiny]].tolist()) == \
        list(range(tiny_id, tiny_id + 32))
    n = 6000
    r1, rad1 = silhouette_rays(rng, n, far[0], 0.12)
    r2, rad2 = silhouette_rays(rng, n, tiny, 0.01)
    boot = torch.cat([torch.cat([r1, r2], dim=1), torch.ones((1, 2 * n))]).contiguous()
    a, _ = windowed_against_unculled(host_blocks, boot, None, tables)
    b = W.wave_level_plain(boot, None, tables, record=True)
    assert_same(a, b[:13])
    won = b[13]
    assert int(((won[:n] == 0) & torch.from_numpy(rad1 > 0.12 * 1.02)).sum()) > 100
    assert int((won[n:] == tiny_id).sum()) > 100 and (rad2 > 0.008).all()
    # the tiny sphere's graze is its window's alone
    graze = tables.windows[:, 6].numpy()
    assert graze[w_tiny] == graze.max() and (np.delete(graze, w_tiny) < graze.max() / 100).all()
    # Without the graze slack the same windows lose the tiny sphere's far hits.
    bare = tables.windows.clone()
    bare[:, 6] = 0.0
    lost = host_blocks(boot, None, dataclasses.replace(tables, windows=bare), build="windows")
    assert int((lost[12, n:] < a[12, n:]).sum()) > 100


def test_windowed_legacy_planes_keep_their_hits_past_the_edge(host_blocks, monkeypatch):
    """A legacy plane's test (csrc/geom.cuh::plane_t_x) takes points up to
    1e-6 / |edge| outside its triangles: on a plane 0.004 wide, 2.5e-4
    past its edge, where the reference's box (`geom_aabbs`: the corners
    +- 1e-4) no longer reaches.  Thirty-two copies of such a plane fill one
    window of their own; rays from the camera aim at a strip across the
    plane's right edge, and grazing rays (0.06-1.7 degrees off the plane)
    cross that edge.  The window cull (the package's build, its boxes grown
    by `plane_boxes`) keeps every hit: the schedule equals the plain
    version and is torch.equal to the unculled staged one; some kept hits
    lie past the reference's box.  Built from the reference's boxes alone,
    the same windows lose those hits (the rays sorted by how far past the
    edge they aim, so that whole warps miss the box)."""
    import dataclasses

    x0, y0, z0, h = 0.3, 4.5, 0.2, 0.002
    tiny = {"corners": [[x0 - h, y0, z0 - h], [x0 + h, y0, z0 - h], [x0 + h, y0, z0 + h],
                        [x0 - h, y0, z0 + h]]}
    spheres = [{"location": [0.0, 9.0, 0.0], "radius": 3.0}]
    lights = [{"location": [0.0, 2.0, 3.0], "intensity": 300.0, "color": [1.0, 1.0, 1.0],
               "radius": 0.0}]
    scene = rt.load_scene_dict(camera_dict(planes=[tiny] * 32, spheres=spheres, lights=lights),
                               device="cpu")
    tables = W.wave_tables(scene)
    assert W.package_build(tables) == "staged_windows"
    assert [k for k, _, _ in tables.ranges] == [CH.KIND_SPHERE, W.KIND_PLANE]
    assert tables.window_ranges == (0, 1, 2)   # the planes' window holds nothing else
    plane_ids = set(range(1, 33))
    rng = np.random.default_rng(11)
    n = 3000
    # past the right edge (x = x0 + h), in order: a warp runs a window when
    # one of its lanes wants it, so a lost hit shows only where a whole warp
    # misses the box
    past = np.sort(rng.uniform(-3e-4, 4e-4, n))
    target = np.stack([x0 + h + past, np.full(n, y0), z0 + rng.uniform(-h, h, n)], axis=1)
    d1 = target / np.linalg.norm(target, axis=1, keepdims=True)
    o1 = np.zeros((n, 3))
    ang = rng.uniform(1e-3, 3e-2, n)           # grazing: toward -x, rising through y0
    d2 = np.stack([-np.cos(ang), np.sin(ang), np.zeros(n)], axis=1)
    cross = np.stack([x0 + h + np.sort(rng.uniform(-3e-4, 4e-4, n)), np.full(n, y0),
                      z0 + rng.uniform(-h, h, n)], axis=1)
    o2 = cross - 0.5 * d2
    o = torch.from_numpy(np.concatenate([o1, o2]).astype(np.float32))
    d = torch.from_numpy(np.concatenate([d1, d2]).astype(np.float32))
    boot = wide_boot(o, d, torch.zeros(2 * n))
    a = host_blocks(boot, None, tables)
    assert not torch.isnan(a).any()
    assert torch.equal(a, host_blocks(boot, None, tables, build="staged"))
    b = W.wave_level_plain(boot, None, tables, record=True)
    assert_same(a, b[:13])
    won = np.isin(b[13].numpy(), list(plane_ids))
    beyond = np.concatenate([past, cross[:, 0] - x0 - h]) > 1.5e-4
    assert int((won & beyond)[:n].sum()) > 50 and int((won & beyond)[n:].sum()) > 50
    assert int(won[n:].sum()) > 500
    # the same windows from the reference's boxes alone
    monkeypatch.setattr(W, "plane_boxes", lambda rows, boxes: boxes)
    bare = W.with_windows(tables, scene)
    assert (bare.windows[1, 3:6] <= tables.windows[1, 3:6]).all()
    assert bare.windows[1, 3] < tables.windows[1, 3]   # past the right edge
    lost = host_blocks(boot, None, bare)
    assert int((lost[:, :n] != a[:, :n]).any(dim=0).sum()) > 50


def _off_plane_quad(rng, n):
    """A quad whose corner e is off the plane of a, b, c (the reference's
    test takes triangle (b, e', c), e' = e projected onto that plane, which
    reaches past the corners' box); targets in that triangle, the farthest
    from the box first, each from 0.25 below it, upward (the corners' box
    is 1 deep in y: a ray from the camera would cross it)."""
    o0 = np.array([-0.5, 4.5, -0.5])
    a, b, c, e = (o0 + v for v in ([0, 0, 0], [1, 1, 0], [0, 0, 1], [3, 0, 0]))
    e_p = o0 + np.array([1.5, 1.5, 0.0])
    lam = rng.dirichlet((1.0, 1.0, 1.0), n)
    target = lam[:, :1] * b + lam[:, 1:2] * e_p + lam[:, 2:] * c
    target = target[np.argsort(-target[:, 1])]
    return [a, b, c, e], target, target - np.array([0.0, 0.25, 0.0])


def _sliver_quad(rng, n):
    """A sheared sliver (a parallelogram 3 long and 1e-3 high): its test
    takes points up to about 3e-3 past the sharp corner a, 3 / (the
    triangle's doubled area) times 1e-6; targets around and past a, the
    farthest first."""
    o0, h = np.array([-1.5, 4.5, 0.2]), 1e-3
    a, b, c, e = (o0 + v for v in ([0, 0, 0], [1, 0, 0], [2, 0, h], [3, 0, h]))
    lam = rng.uniform(-2e-3, 2e-4, (n, 2))
    target = a + lam[:, :1] * (b - a) + lam[:, 1:] * (c - a)
    return [a, b, c, e], target[np.argsort(target[:, 0])], np.zeros((n, 3))


def _repeated_corner_quad(rng, n):
    """A triangle written as a quad (e = c): the test's triangle (b, c, c)
    has no area and takes a strip 5e-4 wide along the whole line through b
    and c; targets on that strip up to 0.3 past c."""
    x0, y0, z0, h = 0.3, 4.5, 0.2, 0.002
    a, b, c = (np.array(v) for v in ([x0 - h, y0, z0 - h], [x0 + h, y0, z0 - h],
                                     [x0 + h, y0, z0 + h]))
    s = np.sort(rng.uniform(1e-3, 0.3, n))[::-1]
    target = np.stack([x0 + h + rng.uniform(-3e-4, 3e-4, n), np.full(n, y0), z0 + h + s], axis=1)
    return [a, b, c, c], target, np.zeros((n, 3))


@pytest.mark.parametrize("quad", [_off_plane_quad, _sliver_quad, _repeated_corner_quad],
                         ids=["off_plane", "sliver", "repeated_corner"])
def test_windowed_legacy_quads_keep_every_hit_their_test_takes(host_blocks, monkeypatch, quad):
    """Quads whose test (csrc/geom.cuh::plane_t_x) takes points outside
    their corners' box: a fourth corner off the plane of the other three, a
    sliver with a sharp corner, a repeated corner.  Thirty-two copies of
    the quad fill one window; rays from the camera aim at points the test
    takes outside the reference's box (`geom_aabbs`).  The window cull (the
    package's build, the box from `plane_boxes`: the test's own plane and
    triangles, their edge slack, or for the repeated corner a box every ray
    starts in) keeps every hit: the schedule equals the plain version and
    is torch.equal to the unculled staged one, and the plane wins lanes
    past the reference's box.  Built from the reference's boxes alone, the
    same windows lose some of those hits (the rays ordered so that whole
    warps miss that box)."""
    rng = np.random.default_rng(23)
    n = 2048
    corners, target, origin = quad(rng, n)
    plane = {"corners": [[float(x) for x in v] for v in corners]}
    spheres = [{"location": [0.0, 30.0, 10.0], "radius": 1.0}]
    lights = [{"location": [0.0, 2.0, 3.0], "intensity": 300.0, "color": [1.0, 1.0, 1.0],
               "radius": 0.0}]
    scene = rt.load_scene_dict(camera_dict(planes=[plane] * 32, spheres=spheres, lights=lights),
                               device="cpu")
    tables = W.wave_tables(scene)
    assert W.package_build(tables) == "staged_windows"
    assert tables.window_ranges == (0, 1, 2)
    d = (target - origin) / np.linalg.norm(target - origin, axis=1, keepdims=True)
    boot = wide_boot(torch.from_numpy(origin.astype(np.float32)),
                     torch.from_numpy(d.astype(np.float32)), torch.zeros(n))
    a = host_blocks(boot, None, tables)
    assert not torch.isnan(a).any()
    assert torch.equal(a, host_blocks(boot, None, tables, build="staged"))
    b = W.wave_level_plain(boot, None, tables, record=True)
    assert_same(a, b[:13])
    won = np.isin(b[13].numpy(), list(range(1, 33)))
    k = np.array(corners, np.float32)
    lo, hi = k.min(axis=0) - 1e-4, k.max(axis=0) + 1e-4
    outside = ((target < lo) | (target > hi)).any(axis=1)   # a ray meets the plane there
    assert int((won & outside).sum()) > 100
    monkeypatch.setattr(W, "plane_boxes", lambda rows, boxes: boxes)
    bare = W.with_windows(tables, scene)
    assert (bare.windows[1, :3] >= tables.windows[1, :3]).all()
    lost = host_blocks(boot, None, bare)
    assert int((lost != a).any(dim=0).sum()) > 20


def test_windowed_record_rows_equal_plain_on_cube_city(host_blocks):
    """Record mode through the windowed schedule on cube_city(n=2048)
    (cubes and the floor's rect, two lights): levels 0 and 1, rows 0-12
    those of the inference schedule, the winner ids and visibility equal to
    wave_level_plain(record=True), every lane torch.equal to the unculled
    schedule."""
    from ray_tracying_tpu_torch import models

    scene = models.get("cube_city", n=2048, res=(48, 27), device="cpu")
    tables = W.wave_tables(scene)
    o, d, tm = tile_rays(scene.camera, 12, 2, 48, 1, generator=torch.Generator().manual_seed(2))
    act = random_act(o.shape[0], 0.8, seed=9)
    prev = wide_boot(o, d, tm, act)
    L = tables.n_lights
    for lv in range(2):
        a, _ = windowed_against_unculled(host_blocks, prev, None, tables, record=True)
        b = W.wave_level_plain(prev, None, tables, record=True)
        assert a.shape == b.shape == (13 + 1 + L, prev.shape[1])
        assert torch.equal(a[:13], host_blocks(prev, None, tables))
        assert_same(a[:13], b[:13])
        assert torch.equal(a[13:], b[13:])
        assert int((b[12] > 0).sum()) > 0
        prev = b[:13].contiguous()


def test_window_need_is_at_most_what_the_schedule_runs(host_blocks):
    """chip_smoke.py's window counts of a plain level (`window_need_counts`:
    what a per-ray cull by exact boxes cannot avoid, the closest hit against
    its final best t) never exceed what the windowed schedule's counting ran
    for the same lanes (box slack, the running best, a warp's union of
    windows), and the counts the schedule ran are a fraction of the unculled
    level's every test.  The counts leave the plain version's output and its
    own counts as they are."""
    import importlib.util

    from ray_tracying_tpu_torch import models

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene = models.get("cube_city", n=2048, res=(64, 36), device="cpu")
    tables = W.wave_tables(scene)
    o, d, tm = tile_rays(scene.camera, 12, 8, 64, 1, generator=torch.Generator().manual_seed(1))
    boot = wide_boot(o, d, tm)
    need, alone = {}, {}
    with smoke.window_need_counts(W, tables, boot[7] > 0, need):
        counted = W.wave_level_plain(boot, None, tables, stats=need)
    assert torch.equal(counted, W.wave_level_plain(boot, None, tables, stats=alone))
    assert alone == {k: v for k, v in need.items() if "window" not in k}
    _, ran = windowed_against_unculled(host_blocks, boot, None, tables, n_blocks=1)
    n = boot.shape[1]
    assert need["closest_window_tests"] <= ran["closest_wanted_tests"] <= ran["closest_tests"]
    assert need["shadow_window_tests"] <= ran["shadow_tests"] * 1.02
    assert need["closest_window_boxes"] == n * tables.windows.shape[0]
    assert ran["closest_tests"] < need["closest_tests"] / 4
    assert ran["shadow_tests"] < need["shadow_tests"] / 4
    assert need["shadow_window_boxes"] <= ran["shadow_box_tests"]


# ---------------------------------------------------------------------------
# csrc/closest_hit.cu
# ---------------------------------------------------------------------------

BRUTE_HOST_LOOP = """
#include "closest_hit.cu"
extern "C" void closest_host(
    const float* rays, const float* table, float* t, int* id, float* n,
    long long R, int G, const int* ranges, int n_ranges, int motion) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, nullptr, table, t, id, n, nullptr, R, G, ranges, n_ranges, motion);
  for (long long i = 0; i < R; ++i) {
    if (n) rtt::closest_lane<true>(p, table, (size_t)i);
    else rtt::closest_lane<false>(p, table, (size_t)i);
  }
}
extern "C" void occlusion_host(
    const float* rays, const float* maxt, const float* table, uint8_t* blocked,
    long long R, int G, const int* ranges, int n_ranges) {
  const rtt::BruteParams p = rtt::make_brute_params(
      rays, maxt, table, nullptr, nullptr, nullptr, blocked, R, G, ranges,
      n_ranges, 0);
  for (long long i = 0; i < R; ++i) rtt::occlusion_lane(p, table, (size_t)i);
}
"""


@pytest.fixture(scope="module")
def host_brute(tmp_path_factory):
    """The g++ build of the closest-hit and any-hit lane functions, behind
    the signatures of `brute_closest[_n]` and `occlusion_any`."""
    d = tmp_path_factory.mktemp("brute_host")
    src, out = str(d / "brute_host.cpp"), str(d / "libbrute_host.so")
    with open(src, "w") as f:
        f.write(BRUTE_HOST_LOOP)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    rng_t = ctypes.POINTER(ctypes.c_int)
    lib.closest_host.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, rng_t, i, i]
    lib.occlusion_host.argtypes = [p, p, p, p, ctypes.c_longlong, i, rng_t, i]
    lib.closest_host.restype = lib.occlusion_host.restype = None

    def c_ranges(ranges):
        flat = [x for rng in ranges for x in rng]
        return (ctypes.c_int * 12)(*(flat + [0] * (12 - len(flat))))

    def closest(rays, table, ranges, motion, want_n):
        r, g = rays.shape[1], table.shape[1]
        t = torch.empty(r)
        pid = torch.empty(r, dtype=torch.int32)
        n = torch.empty((3, r)) if want_n else None
        lib.closest_host(
            rays.data_ptr(), table.data_ptr(), t.data_ptr(), pid.data_ptr(),
            n.data_ptr() if want_n else None, r, g, c_ranges(ranges),
            len(ranges), int(motion),
        )
        return (t, pid, n) if want_n else (t, pid)

    def occlusion(rays, maxt, table, ranges):
        r, g = rays.shape[1], table.shape[1]
        blocked = torch.empty(r, dtype=torch.bool)
        lib.occlusion_host(
            rays.data_ptr(), maxt.data_ptr(), table.data_ptr(),
            blocked.data_ptr(), r, g, c_ranges(ranges), len(ranges),
        )
        return blocked

    return closest, occlusion


def all_kinds_scene():
    """Every kind (a plane too), rotated and scaled prims, a moving
    sphere."""
    d = {
        "cameras": [{"location": [0, 0, 0], "gaze_vector": [0, 1, 0],
                     "up_vector": [0, 0, 1], "focal_length": 20.0,
                     "sensor_width": 36, "sensor_height": 24}],
        "render": {"resolution_x": 8, "resolution_y": 6},
        "spheres": [
            {"location": [0, 5, 0], "radius": 1.0},
            {"location": [2, 6, 0.5], "rotation": [0.3, 0.2, 0.7],
             "scale": [0.8, 0.5, 1.2], "velocity": [1.0, 0.0, 0.0]},
        ],
        "cubes": [{"translation": [-2, 7, 0], "rotation": [0.1, 0.9, 0.4],
                   "scale": [0.7, 1.1, 0.6]}],
        "rectangles": [{"translation": [0, 9, 0], "rotation": [1.0, 0.2, 0.0],
                        "scale": [6.0, 6.0, 1.0]}],
        "planes": [{"corners": [[-9, 12, -9], [9, 12, -9], [9, 12, 9], [-9, 12, 9]]}],
    }
    return rt.load_scene_dict(d, device="cpu")


def brute_case(name):
    """(scene, (8, R) rays with a random act mask and random times, maxt)
    at a width that is a multiple of nothing."""
    rng = np.random.default_rng(11)
    if name == "all_kinds":
        scene = all_kinds_scene()
        n = 4001
        o = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d[:, 1] = np.abs(d[:, 1]) + 0.3
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = torch.from_numpy(o), torch.from_numpy(d)
    else:
        scene, o, d, _, _ = scene_and_rays(name, 2, 1, seed=3)
        n = o.shape[0] - 5
        o, d = o[:n], d[:n]
    tm = torch.from_numpy(rng.random(n).astype(np.float32))
    act = torch.from_numpy(rng.random(n) < 0.7)
    maxt = torch.from_numpy(rng.uniform(0.5, 25.0, n).astype(np.float32))
    return scene, CH.pack_rays(o, d, tm, act), maxt


@pytest.mark.parametrize("name", ["all_kinds", "golden/ASCII/scene.json", "scenes/glossy.json"])
@pytest.mark.parametrize("want_n", [False, True], ids=["t_id", "t_id_normal"])
def test_closest_lane_equals_plain(host_brute, name, want_n):
    closest, _ = host_brute
    scene, rays, _ = brute_case(name)
    table, ranges = CH.scene_table(scene)
    plain = (CH.brute_closest_n_plain if want_n else CH.brute_closest_plain)(
        rays, table, ranges, scene.has_motion
    )
    host = closest(rays, table, ranges, scene.has_motion, want_n)
    assert torch.equal(host[1], plain[1])                       # ids
    hit = plain[1] >= 0
    assert 0 < int(hit.sum()) < rays.shape[1]
    assert torch.equal(torch.isinf(host[0]), torch.isinf(plain[0]))
    np.testing.assert_allclose(host[0][hit].numpy(), plain[0][hit].numpy(), rtol=RTOL, atol=ATOL)
    dead = rays[7] <= 0
    assert (host[1][dead] == -1).all() and torch.isinf(host[0][dead]).all()
    if want_n:
        np.testing.assert_allclose(host[2].numpy(), plain[2].numpy(), rtol=RTOL, atol=ATOL)
        assert not host[2][:, ~hit].any()


@pytest.mark.parametrize("name", ["all_kinds", "golden/ASCII/scene.json", "scenes/glossy.json"])
def test_occlusion_lane_equals_plain(host_brute, name):
    _, occlusion = host_brute
    scene, rays, maxt = brute_case(name)
    rays[6] = 0.0  # shadow rays carry time 0
    table, ranges = CH.scene_table(scene)
    plain = CH.occlusion_plain(rays, maxt, table, ranges)
    host = occlusion(rays, maxt, table, ranges)
    # a hit within one rounding of maxt may fall on either side
    assert int((host != plain).sum()) <= 1
    assert 0 < int(plain.sum()) < rays.shape[1]
    assert not host[rays[7] <= 0].any()


# ---------------------------------------------------------------------------
# The any-hit's warp schedule of csrc/closest_hit.cu (occlusion_warp_kernel),
# run on the host from the same steps: the shadow table staged by the
# threads of a block from the (17, G) table, the scan in steps of kWarpScan
# lanes (sweep_scan4 in the any-hit mode), the list of live lanes, then
# tasks of warp_task list entries, each an emulated warp whose lanes run
# shadow_blocked in a loop (a short task's rows split over helper lanes, whose
# answers OR as the kernel's shuffles take them).
# ---------------------------------------------------------------------------

SHADOW_HOST = """
#include "closest_hit.cu"
#include <string.h>
#include <vector>

namespace {
using namespace rtt;
}  // namespace

// n_threads: the threads of the block that stage the shadow table (entries
// t, t + n_threads, ...); n_warps: the launch's warps, which a short list is
// shared over.  stab_out: G x 12 floats, the staged table.  did: live lanes,
// warps, lanes a warp takes, lanes a listed lane's rows are split over.
extern "C" void occlusion_warp_host(
    const float* rays, const float* maxt, const float* table, uint8_t* blocked, long long R,
    int G, const int* ranges, int n_ranges, int n_threads, int n_warps, float* stab_out,
    long long* did) {
  const BruteParams p = make_brute_params(rays, maxt, table, nullptr, nullptr, nullptr, blocked,
                                          R, G, ranges, n_ranges, 0);
  const SweepParams scan = scan_params(p);
  std::vector<F4> buf((shadow_smem_bytes(G) + sizeof(F4) - 1) / sizeof(F4) + 1);
  float* stab = reinterpret_cast<float*>(buf.data());
  for (int t = 0; t < n_threads; ++t) stage_rows<kShadowCols>(table, G, stab, t, n_threads);
  std::vector<int> live;
  for (long long base = 0; base < R; base += kWarpScan) {
    for (int lane = 0; lane < 32; ++lane) {
      const unsigned live4 = sweep_scan4<kSweepAnyHit>(scan, base + 4 * lane);
      for (int j = 0; j < 4; ++j)
        if ((live4 >> j) & 1u) live.push_back((int)(base + 4 * lane + j));
    }
  }
  const int n = (int)live.size();
  const int task = warp_task(n, n_warps);
  const int g = split_lanes(task);
  long long warps = 0;
  for (int first = 0; first < n; first += task, ++warps) {
    bool blocked_by[32];
    for (int lane = 0; lane < 32; ++lane) {
      const int q = lane / g, e = first + q;
      const bool mine = q < task && e < n;
      blocked_by[lane] = mine && shadow_blocked(p, stab, (size_t)live[mine ? e : 0], lane % g, g);
    }
    for (int o = g / 2; o > 0; o >>= 1) {  // the group's OR, as the shuffles take it
      bool next[32];
      for (int lane = 0; lane < 32; ++lane) next[lane] = blocked_by[lane] || blocked_by[lane ^ o];
      memcpy(blocked_by, next, sizeof next);
    }
    for (int lane = 0; lane < 32; ++lane) {
      const int q = lane / g, e = first + q;
      if (q < task && e < n && lane % g == 0) blocked[live[e]] = blocked_by[lane] ? 1 : 0;
    }
  }
  memcpy(stab_out, stab, shadow_smem_bytes(G));
  did[0] = n; did[1] = warps; did[2] = task; did[3] = g;
}

extern "C" long long shadow_smem_bytes_host(int G) { return (long long)shadow_smem_bytes(G); }
"""


@pytest.fixture(scope="module")
def host_shadow(tmp_path_factory):
    """The g++ build of the any-hit's warp schedule behind `occlusion_any`'s
    signature: occlusion(rays, maxt, table, ranges, n_threads=1, n_warps=1,
    counts=None) -> blocked; `counts` receives the live lanes,
    the warps, the lanes a warp takes, the lanes a listed lane's rows are
    split over and the staged table.  Every output is written: the buffer
    starts as 7."""
    d = tmp_path_factory.mktemp("shadow_host")
    src, out = str(d / "shadow_host.cpp"), str(d / "libshadow_host.so")
    with open(src, "w") as f:
        f.write(SHADOW_HOST)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.occlusion_warp_host.argtypes = [p, p, p, p, ll, i, ctypes.POINTER(ctypes.c_int), i, i,
                                        i, p, p]
    lib.occlusion_warp_host.restype = None
    lib.shadow_smem_bytes_host.argtypes = [i]
    lib.shadow_smem_bytes_host.restype = ll

    def occlusion(rays, maxt, table, ranges, n_threads=1, n_warps=1, counts=None):
        r, g = rays.shape[1], table.shape[1]
        blocked = torch.full((r,), 7, dtype=torch.uint8)
        stab = torch.full((g, 12), float("nan"))
        did = torch.zeros(4, dtype=torch.int64)
        flat = [x for rng in ranges for x in rng]
        lib.occlusion_warp_host(
            rays.data_ptr(), maxt.data_ptr(), table.data_ptr(), blocked.data_ptr(), r, g,
            (ctypes.c_int * 12)(*(flat + [0] * (12 - len(flat)))), len(ranges), n_threads,
            n_warps, stab.data_ptr(), did.data_ptr())
        if counts is not None:
            counts.update(live=int(did[0]), warps=int(did[1]), task=int(did[2]),
                          helpers=int(did[3]), stab=stab)
        assert int(blocked.max()) <= 1
        return blocked.bool()

    occlusion.smem_bytes = lib.shadow_smem_bytes_host
    return occlusion


@pytest.mark.parametrize("name", ["all_kinds", "golden/ASCII/scene.json"])
@pytest.mark.parametrize("act", ["case_mask", "few_live", "all_dead"])
@pytest.mark.parametrize("n_warps", [1, 600])
def test_shadow_schedule_equals_plain(host_shadow, host_brute, name, act, n_warps):
    """The any-hit's warp schedule (staged 12-column rows, scan, live-lane
    list, tasks of 32 or, over 600 warps, short equal shares whose rows are
    split over helper lanes) on the scene with every kind (a legacy plane
    too) and on the flagship's 141 cubes and rect: bit-equal to the
    one-thread-per-lane function it replaced (both g++ builds of the same
    arithmetic) and to itself over one warp (tasks of 32, no helper
    lanes), occlusion_plain's output
    but for a hit within one rounding of maxt, every output written, a dead
    lane not blocked."""
    _, occlusion = host_brute
    scene, rays, maxt = brute_case(name)
    rays[6] = 0.0  # shadow rays carry time 0
    share = {"case_mask": None, "few_live": 0.05, "all_dead": 0.0}[act]
    if share is not None:
        rays[7] = random_act(rays.shape[1], share, seed=4)
    table, ranges = CH.scene_table(scene)
    assert name != "all_kinds" or sorted(k for k, _, _ in ranges) == [0, 1, 2, 3]
    counts = {}
    host = host_shadow(rays, maxt, table, ranges, n_warps=n_warps, counts=counts)
    assert torch.equal(host, occlusion(rays, maxt, table, ranges))
    assert torch.equal(host, host_shadow(rays, maxt, table, ranges, n_warps=1))
    plain = CH.occlusion_plain(rays, maxt, table, ranges)
    assert int((host != plain).sum()) <= 1
    assert not host[rays[7] <= 0].any()
    live = int((rays[7] > 0).sum())
    task = min(32, max(1, -(-live // n_warps)))
    assert counts["live"] == live and counts["task"] == task
    assert counts["warps"] == -(-live // task)
    # a short task's rows are split so that the warp's lanes stay busy
    assert counts["helpers"] == max(g for g in (1, 2, 4, 8, 16, 32) if g == 1 or g * task <= 32)
    assert (counts["helpers"] > 1) == (task <= 16)
    if act == "all_dead":
        assert live == 0 and not host.any()
    else:
        assert 0 < int(plain.sum()) < live
        assert (task == 32) == (n_warps == 1)


@pytest.mark.parametrize("n_threads", [1, 7, 1024])
def test_shadow_table_is_the_twelve_columns_row_major(host_shadow, n_threads):
    """However many threads of a block stage it, the shadow table is
    columns 0..11 of the (17, G) table as rows of 12: w2o, or a legacy
    plane's corners."""
    scene, rays, maxt = brute_case("all_kinds")
    table, ranges = CH.scene_table(scene)
    counts = {}
    host_shadow(rays, maxt, table, ranges, n_threads=n_threads, counts=counts)
    assert torch.equal(counts["stab"], table[:12].T.contiguous())


def test_shadow_smem_formula_is_the_kernels(host_shadow):
    """The kernel's shared memory (csrc/closest_hit.cu::shadow_smem_bytes,
    what occlusion_any_plan reports) is 48 bytes a geom, rows of three whole
    16-byte words, and the table of the brute kernels' cap fits a block."""
    for g in (0, 1, 141, 2049, CH.BRUTE_SMEM_MAX_GEOMS):
        assert host_shadow.smem_bytes(g) == 48 * g == 3 * 16 * g
    assert host_shadow.smem_bytes(CH.BRUTE_SMEM_MAX_GEOMS) <= CH.BRUTE_MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# The closest hits' warp schedule of csrc/closest_hit.cu (brute_warp_kernel),
# run on the host from the same steps: the 16-column table staged by the
# threads of a block, the scan (sweep_scan4 in the closest-hit modes), the
# list of live lanes, then tasks of warp_task list entries, each an emulated
# warp whose lanes run brute_best (a short task's rows split over helper
# lanes, whose winners merge by (t, row) as the kernel's shuffles take them),
# and brute_end on the group's first lane: t, id and the winner's normal.
# ---------------------------------------------------------------------------

BRUTE_WARP_HOST = """
#include "closest_hit.cu"
#include <string.h>
#include <vector>

namespace {
using namespace rtt;

template <bool WANT_N>
void run(const BruteParams& p, int n_threads, int n_warps, float* rows_out, long long* did) {
  const int G = p.G;
  const SweepParams scan = scan_params(p);
  std::vector<F4> buf((brute_smem_bytes(G) + sizeof(F4) - 1) / sizeof(F4) + 1);
  float* rows = reinterpret_cast<float*>(buf.data());
  for (int t = 0; t < n_threads; ++t) stage_rows<kBruteCols>(p.table, G, rows, t, n_threads);
  std::vector<int> live;
  for (long long base = 0; base < p.R; base += kWarpScan) {
    for (int lane = 0; lane < 32; ++lane) {
      const unsigned live4 = sweep_scan4<WANT_N ? kSweepClosestN : kSweepClosest>(
          scan, base + 4 * lane);
      for (int j = 0; j < 4; ++j)
        if ((live4 >> j) & 1u) live.push_back((int)(base + 4 * lane + j));
    }
  }
  const int n = (int)live.size();
  const int task = warp_task(n, n_warps);
  const int g = split_lanes(task);
  long long warps = 0;
  for (int first = 0; first < n; first += task, ++warps) {
    Best best[32];
    Ray ray[32];
    for (int lane = 0; lane < 32; ++lane) {
      const int q = lane / g, e = first + q;
      const bool mine = q < task && e < n;
      ray[lane] = brute_ray(p, (size_t)live[mine ? e : first]);
      best[lane].t = kInf; best[lane].row = -1;
      if (mine) brute_best(p, rows, ray[lane], lane % g, g, best[lane]);
    }
    for (int o = g / 2; o > 0; o >>= 1) {  // the group's merge, as the shuffles take it
      Best next[32];
      for (int lane = 0; lane < 32; ++lane) {
        next[lane] = best[lane];
        best_merge(next[lane], best[lane ^ o].t, best[lane ^ o].row);
      }
      memcpy(best, next, sizeof next);
    }
    for (int lane = 0; lane < 32; ++lane) {
      const int q = lane / g, e = first + q;
      if (q < task && e < n && lane % g == 0)
        brute_end<WANT_N>(p, rows, (size_t)live[e], ray[lane], best[lane]);
    }
  }
  memcpy(rows_out, rows, brute_smem_bytes(G));
  did[0] = n; did[1] = warps; did[2] = task; did[3] = g;
}
}  // namespace

// n_threads: the threads of the block that stage the table (entries t,
// t + n_threads, ...); n_warps: the launch's warps, which a short list is
// shared over.  rows_out: G x 16 floats, the staged table.  did: live
// lanes, warps, lanes a warp takes, lanes a listed lane's rows are split
// over.  n null: brute_closest's outputs, else brute_closest_n's.
extern "C" void brute_warp_host(
    const float* rays, const float* table, float* t, int* id, float* n, long long R, int G,
    const int* ranges, int n_ranges, int motion, int n_threads, int n_warps, float* rows_out,
    long long* did) {
  const BruteParams p = make_brute_params(rays, nullptr, table, t, id, n, nullptr, R, G, ranges,
                                          n_ranges, motion);
  if (n) run<true>(p, n_threads, n_warps, rows_out, did);
  else run<false>(p, n_threads, n_warps, rows_out, did);
}

extern "C" long long brute_smem_bytes_host(int G) { return (long long)brute_smem_bytes(G); }

extern "C" int ranges_ascend_host(int G, const int* ranges, int n_ranges) {
  return ranges_ascend(make_brute_params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                         nullptr, 0, G, ranges, n_ranges, 0));
}
"""


@pytest.fixture(scope="module")
def host_brute_warp(tmp_path_factory):
    """The g++ build of the closest hits' warp schedule behind the
    signatures of `brute_closest[_n]`: closest(rays, table, ranges, motion,
    want_n, n_threads=1, n_warps=1, counts=None) -> (t, id[, n]); `counts`
    receives the live lanes, the warps, the lanes a warp takes, the lanes a
    listed lane's rows are split over and the staged table.  Every output is
    written: the buffers start as NaN and 7."""
    d = tmp_path_factory.mktemp("brute_warp_host")
    src, out = str(d / "brute_warp_host.cpp"), str(d / "libbrute_warp_host.so")
    with open(src, "w") as f:
        f.write(BRUTE_WARP_HOST)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    rng_t = ctypes.POINTER(ctypes.c_int)
    lib.brute_warp_host.argtypes = [p, p, p, p, p, ll, i, rng_t, i, i, i, i, p, p]
    lib.brute_warp_host.restype = None
    lib.brute_smem_bytes_host.argtypes = [i]
    lib.brute_smem_bytes_host.restype = ll
    lib.ranges_ascend_host.argtypes = [i, rng_t, i]
    lib.ranges_ascend_host.restype = i

    def c_ranges(ranges):
        flat = [x for rng in ranges for x in rng]
        return (ctypes.c_int * 12)(*(flat + [0] * (12 - len(flat))))

    def closest(rays, table, ranges, motion, want_n, n_threads=1, n_warps=1, counts=None):
        r, g = rays.shape[1], table.shape[1]
        t = torch.full((r,), float("nan"))
        pid = torch.full((r,), 7, dtype=torch.int32)
        n = torch.full((3, r), float("nan")) if want_n else None
        rows = torch.full((g, 16), float("nan"))
        did = torch.zeros(4, dtype=torch.int64)
        lib.brute_warp_host(
            rays.data_ptr(), table.data_ptr(), t.data_ptr(), pid.data_ptr(),
            n.data_ptr() if want_n else None, r, g, c_ranges(ranges), len(ranges), int(motion),
            n_threads, n_warps, rows.data_ptr(), did.data_ptr())
        if counts is not None:
            counts.update(live=int(did[0]), warps=int(did[1]), task=int(did[2]),
                          helpers=int(did[3]), rows=rows)
        assert not torch.isnan(t).any() and (pid != 7).all()
        assert not want_n or not torch.isnan(n).any()
        return (t, pid, n) if want_n else (t, pid)

    closest.smem_bytes = lib.brute_smem_bytes_host
    closest.ranges_ascend = lambda g, ranges: bool(
        lib.ranges_ascend_host(g, c_ranges(ranges), len(ranges)))
    return closest


@pytest.mark.parametrize("name", ["all_kinds", "golden/ASCII/scene.json", "scenes/glossy.json"])
@pytest.mark.parametrize("act", ["case_mask", "few_live", "all_dead"])
@pytest.mark.parametrize("n_warps", [1, 600])
@pytest.mark.parametrize("want_n", [False, True], ids=["t_id", "t_id_normal"])
def test_brute_schedule_equals_lane_and_plain(host_brute_warp, host_brute, name, act, n_warps,
                                              want_n):
    """The closest hits' warp schedule (staged 16-column rows, scan, live-lane
    list, tasks of 32 or, over 600 warps, short equal shares whose rows are
    split over helper lanes, the winner's normal recomputed) on the scene
    with every kind (a legacy plane and a moving sphere too), the flagship's
    141 cubes and rect, and glossy: bit-equal to the one-thread-per-lane
    function it replaced (both g++ builds of the same arithmetic) and to
    itself over one warp (tasks of 32, no helper lanes); the plain version's
    ids, its t to the file's tolerance; every output written, a dead lane a
    miss with a zero normal."""
    closest, _ = host_brute
    scene, rays, _ = brute_case(name)
    share = {"case_mask": None, "few_live": 0.05, "all_dead": 0.0}[act]
    if share is not None:
        rays[7] = random_act(rays.shape[1], share, seed=4)
    table, ranges = CH.scene_table(scene)
    mo = scene.has_motion
    assert name != "all_kinds" or (mo and sorted(k for k, _, _ in ranges) == [0, 1, 2, 3])
    counts = {}
    host = host_brute_warp(rays, table, ranges, mo, want_n, n_warps=n_warps, counts=counts)
    for other in (closest(rays, table, ranges, mo, want_n),
                  host_brute_warp(rays, table, ranges, mo, want_n, n_warps=1)):
        assert all(torch.equal(x, y) for x, y in zip(host, other))
    plain = (CH.brute_closest_n_plain if want_n else CH.brute_closest_plain)(
        rays, table, ranges, mo)
    assert torch.equal(host[1], plain[1])
    hit = plain[1] >= 0
    assert torch.equal(torch.isinf(host[0]), torch.isinf(plain[0]))
    np.testing.assert_allclose(host[0][hit].numpy(), plain[0][hit].numpy(), rtol=RTOL, atol=ATOL)
    if want_n:
        np.testing.assert_allclose(host[2].numpy(), plain[2].numpy(), rtol=RTOL, atol=ATOL)
        assert not host[2][:, ~hit].any()
    dead = rays[7] <= 0
    assert (host[1][dead] == -1).all() and torch.isinf(host[0][dead]).all()
    live = int((~dead).sum())
    task = min(32, max(1, -(-live // n_warps)))
    assert counts["live"] == live and counts["task"] == task
    assert counts["warps"] == -(-live // task)
    # a short task's rows are split so that the warp's lanes stay busy
    assert counts["helpers"] == max(g for g in (1, 2, 4, 8, 16, 32) if g == 1 or g * task <= 32)
    assert (counts["helpers"] > 1) == (task <= 16)
    if act == "all_dead":
        assert live == 0 and not hit.any()
    else:
        assert 0 < int(hit.sum()) <= live  # glossy's room: every live ray hits


def tie_case():
    """Eight spheres in a row, row 6 of the table made row 3's sphere again
    under its own id, and 64 live rays at row 3's sphere: every ray hits
    both at the same t.  Rows 3 and 6 lie 3 apart, so every split of the rows
    over 2, 4, ..., 32 helper lanes puts them in different slices, row 6's
    the lower."""
    d = {
        "cameras": [{"location": [0, 0, 0], "gaze_vector": [0, 1, 0],
                     "up_vector": [0, 0, 1], "focal_length": 20.0,
                     "sensor_width": 36, "sensor_height": 24}],
        "render": {"resolution_x": 8, "resolution_y": 6},
        "spheres": [{"location": [3.0 * k - 12.0, 20.0, 1.0], "radius": 1.0} for k in range(8)],
    }
    scene = rt.load_scene_dict(d, device="cpu")
    table, ranges = CH.scene_table(scene)
    table[:16, 6] = table[:16, 3]
    rng = np.random.default_rng(5)
    n = 64
    aim = np.array([-3.0, 20.0, 1.0]) + rng.uniform(-0.4, 0.4, size=(n, 3))
    d_ = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    o = torch.zeros((n, 3))
    rays = CH.pack_rays(o, torch.from_numpy(d_), torch.zeros(n))
    return rays, table, ranges


@pytest.mark.parametrize("n_warps,helpers", [(1, 1), (4, 2), (8, 4), (16, 8), (32, 16),
                                             (64, 32)])
@pytest.mark.parametrize("want_n", [False, True], ids=["t_id", "t_id_normal"])
def test_brute_schedule_tie_keeps_the_lower_row_under_every_split(host_brute_warp, host_brute,
                                                                  n_warps, helpers, want_n):
    """Two rows that hit at the same t in different helper slices: the lower
    row wins under every split, as in the one-thread-per-lane function and
    the plain version (strict < in row order)."""
    closest, _ = host_brute
    rays, table, ranges = tie_case()
    counts = {}
    host = host_brute_warp(rays, table, ranges, False, want_n, n_warps=n_warps, counts=counts)
    assert counts["helpers"] == helpers
    assert (host[1] == 3).all()
    assert all(torch.equal(x, y)
               for x, y in zip(host, closest(rays, table, ranges, False, want_n)))
    plain = (CH.brute_closest_n_plain if want_n else CH.brute_closest_plain)(
        rays, table, ranges)
    assert torch.equal(host[1], plain[1])


@pytest.mark.parametrize("n_threads", [1, 7, 1024])
def test_brute_table_is_columns_0_to_14_and_the_id(host_brute_warp, n_threads):
    """However many threads of a block stage it, the closest hits' table is
    columns 0..14 of the (17, G) table and then column 16 as rows of 16:
    w2o or a legacy plane's corners, the velocity, the id; not the kind."""
    scene, rays, _ = brute_case("all_kinds")
    table, ranges = CH.scene_table(scene)
    counts = {}
    host_brute_warp(rays, table, ranges, True, False, n_threads=n_threads, counts=counts)
    assert torch.equal(counts["rows"], torch.cat([table[:15], table[16:]]).T.contiguous())


def test_brute_smem_formula_is_the_kernels(host_brute_warp):
    """The kernel's shared memory (csrc/closest_hit.cu::brute_smem_bytes,
    what brute_closest_plan reports) is 64 bytes a geom, rows of four whole
    16-byte words, and the table of the routing's cap fits a block."""
    for g in (0, 1, 141, 2049, CH.BRUTE_SMEM_MAX_GEOMS):
        assert host_brute_warp.smem_bytes(g) == 64 * g == 4 * 16 * g
    assert host_brute_warp.smem_bytes(CH.BRUTE_SMEM_MAX_GEOMS) <= CH.BRUTE_MAX_SMEM_BYTES


def test_launcher_takes_only_ranges_that_ascend(host_brute_warp):
    """The warp kernels' launcher (csrc/closest_hit.cu::ranges_ascend) takes
    ranges that lie in the table in ascending order, as scene_table makes
    them, and refuses ranges that overlap, descend or leave the table."""
    ok = host_brute_warp.ranges_ascend
    _, table_ranges = CH.scene_table(all_kinds_scene())
    assert ok(5, table_ranges)
    assert ok(9, ((1, 0, 4), (2, 4, 4), (3, 6, 9)))
    assert not ok(9, ((1, 0, 5), (2, 4, 9)))       # overlap
    assert not ok(9, ((2, 4, 9), (1, 0, 4)))       # descend
    assert not ok(9, ((1, 0, 10),))                # past the table
    assert not ok(9, ((1, 3, 2),))                 # reversed


# ---------------------------------------------------------------------------
# csrc/sweep.cuh (chunk_stream.cu, the chunked brute of closest_hit.cu) and
# csrc/bvh_traverse.cu: the chunk sweep with its per-ray cull, the per-ray
# traversal, and the dispatch on a row's own kind
# ---------------------------------------------------------------------------

ACCEL_HOST_LOOP = """
#include "chunk_stream.cu"
#include "bvh_traverse.cu"
template <int MODE, bool CULL>
static void sweep_all(const rtt::SweepParams& p) {
  for (long long i = 0; i < p.R; ++i) rtt::sweep_lane<MODE, CULL>(p, (size_t)i);
}
// mode: 0 closest, 1 closest + normal, 2 any-hit; boxes == null: no cull.
extern "C" void sweep_host(
    int mode, const float* rays, const float* maxt, const float* boxes,
    const float* graze, const float* table, float* t, int* id, float* n,
    uint8_t* blocked, long long R, int G, int chunk, int motion) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, maxt, boxes, graze, table, t, id, n, blocked, R, G, chunk, motion);
  if (mode == 0 && boxes) sweep_all<rtt::kSweepClosest, true>(p);
  else if (mode == 0) sweep_all<rtt::kSweepClosest, false>(p);
  else if (mode == 1) sweep_all<rtt::kSweepClosestN, true>(p);
  else sweep_all<rtt::kSweepAnyHit, true>(p);
}
extern "C" void bvh_host(
    const float* rays, const float* table, const float* boxes, const int* topo,
    const float* graze, float* t, int* id, float* n, long long R, int G, int M,
    int motion) {
  const rtt::BvhParams p = rtt::make_bvh_params(
      rays, table, boxes, topo, graze, t, id, n, R, G, M, motion);
  for (long long i = 0; i < R; ++i) {
    if (n) rtt::bvh_lane<true>(p, (size_t)i);
    else rtt::bvh_lane<false>(p, (size_t)i);
  }
}
"""


@pytest.fixture(scope="module")
def host_accel(tmp_path_factory):
    """The g++ build of the chunk sweep's and the traversal's lane
    functions, behind the signatures of the chunk, chunked-brute and BVH
    wrappers."""
    d = tmp_path_factory.mktemp("accel_host")
    src, out = str(d / "accel_host.cpp"), str(d / "libaccel_host.so")
    with open(src, "w") as f:
        f.write(ACCEL_HOST_LOOP)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_host.argtypes = [i, p, p, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i]
    lib.bvh_host.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i]
    lib.sweep_host.restype = lib.bvh_host.restype = None

    def outputs(r, want_n):
        return (torch.empty(r), torch.empty(r, dtype=torch.int32),
                torch.empty((3, r)) if want_n else None)

    def sweep(mode, rays, maxt, boxes, graze, table, g, chunk, motion):
        r = rays.shape[1]
        t, pid, n = outputs(r, mode == 1)
        blocked = torch.empty(r, dtype=torch.bool)
        lib.sweep_host(
            mode, rays.data_ptr(), None if maxt is None else maxt.data_ptr(),
            None if boxes is None else boxes.data_ptr(),
            None if boxes is None else graze.data_ptr(), table.data_ptr(),
            t.data_ptr(), pid.data_ptr(), n.data_ptr() if mode == 1 else None,
            blocked.data_ptr(), r, g, chunk, int(motion),
        )
        return blocked if mode == 2 else (t, pid, n) if mode == 1 else (t, pid)

    def bvh(rays, table, boxes, topo, graze, motion, want_n):
        r = rays.shape[1]
        t, pid, n = outputs(r, want_n)
        lib.bvh_host(
            rays.data_ptr(), table.data_ptr(), boxes.data_ptr(), topo.data_ptr(),
            graze.data_ptr(), t.data_ptr(), pid.data_ptr(), n.data_ptr() if want_n else None,
            r, table.shape[0], boxes.shape[0], int(motion),
        )
        return (t, pid, n) if want_n else (t, pid)

    return sweep, bvh


def accel_case(name):
    """(scene with chunks of 4 and a BVH, (8, R) rays, maxt): the scene
    with every kind and a moving sphere, or a small zoo scene seen from its
    camera and from inside (rays that start among the geoms)."""
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.accel import lbvh

    if name == "all_kinds":
        scene, rays, maxt = brute_case("all_kinds")
    else:
        scene = models.get(name, n=45, res=(40, 24), device="cpu")
        rng = np.random.default_rng(5)
        o, d, _ = tile_rays(scene.camera, 0, 24, 40, 1)
        n = o.shape[0]
        inside = torch.from_numpy(
            rng.uniform([-3, 0, 0], [3, 8, 1.5], (n, 3)).astype(np.float32))
        rnd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        o = torch.cat([o, inside])[: 2 * n - 3]
        d = torch.cat([d, rnd / rnd.norm(dim=1, keepdim=True)])[: 2 * n - 3]
        n = o.shape[0]
        rays = CH.pack_rays(
            o, d, torch.from_numpy(rng.random(n).astype(np.float32)),
            torch.from_numpy(rng.random(n) < 0.8))
        maxt = torch.from_numpy(rng.uniform(0.5, 25.0, n).astype(np.float32))
    return lbvh.with_bvh(lbvh.with_chunks(scene, 4)), rays, maxt


def assert_same_hits(host, plain, rays):
    assert torch.equal(host[1], plain[1])                       # ids
    hit = plain[1] >= 0
    assert 0 < int(hit.sum()) < rays.shape[1]
    assert torch.equal(torch.isinf(host[0]), torch.isinf(plain[0]))
    np.testing.assert_allclose(host[0][hit].numpy(), plain[0][hit].numpy(), rtol=RTOL, atol=ATOL)
    dead = rays[7] <= 0
    assert (host[1][dead] == -1).all() and torch.isinf(host[0][dead]).all()
    if len(plain) == 3:
        np.testing.assert_allclose(host[2].numpy(), plain[2].numpy(), rtol=RTOL, atol=ATOL)
        assert not host[2][:, ~hit].any()


ACCEL_SCENES = ["all_kinds", "sphere_field", "cube_city"]


@pytest.mark.parametrize("name", ACCEL_SCENES)
@pytest.mark.parametrize("kernel", ["chunk_closest", "chunk_closest_n", "brute_closest_chunked"])
def test_sweep_lane_equals_plain(host_accel, name, kernel):
    """The chunk sweep (cull per ray, rows of mixed kinds, the last chunk
    ragged) against the plain row-order sweep of the same table."""
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS

    sweep, _ = host_accel
    scene, rays, _ = accel_case(name)
    g, motion = scene.n_geoms, scene.has_motion
    assert g % 4  # the last chunk is ragged
    if kernel == "brute_closest_chunked":
        table = CH.pack_geom_table(scene).contiguous()
        plain = CH.brute_closest_chunked_plain(rays, table, motion)
        host = sweep(0, rays, None, None, None, table, g, 3, motion)
    else:
        boxes, graze, table = scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms
        want_n = kernel.endswith("_n")
        plain = getattr(CS, kernel + "_plain")(rays, boxes, graze, table, g, motion)
        host = sweep(int(want_n), rays, None, boxes, graze, table, g, 4, motion)
    assert_same_hits(host, plain, rays)
    # one hit set whatever the route: the kind-sorted brute kernel's
    ref = CH.brute_closest_plain(rays, *CH.scene_table(scene), motion)
    assert torch.equal(plain[0], ref[0]) and torch.equal(plain[1], ref[1])


@pytest.mark.parametrize("name", ACCEL_SCENES)
def test_sweep_any_hit_lane_equals_plain(host_accel, name):
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS

    sweep, _ = host_accel
    scene, rays, maxt = accel_case(name)
    rays[6] = 0.0  # shadow rays carry time 0
    ops = (scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms, scene.n_geoms)
    plain = CS.chunk_occlusion_plain(rays, maxt, *ops)
    host = sweep(2, rays, maxt, *ops, 4, False)
    # a hit within one rounding of maxt may fall on either side
    assert int((host != plain).sum()) <= 1
    assert 0 < int(plain.sum()) < rays.shape[1]
    assert not host[rays[7] <= 0].any()


@pytest.mark.parametrize("name", ACCEL_SCENES)
@pytest.mark.parametrize("want_n", [False, True], ids=["t_id", "t_id_normal"])
def test_bvh_lane_equals_plain(host_accel, name, want_n):
    """The per-ray traversal (own stack, own near child, pruning by best
    t) against the plain row-order sweep of the Morton-ordered table."""
    from ray_tracying_tpu_torch.kernels import bvh_traverse as BT

    _, bvh = host_accel
    scene, rays, _ = accel_case(name)
    ops = (scene.bvh_geoms, scene.bvh_nodes_box, scene.bvh_nodes_topo,
           scene.bvh_nodes_graze)
    plain = (BT.bvh_closest_n_plain if want_n else BT.bvh_closest_plain)(
        rays, *ops, scene.has_motion)
    host = bvh(rays, *ops, scene.has_motion, want_n)
    assert_same_hits(host, plain, rays)
    assert scene.bvh_nodes_topo.shape[0] > 1  # a real tree, not one leaf


# ---------------------------------------------------------------------------
# The warp schedule of csrc/sweep.cuh (sweep_warp_kernel: chunk_closest,
# chunk_closest_n, chunk_occlusion), run on the host from the same step functions: the scan in
# steps of kWarpScan lanes (dead lanes written there, 16-byte stores where
# the rows allow), the list of live lanes, then tasks of 32 list entries,
# each an emulated warp whose 32 lanes run in a loop where the kernel has
# __any_sync, __reduce_min_sync and the lanes of the rank sort.
# ---------------------------------------------------------------------------

WARP_HOST = """
#include "chunk_stream.cu"
#include <algorithm>
#include <vector>

namespace {
using namespace rtt;

// One warp: lanes s[0..31], windows of `cap` chunks; counts into work[0..2]
// as the counting build does, and each lane's geom tests into tests[].
template <int MODE>
void warp_host(const SweepParams& p, SweepLane* s, int nc, int cap, long long* work,
               int* tests, long long* did) {
  std::vector<uint32_t> keys(cap);
  std::vector<uint8_t> order(cap);
  bool want[32];
  const auto any = [&](const bool* f) { return std::any_of(f, f + 32, [](bool b) { return b; }); };
  const auto reach = [&] {
    float r = -kInf;
    for (int l = 0; l < 32; ++l) r = std::max(r, s[l].open ? s[l].best.t : -kInf);
    return r;
  };
  // A chunk on the lanes that want it: each runs all its rows when more
  // than half want it, else each has its rows split over split_lanes(k)
  // helpers (strided rows from its own offset), whose winners or blocked
  // flags merge back into it.
  const auto run = [&](int c) {
    constexpr int LM = kLoopMode<MODE>;
    const int row0 = c * p.chunk;
    const int n_rows = std::min(p.chunk, p.G - row0);
    const float* rows = p.table + (size_t)kGeomCols * row0;
    int k = 0;
    for (int l = 0; l < 32; ++l) k += want[l];
    const int g = split_lanes(k);
    did[g == 1 ? 3 : 2] += 1;
    int most = 0;
    for (int l = 0; l < 32; ++l) {
      if (!want[l]) continue;
      if (g == 1) {
        const int ran = sweep_rows<LM, true>(p, s[l], rows, row0, n_rows);
        work[0] += ran; tests[l] += ran;
        most = std::max(most, ran);
        continue;
      }
      SweepLane group = sweep_helper(s[l]);
      for (int h = 0; h < g; ++h) {
        SweepLane helper = sweep_helper(s[l]);
        const int ran = sweep_rows<LM, true>(p, helper, rows, row0, n_rows, h, g);
        work[0] += ran; tests[l] += ran;
        most = std::max(most, ran);
        sweep_merge<LM>(group, helper.best.t, helper.best.row, helper.blocked);
      }
      sweep_merge<LM>(s[l], group.best.t, group.best.row, group.blocked);
    }
    work[2] += 32 * most;
  };
  const auto wants = [&](int c) {
    for (int l = 0; l < 32; ++l) {
      work[1] += s[l].open;
      want[l] = sweep_wants_box<MODE>(p.boxes + 6 * c, p.graze[c], s[l]);
    }
    return any(want);
  };
  if (!p.boxes) {  // BOXES false (warp_sweep_all): every chunk in row order on the live lanes
    for (int l = 0; l < 32; ++l) want[l] = s[l].open;
    if (!any(want)) return;
    for (int c = 0; c < nc; ++c) run(c);
    return;
  }
  if (MODE == kSweepAnyHit) {
    for (int c = 0; c < nc; ++c) {
      bool open[32];
      for (int l = 0; l < 32; ++l) open[l] = s[l].open;
      if (!any(open)) break;
      if (wants(c)) run(c);
    }
    return;
  }
  for (int w0 = 0; w0 < nc; w0 += cap) {
    const int wn = std::min(cap, nc - w0);
    for (int j = 0; j < wn; ++j) {
      uint32_t least = kNoKey;
      for (int l = 0; l < 32; ++l)
        least = std::min(least, sweep_key(p.boxes + 6 * (w0 + j), p.graze[w0 + j], s[l]));
      keys[j] = least;
    }
    for (int l = 0; l < 32; ++l) work[1] += s[l].open ? wn : 0;
    int m = 0;
    for (int l = 0; l < 32; ++l) m = order_window(keys.data(), order.data(), wn, l, 32);
    float r = reach();
    for (int q = 0; q < m; ++q) {
      const int j = order[q];
      if (key_dist(keys[j]) > r) break;
      if (!wants(w0 + j)) continue;
      run(w0 + j);
      r = reach();
    }
  }
}

template <int MODE>
void sweep_warps(const SweepParams& p, int cap, int n_warps, long long* work, int* tests,
                 long long* did) {
  std::vector<int> live;
  for (long long base = 0; base < p.R; base += kWarpScan) {
    for (int lane = 0; lane < 32; ++lane) {
      const unsigned live4 = sweep_scan4<MODE>(p, base + 4 * lane);
      for (int j = 0; j < 4; ++j)
        if ((live4 >> j) & 1u) live.push_back((int)(base + 4 * lane + j));
    }
  }
  const int nc = (p.G + p.chunk - 1) / p.chunk;
  const int n = (int)live.size();
  const int task = warp_task(n, n_warps);
  long long warps = 0;
  for (int first = 0; first < n; first += task, ++warps) {
    SweepLane s[32];
    int lane_tests[32] = {0};
    for (int l = 0; l < 32; ++l) {
      sweep_idle(s[l]);
      if (l < task && first + l < n) sweep_begin<MODE>(p, (size_t)live[first + l], s[l]);
    }
    warp_host<MODE>(p, s, nc, cap, work, lane_tests, did);
    for (int l = 0; l < task && first + l < n; ++l) {
      sweep_winner_normal<MODE>(p, s[l]);
      sweep_end<MODE>(p, (size_t)live[first + l], s[l]);
      tests[live[first + l]] = lane_tests[l];
    }
  }
  did[0] = n; did[1] = warps;  // did[2], did[3]: counted by warp_host
}
}  // namespace

// mode: 0 closest, 1 closest + normal, 2 any-hit; boxes null: the sweep
// without boxes (brute_closest_chunked).
extern "C" void sweep_warp_host(
    int mode, const float* rays, const float* maxt, const float* boxes, const float* graze,
    const float* table, float* t, int* id, float* n, uint8_t* blocked, long long R, int G,
    int chunk, int motion, int cap, int n_warps, long long* work, int* tests, long long* did) {
  const SweepParams p = make_sweep_params(
      rays, maxt, boxes, graze, table, t, id, n, blocked, R, G, chunk, motion);
  if (mode == 0) sweep_warps<kSweepClosest>(p, cap, n_warps, work, tests, did);
  else if (mode == 1) sweep_warps<kSweepClosestN>(p, cap, n_warps, work, tests, did);
  else sweep_warps<kSweepAnyHit>(p, cap, n_warps, work, tests, did);
}

extern "C" void sweep_layout_host(int nc, int chunk, int boxes, long long* out) {
  const SweepLayout o = sweep_layout(nc, chunk, boxes != 0);
  out[0] = (long long)o.keys; out[1] = (long long)o.order; out[2] = (long long)o.ring;
  out[3] = (long long)o.boxes; out[4] = (long long)o.bytes; out[5] = ring_rows(chunk);
  out[6] = kSweepWarps; out[7] = kOrderCap; out[8] = kStageChunks;
}

extern "C" unsigned order_key_host(float e) { return order_key(e); }
extern "C" float key_dist_host(unsigned k) { return key_dist(k); }
"""


@pytest.fixture(scope="module")
def host_warp(tmp_path_factory):
    """The g++ build of the warp schedule behind the chunk wrappers'
    signatures: sweep(mode, rays, maxt, boxes, graze, table, g, chunk,
    motion, cap=kOrderCap, n_warps=1, counts=None) -> outputs (boxes None:
    the sweep without boxes of brute_closest_chunked); n_warps: the
    launch's warps, which a short list is shared over; `counts` receives what
    the schedule ran (lane geom tests, lane box tests, warp lane slots, the
    live lanes, the warps, the chunks a warp ran with rows split over helper
    lanes and those it ran whole, and each lane's geom tests).  Every output is
    written: the buffers start as NaN / 7 / 7."""
    d = tmp_path_factory.mktemp("warp_host")
    src, out = str(d / "warp_host.cpp"), str(d / "libwarp_host.so")
    with open(src, "w") as f:
        f.write(WARP_HOST)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sweep_warp_host.argtypes = [i, p, p, p, p, p, p, p, p, p, ll, i, i, i, i, i, p, p, p]
    lib.sweep_layout_host.argtypes = [i, i, i, ctypes.POINTER(ll)]
    lib.order_key_host.argtypes = [ctypes.c_float]
    lib.order_key_host.restype = ctypes.c_uint
    lib.key_dist_host.argtypes = [ctypes.c_uint]
    lib.key_dist_host.restype = ctypes.c_float
    lib.sweep_warp_host.restype = lib.sweep_layout_host.restype = None

    def sweep(mode, rays, maxt, boxes, graze, table, g, chunk, motion, cap=None, n_warps=1,
              counts=None):
        r = rays.shape[1]
        t = torch.full((r,), float("nan"))
        pid = torch.full((r,), 7, dtype=torch.int32)
        n = torch.full((3, r), float("nan"))
        blocked = torch.full((r,), 7, dtype=torch.uint8)
        work = torch.zeros(3, dtype=torch.int64)
        tests = torch.zeros(r, dtype=torch.int32)
        did = torch.zeros(4, dtype=torch.int64)
        lib.sweep_warp_host(
            mode, rays.data_ptr(), None if maxt is None else maxt.data_ptr(),
            None if boxes is None else boxes.data_ptr(),
            None if boxes is None else graze.data_ptr(), table.data_ptr(), t.data_ptr(),
            pid.data_ptr(), n.data_ptr(), blocked.data_ptr(), r, g, chunk, int(motion),
            cap or layout(1)["order_cap"], n_warps, work.data_ptr(), tests.data_ptr(),
            did.data_ptr(),
        )
        if counts is not None:
            counts.update(tests=int(work[0]), box_tests=int(work[1]), slots=int(work[2]),
                          live=int(did[0]), warps=int(did[1]), split_chunks=int(did[2]),
                          whole_chunks=int(did[3]), lane_tests=tests)
        if mode == 2:
            assert int(blocked.max()) <= 1
            return blocked.bool()
        return (t, pid, n) if mode == 1 else (t, pid)

    def layout(nc, chunk=256, boxes=True):
        res = (ll * 9)()
        lib.sweep_layout_host(nc, chunk, int(boxes), res)
        return dict(zip(("keys", "order", "ring", "boxes", "bytes", "ring_rows", "warps",
                         "order_cap", "stage_chunks"), list(res)))

    sweep.layout = layout
    sweep.order_key = lib.order_key_host
    sweep.key_dist = lib.key_dist_host
    return sweep


WARP_KERNELS = {"chunk_closest": 0, "chunk_closest_n": 1, "chunk_occlusion": 2}


def warp_case(name, kernel, act_share=None, seed=8):
    """(operands, plain output, rays, maxt) of `kernel` on accel_case(name),
    shadow rays at time 0 for the any-hit; act_share: a random act mask with
    that share of live lanes instead of accel_case's."""
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS

    scene, rays, maxt = accel_case(name)
    if act_share is not None:
        rays[7] = torch.from_numpy(
            (np.random.default_rng(seed).random(rays.shape[1]) < act_share).astype(np.float32))
    ops = (scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms, scene.n_geoms)
    if kernel == "chunk_occlusion":
        rays[6] = 0.0
        return ops, CS.chunk_occlusion_plain(rays, maxt, *ops), rays, maxt, False
    plain = getattr(CS, kernel + "_plain")(rays, *ops, scene.has_motion)
    return ops, plain, rays, None, scene.has_motion


def assert_warp_same(host, lane, plain, rays, kernel):
    """The warp schedule against the one-thread-per-lane schedule (g++ builds
    of the same arithmetic: bit-equal) and against the plain version (ids
    equal; t and normals to the host tolerance)."""
    if kernel == "chunk_occlusion":
        assert torch.equal(host, lane)
        assert int((host != plain).sum()) <= 1  # a hit within one rounding of maxt
        assert not host[rays[7] <= 0].any()
        return
    for a, b in zip(host, lane):
        assert torch.equal(a, b)
    assert_same_hits(host, plain, rays)


@pytest.mark.parametrize("name", ACCEL_SCENES)
@pytest.mark.parametrize("kernel", sorted(WARP_KERNELS))
@pytest.mark.parametrize("act", ["case_mask", "few_live"])
@pytest.mark.parametrize("n_warps", [1, 600])
def test_warp_schedule_equals_plain(host_warp, host_accel, name, kernel, act, n_warps):
    """The warp schedule (scan, live-lane list, warps of 32, nearest chunk
    first with the (t, row) merge; any-hit in row order) on the scene with
    every kind and a moving sphere and on two zoo scenes, chunks of 4, the
    last ragged, a random act mask or few live lanes (warps mostly of
    lanes that are not theirs in the tile), the list dealt in tasks of 32
    or, over 600 warps, in short equal shares; every output written, a dead
    lane a miss."""
    sweep, _ = host_accel
    ops, plain, rays, maxt, motion = warp_case(
        name, kernel, act_share=0.05 if act == "few_live" else None)
    mode = WARP_KERNELS[kernel]
    counts = {}
    host = host_warp(mode, rays, maxt, *ops, 4, motion, n_warps=n_warps, counts=counts)
    lane = sweep(mode, rays, maxt, *ops, 4, motion)
    assert_warp_same(host, lane, plain, rays, kernel)
    live = int((rays[7] > 0).sum())
    task = min(32, max(1, -(-live // n_warps)))
    assert counts["live"] == live and counts["warps"] == -(-live // task)
    assert (task == 32) == (n_warps == 1)
    assert counts["split_chunks"] > 0          # chunks few lanes of a warp want
    if act == "case_mask" and task == 32:
        assert counts["whole_chunks"] > 0      # and chunks most of a warp wants
    if task <= 16:
        assert counts["whole_chunks"] == 0     # a short task always splits
    if kernel != "chunk_occlusion":
        dead = rays[7] <= 0
        assert (host[1][dead] == -1).all() and torch.isinf(host[0][dead]).all()
        assert len(host) == 2 or not host[2][:, dead].any()
    assert not counts["lane_tests"][rays[7] <= 0].any()


@pytest.mark.parametrize("kernel", sorted(WARP_KERNELS))
@pytest.mark.parametrize("width", [4 * 128 * 3, 4 * 128 * 3 + 2])
def test_warp_schedule_scan_widths(host_warp, kernel, width):
    """Widths with and without the scan's 16-byte stores (a multiple of 4
    and not), an all-dead tile and a tile whose live lanes are not a
    multiple of 32."""
    scene, rays, maxt = accel_case("sphere_field")
    idx = torch.arange(width) % rays.shape[1]
    rays, maxt = rays[:, idx].contiguous(), maxt[idx].contiguous()
    mode = WARP_KERNELS[kernel]
    ops = (scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms, scene.n_geoms)
    for live in (0, 37):
        rays[7] = 0.0
        rays[7, torch.from_numpy(np.random.default_rng(live).choice(width, live, replace=False))] = 1.0
        counts = {}
        host = host_warp(mode, rays, maxt if mode == 2 else None, *ops, 4, False, counts=counts)
        assert counts["live"] == live and counts["warps"] == -(-live // 32)
        if mode == 2:
            assert int(host.sum()) <= live
            assert not host[rays[7] <= 0].any()
        else:
            dead = rays[7] <= 0
            assert torch.isinf(host[0][dead]).all() and (host[1][dead] == -1).all()
            assert not torch.isnan(host[0]).any()
            if mode == 1:
                assert not host[2][:, dead].any() and not torch.isnan(host[2]).any()
            plain = CH.mixed_closest_plain(rays, scene.chunk_geoms, scene.n_geoms, False,
                                           want_n=mode == 1)
            assert torch.equal(host[1], plain[1])


@pytest.mark.parametrize("cap", [1, 3, 7])
def test_warp_schedule_windows(host_warp, host_accel, cap):
    """More chunks than a warp orders at once: the chunks go window by
    window, each nearest first, and the result is the same."""
    sweep, _ = host_accel
    ops, plain, rays, _, motion = warp_case("sphere_field", "chunk_closest_n")
    assert ops[0].shape[0] > cap
    host = host_warp(1, rays, None, *ops, 4, motion, cap=cap)
    assert_warp_same(host, sweep(1, rays, None, *ops, 4, motion), plain, rays, "chunk_closest_n")


def test_warp_schedule_tie_across_chunks_keeps_the_lowest_row(host_warp, host_accel):
    """The same sphere twice, in two chunks: rows 0 and 2.  The chunk of
    row 2 also holds a small sphere near the camera, so its box is entered
    first and the warp visits it first; the chunk of row 0 can only tie
    (its box is re-tested with <=) and its row wins the tie, as in the
    row-order sweep, by the (t, row) merge."""
    from ray_tracying_tpu_torch.accel import lbvh

    sweep, _ = host_accel
    s = {"location": [0.0, 10.0, 0.0], "radius": 1.0}
    scene = rt.load_scene_dict(camera_dict(spheres=[
        s, {"location": [0.0, 20.0, 0.0], "radius": 1.0},
        s, {"location": [0.6, 2.0, 0.0], "radius": 0.3}]), device="cpu")
    table = CH.pack_geom_table(scene).contiguous()        # load order: rows 0..3
    aabbs = lbvh.geom_aabbs(scene)
    boxes = torch.from_numpy(np.concatenate(
        [np.concatenate([aabbs[k:k + 2, :3].min(0), aabbs[k:k + 2, 3:].max(0)])[None]
         for k in (0, 2)]).astype(np.float32))
    graze = torch.from_numpy(lbvh.chunk_graze(table.numpy(), 2))
    assert float(boxes[1, 1]) < float(boxes[0, 1])          # row 2's chunk is nearer
    rng = np.random.default_rng(12)
    n = 300
    d = np.stack([rng.normal(0, 0.03, n), np.ones(n), rng.normal(0, 0.03, n)], axis=1)
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    rays = CH.pack_rays(torch.zeros((n, 3)), d, torch.zeros(n))
    plain = CH.mixed_closest_plain(rays, table, 4, False, want_n=True)
    assert (plain[1] == 0).sum() > n // 2 and not (plain[1] == 2).any()
    for mode in (0, 1):
        host = host_warp(mode, rays, None, boxes, graze, table, 4, 2, False)
        assert torch.equal(host[1], plain[1])
        assert torch.equal(host[1], sweep(mode, rays, None, boxes, graze, table, 4, 2, False)[1])


def test_warp_schedule_lane_without_a_hit_skips_the_boxes_it_misses(host_warp):
    """Lanes that have no hit (best t = +inf) beside boxes they miss: rays
    parallel to an axis and outside the boxes' slab there, or pointing away
    from the scene, in the same warps as rays that hit.  A missed box
    is never wanted, though its entry distance may read +inf and the
    lane's bound is +inf: those lanes run no geom test."""
    scene, rays, _ = accel_case("sphere_field")
    n = rays.shape[1]
    miss = torch.arange(n) % 3 == 0
    rays[7] = 1.0
    rays[0, miss] = 1000.0                              # far off the scene in x ...
    rays[3, miss] = 0.0                                 # ... and parallel to x
    away = torch.arange(n) % 3 == 1
    rays[3:6, away] = -rays[3:6, away]
    rays[4, away] = -rays[4, away].abs() - 0.5         # back, away from the field
    rays[3:6, away] /= rays[3:6, away].norm(dim=0)
    ops = (scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms, scene.n_geoms)
    counts = {}
    host = host_warp(1, rays, None, *ops, 4, False, counts=counts)
    plain = CH.mixed_closest_plain(rays, scene.chunk_geoms, scene.n_geoms, False, want_n=True)
    assert torch.equal(host[1], plain[1])
    assert (host[1][miss] == -1).all() and not counts["lane_tests"][miss].any()
    hit = plain[1] >= 0
    assert int(hit.sum()) > n // 10 and counts["tests"] > 0
    # Warps of such lanes alone rank no chunk: each lane's one key test a
    # chunk is all they run.
    alone = rays[:, miss].contiguous()
    counts = {}
    host = host_warp(1, alone, None, *ops, 4, False, counts=counts)
    assert (host[1] == -1).all()
    nc = scene.chunk_boxes.shape[0]
    assert counts["tests"] == counts["slots"] == 0
    assert counts["box_tests"] == alone.shape[1] * nc


def test_order_key_is_the_float_order(host_warp):
    """The chunks' keys order as their entry distances: negative, -0 just
    below +0, +inf last but below the no-key mark, and back."""
    vals = [-float("inf"), -3e38, -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.5, 2.5, 3e38, float("inf")]
    keys = [host_warp.order_key(v) for v in vals]
    assert keys == sorted(keys) and len(set(keys)) == len(keys) and keys[-1] < 0xffffffff
    back = [host_warp.key_dist(k) for k in keys]
    assert [np.float32(x).tobytes() for x in back] == [np.float32(v).tobytes() for v in vals]


def test_warp_layout_is_aligned_and_stages_boxes_up_to_its_cap(host_warp):
    """The shared memory the warp kernel's launcher sizes: 16-byte aligned
    regions, two ring buffers a warp of whole 16-byte rows, the box table (7
    floats a chunk) while it fits the staging cap.  A chunk that gives no
    whole 16-byte copies gets no ring rows, which the launcher refuses."""
    for nc, chunk, rows in [(79, 256, 32), (2, 4, 4), (4, 12, 12), (1024, 256, 32),
                            (1025, 256, 32), (3, 6, 0), (2, 40, 0)]:
        o = host_warp.layout(nc, chunk)
        for key in ("keys", "order", "ring", "boxes"):
            assert o[key] % 16 == 0 or key == "order"
        assert o["order"] == o["keys"] + 4 * o["order_cap"] * o["warps"]
        assert o["ring_rows"] == rows
        ring_bytes = 2 * 4 * 17 * rows * o["warps"]
        assert o["boxes"] == o["ring"] + ring_bytes and (17 * 4 * rows) % 16 == 0
        staged = 28 * nc if nc <= o["stage_chunks"] else 0
        assert o["bytes"] == o["boxes"] + staged
    assert host_warp.layout(79)["bytes"] < 48 * 1024


@pytest.mark.parametrize("name", ACCEL_SCENES)
@pytest.mark.parametrize("act", ["case_mask", "few_live"])
@pytest.mark.parametrize("n_warps", [1, 600])
def test_no_box_sweep_equals_plain(host_warp, host_accel, name, act, n_warps):
    """brute_closest_chunked's warp schedule (the sweep without boxes: scan,
    live-lane list, warps of 32 or, over 600 warps, short shares whose rows
    are split over helper lanes, every chunk in row order) over the
    load-order table, chunks of 4, the last ragged: bit-equal to the
    one-thread-per-lane sweep it replaced, the plain version's ids and t;
    every live lane runs every row, no box is tested."""
    sweep, _ = host_accel
    scene, rays, _ = accel_case(name)
    if act == "few_live":
        rays[7] = random_act(rays.shape[1], 0.05, seed=3)
    g, mo = scene.n_geoms, scene.has_motion
    table = CH.pack_geom_table(scene).contiguous()
    counts = {}
    host = host_warp(0, rays, None, None, None, table, g, 4, mo, n_warps=n_warps,
                     counts=counts)
    lane = sweep(0, rays, None, None, None, table, g, 4, mo)
    assert all(torch.equal(a, b) for a, b in zip(host, lane))
    assert_same_hits(host, CH.brute_closest_chunked_plain(rays, table, mo), rays)
    live = int((rays[7] > 0).sum())
    task = min(32, max(1, -(-live // n_warps)))
    assert counts["live"] == live and counts["warps"] == -(-live // task)
    assert counts["tests"] == live * g and counts["box_tests"] == 0
    assert not counts["lane_tests"][rays[7] <= 0].any()
    assert (counts["lane_tests"][rays[7] > 0] == g).all()
    if task <= 16:
        assert counts["whole_chunks"] == 0 and counts["split_chunks"] > 0


def test_no_box_layout_reserves_no_keys_and_stages_no_boxes(host_warp):
    """Without boxes the warp kernel's shared memory is the mbarriers and the
    rings: no keys, no order entries, no staged boxes, whatever the chunks."""
    for nc, chunk in [(40, 512), (3, 4), (2000, 256)]:
        o = host_warp.layout(nc, chunk, boxes=False)
        assert o["order"] == o["keys"] == o["ring"] == 16 * o["warps"]
        assert o["bytes"] == o["boxes"] == o["ring"] + 2 * 4 * 17 * o["ring_rows"] * o["warps"]
        assert o["bytes"] < host_warp.layout(nc, chunk)["bytes"]


# ---------------------------------------------------------------------------
# The traversal's warp schedule of csrc/bvh_traverse.cu (bvh_warp_kernel), run
# on the host from the same steps: the scan (sweep_scan4 in the closest-hit
# modes), the list of live lanes, then tasks of warp_task list entries, each
# an emulated warp of 32 lanes in a while-while loop: the root's test
# (bvh_begin), inner nodes by their packed records (bvh_visit: both children
# tested, the nearer entered, the other pushed as (node, e)), leaves held
# back until no lane of the loop lacks one (bvh_postpone), then the leaf step
# of every open lane (bvh_leaf_step, merging by (t, row)), and the outputs
# with the winner's normal recomputed (bvh_end).
# ---------------------------------------------------------------------------

BVH_WARP_HOST = """
#include "bvh_traverse.cu"
#include <algorithm>
#include <vector>

namespace {
using namespace rtt;

template <bool WANT_N>
void run(const BvhWarpParams& p, int n_warps, long long* work, int* lane_visits,
         long long* did) {
  const SweepParams scan = bvh_scan_params(p);
  std::vector<int> live;
  for (long long base = 0; base < p.R; base += kWarpScan) {
    for (int lane = 0; lane < 32; ++lane) {
      const unsigned live4 = sweep_scan4<WANT_N ? kSweepClosestN : kSweepClosest>(
          scan, base + 4 * lane);
      for (int j = 0; j < 4; ++j)
        if ((live4 >> j) & 1u) live.push_back((int)(base + 4 * lane + j));
    }
  }
  const int n = (int)live.size();
  const int task = warp_task(n, n_warps);
  const bool motion = p.motion != 0;
  long long warps = 0, most_stack = 0;
  for (int first = 0; first < n; first += task, ++warps) {
    BvhLane s[32];
    BvhStack st[32];
    BvhWork w[32] = {};
    for (int l = 0; l < 32; ++l) {
      const bool mine = l < task && first + l < n;
      bvh_begin<true>(p, mine ? (size_t)live[first + l] : 0, mine, s[l], w[l]);
    }
    for (;;) {
      bool open = false;
      for (int l = 0; l < 32; ++l) open = open || bvh_open(s[l]);
      if (!open) break;
      bool in[32];
      for (int l = 0; l < 32; ++l) in[l] = bvh_is_inner(s[l].cur);
      while (std::any_of(in, in + 32, [](bool b) { return b; })) {
        work[3] += 32;
        bool lacking = false;
        for (int l = 0; l < 32; ++l) {
          if (!in[l]) continue;
          bvh_visit<true>(p.inner, s[l], st[l], w[l]);
          most_stack = std::max(most_stack, (long long)s[l].sp);
          bvh_postpone(s[l], st[l]);
          lacking = lacking || s[l].leaf == kBvhNone;
        }
        for (int l = 0; l < 32; ++l)
          if (in[l]) in[l] = lacking && bvh_is_inner(s[l].cur);
      }
      int most = 0;
      for (int l = 0; l < 32; ++l) {
        if (!bvh_open(s[l])) continue;
        const int ran = bvh_leaf_step(p.rows, s[l], st[l], motion);
        w[l].tests += ran;
        most = std::max(most, ran);
      }
      work[3] += 32 * most;
    }
    for (int l = 0; l < 32; ++l) {
      work[0] += w[l].visits; work[1] += w[l].boxes; work[2] += w[l].tests;
      if (l < task && first + l < n) {
        bvh_end<WANT_N>(p, (size_t)live[first + l], s[l]);
        lane_visits[live[first + l]] = (int)w[l].visits;
      }
    }
  }
  did[0] = n; did[1] = warps; did[2] = task; did[3] = most_stack;
}
}  // namespace

// n null: bvh_closest's outputs, else bvh_closest_n's.  work: visits, box
// tests, geom tests, lane slots; lane_visits:
// each listed lane's inner-node visits; did: live lanes, warps, lanes a warp
// takes, the deepest stack.
extern "C" void bvh_warp_host(
    const float* rays, const float* boxes, const int* topo, const float* graze,
    const float* inner, const float* rows, float* t, int* id, float* n, long long R, int G,
    int motion, int n_warps, long long* work, int* lane_visits, long long* did) {
  const BvhWarpParams p = make_bvh_warp_params(rays, boxes, topo, graze, inner, rows, t, id, n,
                                               R, G, motion, nullptr);
  if (n) run<true>(p, n_warps, work, lane_visits, did);
  else run<false>(p, n_warps, work, lane_visits, did);
}

extern "C" void bvh_consts_host(long long* out) {
  out[0] = kBvhStackMax; out[1] = kLeafCountBits; out[2] = kBvhMaxGeoms; out[3] = kBvhCols;
  out[4] = kBvhThreads;
}
"""


@pytest.fixture(scope="module")
def host_bvh_warp(tmp_path_factory):
    """The g++ build of the traversal's warp schedule behind the signatures
    of `bvh_closest[_n]`: bvh(rays, scene_or_arrays, want_n, n_warps=1,
    counts=None) -> (t, id[, n]), the tree given as (table,
    boxes, topo, graze) or a scene that carries it; `counts` receives the
    inner nodes visited, box tests, geom tests and lane slots, the live
    lanes, warps, the lanes a warp takes, the deepest stack and each lane's
    visits.  Every output is written: the buffers start as NaN and -7."""
    from ray_tracying_tpu_torch.accel import lbvh

    d = tmp_path_factory.mktemp("bvh_warp_host")
    src, out = str(d / "bvh_warp_host.cpp"), str(d / "libbvh_warp_host.so")
    with open(src, "w") as f:
        f.write(BVH_WARP_HOST)
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-I", CSRC,
         "-shared", "-fPIC", "-o", out, src],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bvh_warp_host.argtypes = [p] * 9 + [ll, i, i, i, p, p, p]
    lib.bvh_warp_host.restype = None
    lib.bvh_consts_host.argtypes = [p]
    lib.bvh_consts_host.restype = None

    def bvh(rays, tree, want_n, n_warps=1, counts=None, motion=None):
        if hasattr(tree, "bvh_geoms"):
            motion = tree.has_motion if motion is None else motion
            tree = (tree.bvh_geoms, tree.bvh_nodes_box, tree.bvh_nodes_topo,
                    tree.bvh_nodes_graze)
        table, boxes, topo, graze = tree
        inner, rows = (torch.from_numpy(x) for x in lbvh.pack_bvh(
            *(x.numpy() for x in tree)))
        r = rays.shape[1]
        t = torch.full((r,), float("nan"))
        pid = torch.full((r,), -7, dtype=torch.int32)
        n = torch.full((3, r), float("nan")) if want_n else None
        work = torch.zeros(4, dtype=torch.int64)
        visits = torch.zeros(r, dtype=torch.int32)
        did = torch.zeros(4, dtype=torch.int64)
        lib.bvh_warp_host(
            rays.data_ptr(), boxes.data_ptr(), topo.data_ptr(), graze.data_ptr(),
            inner.data_ptr(), rows.data_ptr(), t.data_ptr(), pid.data_ptr(),
            n.data_ptr() if want_n else None, r, table.shape[0], int(bool(motion)),
            n_warps, work.data_ptr(), visits.data_ptr(), did.data_ptr())
        if counts is not None:
            counts.update(visits=int(work[0]), box_tests=int(work[1]), tests=int(work[2]),
                          slots=int(work[3]), live=int(did[0]), warps=int(did[1]),
                          task=int(did[2]), deepest_stack=int(did[3]), lane_visits=visits)
        assert not torch.isnan(t).any() and (pid != -7).all()
        assert not want_n or not torch.isnan(n).any()
        return (t, pid, n) if want_n else (t, pid)

    def consts():
        res = (ll * 5)()
        lib.bvh_consts_host(res)
        return dict(zip(("stack_max", "leaf_count_bits", "max_geoms", "cols", "threads"),
                        list(res)))

    bvh.consts = consts
    return bvh


def bvh_case(name, seed=8):
    """(scene with a BVH, (8, R) rays) of accel_case, or a random scene of
    spheres and cubes of random sizes (a new tree for each seed) seen from
    its camera and from inside, with a random act mask."""
    from ray_tracying_tpu_torch.accel import lbvh

    if name != "random":
        scene, rays, _ = accel_case(name)
        return scene, rays
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-8, 6, -3], [8, 30, 3], (40, 3))
    scene = rt.load_scene_dict(camera_dict(
        spheres=[{"location": q.tolist(), "radius": float(rng.uniform(0.2, 2.0))}
                 for q in pos[:25]],
        cubes=[{"translation": q.tolist(), "rotation": rng.uniform(0, 90, 3).tolist(),
                "scale": rng.uniform(0.3, 2.5, 3).tolist()} for q in pos[25:]],
    ), device="cpu")
    n = 700
    d = np.concatenate([rng.uniform([-0.5, 1, -0.2], [0.5, 1, 0.2], (n // 2, 3)),
                        rng.normal(size=(n - n // 2, 3))])
    o = np.concatenate([np.zeros((n // 2, 3)), rng.uniform([-8, 6, -3], [8, 30, 3],
                                                          (n - n // 2, 3))])
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    rays = CH.pack_rays(torch.from_numpy(o.astype(np.float32)), d, torch.zeros(n),
                        torch.from_numpy(rng.random(n) < 0.85))
    return lbvh.with_bvh(scene), rays


BVH_CASES = ["all_kinds", "sphere_field", "cube_city", "random"]


def assert_bvh_same(host, lane, plain, rays):
    """The warp schedule against the one-thread-per-lane traversal (g++
    builds of the same arithmetic: bit-equal) and against the plain version
    (ids equal, t and normals to the file's tolerance)."""
    for a, b in zip(host, lane):
        assert torch.equal(a, b)
    assert_same_hits(host, plain, rays)


@pytest.mark.parametrize("name", BVH_CASES)
@pytest.mark.parametrize("want_n", [False, True], ids=["t_id", "t_id_normal"])
@pytest.mark.parametrize("per_warp", [32, 12], ids=["full_tasks", "short_tasks"])
def test_bvh_warp_schedule_equals_lane_and_plain(host_bvh_warp, host_accel, name, want_n,
                                                 per_warp):
    """The traversal's warp schedule (packed records, order by entry
    distance, the (node, e) stack, a warp in a while-while loop, the
    winner's normal recomputed) on the scene with every kind and a moving
    sphere, two zoo scenes and a random tree, with dead lanes: bit-equal to
    the one-thread-per-lane traversal it replaced, the plain version's ids
    and t; a dead lane a miss with a zero normal; a lane runs no more geom
    tests than the table has rows, its stack stays within the tree's depth,
    and the warp's lane slots hold every visit and test."""
    from ray_tracying_tpu_torch.accel import lbvh
    from ray_tracying_tpu_torch.kernels import bvh_traverse as BT

    _, lane_bvh = host_accel
    scene, rays = bvh_case(name)
    ops = (scene.bvh_geoms, scene.bvh_nodes_box, scene.bvh_nodes_topo,
           scene.bvh_nodes_graze)
    mo = scene.has_motion
    counts = {}
    live = int((rays[7] > 0).sum())
    n_warps = -(-live // per_warp)
    host = host_bvh_warp(rays, scene, want_n, n_warps, counts=counts)
    plain = (BT.bvh_closest_n_plain if want_n else BT.bvh_closest_plain)(rays, *ops, mo)
    assert_bvh_same(host, lane_bvh(rays, *ops, mo, want_n), plain, rays)
    dead = rays[7] <= 0
    assert dead.any() and (host[1][dead] == -1).all() and torch.isinf(host[0][dead]).all()
    assert not want_n or not host[2][:, dead].any()
    task = min(32, max(1, -(-live // n_warps)))
    assert counts["live"] == live and counts["task"] == task and task <= per_warp
    assert counts["warps"] == -(-live // task) and (task == 32) == (per_warp == 32)
    assert not counts["lane_visits"][dead].any()
    assert 0 < counts["tests"] < live * scene.n_geoms
    assert counts["box_tests"] == live + 2 * counts["visits"]
    assert counts["deepest_stack"] <= lbvh.tree_depth(scene.bvh_nodes_topo.numpy())
    assert counts["visits"] + counts["tests"] <= counts["slots"]


@pytest.mark.parametrize("n_warps", [1, 5, 600])
def test_bvh_warp_schedule_short_tasks(host_bvh_warp, n_warps):
    """A short list shared over many warps: tasks of fewer than 32 lanes, the
    rest of each warp idle; the same answer as one warp of tasks of 32."""
    scene, rays = bvh_case("sphere_field")
    rays[7] = random_act(rays.shape[1], 0.05, seed=2)
    counts = {}
    host = host_bvh_warp(rays, scene, True, n_warps=n_warps, counts=counts)
    ref = host_bvh_warp(rays, scene, True)
    assert all(torch.equal(a, b) for a, b in zip(host, ref))
    live = int((rays[7] > 0).sum())
    task = min(32, max(1, -(-live // n_warps)))
    assert counts["task"] == task and counts["warps"] == -(-live // task)


def test_bvh_warp_schedule_root_leaf_and_no_hit(host_bvh_warp, host_accel):
    """A tree that is one leaf (no inner record: the root's own test, then its
    rows) and rays that miss the root's box: every lane answered."""
    from ray_tracying_tpu_torch.accel import lbvh
    from ray_tracying_tpu_torch.kernels import bvh_traverse as BT

    _, lane_bvh = host_accel
    scene = lbvh.with_bvh(rt.load_scene_dict(camera_dict(spheres=[
        {"location": [0.0, 10.0, 0.0], "radius": 1.0},
        {"location": [2.0, 12.0, 1.0], "radius": 0.5},
        {"location": [-1.0, 8.0, -0.5], "radius": 0.7}]), device="cpu"))
    assert scene.bvh_nodes_topo.shape[0] == 1 and scene.bvh_inner.shape[0] == 0
    rng = np.random.default_rng(3)
    n = 200
    d = rng.normal([0, 1, 0], [0.15, 0, 0.15], (n, 3))
    d[::4] = [0.0, -1.0, 0.0]                              # away: miss the root's box
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    rays = CH.pack_rays(torch.zeros((n, 3)), d, torch.zeros(n))
    ops = (scene.bvh_geoms, scene.bvh_nodes_box, scene.bvh_nodes_topo,
           scene.bvh_nodes_graze)
    for want_n in (False, True):
        counts = {}
        host = host_bvh_warp(rays, scene, want_n, counts=counts)
        plain = (BT.bvh_closest_n_plain if want_n else BT.bvh_closest_plain)(rays, *ops)
        assert_bvh_same(host, lane_bvh(rays, *ops, False, want_n), plain, rays)
        assert counts["visits"] == 0 and (host[1][::4] == -1).all()


def tie_tree(scene, a, b):
    """The tree of `scene` with row b made row a's geom again under its own
    id: b's leaf box and every box above it grown to hold a's leaf box, and
    their slacks to a's.  (tree, leaf of a, leaf of b)."""
    table = scene.bvh_geoms.clone()
    boxes = scene.bvh_nodes_box.clone()
    graze = scene.bvh_nodes_graze.clone()
    topo = scene.bvh_nodes_topo
    table[b, :16] = table[a, :16]
    table[b, 16] = scene.bvh_geoms[b, 16]
    topo_l = topo.tolist()
    parent = {c: i for i, (l, r, _, _) in enumerate(topo_l) if l >= 0 for c in (l, r)}

    def leaf(row):
        return next(i for i, (l, _, f, c) in enumerate(topo_l) if l < 0 and f <= row < f + c)

    la, lb = leaf(a), leaf(b)
    node = lb
    while True:
        boxes[node, :3] = torch.minimum(boxes[node, :3], boxes[la, :3])
        boxes[node, 3:] = torch.maximum(boxes[node, 3:], boxes[la, 3:])
        graze[node] = torch.maximum(graze[node], graze[la])
        if node == 0:
            break
        node = parent[node]
    return (table, boxes, topo, graze), la, lb


@pytest.mark.parametrize("lower", ["copy_lower", "copy_higher"])
@pytest.mark.parametrize("want_n", [False, True], ids=["t_id", "t_id_normal"])
def test_bvh_warp_schedule_tie_across_two_leaves(host_bvh_warp, host_accel, lower, want_n):
    """One geom twice, in two leaves far apart: every ray that hits it hits
    both rows at the same t.  Whichever leaf a lane enters first, the lower
    row wins, as in the row-order sweep: the other leaf's box is still
    entered at a tie (<=) and the (t, row) merge takes the lower row."""
    from ray_tracying_tpu_torch.kernels import bvh_traverse as BT

    _, lane_bvh = host_accel
    scene, rays = bvh_case("sphere_field")
    g = scene.n_geoms
    plain0 = BT.bvh_closest_plain(rays, scene.bvh_geoms, scene.bvh_nodes_box,
                                  scene.bvh_nodes_topo, scene.bvh_nodes_graze)
    rows, hits = torch.unique(plain0[1][plain0[1] >= 0], return_counts=True)
    gid = int(rows[hits.argmax()])                         # the geom hit most often
    a = int((scene.bvh_geoms[:, 16].round() == gid).nonzero()[0, 0])
    b = 0 if lower == "copy_lower" else g - 1
    tree, la, lb = tie_tree(scene, a, b)
    assert la != lb and (b < a) == (lower == "copy_lower")
    plain = (BT.bvh_closest_n_plain if want_n else BT.bvh_closest_plain)(rays, *tree)
    won = int(round(float(tree[0][min(a, b), 16])))
    assert int((plain[1] == won).sum()) >= int(hits.max())  # every such ray ties: lower row
    for n_warps in (1, rays.shape[1] // 12):
        host = host_bvh_warp(rays, tree, want_n, n_warps)
        assert_bvh_same(host, lane_bvh(rays, *tree, False, want_n), plain, rays)


def test_bvh_warp_schedule_keeps_the_fuzzy_grazing_hits(host_bvh_warp):
    """The far grazing spheres of the box-slack test: the warp schedule's
    child tests carry each child's own slack, so it keeps every fuzzy hit:
    t and ids bit-equal to the plain sweep, the normals to the file's
    tolerance (torch's CPU sqrt)."""
    from ray_tracying_tpu_torch.accel import lbvh

    rng = np.random.default_rng(4)
    centers = [[0.0, 150.0, 0.0]] + rng.uniform([-40, 100, -20], [40, 160, 20], (8, 3)).tolist()
    scene = lbvh.with_bvh(rt.load_scene_dict(
        camera_dict(spheres=[{"location": c, "radius": 0.12} for c in centers]), device="cpu"))
    rays, rad = silhouette_rays(rng, 60000, centers[0], 0.12)
    plain = CH.mixed_closest_plain(rays, scene.bvh_geoms, scene.n_geoms, False, want_n=True)
    assert int(((plain[1] == 0) & torch.from_numpy(rad > 0.12 * 1.02)).sum()) > 100
    for n_warps in (1, rays.shape[1] // 12):
        host = host_bvh_warp(rays, scene, True, n_warps)
        assert torch.equal(host[1], plain[1]) and torch.equal(host[0], plain[0])
        np.testing.assert_allclose(host[2].numpy(), plain[2].numpy(), rtol=RTOL, atol=ATOL)


def test_bvh_kernel_constants_are_the_packers(host_bvh_warp):
    """The kernel's stack, leaf coding, geom limit and record width are
    accel/lbvh.py's; its blocks are whole warps."""
    from ray_tracying_tpu_torch.accel import lbvh

    c = host_bvh_warp.consts()
    assert c["stack_max"] == lbvh.BVH_STACK_MAX
    assert c["leaf_count_bits"] == lbvh.LEAF_COUNT_BITS
    assert c["max_geoms"] == lbvh.BVH_MAX_GEOMS and c["cols"] == 16
    assert c["threads"] % 32 == 0


def silhouette_rays(rng, n, centre, radius):
    """n rays from the origin to a ring around a sphere's silhouette, from
    0.9 to 1.3 radii off its centre: ((8, n) rays, the ring's radii)."""
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = radius * rng.uniform(0.9, 1.3, n)
    target = np.asarray(centre) + np.stack(
        [rad * np.cos(ang), np.zeros(n), rad * np.sin(ang)], axis=1)
    d = torch.from_numpy((target / np.linalg.norm(target, axis=1, keepdims=True)).astype(np.float32))
    return CH.pack_rays(torch.zeros((n, 3)), d, torch.zeros(n)), rad


def camera_dict(**geoms):
    return {
        "cameras": [{"location": [0, 0, 0], "gaze_vector": [0, 1, 0],
                     "up_vector": [0, 0, 1], "focal_length": 20.0,
                     "sensor_width": 36, "sensor_height": 24}],
        "render": {"resolution_x": 8, "resolution_y": 6}, **geoms,
    }


def leaf_of(scene, geom_id):
    """(node, table row) of the BVH leaf that holds load-order geom `geom_id`."""
    row = int((scene.bvh_geoms[:, 16].round() == geom_id).nonzero()[0, 0])
    topo = scene.bvh_nodes_topo.tolist()
    return next(i for i, (l, _, f, c) in enumerate(topo) if l < 0 and f <= row < f + c), row


def test_box_slack_keeps_the_fuzzy_grazing_hits_of_far_spheres(host_accel, host_warp, monkeypatch):
    """At a distance of hundreds of radii the sphere test's discriminant
    cancels, and rays that pass just outside a sphere still test as grazing
    hits; an exact box would cull some of them.  The culling kernels grow
    each box by its own slack scaled with distance squared
    (csrc/geom.cuh::box_hit), so the traversal and the chunk sweep still
    equal the plain sweep; without the slack the same box test loses
    hits."""
    from ray_tracying_tpu_torch.accel import lbvh
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS

    sweep, bvh = host_accel
    rng = np.random.default_rng(4)
    centers = [[0.0, 150.0, 0.0]] + rng.uniform([-40, 100, -20], [40, 160, 20], (8, 3)).tolist()
    scene = rt.load_scene_dict(
        camera_dict(spheres=[{"location": c, "radius": 0.12} for c in centers]), device="cpu")
    scene = lbvh.with_bvh(lbvh.with_chunks(scene, 4))
    n = 60000
    rays, rad = silhouette_rays(rng, n, centers[0], 0.12)
    g = scene.n_geoms
    plain = CH.mixed_closest_plain(rays, scene.bvh_geoms, g, False)
    hit = plain[1] == 0
    beyond = hit & torch.from_numpy(rad > 0.12 * 1.02)
    assert int(beyond.sum()) > 100          # the fuzzy hits exist
    host = bvh(rays, scene.bvh_geoms, scene.bvh_nodes_box, scene.bvh_nodes_topo,
               scene.bvh_nodes_graze, False, False)
    assert torch.equal(host[1], plain[1]) and torch.equal(host[0], plain[0])
    host = sweep(0, rays, None, scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms,
                 g, 4, False)
    assert torch.equal(host[1], plain[1]) and torch.equal(host[0], plain[0])
    # the warp schedule, nearest chunk first, as chunk_closest_n runs it
    host = host_warp(1, rays, None, scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms,
                     g, 4, False)
    assert torch.equal(host[1], plain[1]) and torch.equal(host[0], plain[0])
    # The same box test without the slack would cull some of those hits.
    leaf, _ = leaf_of(scene, 0)
    box = scene.bvh_nodes_box[leaf].tolist()
    rb = CH.RayBlock(rays)
    inf = torch.full((n,), float("inf"))
    assert bool(CS.box_hit(rb, box, inf, float(scene.bvh_nodes_graze[leaf]))[hit].all())
    assert not bool(CS.box_hit(rb, box, inf, None)[hit].all())


def test_one_tiny_far_sphere_widens_only_its_own_boxes(host_accel, host_warp):
    """One sphere of radius 0.001 at 150 units among large cubes and
    spheres: its fuzzy grazing hits need a wide slack (1.2e-7 * 9000 *
    distance^2, about 24 units there), and every box that holds it gets
    that; no other box does.  So no hit is lost, through the traversal and
    through the chunk sweep, and a ray still runs a fraction of the table:
    with the scene-wide largest slack on every box the cull would keep
    nearly every box in front of every ray."""
    from ray_tracying_tpu_torch.accel import lbvh
    from ray_tracying_tpu_torch.kernels import bvh_traverse as BT
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS

    sweep, bvh = host_accel
    rng = np.random.default_rng(6)
    tiny = [3.0, 150.0, 2.0]
    pos = rng.uniform([-60, 20, -30], [60, 140, 30], (120, 3))
    scene = rt.load_scene_dict(camera_dict(
        spheres=[{"location": tiny, "radius": 0.001}]
        + [{"location": p.tolist(), "radius": 2.0} for p in pos[:60]],
        cubes=[{"translation": p.tolist(), "rotation": [0.0, 0.0, 0.0],
                "scale": [3.0, 3.0, 3.0]} for p in pos[60:]],
    ), device="cpu")
    scene = lbvh.with_bvh(lbvh.with_chunks(scene, 4))
    g = scene.n_geoms
    n = 20000
    ring, rad = silhouette_rays(rng, n, tiny, 0.001)
    d = rng.uniform([-60, 20, -30], [60, 140, 30], (n, 3))   # into the geoms' volume
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    rays = torch.cat([ring, CH.pack_rays(torch.zeros((n, 3)), d, torch.zeros(n))], dim=1).contiguous()
    bvh_ops = (scene.bvh_geoms, scene.bvh_nodes_box, scene.bvh_nodes_topo,
               scene.bvh_nodes_graze)
    need = {}
    plain = BT.bvh_closest_plain(rays, *bvh_ops, False, stats=need)
    # the tiny sphere is seen, beyond its true silhouette too, and other
    # geoms are hit as well
    on_tiny = plain[1][:n] == 0
    assert int((on_tiny & torch.from_numpy(rad > 0.001 * 1.02)).sum()) > 100
    assert int((plain[1][n:] > 0).sum()) > n // 40
    host = bvh(rays, *bvh_ops, False, False)
    assert torch.equal(host[1], plain[1]) and torch.equal(host[0], plain[0])
    host = sweep(0, rays, None, scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms,
                 g, 4, False)
    assert torch.equal(host[1], plain[1]) and torch.equal(host[0], plain[0])
    # the warp schedule, nearest chunk first, as chunk_closest_n runs it
    host = host_warp(1, rays, None, scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms,
                     g, 4, False)
    assert torch.equal(host[1], plain[1]) and torch.equal(host[0], plain[0])

    # How many boxes a ray is let into, of the random rays: with each box's
    # own slack, with the largest slack on every box, and with exact boxes
    # (the count the plain version reports as unavoidable).
    rb = CH.RayBlock(rays[:, n:].contiguous())
    t = plain[0][n:]
    boxes = scene.bvh_nodes_box.tolist()
    own = scene.bvh_nodes_graze.tolist()
    worst = max(own)
    leaf, _ = leaf_of(scene, 0)
    assert own[leaf] == worst and sum(x == worst for x in own) <= lbvh.tree_depth(
        scene.bvh_nodes_topo.numpy()) + 1

    def entered(graze_of):
        return sum(int(CS.box_hit(rb, box, t, graze_of(i)).sum())
                   for i, box in enumerate(boxes))

    n_own, n_worst, n_exact = entered(lambda i: own[i]), entered(lambda i: worst), \
        entered(lambda i: None)
    # the slack costs at most the few boxes on the tiny sphere's path, a
    # fifth of what the largest slack on every box would cost
    assert n_exact <= n_own <= n_exact + n * sum(x == worst for x in own)
    assert n_worst - n_exact > 5 * (n_own - n_exact) > 0


def test_graze_coef_is_nine_over_the_smallest_radius():
    """Each sphere row asks 1.2e-7 * 9 / r; a chunk's slack is that of its
    smallest sphere; a table without spheres asks none."""
    from ray_tracying_tpu_torch.accel import lbvh

    scene, _, _ = accel_case("sphere_field")
    g = scene.n_geoms
    rows = lbvh.row_graze(scene.chunk_geoms.numpy())
    assert rows.dtype == np.float32 and rows.shape == (scene.chunk_geoms.shape[0],)
    sphere = scene.chunk_geoms[:g, 15].round().numpy() == 0
    radii = 1.0 / scene.chunk_geoms[:g, 0].numpy()[sphere]
    np.testing.assert_allclose(rows[:g][sphere], lbvh.GRAZE_SLACK * 9.0 / radii, rtol=1e-5)
    assert not rows[:g][~sphere].any() and not rows[g:].any()
    np.testing.assert_array_equal(
        scene.chunk_graze.numpy(), rows.reshape(-1, 4).max(axis=1))
    cubes, _, _ = accel_case("cube_city")
    assert not cubes.chunk_graze.any() and not cubes.bvh_nodes_graze.any()
