"""The arithmetic of csrc/wavefront.cu and csrc/closest_hit.cu, checked
without a GPU.

The CUDA sources keep their per-lane functions (`rtt::wave_lane`,
`rtt::closest_lane`, `rtt::occlusion_lane`) free of CUDA constructs, so a
host C++ compiler builds them.  Here g++ compiles that
function behind a ten-line loop over lanes, with FMA contraction off as in
the nvcc build, and every level of a trace goes through it and through
`wave_level_plain` on the same rays and fuzz rows.  This holds the two
sources to the same arithmetic (the closest-hit and any-hit lane functions
likewise go through seeded rays beside `brute_closest_plain`,
`brute_closest_n_plain` and `occlusion_plain`); it says nothing of the launch, the
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
    int n_tex, int tex_h, int tex_w, float min_tp) {
  const rtt::WaveParams p = rtt::make_params(
      q, fuzz, table, lights, tex, twh, out, R, G, n_cols, n_lights, ranges,
      n_ranges, glossy, has_tex, n_tex, tex_h, tex_w, min_tp);
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
        ctypes.POINTER(ctypes.c_int), i, i, i, i, i, i, ctypes.c_float,
    ]
    lib.wave_level_host.restype = None

    def level(out_prev, fuzz, tables, min_tp=0.0):
        r = out_prev.shape[1]
        n_cols, g = tables.table.shape
        out = torch.empty((W.OUT_ROWS, r), dtype=torch.float32)
        flat = [x for rng in tables.ranges for x in rng]
        ranges = (ctypes.c_int * 9)(*(flat + [0] * (9 - len(flat))))
        if tables.has_tex:
            n_tex, th, tw, _ = tables.tex.shape
            tex, twh = tables.tex.data_ptr(), tables.twh.data_ptr()
        else:
            n_tex = th = tw = 0
            tex = twh = None
        lib.wave_level_host(
            out_prev.data_ptr(), fuzz.data_ptr() if tables.glossy else None,
            tables.table.data_ptr(), tables.lights.data_ptr(), tex, twh,
            out.data_ptr(), r, g, n_cols, tables.n_lights, ranges,
            len(tables.ranges), int(tables.glossy), int(tables.has_tex),
            n_tex, th, tw, float(min_tp),
        )
        return out

    return level


def scene_and_rays(path, rows, spp_sqrt, seed):
    scene = rt.load_scene(
        os.path.join(REPO, path), device="cpu",
        textures_dir=os.path.join(REPO, "golden", "Textures"),
    )
    gen = torch.Generator().manual_seed(seed)
    w, h = scene.camera.resolution
    o, d, tm = tile_rays(scene.camera, (2 * h) // 3, rows, w, spp_sqrt, generator=gen)
    n = o.shape[0]
    fuzz = [uniform_in_unit_sphere(gen, (n,), device="cpu").T.contiguous()
            for _ in range(11)]
    return scene, o, d, tm, fuzz


def assert_same(host, plain):
    host, plain = host.numpy(), plain.numpy()
    np.testing.assert_array_equal(host[7], plain[7])
    np.testing.assert_array_equal(host[12], plain[12])
    np.testing.assert_allclose(host, plain, rtol=RTOL, atol=ATOL)


# Cubes + rect, textured: glossy (the flagship's specialisation) and the
# flagship itself; spheres + rect: glossy and mirror.
@pytest.mark.parametrize("path,rows,spp_sqrt", [
    ("scenes/bvh_glossy.json", 3, 2),
    ("golden/ASCII/scene.json", 1, 1),
    ("scenes/glossy.json", 3, 2),
    ("scenes/det_mirrors.json", 3, 2),
])
def test_lane_function_equals_plain_on_every_level(host_level, path, rows, spp_sqrt):
    scene, o, d, tm, fuzz = scene_and_rays(path, rows, spp_sqrt, seed=0)
    common = dict(fuzz=fuzz, device="cpu", return_levels=True)
    _, plain = trace_wavefront(scene, o, d, tm, level_fn=W.wave_level_plain, **common)
    _, host = trace_wavefront(scene, o, d, tm, level_fn=host_level, **common)
    assert len(host) == len(plain) == 11
    assert int((plain[0][7] > 0).sum()) > 0  # some rays go on past level 0
    for a, b in zip(host, plain):
        assert_same(a, b)


def test_lane_function_mixed_mask(host_level):
    """Dead and live lanes side by side: a dead lane is all zeros."""
    scene, o, d, tm, fuzz = scene_and_rays("scenes/bvh_glossy.json", 2, 1, seed=1)
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
