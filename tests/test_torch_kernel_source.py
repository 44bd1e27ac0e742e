"""The arithmetic of csrc/wavefront.cu, checked without a GPU.

The CUDA source keeps its per-lane function (`rtt::wave_lane`) free of CUDA
constructs, so a host C++ compiler builds it.  Here g++ compiles that
function behind a ten-line loop over lanes, with FMA contraction off as in
the nvcc build, and every level of a trace goes through it and through
`wave_level_plain` on the same rays and fuzz rows.  This holds the two
sources to the same arithmetic; it says nothing of the launch, the
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
