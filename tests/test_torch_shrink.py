"""Queue shrink of the port's fused path against the JAX package's.

The port compacts per lane (the JAX package by 128-lane groups) into the
JAX package's widths, and folds each shrunk level's contribution back by
destination on that level, so with nothing dropped the radiance is the
unshrunk one bit for bit (`torch.equal`), draws fed in included.  Overflow
drops the dimmest lanes and counts them (`live + dropped == spawned`), never
more than the JAX package drops on the same schedule.  The JAX side runs
its Pallas kernel in interpret mode, as tests/test_wavefront.py does.
"""

import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tracying_tpu.kernels.wavefront import WAVE_BLOCK as BLOCK_JAX
from ray_tracying_tpu.render import integrator as G_jax
from ray_tracying_tpu.render import pipeline as pipeline_jax
from ray_tracying_tpu_torch.diff import params as P
from ray_tracying_tpu_torch.render import integrator as G
from ray_tracying_tpu_torch.render import pipeline
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.scene.loader import load_scene

from test_torch_diff import assert_grads_close
from test_torch_wavefront import ATOL, RTOL, carried, interpret
from test_wavefront import cam_rays, clustered_rays, wave_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
N = 8192
TWO_STAGES = ((1, 2), (3, 2))


def torch_rays(o, d, tm):
    return tuple(torch.from_numpy(np.array(x, np.float32)) for x in (o, d, tm))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX fused path on wave_scene: clustered rays under TWO_STAGES
    (lossless) and scattered rays under ((1, 4),) (overflowing), with
    stats, and the latter's return_dropped scalar."""
    s = wave_scene(roughness=0.0)
    key = jax.random.key(4)
    with interpret():
        lossless, st_lossless = G_jax.trace_wavefront(
            s, *clustered_rays(n=N, n_live=2048, seed=31), key, 1, shrink=TWO_STAGES,
            return_stats=True)
        _, st_over = G_jax.trace_wavefront(
            s, *cam_rays(n=N, seed=31), key, 1, shrink=((1, 4),), return_stats=True)
        _, dropped = G_jax.trace_wavefront(
            s, *cam_rays(n=N, seed=31), key, 1, shrink=((1, 4),), return_dropped=True)
    return dict(lossless=np.asarray(lossless),
                lossless_live=np.asarray(st_lossless.live),
                over=jax.tree.map(np.asarray, st_over), dropped=int(dropped))


def test_schedules_and_widths_are_the_jax_packages():
    """The port's schedules and quantum are the JAX package's, and so are
    the stage widths: the flagship tile's 8,386,560 lanes run levels 2-3
    at 2,097,152 and 4-10 at 1,048,576."""
    assert G.WAVE_SHRINK_AUTO == G_jax.WAVE_SHRINK_AUTO
    assert G.WAVE_SHRINK_SPARSE == G_jax.WAVE_SHRINK_SPARSE
    assert G.WAVE_BLOCK == BLOCK_JAX
    assert G.shrink_plan(8386560, 11, "auto") == ([0, 2, 4, 11], [8386560, 2097152, 1048576])
    assert G.shrink_plan(8192, 11, TWO_STAGES) == ([0, 1, 3, 11], [8192, 4096, 2048])
    assert G.shrink_plan(2048, 11, "auto") == ([0, 11], [2048])
    assert G.shrink_plan(8192, 1, "auto") == ([0, 1], [8192])
    assert G.shrink_plan(8192, 11, ()) == ([0, 11], [8192])
    with pytest.raises(ValueError):
        G.shrink_plan(8192, 11, "always")


def test_wave_shrink_matches_unshrunk(jax_runs):
    """tests/test_wavefront.py::test_wave_shrink_matches_unshrunk on the
    port: clustered liveness under ((1, 2), (3, 2)) gives the unshrunk
    radiance bit for bit, the same live counts, nothing dropped, and the
    JAX package's shrunk radiance at RTOL/ATOL.  Each returned level has its
    stage's width, and its contribution rows added at `dest` are the
    radiance."""
    st = carried(wave_scene(roughness=0.0))
    rays = torch_rays(*clustered_rays(n=N, n_live=2048, seed=31))
    base, st0 = trace_wavefront(st, *rays, 1, shrink=(), return_stats=True, device="cpu")
    got, st1, levels = trace_wavefront(st, *rays, 1, shrink=TWO_STAGES, return_stats=True,
                                       return_levels=True, device="cpu")
    assert int(st0.live[1]) > 1024  # the cluster really spawns
    assert int(st1.live[2]) > 0     # and lives on in the first stage
    assert int(st1.dropped.sum()) == 0
    assert torch.equal(got, base)
    assert torch.equal(st1.live, st0.live)
    np.testing.assert_array_equal(st1.live.numpy(), jax_runs["lossless_live"])
    np.testing.assert_allclose(got.numpy(), jax_runs["lossless"], rtol=RTOL, atol=ATOL)
    assert [lv.shape[1] for lv in levels] == [N] + [4096] * 2 + [2048] * 8
    assert levels.dest[0] is None and levels.dest[1].shape == (4096,)
    total = torch.zeros((3, N))
    for out, dest in zip(levels, levels.dest):
        if dest is None:
            total += out[9:12]
        else:
            keep = dest >= 0
            total.index_add_(1, dest[keep], out[9:12, keep])
    assert torch.equal(total.T, got)


def test_wave_shrink_overflow_counted(jax_runs):
    """tests/test_wavefront.py::test_wave_shrink_overflow_counted on the
    port: scattered liveness overflows a 1/4 stage; the dropped lanes are
    counted (live1 + dropped1 == spawned0), the port's per-lane packing
    drops no more than the JAX package's groups, and the kept lanes are the
    brightest by throughput, in slot order."""
    st = carried(wave_scene(roughness=0.0))
    rays = torch_rays(*cam_rays(n=N, seed=31))
    _, stats, levels = trace_wavefront(st, *rays, 1, shrink=((1, 4),), return_stats=True,
                                       return_levels=True, device="cpu")
    live1, spawned0, dropped1 = (int(stats.live[1]), int(stats.spawned[0]),
                                 int(stats.dropped[1]))
    assert live1 == 2048
    assert dropped1 > 0
    assert live1 + dropped1 == spawned0
    assert int(stats.dropped.sum()) == dropped1
    over = jax_runs["over"]
    assert int(over.spawned[0]) == spawned0
    assert dropped1 <= int(over.dropped[1])
    dest = levels.dest[1]
    assert bool((dest[1:] > dest[:-1]).all())  # slot order
    tp0 = levels[0][8]
    alive = levels[0][7] > 0
    lost = alive.clone()
    lost[dest] = False
    assert float(tp0[dest].min()) >= float(tp0[lost].max())


def test_demo_scenes_no_shrink_drops():
    """tests/test_wavefront.py::test_demo_scenes_no_shrink_drops on the
    port's fused path: under "auto" the committed demo scenes (whole frame,
    1 spp) drop nothing, and the live lanes entering each stage are at most
    its share of the rays (1/4, then 1/8) over 1.9, the JAX package's bar."""
    for name in ("det_basic", "det_mirrors", "bvh_det", "bvh_glossy", "glossy"):
        s = load_scene(os.path.join(REPO, "golden", "ASCII", f"{name}.json"),
                       textures_dir=TEX, device="cpu")
        w, h = s.camera.resolution
        o, d, tm = pipeline.tile_rays(s.camera, 0, h, w, 1,
                                      generator=torch.Generator().manual_seed(0))
        _, st = trace_wavefront(s, o, d, tm, 1, generator=torch.Generator().manual_seed(1),
                                fused=True, shrink="auto", return_stats=True, device="cpu")
        assert int(st.dropped.sum()) == 0, name
        live = st.live.numpy().astype(np.float64) / o.shape[0]
        cap = 1.0
        for lv, f in G.WAVE_SHRINK_AUTO:
            cap /= f
            assert live[lv] <= cap / 1.9, (name, lv, live[lv], cap)


def test_wave_return_dropped_scalar(jax_runs):
    """tests/test_wavefront.py::test_wave_return_dropped_scalar on the port:
    return_dropped gives the overflow count as a 0-d tensor beside the
    radiance (no more than the JAX package's), and 0 unshrunk."""
    st = carried(wave_scene(roughness=0.0))
    rays = torch_rays(*cam_rays(n=N, seed=31))
    out, dropped = trace_wavefront(st, *rays, 1, shrink=((1, 4),), return_dropped=True,
                                   device="cpu")
    out2, none_dropped = trace_wavefront(st, *rays, 1, shrink=(), return_dropped=True,
                                         device="cpu")
    assert out.shape == out2.shape == (N, 3)
    assert dropped.dim() == 0 and 0 < int(dropped) <= jax_runs["dropped"]
    assert int(none_dropped) == 0


def test_glossy_shrink_with_fuzz_fed_is_bit_equal():
    """A glossy scene with its fuzz fed in as full-width tensors: each
    shrunk level gathers its lanes' draws by dest, so the radiance is the
    unshrunk one bit for bit; a generator's draws are made at the stage's
    width, as the JAX package makes them."""
    st = carried(wave_scene(roughness=0.35))
    rays = torch_rays(*clustered_rays(n=N, n_live=2048, seed=31))
    rng = np.random.default_rng(12)
    fuzz = []
    for _ in range(11):
        v = rng.normal(size=(3, N))
        v *= rng.random(N) ** (1 / 3) / np.linalg.norm(v, axis=0)
        fuzz.append(torch.from_numpy(v.astype(np.float32)))
    base = trace_wavefront(st, *rays, 1, fuzz=fuzz, shrink=(), device="cpu")
    got, stats = trace_wavefront(st, *rays, 1, fuzz=fuzz, shrink=TWO_STAGES,
                                 return_stats=True, device="cpu")
    assert int(stats.dropped.sum()) == 0 and int(stats.live[2]) > 0
    assert torch.equal(got, base)
    calls = []
    level_fuzz = G.level_fuzz
    try:
        G.level_fuzz = lambda tables, gen, width, *a, **k: (
            calls.append(width) or level_fuzz(tables, gen, width, *a, **k))
        trace_wavefront(st, *rays, 1, generator=torch.Generator().manual_seed(2),
                        shrink=TWO_STAGES, device="cpu")
    finally:
        G.level_fuzz = level_fuzz
    assert calls == [N] + [4096] * 2 + [2048] * 8


def test_area_light_shrink_with_jitter_fed_is_bit_equal():
    """cornell (legacy planes, a mirror, glass, an area light at 2 samples)
    with its area-light jitter fed in as full-width (R, nss, 3) tensors:
    the radiance with shrink is the unshrunk one bit for bit."""
    from ray_tracying_tpu_torch import models

    st = models.get("cornell", res=(64, 64), device="cpu")
    o, d, tm = pipeline.tile_rays(st.camera, 0, 64, 64, 1,
                                  generator=torch.Generator().manual_seed(0))
    n = o.shape[0]
    gen = torch.Generator().manual_seed(5)
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere

    jitter = [[uniform_in_unit_sphere(gen, (n, 2)) if a else None for a in st.lights.is_area]
              for _ in range(11)]
    base = trace_wavefront(st, o, d, tm, 2, light_jitter=jitter, shrink=(), device="cpu")
    got, stats = trace_wavefront(st, o, d, tm, 2, light_jitter=jitter, shrink=((1, 2),),
                                 return_stats=True, device="cpu")
    assert int(stats.dropped.sum()) == 0 and int(stats.live[2]) > 0
    assert torch.equal(got, base)


def test_differentiable_shrink_gradients_match_unshrunk():
    """The differentiable fused path (WaveLevelFn at each stage's width,
    the gathers and the adds by dest in the graph): the radiance equals the
    unshrunk one, and the gradients of materials, lights and the ray
    origins agree at tests/test_torch_diff.py's tolerance."""
    sj = wave_scene(roughness=0.2)
    st = carried(sj)
    o, d, tm = torch_rays(*clustered_rays(n=N, n_live=2048, seed=31))
    rng = np.random.default_rng(3)
    fuzz = [torch.from_numpy(rng.uniform(-0.5, 0.5, (3, N)).astype(np.float32))
            for _ in range(11)]
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, (N, 3)).astype(np.float32))
    paths = ["materials.diffuse", "materials.reflectivity", "lights.intensity",
             "lights.position"]
    res = {}
    for shrink in ((), TWO_STAGES):
        theta = P.extract(st, paths)
        origins = o.clone().requires_grad_(True)
        rad, stats = trace_wavefront(P.apply(st, theta), origins, d, tm, 1, fuzz=fuzz,
                                     differentiable=True, shrink=shrink, return_stats=True,
                                     device="cpu")
        assert int(stats.dropped.sum()) == 0
        grads = torch.autograd.grad((rad * weight).sum(), list(theta.values()) + [origins])
        res[shrink] = (rad.detach(), grads)
    (r0, g0), (r1, g1) = res[()], res[TWO_STAGES]
    assert torch.equal(r0, r1)
    for k, a, b in zip(paths + ["origins"], g1, g0):
        assert float(b.abs().max()) > 0, k
        assert_grads_close(a.numpy(), b.numpy(), err_msg=k)


# (rows, width, samples_sqrt) of a tile: under 2^20 lanes, at 1 and 4 spp
# over it, at 9 and 16 spp over it.
TILES = [(8, 64, 1), (64, 1024, 2), (512, 2048, 1), (256, 1024, 2), (57, 2048, 3),
         (32, 2048, 4)]


def test_render_tile_chooses_the_schedule_as_the_jax_pipeline(monkeypatch):
    """_render_tile passes the shrink schedule the JAX package's does for
    the same tile: () under 2^20 lanes, "auto" at >= 8 samples a pixel,
    WAVE_SHRINK_SPARSE otherwise (each side's trace replaced by a recorder;
    the JAX tile traced abstractly)."""
    from ray_tracying_tpu.scene.loader import load_scene as load_jax

    path = os.path.join(REPO, "scenes", "bvh_det.json")
    sj = load_jax(path, textures_dir=TEX)
    st = load_scene(path, textures_dir=TEX, device="cpu")
    seen = {"jax": [], "port": []}

    def record(side):
        def fake(scene, o, *a, shrink, **k):
            seen[side].append(shrink)
            zeros = jnp.zeros if side == "jax" else torch.zeros
            return zeros((o.shape[0], 3)), (jnp.int32(0) if side == "jax" else torch.zeros(()))
        return fake

    monkeypatch.setattr(pipeline_jax, "trace_wavefront", record("jax"))
    monkeypatch.setattr(pipeline, "trace_wavefront", record("port"))
    for rows, width, s in TILES:
        jax.eval_shape(
            lambda y0, k: pipeline_jax._render_tile.__wrapped__(sj, y0, k, rows, width, s, 1, 2),
            jnp.float32(0), jax.random.key(0))
        opts = pipeline.RenderOptions(samples_sqrt=s)
        pipeline._render_tile(st, 0, rows, width, opts, torch.Generator().manual_seed(0))
    as_pairs = [G.shrink_schedule(x) for x in seen["port"]]
    assert as_pairs == [G_jax.WAVE_SHRINK_AUTO if x == "auto" else tuple(x)
                        for x in seen["jax"]]
    assert seen["port"] == [(), (), G.WAVE_SHRINK_SPARSE, G.WAVE_SHRINK_SPARSE, "auto", "auto"]


def test_render_warns_on_shrink_overflow(monkeypatch):
    """A tile's dropped count reaches the pipeline's RuntimeWarning, which
    names queue-shrink overflow as well as compaction."""
    st = load_scene(os.path.join(REPO, "scenes", "bvh_det.json"), textures_dir=TEX,
                    device="cpu")
    monkeypatch.setattr(pipeline, "trace_wavefront",
                        lambda scene, o, *a, **k: (torch.zeros((o.shape[0], 3)),
                                                   torch.tensor(3, dtype=torch.int32)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipeline.render_image(st, pipeline.RenderOptions(samples_sqrt=1), device="cpu")
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "queue-shrink" in msgs[0] and "dropped 3 " in msgs[0]


def test_srgb_stats_mode_counts_what_the_warning_counts(monkeypatch):
    """render_to_srgb_u8 with opts.stats gives the bytes of the plain call
    and, in stats["total_dropped"], the count the plain call's warning
    names; at the shrink level live + dropped == spawned."""
    st = load_scene(os.path.join(REPO, "scenes", "glossy.json"), textures_dir=TEX,
                    device="cpu")
    monkeypatch.setattr(pipeline, "tile_shrink", lambda lanes, spp: ((1, 4),))
    opts = pipeline.RenderOptions(samples_sqrt=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img = pipeline.render_to_srgb_u8(st, opts, torch.Generator().manual_seed(0),
                                         device="cpu")
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    img_s, stats = pipeline.render_to_srgb_u8(
        st, pipeline.RenderOptions(samples_sqrt=2, stats=True),
        torch.Generator().manual_seed(0), device="cpu")
    lv = stats["levels"]
    assert stats["total_dropped"] > 0 and len(msgs) == 1
    assert f"dropped {stats['total_dropped']} " in msgs[0]
    assert lv[1]["live"] + lv[1]["dropped"] == lv[0]["spawned"]
    np.testing.assert_array_equal(img_s, img)


def test_generator_draws_at_stage_width_keep_the_estimate(monkeypatch):
    """cornell (a mirror, glass, an area light at 4 samples) through the pipeline at
    16 spp, its draws from a generator: with "auto" the shrunk levels draw
    at their width, so the frame is another estimate of the same image.
    It differs from the unshrunk frame of its seed by no more than two
    unshrunk frames from two seeds differ (mean |diff| <= 1.1 times, p99
    <= 1 step above: chip_smoke.py's limit), and two shrunk frames from
    two seeds spread as two unshrunk ones do (mean |diff| within 10 %)."""
    from ray_tracying_tpu_torch import models

    st = models.get("cornell", res=(96, 54), device="cpu")
    opts = pipeline.RenderOptions(samples_sqrt=4, light_samples=4, stats=True)
    frames = {}
    for sched in ((), "auto"):
        monkeypatch.setattr(pipeline, "tile_shrink", lambda lanes, spp, s_=sched: s_)
        for seed in (41, 42):
            img, stats = pipeline.render_to_srgb_u8(
                st, opts, torch.Generator().manual_seed(seed), device="cpu")
            assert stats["total_dropped"] == 0
            frames[sched, seed] = img.astype(np.float32)
        assert int(stats["levels"][2]["live"]) > 0

    def spread(a, b):
        d = np.abs(frames[a] - frames[b])
        return float(d.mean()), float(np.percentile(d, 99))

    witness = spread(((), 41), ((), 42))
    shrunk = spread(("auto", 41), ((), 41))
    assert witness[0] > 0
    assert shrunk[0] <= 1.1 * witness[0] and shrunk[1] <= witness[1] + 1
    assert abs(spread(("auto", 41), ("auto", 42))[0] / witness[0] - 1) <= 0.1


@pytest.mark.parametrize("name", ["cornell", "glossy"])
def test_generator_draws_are_fresh_at_each_stage_width(name):
    """Traced from a generator under "auto", each level gets its own draws
    at the width it runs (cornell: an area light's 4 jitter samples;
    glossy: the glossy fuzz): every 3 rows are points of the unit ball
    with its moments (mean 0, E|v|^2 = 3/5, within 5 sigma), and no level
    reuses another's."""
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.kernels.wavefront import wave_level

    if name == "cornell":
        st, nss, sqrt_spp = models.get("cornell", res=(64, 32), device="cpu"), 4, 4
    else:
        st = load_scene(os.path.join(REPO, "scenes", "glossy.json"), textures_dir=TEX,
                        device="cpu")
        nss, sqrt_spp = 1, 2
    width, height = st.camera.resolution
    o, d, tm = pipeline.tile_rays(st.camera, 0, height, width, sqrt_spp,
                                  generator=torch.Generator().manual_seed(0))
    seen = []

    def level_fn(prev, fz, tables, min_tp):
        seen.append((prev.shape[1], fz.clone()))
        return wave_level(prev, fz, tables, min_tp)

    trace_wavefront(st, o, d, tm, nss, generator=torch.Generator().manual_seed(9),
                    shrink="auto", level_fn=level_fn, device="cpu")
    _, widths = G.shrink_plan(o.shape[0], len(seen), "auto")
    assert len(seen) == 11 and widths[2] < o.shape[0]
    assert [w for w, _ in seen] == [o.shape[0]] * 2 + [widths[1]] * 2 + [widths[2]] * 7
    rows = 3 * nss if name == "cornell" else 3
    for k, (lanes, fz) in enumerate(seen):
        assert fz.shape == (rows, lanes)
        pts = fz.reshape(-1, 3, lanes).permute(0, 2, 1).reshape(-1, 3).double()
        r2 = (pts * pts).sum(1)
        n = pts.shape[0]
        assert float(r2.max()) <= 1.0 + 1e-6
        assert float(pts.mean(0).abs().max()) <= 5 * (0.2 / n) ** 0.5, k
        assert abs(float(r2.mean()) - 0.6) <= 5 * ((3 / 7 - 0.36) / n) ** 0.5, k
        for lanes_j, fz_j in seen[:k]:
            m = min(lanes, lanes_j)
            assert not torch.equal(fz[:, :m], fz_j[:, :m]), (k, lanes_j)
