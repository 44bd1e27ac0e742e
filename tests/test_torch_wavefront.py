"""The port's fused level against the JAX package's: device functions,
one level, the 11-level trace, and the gate.  The JAX side runs its
Pallas kernel in interpret mode on the CPU, as tests/test_wavefront.py
does; the port runs `wave_level_plain` (what `wave_level` takes for a CPU
tensor).  Both sides get the same rays and the same glossy fuzz rows.

Float tolerance: rtol 2e-5, atol 2e-6 — the bar the JAX package holds its
own fused path to against its general path (tests/test_wavefront.py).
The two sides run the same f32 formulas; XLA contracts some a*b+c and the
frameworks' sqrt differ in the last bit.  Decision rows (act, act_hit)
must be equal."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tracying_tpu as rt_jax
import ray_tracying_tpu_torch as rt
from ray_tracying_tpu.core.sampling import uniform_in_unit_sphere as sphere_jax
from ray_tracying_tpu.kernels import closest_hit as ch_jax
from ray_tracying_tpu.kernels import wavefront as wf_jax
from ray_tracying_tpu.render.integrator import trace_wavefront as trace_jax
from ray_tracying_tpu_torch import models
from ray_tracying_tpu_torch.kernels import closest_hit as ch
from ray_tracying_tpu_torch.kernels import wavefront as wf
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.render.pipeline import tile_rays
from ray_tracying_tpu_torch.scene.convert import scene_from_numpy

from test_wavefront import cam_rays, wave_scene

# Small tensors: one thread each is fastest and keeps parallel test
# workers from oversubscribing the host.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
RTOL, ATOL = 2e-5, 2e-6
BLOCK = wf_jax.WAVE_BLOCK


class interpret:
    """RTT_PALLAS_INTERPRET=1 around a call, as tests/test_wavefront.py."""

    def __enter__(self):
        os.environ["RTT_PALLAS_INTERPRET"] = "1"

    def __exit__(self, *exc):
        del os.environ["RTT_PALLAS_INTERPRET"]


def glossy_scenes():
    path = os.path.join(REPO, "scenes", "bvh_glossy.json")
    return (
        rt_jax.load_scene(path, textures_dir=TEX),
        rt.load_scene(path, textures_dir=TEX, device="cpu"),
    )


def glossy_rays(n_rows=3, seed=0):
    """Primary rays (1 spp) of three rows of bvh_glossy two thirds down the
    image, where the cube pile is dense and paths reach the last levels."""
    _, st = glossy_scenes()
    w, h = st.camera.resolution
    assert n_rows * w <= 512
    return tile_rays(
        st.camera, (2 * h) // 3, n_rows, w, 1,
        generator=torch.Generator().manual_seed(seed),
    )


def carried(sj):
    return scene_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")


def jax_level(sj, boot, fuzz):
    """One level of the JAX package: wave_level_call in interpret mode
    with the operands _trace_wave packs (render/integrator.py:326-336)."""
    table, ranges, lights = wf_jax.wave_tables(sj)
    ktex = wf_jax.tex_kernel_supported(sj)
    if ktex:
        tex_m, twh = wf_jax.pack_tex_matrix(sj)
    else:
        tex_m = jnp.zeros((8, 128), jnp.bfloat16)
        twh = jnp.zeros((2, 1), jnp.float32)
    uv_kinds = (sj.has_spheres, sj.has_cubes, sj.has_rects, sj.n_planes > 0)
    with interpret():
        return np.asarray(
            wf_jax.wave_level_call(
                jnp.asarray(boot), jnp.asarray(fuzz), table, lights, tex_m,
                twh, ranges, sj.has_motion, sj.n_lights, sj.has_glossy,
                sj.has_refraction, 0.0, sj.has_textures, uv_kinds,
                tuple(sj.lights.is_area), 1, ktex, 0,
            )
        )


def boot_tensor(o, d, tm, act, tp):
    """(13, BLOCK) bootstrap tensor: the given lanes, then dead padding up
    to the JAX kernel's block."""
    n = o.shape[0]
    boot = np.zeros((13, BLOCK), np.float32)
    boot[0:3, :n] = np.asarray(o).T
    boot[3:6, :n] = np.asarray(d).T
    boot[6, :n] = np.asarray(tm)
    boot[7, :n] = act
    boot[8, :n] = tp
    return boot


def assert_level_close(got, ref, live_in):
    """got: the port's (13, R); ref: the JAX kernel's.  Decision rows
    equal everywhere.  Float rows within tolerance on lanes that entered
    live; a lane that entered dead is all zero in the port, while the JAX
    kernel leaves its rows 0..5 undefined (zero in an all-dead block, the
    masked-out arithmetic's leftovers in a mixed one) and zeroes the
    rest."""
    np.testing.assert_array_equal(got[7], ref[7])
    np.testing.assert_array_equal(got[12], ref[12])
    np.testing.assert_allclose(
        got[:, live_in], ref[:, live_in], rtol=RTOL, atol=ATOL
    )
    assert not got[:, ~live_in].any()
    assert not ref[6:, ~live_in].any()


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["sphere", "cube", "rect"])
def test_geom_t_matches_jax(kind):
    """geom_t / geom_step_n of every row of that kind in wave_scene's
    table, on seeded rays: t within rtol 1e-5 where both hit, the same
    hit/miss set, normals within atol 1e-5 (unnormalized, O(1))."""
    sj = wave_scene()
    st = carried(sj)
    tj, ranges_j = ch_jax.pack_geom_table_sorted(sj)
    tables = wf.wave_tables(st)
    o, d, tm = cam_rays(n=2048, seed=7 + kind)
    q = np.concatenate(
        [np.asarray(o).T, np.asarray(d).T, np.asarray(tm)[None]], axis=0
    ).astype(np.float32)
    rb_j = ch_jax.RayBlock(jnp.asarray(q))
    rb_t = ch.RayBlock(torch.from_numpy(q))
    rows = tables.table.T.tolist()
    spec = ch_jax._kind_spec(kind, False)
    (start, end), = [(s, e) for k, s, e in tables.ranges if k == kind]
    assert (kind, start, end) in ranges_j
    n_hits = 0
    for g in range(start, end):
        t_j, gid, n_j = ch_jax.geom_t(g, tj.T, rb_j, spec, want_normal=True)
        t_t, n_t = ch.geom_t(rows[g], rb_t, kind, want_normal=True)
        t_j = np.asarray(t_j)
        hit = np.isfinite(t_j)
        n_hits += int(hit.sum())
        np.testing.assert_array_equal(np.isfinite(t_t.numpy()), hit)
        np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=1e-5)
        for a, b in zip(n_t, n_j):
            np.testing.assert_allclose(
                a.numpy()[hit], np.asarray(b)[hit], atol=1e-5
            )
        np.testing.assert_array_equal(
            ch.geom_t(rows[g], rb_t, kind).numpy(), t_t.numpy()
        )
        assert float(gid) == rows[g][16]
    assert n_hits >= 10


def test_geom_step_n_first_wins():
    """Strict <: of two identical geoms the first row keeps the hit."""
    st = carried(wave_scene())
    rows = wf.wave_tables(st).table.T.tolist()
    o, d, tm = cam_rays(n=64, seed=2)
    q = torch.from_numpy(
        np.concatenate([np.array(o).T, np.array(d).T, np.array(tm)[None]]).astype(np.float32)
    )
    rb = ch.RayBlock(q)
    z = torch.zeros(64)
    best = (torch.full((64,), float("inf")), torch.full((64,), -1), z, z, z)
    best = ch.geom_step_n(0, best, rows[0], rb, 0)
    again = ch.geom_step_n(5, best, rows[0], rb, 0)
    assert torch.equal(again[1], best[1])
    assert set(best[1].tolist()) <= {-1, 0} and (best[1] == 0).any()


# ---------------------------------------------------------------- (b), (c)
def level_case(name):
    if name == "bvh_glossy":
        sj, st = glossy_scenes()
        o, d, tm = glossy_rays()
    else:
        sj = wave_scene(roughness=0.35 if name == "wave_scene_glossy" else 0.0)
        st = carried(sj)
        o, d, tm = cam_rays(n=384, seed=4)
    return sj, st, np.array(o), np.array(d), np.array(tm)


@pytest.mark.parametrize(
    "name", ["bvh_glossy", "wave_scene", "wave_scene_glossy"]
)
def test_one_level_matches_jax_kernel(name):
    """One level on <= 512 lanes with a mixed act mask and varied
    throughput: bvh_glossy is the flagship's specialisation (cubes + rect,
    2 point lights, in-kernel texture, glossy); wave_scene is spheres +
    cube + rect, untextured."""
    sj, st, o, d, tm = level_case(name)
    n = o.shape[0]
    assert n <= 512
    rng = np.random.default_rng(5)
    act = (rng.random(n) < 0.7).astype(np.float32)
    tp = (0.2 + 0.8 * rng.random(n)).astype(np.float32)
    boot = boot_tensor(o, d, tm, act, tp)
    fuzz = np.array(sphere_jax(jax.random.key(9), (BLOCK,)).T)
    ref = jax_level(sj, boot, fuzz)
    tables = wf.wave_tables(st)
    assert tables.glossy == (name != "wave_scene")
    got = wf.wave_level(
        torch.from_numpy(boot), torch.from_numpy(fuzz), tables
    ).numpy()
    assert got.shape == ref.shape == (13, BLOCK)
    live_in = boot[7] > 0
    assert_level_close(got, ref, live_in)
    # the tile exercises what it claims to
    assert 0 < got[12].sum() < live_in.sum()          # hits and misses
    assert 0 < got[7].sum() <= got[12].sum()          # hits spawn
    assert wf.wave_level.launches == 0                # CPU: no kernel launch


def test_second_level_matches_jax_kernel():
    """Level 1 fed by level 0's output (secondary rays: reflected
    directions, offset origins, shadowed interiors) on bvh_glossy."""
    sj, st, o, d, tm = level_case("bvh_glossy")
    n = o.shape[0]
    boot = boot_tensor(o, d, tm, np.ones(n, np.float32), np.ones(n, np.float32))
    fuzz = np.array(sphere_jax(jax.random.key(1), (BLOCK,)).T)
    tables = wf.wave_tables(st)
    lvl0 = wf.wave_level(torch.from_numpy(boot), torch.from_numpy(fuzz), tables)
    assert lvl0[7].sum() > 10
    ref = jax_level(sj, lvl0.numpy(), fuzz)
    got = wf.wave_level(lvl0, torch.from_numpy(fuzz), tables).numpy()
    assert_level_close(got, ref, lvl0.numpy()[7] > 0)


def test_min_tp_cuts_dim_continuations():
    _, st, o, d, tm = level_case("wave_scene")
    n = o.shape[0]
    boot = torch.from_numpy(
        boot_tensor(o, d, tm, np.ones(n, np.float32), np.full(n, 0.5, np.float32))
    )
    tables = wf.wave_tables(st)
    full = wf.wave_level(boot, None, tables)
    cut = wf.wave_level(boot, None, tables, min_tp=0.12)
    # reflectivities 0.4 / 0.3 / 0.2 at tp 0.5 -> tp2 0.2 / 0.15 / 0.1
    assert 0 < cut[7].sum() < full[7].sum()
    assert float(cut[8][cut[7] > 0].min()) > 0.12
    assert torch.equal(cut[9:12], full[9:12])


def test_level_argument_checks():
    _, st, o, d, tm = level_case("bvh_glossy")
    tables = wf.wave_tables(st)
    boot = torch.zeros((13, 64))
    with pytest.raises(TypeError):
        wf.wave_level(boot, None, tables)              # glossy needs fuzz
    with pytest.raises(ValueError):
        wf.wave_level(boot, torch.zeros((3, 32)), tables)
    with pytest.raises(ValueError):
        wf.wave_level(torch.zeros((8, 64)), torch.zeros((3, 64)), tables)
    with pytest.raises(TypeError):
        wf.wave_level(boot.double(), torch.zeros((3, 64)), tables)
    with pytest.raises(ValueError):
        wf.wave_level(torch.zeros((64, 13)).T, torch.zeros((3, 64)), tables)


# ---------------------------------------------------------------- (d)
def jax_level_fuzz(key, levels, width):
    """The glossy fuzz rows of the JAX fused path, level by level
    (render/integrator.py:355-382)."""
    out = []
    for depth in range(levels):
        k_level = jax.random.fold_in(key, depth)
        out.append(
            np.asarray(sphere_jax(jax.random.fold_in(k_level, 1), (width,)).T)
        )
    return out


@pytest.mark.parametrize("name", ["bvh_glossy", "wave_scene_glossy"])
def test_trace_matches_jax_fused_path(name):
    """The slice as a whole: 11 levels of the port against the JAX fused
    path (in-slot, shrink=(), Pallas in interpret mode) with the JAX level
    fuzz reproduced from the key and fed in.  Radiance within the float
    tolerance; per-level live / hit / spawned counts equal, which pins
    every level's decisions."""
    sj, st, o, d, tm = level_case(name)
    n = o.shape[0]
    key = jax.random.key(21)
    with interpret():
        ref, st_ref = trace_jax(
            sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), key, 1,
            shrink=(), return_stats=True,
        )
    fuzz = [torch.from_numpy(f[:, :n].copy()) for f in jax_level_fuzz(key, 11, BLOCK)]
    got, stats, levels = trace_wavefront(
        st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm), 1,
        fuzz=fuzz, return_stats=True, return_levels=True, device="cpu", shrink=(),
    )
    assert len(levels) == 11 and levels[0].shape == (13, n)
    np.testing.assert_array_equal(stats.live.numpy(), np.asarray(st_ref.live))
    np.testing.assert_array_equal(stats.hits.numpy(), np.asarray(st_ref.hits))
    np.testing.assert_array_equal(stats.spawned.numpy(), np.asarray(st_ref.spawned))
    assert int(stats.dropped.sum()) == 0
    assert int(stats.live[3]) > 0, "the tile must reach deep levels"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # radiance is the sum of the levels' contribution rows
    total = sum(lv[9:12] for lv in levels).T
    np.testing.assert_allclose(got.numpy(), total.numpy(), rtol=1e-6, atol=1e-7)


def test_trace_draws_fuzz_from_generator():
    """Without fuzz passed in, a glossy trace draws from the generator:
    reproducible from the seed, and a glossy scene without either raises."""
    _, st, o, d, tm = level_case("wave_scene_glossy")
    args = (st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm), 1)
    a = trace_wavefront(*args, generator=torch.Generator().manual_seed(3), device="cpu", max_depth=2)
    b = trace_wavefront(*args, generator=torch.Generator().manual_seed(3), device="cpu", max_depth=2)
    c = trace_wavefront(*args, generator=torch.Generator().manual_seed(4), device="cpu", max_depth=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        trace_wavefront(*args, device="cpu")


def test_empty_scene_is_background():
    d = {"cameras": [{"location": [0, 0, 0], "gaze_vector": [0, 1, 0],
                      "up_vector": [0, 0, 1], "focal_length": 20.0,
                      "sensor_width": 36, "sensor_height": 24}],
         "render": {"resolution_x": 8, "resolution_y": 6}}
    st = rt.load_scene_dict(d, device="cpu")
    o, dd, tm = cam_rays(n=16)
    args = [torch.from_numpy(np.array(x)) for x in (o, dd, tm)]
    rad, stats = trace_wavefront(st, *args, 1, return_stats=True, device="cpu")
    np.testing.assert_allclose(rad.numpy(), np.full((16, 3), 0.1, np.float32))
    assert stats.live.tolist() == [16] and stats.hits.tolist() == [0]


def test_trace_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, st, o, d, tm = level_case("wave_scene")
    with pytest.raises((AssertionError, RuntimeError)):
        trace_wavefront(st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm), 1)


# ---------------------------------------------------------------- (e)
def _scene_with(**changes):
    return dataclasses.replace(carried(wave_scene()), **changes)


def _area_scene():
    sc = carried(wave_scene())
    return dataclasses.replace(sc, lights=dataclasses.replace(sc.lights, is_area=(True, False)))


# feature -> (scene, light_samples)
GATE_CASES = {
    "two-way materials": lambda: (_scene_with(has_refraction=True, has_two_way=True), 1),
    "more than 8 lights": lambda: (_scene_with(n_lights=9), 1),
    # 6145 rows: one over the JAX package's WAVE_MAX_GEOMS
    "a shaded table of 6145 geoms": lambda: (_scene_with(n_prims=6145), 1),
    # 33 jittered shadow rays of one area light: over JAX's fuzz cap
    "more than 32 area-light samples": lambda: (_area_scene(), 33),
}


@pytest.mark.parametrize("feature", sorted(GATE_CASES))
def test_gate_refuses_by_name(feature):
    """The gate answers with the feature (`wave_refusal`), and raises with
    it for a caller that forces the fused path."""
    scene, samples = GATE_CASES[feature]()
    assert feature in wf.wave_refusal(scene, light_samples=samples)
    with pytest.raises(NotImplementedError, match=feature):
        wf.wave_supported(scene, light_samples=samples)
    o, d, tm = cam_rays(n=8)
    with pytest.raises(NotImplementedError, match=feature):
        trace_wavefront(
            scene, *(torch.from_numpy(np.array(x)) for x in (o, d, tm)), samples,
            fused=True, device="cpu",
        )


def test_gate_takes_what_the_jax_gate_takes():
    """Motion blur, one-way refraction, legacy planes, area lights (up to
    32 samples in all) and textured spheres pass the port's gate exactly
    where they pass the JAX package's `wave_supported`."""
    cases = {
        "motion blur": (_scene_with(has_motion=True), 1),
        "refraction": (_scene_with(has_refraction=True), 1),
        "legacy planes": (_scene_with(n_planes=1), 1),
        "area lights, 32 samples": (_area_scene(), 32),
        "textured spheres": (_scene_with(has_textures=True, tex_atlas=torch.zeros(1, 2, 2, 3)), 1),
    }
    for name, (scene, samples) in cases.items():
        assert wf.wave_refusal(scene, light_samples=samples) is None, name
        assert wf.wave_supported(scene, light_samples=samples), name
    sj = rt_jax.load_scene(os.path.join(REPO, "scenes", "softshadow.json"), textures_dir=TEX)
    st = rt.load_scene(os.path.join(REPO, "scenes", "softshadow.json"), textures_dir=TEX,
                       device="cpu")
    for samples in (1, 16, 32, 33, 64):
        assert (wf.wave_refusal(st, light_samples=samples) is None) == \
            wf_jax.wave_supported(sj, light_samples=samples), samples


@pytest.mark.parametrize(
    "kwargs,feature",
    [({"use_bvh": True}, "use_bvh"), ({"differentiable": True}, "record mode")],
)
def test_gate_refuses_options_by_name(kwargs, feature):
    st = carried(wave_scene())
    assert wf.wave_supported(st) and wf.wave_refusal(st) is None
    o, d, tm = cam_rays(n=8)
    rays = [torch.from_numpy(np.array(x)) for x in (o, d, tm)]
    if "differentiable" in kwargs:
        # Record mode is refused no more: the gate that takes the scene
        # takes it differentiable too, down the fused path (its record-mode
        # level gives the inference radiance bit for bit), forced or not.
        ref = trace_wavefront(st, *rays, 1, device="cpu")
        assert torch.equal(trace_wavefront(st, *rays, 1, device="cpu", **kwargs), ref)
        assert torch.equal(
            trace_wavefront(st, *rays, 1, device="cpu", fused=True, **kwargs), ref
        )
        return
    with pytest.raises(NotImplementedError, match=feature):
        wf.wave_supported(st, **kwargs)
    # use_bvh belongs to the general path: only a forced fused path
    # refuses it.
    with pytest.raises(NotImplementedError, match=feature):
        trace_wavefront(st, *rays, 1, device="cpu", **dict(kwargs, fused=True))
    general = trace_wavefront(st, *rays, 1, device="cpu", fused=False)
    routed = trace_wavefront(st, *rays, 1, device="cpu", **kwargs)
    assert torch.equal(routed, general)


def test_gate_refuses_committed_scenes_by_name():
    """The committed demo scenes outside the fused level's scope each name
    their feature (and render down the general path); the flagship family
    passes."""
    expect = {
        "bvh_det": None, "bvh_glossy": None, "det_mirrors": None,
        "glossy": None,
        "det_basic": None, "det_twoway": "two-way",
        "dof": None, "motion": None, "softshadow": None,
        "texture": None,
    }
    for name, feature in expect.items():
        st = rt.load_scene(
            os.path.join(REPO, "scenes", f"{name}.json"), textures_dir=TEX,
            device="cpu",
        )
        # softshadow at its golden's 16 samples a light
        samples = 16 if name == "softshadow" else 1
        if feature is None:
            assert wf.wave_supported(st, light_samples=samples), name
            assert wf.wave_refusal(st, light_samples=samples) is None
        else:
            assert feature in wf.wave_refusal(st)
            with pytest.raises(NotImplementedError, match=feature):
                wf.wave_supported(st)
    assert wf.wave_refusal(models.get("cornell", res=(8, 8), device="cpu"),
                           light_samples=4) is None


def test_gate_keeps_every_fused_scene_under_the_kernels_shared_memory():
    """The size gate is the JAX package's, on the geom count: every
    committed scene, the flagship and the zoo's large scenes are refused
    exactly where `wave_supported` of the JAX package refuses them
    (cube_city(2048), over what a block stages, is taken by the level's
    wide build; sphere_field(20000) is over WAVE_MAX_GEOMS).  The largest
    table a block stages (the level kernel's own shared memory: table,
    lights, the staging list, a chunk's bits, the shadow queue, the window
    records and the permuted rows) stays within 10 % of what the table, its
    permuted rows, its window records and the lights alone would allow."""
    from ray_tracying_tpu import models as models_jax
    from ray_tracying_tpu_torch import models

    new, jax_says = {}, {}
    for path in sorted(os.listdir(os.path.join(REPO, "scenes"))) + ["flagship"]:
        full = (os.path.join(REPO, "golden", "ASCII", "scene.json") if path == "flagship"
                else os.path.join(REPO, "scenes", path))
        new[path] = wf.wave_refusal(rt.load_scene(full, textures_dir=TEX, device="cpu"))
        jax_says[path] = wf_jax.wave_supported(rt_jax.load_scene(full, textures_dir=TEX))
    for name, n in (("cube_city", 2048), ("sphere_field", 20000)):
        new[name] = wf.wave_refusal(models.get(name, n=n, res=(8, 6), device="cpu"))
        jax_says[name] = wf_jax.wave_supported(models_jax.get(name, n=n, res=(8, 6)))
    assert len(new) == 13 and new.keys() == jax_says.keys()
    assert {k: v is None for k, v in new.items()} == jax_says
    assert new["flagship"] is None and new["cube_city"] is None
    assert "shaded table of 20001 geoms" in new["sphere_field"]
    for n_cols in (31, 32):
        for lights in (1, 2, 8):
            old_cap = (wf.WAVE_MAX_SMEM_BYTES // 4 - 8 * lights
                       - wf.WIN_REC * wf.WAVE_MAX_RANGES) \
                // (n_cols + wf.WIN_COLS + wf.WIN_REC / wf.WAVE_WINDOW)
            cap = wf.wave_cap_geoms(n_cols, lights)
            assert 0.9 * old_cap <= cap < old_cap


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrapper's dispatch: a CUDA tensor goes to the launcher (which
    builds the kernel or raises), never to wave_level_plain."""
    _, st, o, d, tm = level_case("wave_scene")
    tables = wf.wave_tables(st)
    called = []
    monkeypatch.setattr(wf, "_launch", lambda *a: called.append(a) or "launched")
    monkeypatch.setattr(wf, "wave_level_plain", lambda *a, **k: pytest.fail("plain"))

    class FakeCuda(torch.Tensor):
        is_cuda = True

    boot = torch.zeros((13, 8)).as_subclass(FakeCuda)
    assert wf.wave_level(boot, None, tables) == "launched"
    assert len(called) == 1

