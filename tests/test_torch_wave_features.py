"""The fused level's specialisations against the JAX package's fused path:
one-way refraction and a legacy plane (det_basic), moving spheres
(motion), an area light (softshadow, 4 samples), planes + mirror + glass +
area light (cornell), a textured sphere (texture: spherical UV in the
port's level, in the JAX package's glue).  Then the port's fused path
against its own general path on the same scenes.

The JAX side runs its Pallas kernel in interpret mode on the CPU, in a
subprocess whose XLA may not use FMA instructions (`--xla_cpu_max_isa=
SSE4_2`): with them XLA contracts some a*b+c, which the port's plain
version never does, and the hit points of far, small spheres and the
refracted rays through them carry that last bit to a few 1e-5.  Without
them the two sides do the same f32 operations, and the file's tolerance
is the bar of tests/test_torch_wavefront.py: rtol 2e-5, atol 2e-6, with
decision rows (act, act_hit) and per-level counts equal.

    python tests/test_torch_wave_features.py <scene> <out.npz>

writes that scene's JAX references (what the fixture `jax_refs` runs)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_wavefront import ATOL, BLOCK, RTOL, assert_level_close, boot_tensor

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TEX = os.path.join(REPO, "golden", "Textures")

# light_samples of the scenes with an area light
FEATURE_SAMPLES = {"softshadow": 4, "cornell": 4}
LEVEL_SCENES = ["det_basic", "motion", "softshadow", "cornell"]
TRACE_SCENES = LEVEL_SCENES + ["texture"]
KEY_LEVEL, KEY_TRACE = 9, 21

torch.set_num_threads(1)


def port_scene(name):
    import ray_tracying_tpu_torch as rt
    from ray_tracying_tpu_torch import models

    if name == "cornell":
        return models.get("cornell", res=(48, 48), device="cpu")
    return rt.load_scene(os.path.join(REPO, "scenes", f"{name}.json"), textures_dir=TEX,
                         device="cpu")


def feature_case(name):
    """(port scene, o, d, tm, light samples): primary rays of the middle
    rows (384 lanes at 1 spp), with their times."""
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    st = port_scene(name)
    w, h = st.camera.resolution
    n_rows = 384 // w
    o, d, tm = tile_rays(st.camera, h // 2 - n_rows // 2, n_rows, w, 1,
                         generator=torch.Generator().manual_seed(3))
    return st, o.numpy(), d.numpy(), tm.numpy(), FEATURE_SAMPLES.get(name, 1)


def level_inputs(st, o, d, tm):
    """(13, BLOCK) bootstrap tensor with a mixed act mask and throughput:
    the given lanes, then dead padding up to the JAX kernel's block."""
    rng = np.random.default_rng(6)
    act = (rng.random(o.shape[0]) < 0.8).astype(np.float32)
    return boot_tensor(o, d, tm, act, (0.2 + 0.8 * rng.random(o.shape[0])).astype(np.float32))


def jax_fuzz_rows(sj, nss, k_level):
    """The fuzz rows of one level of the JAX fused path (render/
    integrator.py:355-376): glossy rows from fold_in(k, 1), then each area
    light's (width, nss) draws from fold_in(k, 2 + light) as 3 * nss rows;
    None for a scene with neither."""
    import jax

    from ray_tracying_tpu.core.sampling import uniform_in_unit_sphere as sphere_jax

    parts = []
    if sj.has_glossy:
        parts.append(np.asarray(sphere_jax(jax.random.fold_in(k_level, 1), (BLOCK,)).T))
    for li, area in enumerate(sj.lights.is_area):
        if area:
            b = np.asarray(sphere_jax(jax.random.fold_in(k_level, 2 + li), (BLOCK, nss)))
            parts.append(b.transpose(1, 2, 0).reshape(3 * nss, BLOCK))
    return np.ascontiguousarray(np.concatenate(parts), np.float32) if parts else None


def port_draws(st, rows, nss, n):
    """JAX fuzz rows as the port's trace takes them: the glossy (3, n)
    rows and each area light's (n, nss, 3) jitter (None where none)."""
    fz, glossy, jitter = 0, None, []
    if st.has_glossy:
        glossy, fz = torch.from_numpy(rows[:3, :n].copy()), 3
    for area in st.lights.is_area:
        if not area:
            jitter.append(None)
            continue
        b = rows[fz : fz + 3 * nss].reshape(nss, 3, BLOCK).transpose(2, 0, 1)[:n]
        jitter.append(torch.from_numpy(b.copy()))
        fz += 3 * nss
    return glossy, jitter


def write_jax_refs(name, out):
    """The JAX references of one scene: levels 0 and 1 of wave_level_call
    (level 1 fed by the port's level 0) and the whole fused trace, with
    the fuzz rows of both (drawn here: the draws' own arithmetic runs on
    the same ISA as the references)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import ray_tracying_tpu as rt_jax
    from ray_tracying_tpu.kernels import wavefront as wf_jax
    from ray_tracying_tpu.models import zoo as zoo_jax
    from ray_tracying_tpu.render.integrator import trace_wavefront as trace_jax
    from ray_tracying_tpu_torch.kernels import wavefront as wf

    os.environ["RTT_PALLAS_INTERPRET"] = "1"
    sj = (zoo_jax.cornell(res=(48, 48)) if name == "cornell" else
          rt_jax.load_scene(os.path.join(REPO, "scenes", f"{name}.json"), textures_dir=TEX))
    st, o, d, tm, nss = feature_case(name)
    res = {}
    if name in LEVEL_SCENES:
        boot = level_inputs(st, o, d, tm)
        rows = jax_fuzz_rows(sj, nss, jax.random.key(KEY_LEVEL))
        if rows is not None:
            res["level_fuzz"] = rows
        fuzz = None if rows is None else torch.from_numpy(rows)
        tables = wf.wave_tables(st, light_samples=nss)
        lvl0 = wf.wave_level(torch.from_numpy(boot), fuzz, tables).numpy()
        table, ranges, lights = wf_jax.wave_tables(sj)
        jrows = jnp.asarray(np.zeros((1, BLOCK), np.float32) if rows is None else rows)
        for lv, prev in ((0, boot), (1, lvl0)):
            res[f"level{lv}"] = np.asarray(wf_jax.wave_level_call(
                jnp.asarray(prev), jrows, table, lights, jnp.zeros((8, 128), jnp.bfloat16),
                jnp.zeros((2, 1), jnp.float32), ranges, sj.has_motion, sj.n_lights,
                sj.has_glossy, sj.has_refraction, 0.0, sj.has_textures,
                (sj.has_spheres, sj.has_cubes, sj.has_rects, sj.n_planes > 0),
                tuple(sj.lights.is_area), nss, False, 0,
            ))
    key = jax.random.key(KEY_TRACE)
    rad, stats = trace_jax(sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), key, nss,
                           shrink=(), return_stats=True)
    res["radiance"] = np.asarray(rad)
    res["counts"] = np.stack([np.asarray(stats.live), np.asarray(stats.hits),
                              np.asarray(stats.spawned)])
    n_levels = res["counts"].shape[1]
    for depth in range(n_levels):
        rows = jax_fuzz_rows(sj, nss, jax.random.fold_in(key, depth))
        if rows is not None:
            res[f"trace_fuzz{depth}"] = rows
    np.savez(out, **res)


_REFS = {}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """name -> the JAX references of that scene, computed once in a
    subprocess whose XLA uses no FMA instructions."""
    def get(name):
        if name not in _REFS:
            out = str(tmp_path_factory.mktemp("jax_refs") / f"{name}.npz")
            env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                       XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
            env.pop("JAX_COMPILATION_CACHE_DIR", None)
            subprocess.run([sys.executable, os.path.abspath(__file__), name, out],
                           check=True, env=env, cwd=REPO, timeout=600)
            _REFS[name] = dict(np.load(out))
        return _REFS[name]
    return get


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name", LEVEL_SCENES)
def test_feature_level_matches_jax_kernel(jax_refs, name, level):
    """One level of wave_level_plain against wave_level_call on the same
    rays (mixed act mask and throughput) and fuzz rows (JAX's layout):
    level 0, and level 1 fed by the port's level 0 (rays leaving the
    glass, reflected and refracted ones, shadowed interiors)."""
    from ray_tracying_tpu_torch.kernels import wavefront as wf

    ref = jax_refs(name)
    st, o, d, tm, nss = feature_case(name)
    rows = ref.get("level_fuzz")
    fuzz = None if rows is None else torch.from_numpy(rows)
    tables = wf.wave_tables(st, light_samples=nss)
    assert wf.fuzz_rows(tables) == (0 if rows is None else rows.shape[0])
    prev = torch.from_numpy(level_inputs(st, o, d, tm))
    if level == 1:
        prev = wf.wave_level(prev, fuzz, tables)
        if not (st.has_reflection or st.has_refraction):
            assert not prev[7].any()
        else:
            assert prev[7].sum() > 5
    rec = wf.wave_level(prev, fuzz, tables, record=True)
    got = rec[:13].numpy()
    assert got.shape == ref[f"level{level}"].shape == (13, BLOCK)
    assert_level_close(got, ref[f"level{level}"], prev.numpy()[7] > 0)
    assert got[12].sum() > 0 or level == 1
    if level == 0 and any(st.lights.is_area):
        # some lanes see part of the area light: a fraction of the samples
        frac = rec[14][(rec[14] > 0) & (rec[14] < 1)]
        assert len(frac) > 0 and set((frac * nss).round().tolist()) <= set(range(1, nss))


@pytest.mark.parametrize("name", TRACE_SCENES)
def test_feature_trace_matches_jax_fused_path(jax_refs, name):
    """The 11-level trace (1 level where nothing spawns) against the JAX
    fused path (in-slot, shrink=(), Pallas in interpret mode), JAX's draws
    fed in as glossy fuzz and area-light jitter.  texture: the port's
    in-level spherical UV against the JAX package's glue.  Radiance at
    RTOL/ATOL; per-level live / hit / spawned counts equal."""
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront

    ref = jax_refs(name)
    st, o, d, tm, nss = feature_case(name)
    n = o.shape[0]
    n_levels = 11 if (st.has_reflection or st.has_refraction) else 1
    assert ref["counts"].shape == (3, n_levels)
    fuzz, jitter = [], []
    for depth in range(n_levels):
        rows = ref.get(f"trace_fuzz{depth}")
        g, j = port_draws(st, rows, nss, n) if rows is not None else (None, None)
        fuzz.append(g)
        jitter.append(j)
    got, stats, levels = trace_wavefront(
        st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm), nss,
        fuzz=fuzz if st.has_glossy else None,
        light_jitter=jitter if any(st.lights.is_area) else None,
        return_stats=True, return_levels=True, device="cpu", shrink=(),
    )
    assert len(levels) == n_levels
    counts = torch.stack([stats.live, stats.hits, stats.spawned]).numpy()
    np.testing.assert_array_equal(counts, ref["counts"])
    assert int(stats.hits[0]) > 0
    if n_levels > 1:
        assert int(stats.live[2]) > 0, "the tile must reach past level 1"
    np.testing.assert_allclose(got.numpy(), ref["radiance"], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Fused against general, both the port's, on the CPU
# ---------------------------------------------------------------------------

def _lit_by_a_point(scene):
    li = scene.lights
    return dataclasses.replace(scene, lights=dataclasses.replace(
        li, radius=torch.zeros_like(li.radius), is_area=tuple(False for _ in li.is_area)))


def whole_frame(st):
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    w, h = st.camera.resolution
    return tile_rays(st.camera, 0, h, w, 1, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["det_basic", "texture", "cornell_point"])
def test_fused_and_general_paths_give_the_same_image(name):
    """Deterministic scenes down both paths, the whole frame at 1 spp: the
    same 8-bit image (the reference's output encoding), and radiance at
    RTOL/ATOL on all but the few lanes where the two paths' different
    arithmetic (pass 2 rebuilds the hit, the level keeps the loop's) puts
    a texel fetch or a tie on the other side (at most 0.5 %).
    cornell_point: cornell with its light made a point light."""
    from ray_tracying_tpu_torch.kernels import wavefront as wf
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import linear_to_srgb_u8

    st = (_lit_by_a_point(port_scene("cornell")) if name == "cornell_point"
          else port_scene(name))
    o, d, tm = whole_frame(st)
    assert wf.wave_refusal(st) is None
    fused = trace_wavefront(st, o, d, tm, 1, fused=True, device="cpu")
    general = trace_wavefront(st, o, d, tm, 1, fused=False, device="cpu")
    diff = np.abs(linear_to_srgb_u8(fused).numpy().astype(int)
                  - linear_to_srgb_u8(general).numpy().astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    off = ~np.isclose(fused.numpy(), general.numpy(), rtol=RTOL, atol=ATOL).all(axis=1)
    assert off.mean() <= 0.005, int(off.sum())


def test_fused_and_general_paths_take_the_same_area_light_jitter():
    """softshadow (4 samples) down both paths with the same area-light
    jitter fed in: radiance at RTOL/ATOL (a shadow ray that grazes its
    blocker may flip one sample: at most 0.5 % of lanes); one generator
    seed gives both paths the same draws."""
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront

    st = port_scene("softshadow")
    o, d, tm = whole_frame(st)
    jitter = [[uniform_in_unit_sphere(torch.Generator().manual_seed(4), (o.shape[0], 4))]]
    fused = trace_wavefront(st, o, d, tm, 4, light_jitter=jitter, fused=True, device="cpu")
    general = trace_wavefront(st, o, d, tm, 4, light_jitter=jitter, fused=False, device="cpu")
    off = ~np.isclose(fused.numpy(), general.numpy(), rtol=RTOL, atol=ATOL).all(axis=1)
    assert off.mean() <= 0.005, int(off.sum())
    assert len(np.unique(fused.numpy().max(axis=1).round(4))) > 50  # penumbrae
    seeded = [trace_wavefront(st, o, d, tm, 4, generator=torch.Generator().manual_seed(4),
                              fused=f, device="cpu") for f in (True, False)]
    assert torch.equal(seeded[0], fused) and torch.equal(seeded[1], general)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    write_jax_refs(sys.argv[1], sys.argv[2])
