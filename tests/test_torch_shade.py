"""The port's materials and shading against the JAX package's.

`gather_materials` is an indexed row load on both sides: exact.  `shade`
runs Blinn-Phong plus one shadow any-hit search per light; the JAX side
runs its Pallas occlusion kernel in interpret mode, the port its plain
version, and an area light's jitter draws are made with the JAX sampler
from the key `shade` would fold (render/shade.py:127-129) and fed to the
port.  Tolerance rtol 1e-4 / atol 1e-6 on valid lanes: the two sides
divide, normalize and take pow in their own f32 libraries.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tracying_tpu as rt_jax
import ray_tracying_tpu_torch as rt
from ray_tracying_tpu.core.sampling import uniform_in_unit_sphere as sphere_jax
from ray_tracying_tpu.render import intersect as I_jax
from ray_tracying_tpu.render import materials as M_jax
from ray_tracying_tpu.render import shade as S_jax
from ray_tracying_tpu.scene.loader import load_scene_dict as load_jax
from ray_tracying_tpu_torch.render import intersect as I
from ray_tracying_tpu_torch.render import materials as M
from ray_tracying_tpu_torch.render import shade as S
from ray_tracying_tpu_torch.render.pipeline import tile_rays
from ray_tracying_tpu_torch.scene.convert import scene_from_numpy

from test_scene_loader import minimal_camera
from test_torch_intersect import interpret, tt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
RTOL, ATOL = 1e-4, 1e-6


def lit_dict():
    """Spheres, a cube and a floor under a point light and an area light;
    one material of each flavour (plain, shiny, mirror, glass)."""
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 2, 6], "color": [1, 0.9, 0.8], "intensity": 300.0},
        {"location": [-3, 4, 4], "color": [0.6, 0.7, 1.0], "intensity": 200.0,
         "radius": 0.6},
    ]
    d["spheres"] = [
        {"location": [0, 6, 0], "radius": 1.2,
         "material": {"diffuse_color": [0.8, 0.2, 0.2], "roughness": 0.2}},
        {"location": [2.2, 5, 0.3], "radius": 0.8,
         "material": {"diffuse_color": [0.2, 0.8, 0.3], "reflectivity": 0.5}},
        {"location": [-2.0, 5, 0.2], "radius": 0.7,
         "material": {"transparency": 0.7, "refractive_index": 1.4}},
    ]
    d["cubes"] = [{"translation": [0.5, 4, -0.8], "rotation": [0.2, 0.3, 0.5],
                   "scale": [0.8, 0.8, 0.8]}]
    d["rectangles"] = [{"translation": [0, 6, -1.3], "rotation": [0, 0, 0],
                        "scale": [14, 14, 1],
                        "material": {"diffuse_color": [0.6, 0.6, 0.6]}}]
    return d


def lit_scenes():
    sj = load_jax(lit_dict())
    return sj, scene_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")


def lit_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 0.5
    d = np.stack([rng.uniform(-0.5, 0.5, n), np.ones(n), rng.uniform(-0.4, 0.1, n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.zeros(n, np.float32)


def test_gather_materials_is_exact():
    sj, st = lit_scenes()
    rng = np.random.default_rng(0)
    gid = rng.integers(-1, st.n_geoms, size=200).astype(np.int32)
    ref = M_jax.gather_materials(sj, jnp.asarray(gid))
    got = M.gather_materials(st, torch.from_numpy(gid))
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got.tex_id.dtype == torch.int32
    assert not got.diffuse.numpy()[gid < 0].any()


def test_safe_pow_matches_jax():
    rng = np.random.default_rng(1)
    base = np.concatenate([rng.uniform(0, 1, 500), [0.0, 1.0, 1e-13]]).astype(np.float32)
    exp = np.concatenate([rng.uniform(0.5, 400, 500), [20.0, 5e6, 3.0]]).astype(np.float32)
    ref = np.asarray(S_jax.safe_pow(jnp.asarray(base), jnp.asarray(exp)))
    got = S.safe_pow(*tt(base, exp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-30)
    assert got[500] == 0.0 and got[501] == 1.0


@pytest.mark.parametrize("light_samples", [1, 3])
def test_shade_matches_jax(light_samples):
    """A point and an area light, the area light's draws fed from the JAX
    stream; a random act mask reaches the shadow searches."""
    sj, st = lit_scenes()
    assert st.lights.is_area == (False, True)
    n = 128
    o, d, tm = lit_rays(n, seed=2)
    act = np.random.default_rng(3).random(n) < 0.8
    key = jax.random.key(11)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    with interpret():
        hit_j = I_jax.closest_hit(sj, jo, jd, jt, differentiable=False)
        ref = np.asarray(
            S_jax.shade(sj, hit_j, jo, key, light_samples, active=jnp.asarray(act))
        )
    jitter = [
        None,
        torch.from_numpy(np.array(
            sphere_jax(jax.random.fold_in(key, 1), (n, light_samples))
        )),
    ]
    hit_t = I.closest_hit(st, *tt(o, d, tm), differentiable=False)
    got = S.shade(
        st, hit_t, torch.from_numpy(o), None, light_samples,
        active=torch.from_numpy(act), jitter=jitter,
    ).numpy()
    m = np.asarray(hit_j.valid) & act
    assert got.shape == (n, 3) and m.sum() > 60
    np.testing.assert_allclose(got[m], ref[m], rtol=RTOL, atol=ATOL)
    # lit and shadowed lanes both occur
    assert (got[m].max(axis=1) > 0.3).any() and (got[m].max(axis=1) < 0.15).any()


def test_shade_draws_area_jitter_from_the_generator():
    _, st = lit_scenes()
    o, d, tm = lit_rays(64, seed=4)
    hit = I.closest_hit(st, *tt(o, d, tm), differentiable=False)
    run = lambda seed: S.shade(
        st, hit, torch.from_numpy(o), torch.Generator().manual_seed(seed), 4
    )
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_shade_textured_sphere_matches_jax():
    """scenes/texture.json: spherical UV from pass 2, the nearest texel
    times the diffuse tint (sample_diffuse_color)."""
    path = os.path.join(REPO, "scenes", "texture.json")
    sj = rt_jax.load_scene(path, textures_dir=TEX)
    st = rt.load_scene(path, textures_dir=TEX, device="cpu")
    assert st.has_textures and st.has_spheres
    w, h = st.camera.resolution
    o, d, tm = tile_rays(st.camera, h // 2 - 1, 2, w, 1)
    jo, jd, jt = (jnp.asarray(x.numpy()) for x in (o, d, tm))
    key = jax.random.key(0)
    with interpret():
        hit_j = I_jax.closest_hit(sj, jo, jd, jt, differentiable=False)
        ref = np.asarray(S_jax.shade(sj, hit_j, jo, key, 1))
        base_j = np.asarray(S_jax.sample_diffuse_color(
            sj, M_jax.gather_materials(sj, hit_j.geom_id), hit_j.uv
        ))
    hit_t = I.closest_hit(st, o, d, tm, differentiable=False)
    base_t = S.sample_diffuse_color(
        st, M.gather_materials(st, hit_t.geom_id), hit_t.uv
    ).numpy()
    got = S.shade(st, hit_t, o, None, 1).numpy()
    m = np.asarray(hit_j.valid)
    np.testing.assert_array_equal(hit_t.valid.numpy(), m)
    assert m.sum() > 40
    # a texel boundary may fall between the two sides' uv: allow 2 % of lanes
    same = np.isclose(base_t[m], base_j[m], rtol=RTOL, atol=ATOL).all(axis=1)
    assert same.mean() >= 0.98
    ok = np.isclose(got[m], ref[m], rtol=RTOL, atol=ATOL).all(axis=1)
    assert (ok | ~same).all()
    assert len(np.unique(np.round(base_t[m], 3), axis=0)) > 3  # texels vary
