"""Camera ray generation of the port against the JAX package, on the same
draws.  The JAX side makes the jitter, lens and time draws from its keys
(the splits of render/pipeline.py::_render_tile); the port receives them
as tensors.

Tolerance: atol 1e-6 on unit directions and on origins of a few units.
Both sides do the same f32 arithmetic; what differs is the last bit of
sqrt/divide in the two frameworks' normalize and XLA's fusion of a*b+c."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tracying_tpu as rt_jax
import ray_tracying_tpu_torch as rt
from ray_tracying_tpu.core.sampling import uniform_in_unit_disk as disk_jax
from ray_tracying_tpu.render.camera import camera_basis as basis_jax
from ray_tracying_tpu.render.camera import pixel_rays as pixel_rays_jax
from ray_tracying_tpu_torch.core.sampling import (
    uniform_in_unit_disk,
    uniform_in_unit_sphere,
)
from ray_tracying_tpu_torch.render.camera import camera_basis, pixel_rays
from ray_tracying_tpu_torch.render.pipeline import tile_rays

# Small tensors: one thread each is fastest and keeps parallel test
# workers from oversubscribing the host.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
ATOL = 1e-6


def both(name):
    path = os.path.join(REPO, "scenes", f"{name}.json")
    return (
        rt_jax.load_scene(path, textures_dir=TEX),
        rt.load_scene(path, textures_dir=TEX, device="cpu"),
    )


def jax_tile_rays(scene, y0, key, rows, width, samples_sqrt):
    """The ray-generation half of the JAX package's _render_tile
    (render/pipeline.py:77-109), with its draws returned beside the rays."""
    spp = samples_sqrt * samples_sqrt if samples_sqrt > 1 else 1
    k_jit, k_lens, k_time, _ = jax.random.split(key, 4)
    ys = y0 + jnp.arange(rows, dtype=jnp.float32)[:, None, None]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :, None]
    jitter = None
    if samples_sqrt <= 1:
        sub = jnp.full((rows, width, 1, 2), 0.5, jnp.float32)
    else:
        jitter = jax.random.uniform(
            k_jit, (rows, width, samples_sqrt, samples_sqrt, 2), jnp.float32
        )
        jy = jnp.arange(samples_sqrt, dtype=jnp.float32)[:, None, None]
        ix = jnp.arange(samples_sqrt, dtype=jnp.float32)[None, :, None]
        strata = jnp.stack(
            [
                jnp.broadcast_to(ix, (samples_sqrt, samples_sqrt, 1))[..., 0],
                jnp.broadcast_to(jy, (samples_sqrt, samples_sqrt, 1))[..., 0],
            ],
            axis=-1,
        )
        sub = (strata[None, None] + jitter) / samples_sqrt
        sub = sub.reshape(rows, width, spp, 2)
    px = (xs + sub[..., 0]).reshape(-1)
    py = (ys + sub[..., 1]).reshape(-1)
    o, d = pixel_rays_jax(scene.camera, px, py, k_lens)
    times = jax.random.uniform(k_time, px.shape, jnp.float32)
    lens = disk_jax(k_lens, px.shape)
    return o, d, times, jitter, lens


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ["bvh_det", "dof"])
def test_camera_basis_matches_jax(name):
    sj, st = both(name)
    for a, b in zip(basis_jax(sj.camera), camera_basis(st.camera)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["bvh_det", "dof"])
def test_pixel_rays_match_jax(name):
    """pixel_rays on seeded fractional pixel positions with the JAX lens
    draws: pinhole (bvh_det) and thin lens (dof)."""
    sj, st = both(name)
    rng = np.random.default_rng(11)
    w, h = st.camera.resolution
    px = (rng.random(500) * w).astype(np.float32)
    py = (rng.random(500) * h).astype(np.float32)
    key = jax.random.key(3)
    oj, dj = pixel_rays_jax(sj.camera, jnp.asarray(px), jnp.asarray(py), key)
    lens = disk_jax(key, px.shape)
    o, d = pixel_rays(st.camera, t(px), t(py), lens=t(lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), atol=ATOL, rtol=0)
    if name == "dof":
        assert float(st.camera.aperture) > 0
        assert np.abs(o.numpy() - o.numpy()[0]).max() > 0  # origins jitter
    else:
        np.testing.assert_array_equal(o.numpy(), np.broadcast_to(st.camera.location.numpy(), o.shape))


@pytest.mark.parametrize("name", ["bvh_det", "dof"])
@pytest.mark.parametrize("samples_sqrt", [1, 3])
def test_tile_rays_match_jax(name, samples_sqrt):
    """The ray-generation half of _render_tile: 1 spp centre rays and 3x3
    stratified, on a tile in the middle of the image."""
    sj, st = both(name)
    w, h = st.camera.resolution
    rows, y0 = 3, h // 2
    key = jax.random.fold_in(jax.random.key(5), 2)
    oj, dj, tj, jitter, lens = jax_tile_rays(
        sj, jnp.float32(y0), key, rows, w, samples_sqrt
    )
    o, d, tm = tile_rays(
        st.camera, y0, rows, w, samples_sqrt,
        jitter=t(jitter), lens=t(lens), times=t(tj),
    )
    spp = samples_sqrt * samples_sqrt if samples_sqrt > 1 else 1
    assert o.shape == (rows * w * spp, 3) and d.shape == o.shape
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(tj))
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=1), 1.0, atol=1e-5)


def test_tile_rays_draws_from_generator():
    """Without draws passed in, jitter, lens and times come from the
    generator: reproducible from its seed, different between seeds."""
    _, st = both("dof")
    w, _ = st.camera.resolution

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tile_rays(st.camera, 10, 2, w, 2, generator=g)

    a, b, c = run(1), run(1), run(2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[2], c[2])
    assert float(a[2].min()) >= 0.0 and float(a[2].max()) < 1.0


def test_samplers_cover_their_domains():
    """uniform_in_unit_sphere / uniform_in_unit_disk: inside the unit
    ball / disk, with the radial law of a uniform density (mean radius
    3/4 and 2/3) within 1 % at 200k draws."""
    g = torch.Generator().manual_seed(0)
    s = uniform_in_unit_sphere(g, (200_000,))
    assert s.shape == (200_000, 3)
    r = s.norm(dim=1)
    assert float(r.max()) <= 1.0 + 1e-6
    assert abs(float(r.mean()) - 0.75) < 0.0075
    assert float(s.mean(dim=0).abs().max()) < 0.01
    d = uniform_in_unit_disk(g, (200_000,))
    assert d.shape == (200_000, 2)
    r = d.norm(dim=1)
    assert float(r.max()) <= 1.0 + 1e-6
    assert abs(float(r.mean()) - 2.0 / 3.0) < 0.0067
