"""The port's op-level API (ray_tracying_tpu_torch.ops) against the JAX
package's: the same names (less the LBVH build functions, which come with the
acceleration kernels), the small vector and transform ops value for value,
and a one-level integrator composed from the ops alone."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ray_tracying_tpu.ops as ops_jax
import ray_tracying_tpu_torch as rt
import ray_tracying_tpu_torch.ops as ops
from ray_tracying_tpu.core import vecmath as V_jax
from ray_tracying_tpu_torch.core import vecmath as V

from test_scene_loader import minimal_camera

torch.set_num_threads(1)


def vecs(seed, n=200):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    return a, b


def test_ops_names_are_the_jax_packages_less_the_lbvh_functions():
    """Nothing is left out any more: the LBVH functions came with the
    acceleration kernels."""
    assert sorted(ops.__all__) == sorted(ops_jax.__all__)
    assert {"build_lbvh", "with_bvh"} <= set(ops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name
    assert ops.Hit._fields == ops_jax.Hit._fields


@pytest.mark.parametrize("name", ["dot", "normalize", "reflect", "cross", "norm"])
def test_vector_ops_match_jax(name):
    a, b = vecs(0)
    a[0] = 0.0  # normalize / norm of the zero vector
    if name in ("reflect",):
        a /= np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-9)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
    args = (a,) if name in ("normalize", "norm") else (a, b)
    ref = np.asarray(getattr(V_jax, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(V, name)(*(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_safe_sqrt_and_safe_arcsin_match_jax_and_keep_gradients_finite():
    x = np.array([-1.0, 0.0, 1e-12, 0.25, 4.0], np.float32)
    np.testing.assert_allclose(
        V.safe_sqrt(torch.from_numpy(x)).numpy(),
        np.asarray(V_jax.safe_sqrt(jnp.asarray(x))), rtol=1e-6,
    )
    y = np.array([-1.0, -0.5, 0.0, 0.7, 1.0], np.float32)
    np.testing.assert_allclose(
        V.safe_arcsin(torch.from_numpy(y)).numpy(),
        np.asarray(V_jax.safe_arcsin(jnp.asarray(y))), rtol=1e-6,
    )
    for fn, v in ((V.safe_sqrt, x), (V.safe_arcsin, y)):
        t = torch.from_numpy(v).requires_grad_()
        fn(t).sum().backward()
        assert torch.isfinite(t.grad).all()


def test_refract_matches_jax():
    """Entering, exiting and total internal reflection."""
    a, b = vecs(1)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ior = np.random.default_rng(2).uniform(1.0, 2.4, len(a)).astype(np.float32)
    ref_d, ref_n = ops_jax.refract(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ior))
    got_d, got_n = ops.refract(*(torch.from_numpy(x) for x in (a, b, ior)))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    tir = ~np.asarray(ref_d).any(axis=1)
    assert 0 < tir.sum() < len(a)


@pytest.mark.parametrize("name", ["apply_point", "apply_vector", "apply_normal"])
def test_transform_ops_match_jax(name):
    rng = np.random.default_rng(3)
    _, w2o = ops.build_trs(
        rng.normal(size=(50, 3)), rng.uniform(-3, 3, (50, 3)), rng.uniform(0.3, 2, (50, 3))
    )
    v = rng.normal(size=(50, 3)).astype(np.float32)
    ref = np.asarray(getattr(ops_jax, name)(jnp.asarray(w2o), jnp.asarray(v)))
    got = getattr(ops, name)(torch.from_numpy(w2o), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_build_trs_matches_jax():
    rng = np.random.default_rng(4)
    args = (rng.normal(size=(20, 3)), rng.uniform(-3, 3, (20, 3)), rng.uniform(0.3, 2, (20, 3)))
    for a, b in zip(ops.build_trs(*args), ops_jax.build_trs(*args)):
        np.testing.assert_array_equal(a, b)


def test_a_one_level_integrator_composed_from_the_ops():
    """pixel_rays -> closest_hit -> gather_materials -> shade, weighted as
    the integrator weights a level, equals trace_wavefront on a scene
    without continuations."""
    d = minimal_camera()
    d["lights"] = [{"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 150.0}]
    d["spheres"] = [{"location": [0, 6, 0], "radius": 1.5,
                     "material": {"diffuse_color": [0.8, 0.2, 0.2]}}]
    d["planes"] = [{"corners": [[-6, 2, -1.5], [6, 2, -1.5], [6, 12, -1.5], [-6, 12, -1.5]]}]
    s = rt.load_scene_dict(d, device="cpu")
    w, h = s.camera.resolution
    ys, xs = torch.meshgrid(torch.arange(h) + 0.5, torch.arange(w) + 0.5, indexing="ij")
    o, dirs = ops.pixel_rays(s.camera, xs.reshape(-1).float(), ys.reshape(-1).float())
    tm = torch.zeros(o.shape[0])
    hit = ops.closest_hit(s, o, dirs, tm, differentiable=False)
    mrec = ops.gather_materials(s, hit.geom_id)
    local = ops.shade(s, hit, o, None, 1, mrec, hit.valid)
    mine = torch.where(hit.valid[:, None], local, torch.full_like(local, 0.1))
    ref = ops.trace_wavefront(s, o, dirs, tm, 1, device="cpu")
    assert 0 < int(hit.valid.sum()) < o.shape[0]
    np.testing.assert_allclose(mine.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)
    t = ops.min_hit_t(s, o, dirs, tm)
    reach = torch.where(hit.valid, t + 1.0, torch.full_like(t, 1e6))
    assert torch.equal(ops.occluded(s, o, dirs, reach), hit.valid)
