"""The port's general trace path against the JAX package's.

(a) `trace_wavefront(..., fused=False)` on rays of the committed scenes
    that need it: det_twoway (the compacted two-way queue), det_mirrors
    (in-slot reflection), glossy (fed the JAX fuzz draws), motion (the
    motion shift), softshadow (area-light jitter fed from the JAX stream).
    The JAX side runs its general path with the Pallas kernels in
    interpret mode.  Radiance rtol 1e-4 / atol 1e-5; TraceStats equal,
    which pins every level's decisions.
(b) the general path against the fused path inside the port.
(c) the semantics cases of tests/test_integrator.py, on the port, and the
    queue machinery (`_compact`, `_accumulate_by_dest`).
"""

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
from ray_tracying_tpu.render.integrator import trace_wavefront as trace_jax
from ray_tracying_tpu_torch.render import integrator as G
from ray_tracying_tpu_torch.accel.lbvh import with_bvh
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.render.pipeline import tile_rays
from ray_tracying_tpu_torch.scene.convert import scene_from_numpy

from test_scene_loader import minimal_camera
from test_torch_intersect import interpret

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
RTOL, ATOL = 1e-4, 1e-5
LEVELS = 11


def committed(name):
    path = os.path.join(REPO, "scenes", f"{name}.json")
    return (
        rt_jax.load_scene(path, textures_dir=TEX),
        rt.load_scene(path, textures_dir=TEX, device="cpu"),
    )


def tile(st, rows, seed):
    """Primary rays (1 spp, random exposure times) of `rows` image rows
    around the middle of the frame."""
    w, h = st.camera.resolution
    return tile_rays(
        st.camera, h // 2 - rows // 2, rows, w, 1,
        generator=torch.Generator().manual_seed(seed),
    )


def jax_fuzz(key, capacity):
    """Glossy draws of the JAX general path, level by level
    (render/integrator.py:129), as the port's (3, capacity) rows."""
    return [
        torch.from_numpy(np.array(sphere_jax(
            jax.random.fold_in(jax.random.fold_in(key, depth), 1), (capacity,)
        ).T))
        for depth in range(LEVELS)
    ]


def jax_light_jitter(key, sj, width, samples):
    """Area-light draws of the JAX general path (render/shade.py:127-129
    under integrator.py:693): [level][light] -> (width, samples, 3)."""
    out = []
    for depth in range(LEVELS):
        k = jax.random.fold_in(jax.random.fold_in(key, depth), 0)
        out.append([
            torch.from_numpy(np.array(sphere_jax(jax.random.fold_in(k, li), (width, samples))))
            if sj.lights.is_area[li] else None
            for li in range(sj.n_lights)
        ])
    return out


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("name,light_samples", [
    ("det_twoway", 1), ("det_mirrors", 1), ("glossy", 1), ("motion", 1),
    ("softshadow", 2), ("det_basic", 1),
])
def test_general_path_matches_jax(name, light_samples):
    sj, st = committed(name)
    o, d, tm = tile(st, 2, seed=1)
    n = o.shape[0]
    key = jax.random.key(5)
    with interpret():
        ref, st_ref = trace_jax(
            sj, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(tm.numpy()), key, light_samples, fused=False,
            return_stats=True,
        )
    capacity = n * 2 if st.has_two_way else n
    got, stats = trace_wavefront(
        st, o, d, tm, light_samples, fused=False, return_stats=True,
        device="cpu",
        fuzz=jax_fuzz(key, capacity) if st.has_glossy else None,
        light_jitter=jax_light_jitter(key, sj, capacity, light_samples)
        if any(st.lights.is_area) else None,
    )
    for field in ("live", "hits", "spawned", "dropped"):
        np.testing.assert_array_equal(
            getattr(stats, field).numpy(), np.asarray(getattr(st_ref, field)),
            err_msg=field,
        )
    assert int(stats.hits[0]) > 0 and int(stats.dropped.sum()) == 0
    if st.has_reflection or st.has_refraction:
        assert int(stats.live[1]) > 0, "the tile must spawn continuations"
    if st.has_two_way:
        assert int(stats.live[4]) > 0, "the two-way tile must reach deep levels"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_two_way_scene_takes_the_compacted_queue():
    """det_twoway grows its queue past R, and two traces give equal bits
    (the accumulation order is fixed)."""
    _, st = committed("det_twoway")
    assert st.has_two_way
    o, d, tm = tile(st, 2, seed=2)
    a, stats = trace_wavefront(st, o, d, tm, 1, return_stats=True, device="cpu")
    b = trace_wavefront(st, o, d, tm, 1, device="cpu")
    assert torch.equal(a, b)
    assert int(stats.live.max()) <= 2 * o.shape[0]
    assert int(stats.spawned.max()) > int(stats.hits.min())


@pytest.mark.parametrize("name", ["det_mirrors", "det_basic"])
def test_forced_compaction_gives_the_same_image(name):
    """compact='always' only permutes queue slots."""
    _, st = committed(name)
    o, d, tm = tile(st, 2, seed=3)
    a, sa = trace_wavefront(st, o, d, tm, 1, fused=False, return_stats=True, device="cpu")
    b, sb = trace_wavefront(
        st, o, d, tm, 1, compact="always", return_stats=True, device="cpu"
    )
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("name", ["bvh_det", "det_mirrors"])
def test_general_path_matches_fused_path(name):
    _, st = committed(name)
    o, d, tm = tile(st, 1 if name == "bvh_det" else 4, seed=4)
    fused, sf = trace_wavefront(st, o, d, tm, 1, fused=True, return_stats=True, device="cpu")
    general, sg = trace_wavefront(st, o, d, tm, 1, fused=False, return_stats=True, device="cpu")
    np.testing.assert_allclose(general.numpy(), fused.numpy(), rtol=RTOL, atol=ATOL)
    for x, y in zip(sf, sg):
        assert torch.equal(x, y)
    assert int(sg.live[3 if name == "bvh_det" else 1]) > 0


def test_general_path_matches_fused_path_with_the_same_fuzz():
    """A glossy scene, both paths fed the same (3, R) draws per level."""
    _, st = committed("glossy")
    o, d, tm = tile(st, 4, seed=5)
    fuzz = jax_fuzz(jax.random.key(2), o.shape[0])
    fused = trace_wavefront(st, o, d, tm, 1, fused=True, fuzz=fuzz, device="cpu")
    general = trace_wavefront(st, o, d, tm, 1, fused=False, fuzz=fuzz, device="cpu")
    np.testing.assert_allclose(general.numpy(), fused.numpy(), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ (c)
def trace_dirs(scene, dirs, seed=0, **kw):
    dirs = torch.tensor(dirs, dtype=torch.float32)
    return trace_wavefront(
        scene, torch.zeros_like(dirs), dirs, torch.zeros(dirs.shape[0]), 1,
        generator=torch.Generator().manual_seed(seed), device="cpu", **kw,
    )


def load(d):
    return rt.load_scene_dict(d, device="cpu")


def mirror(y, **material):
    return {"translation": [0, y, 0], "rotation": [1.5707963, 0, 0],
            "scale": [4, 4, 1], "material": material}


def test_miss_is_background():
    s = load(minimal_camera())
    c = trace_dirs(s, [[0, 1, 0], [1, 0, 0]])
    np.testing.assert_allclose(c.numpy(), 0.1, atol=1e-7)


@pytest.mark.parametrize("fused", [None, False])
def test_opaque_hit_no_children(fused):
    d = minimal_camera()
    d["lights"] = [{"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 100.0}]
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0,
                     "material": {"diffuse_color": [1, 0, 0]}}]
    c, st = trace_dirs(load(d), [[0, 1, 0]], fused=fused, return_stats=True)
    assert c[0, 0] > c[0, 1] and c[0, 0] > 0.05
    assert st.live.shape == (1,)


@pytest.mark.parametrize("fused", [None, False])
def test_energy_weights_mirror(fused):
    """local*(1-refl) + refl*child (Code/raytracer.cpp:346-350): a perfect
    mirror (refl=1) facing the background returns exactly background."""
    d = minimal_camera()
    d["rectangles"] = [mirror(5.0, reflectivity=1.0, roughness=0.0)]
    c = trace_dirs(load(d), [[0, 1, 0]], fused=fused)
    np.testing.assert_allclose(c[0].numpy(), [0.1, 0.1, 0.1], atol=1e-6)


@pytest.mark.parametrize("fused", [None, False])
def test_depth_cutoff_two_mirrors(fused):
    """Two facing perfect mirrors: 11 bounces, then black
    (Code/raytracer.cpp:290-292)."""
    d = minimal_camera()
    d["rectangles"] = [mirror(y, reflectivity=1.0, roughness=0.0) for y in (5.0, -5.0)]
    c, st = trace_dirs(load(d), [[0, 1, 0]], fused=fused, return_stats=True)
    np.testing.assert_allclose(c[0].numpy(), 0.0, atol=1e-6)
    assert st.live.tolist() == [1] * 11 and st.spawned.tolist() == [1] * 11


def test_transparency_passthrough():
    """A fully transparent, non-refracting (ior=1) slab passes the
    background through."""
    d = minimal_camera()
    d["rectangles"] = [mirror(5.0, transparency=1.0, refractive_index=1.0)]
    c = trace_dirs(load(d), [[0, 1, 0]])
    np.testing.assert_allclose(c[0].numpy(), [0.1, 0.1, 0.1], atol=1e-6)


@pytest.mark.parametrize("fused", [None, False])
def test_glossy_absorption_black(fused):
    """roughness >> 1 perturbs most reflection rays below the surface ->
    absorbed (Code/raytracer.cpp:322-327)."""
    d = minimal_camera()
    d["rectangles"] = [mirror(5.0, reflectivity=1.0, roughness=50.0)]
    c = trace_dirs(load(d), [[0, 1, 0]] * 512, fused=fused)
    assert float(c.mean()) < 0.08


def mirror_glass_scene():
    d = minimal_camera()
    d["lights"] = [{"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 200.0}]
    d["spheres"] = [
        {"location": [-1, 5, 0], "radius": 1.0, "material": {"reflectivity": 0.5}},
        {"location": [1.5, 5, 0], "radius": 1.0,
         "material": {"transparency": 0.7, "refractive_index": 1.5}},
    ]
    return load(d)


def test_queue_growth_mirror_plus_glass():
    s = mirror_glass_scene()
    assert s.has_reflection and s.has_refraction and not s.has_two_way
    dirs = [[x, 1.0, 0.0] / np.linalg.norm([x, 1.0, 0.0]) for x in np.linspace(-0.5, 0.5, 16)]
    c = trace_dirs(s, np.array(dirs))
    assert torch.isfinite(c).all() and (c >= 0).all()


def test_stats_single_level_local_scene():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0}]
    _, st = trace_dirs(
        load(d), [[0, 1, 0], [0, -1, 0], [0, 1, 0]], fused=False, return_stats=True
    )
    assert st.live.tolist() == [3] and st.hits.tolist() == [2]
    assert st.spawned.tolist() == [0] and st.dropped.tolist() == [0]


def test_stats_mirror_glass_no_drops_at_mult2():
    s = mirror_glass_scene()
    rng = np.random.default_rng(3)
    n = 64
    dirs = np.stack(
        [rng.uniform(-0.4, 0.4, n), np.ones(n), rng.uniform(-0.2, 0.2, n)], 1
    )
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    _, st = trace_dirs(s, dirs, queue_mult=2, return_stats=True)
    assert int(st.dropped.sum()) == 0
    assert int(st.live[0]) == n
    np.testing.assert_array_equal(st.live[1:].numpy(), st.spawned[:-1].numpy())


def test_stats_zoo_cornell_no_drops_at_default_mult():
    """The JAX package's cornell box (planes, a mirror and a glass sphere,
    an area light), carried across."""
    from ray_tracying_tpu.models.zoo import cornell

    s = scene_from_numpy(jax.tree.map(np.asarray, cornell(res=(16, 16))), device="cpu")
    assert s.has_reflection and s.has_refraction and s.n_planes == 5
    o, d, tm = tile_rays(s.camera, 4, 8, 16, 1, generator=torch.Generator().manual_seed(7))
    c, st = trace_wavefront(
        s, o, d, tm, 1, generator=torch.Generator().manual_seed(0),
        return_stats=True, device="cpu",
    )
    assert int(st.dropped.sum()) == 0 and torch.isfinite(c).all()
    assert int(st.live[1]) > 0


def both_ways_dict():
    d = minimal_camera()
    d["rectangles"] = [
        {"translation": [0, y, 0], "rotation": [1.5707963, 0, 0], "scale": [40, 40, 1],
         "material": {"reflectivity": 0.5, "transparency": 0.5,
                      "refractive_index": 1.0, "roughness": 0.0}}
        for y in (5.0, 7.0)
    ]
    return d


def both_ways_scene():
    return load(both_ways_dict())


def test_stats_overflow_is_counted():
    """A material that BOTH reflects and refracts branches 2x per hit;
    queue_mult=1 cannot hold the growth, and the drop counter sees it."""
    s = both_ways_scene()
    assert s.has_two_way
    dirs = [[0.0, 1.0, 0.0]] * 8
    _, st = trace_dirs(s, dirs, queue_mult=1, return_stats=True)
    assert int(st.dropped.sum()) > 0
    _, dropped = trace_dirs(s, dirs, queue_mult=1, return_dropped=True)
    assert int(dropped) == int(st.dropped.sum())
    _, st2 = trace_dirs(s, dirs, queue_mult=4, return_stats=True)
    assert int(st2.dropped.sum()) == 0


def test_stats_do_not_change_image():
    s = mirror_glass_scene()
    dirs = np.array([[0, 1, 0], [0.2, 1, 0.1]], np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    plain = trace_dirs(s, dirs, seed=1)
    with_st, _ = trace_dirs(s, dirs, seed=1, return_stats=True)
    with_dr, dropped = trace_dirs(s, dirs, seed=1, return_dropped=True)
    assert torch.equal(plain, with_st) and torch.equal(plain, with_dr)
    assert int(dropped) == 0


def test_render_with_stats_pipeline():
    img, stats = rt.render_image(
        mirror_glass_scene(), rt.RenderOptions(samples_sqrt=1, stats=True), device="cpu"
    )
    assert img.shape[2] == 3
    assert stats["total_dropped"] == 0 and stats["levels"][0]["live"] > 0


def test_render_warns_when_rays_were_dropped():
    with pytest.warns(RuntimeWarning, match="dropped"):
        rt.render_image(
            both_ways_scene(), rt.RenderOptions(samples_sqrt=1, queue_mult=1), device="cpu"
        )


def test_compact_keeps_order_and_counts_overflow():
    n = 10
    q = G._Queue(
        o=torch.arange(n * 3, dtype=torch.float32).reshape(n, 3),
        d=torch.zeros((n, 3)), time=torch.zeros(n),
        tp=torch.arange(n, dtype=torch.float32), dest=torch.arange(n),
        active=torch.ones(n, dtype=torch.bool),
    )
    keep = torch.tensor([0, 1, 1, 0, 1, 0, 1, 1, 0, 1], dtype=torch.bool)
    out, dropped = G._compact(q, keep, 4)
    assert out.dest.tolist() == [1, 2, 4, 6] and int(dropped) == 2
    assert out.active.tolist() == [True] * 4
    assert torch.equal(out.o, q.o[[1, 2, 4, 6]])
    out, dropped = G._compact(q, keep, 8)
    assert out.dest[:6].tolist() == [1, 2, 4, 6, 7, 9] and int(dropped) == 0
    assert out.active.tolist() == [True] * 6 + [False] * 2


@pytest.mark.parametrize("max_run", [1, 2, 4, 8])
def test_accumulate_by_dest_sums_every_slot(max_run):
    """Against a float64 scatter-add: runs of up to max_run slots a dest,
    inactive slots ignored."""
    rng = np.random.default_rng(max_run)
    r = 50
    dest = np.repeat(np.arange(r), rng.integers(0, max_run + 1, r))
    rng.shuffle(dest)
    n = len(dest)
    contrib = rng.random((n, 3)).astype(np.float32)
    active = rng.random(n) < 0.8
    ref = np.zeros((r, 3))
    np.add.at(ref, dest[active], contrib[active].astype(np.float64))
    start = rng.random((r + 1, 3)).astype(np.float32)
    got = G._accumulate_by_dest(
        torch.from_numpy(start), torch.from_numpy(contrib),
        torch.from_numpy(dest), torch.from_numpy(active), max_run,
    ).numpy()
    np.testing.assert_allclose(got[:r], start[:r] + ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kwargs,feature", [
    ({"use_bvh": True}, "use_bvh"), ({"differentiable": True}, "record mode"),
])
def test_general_path_refuses_options_by_name(kwargs, feature):
    """use_bvh is refused by name only where the fused path is forced.
    Record mode (differentiable rendering) is refused no more: this two-way
    scene, which the fused gate refuses, renders down the general path with
    differentiable=True (pass 2 of the closest hit), with the radiance and
    TraceStats of the JAX package's general path, and finite, non-zero
    gradients to its reflectivity (every pixel is background seen through
    the two-way rects).  (The port's inference path takes the
    closest hit's fused normals instead; on this scene of coincident
    pass-through hits and queue overflow the last-bit difference changes
    which continuations survive.)"""
    scene = both_ways_scene()
    if "use_bvh" in kwargs:
        with pytest.raises(NotImplementedError, match=feature):
            trace_dirs(scene, [[0, 1, 0]], **dict(kwargs, fused=True))
        return
    mats = scene.materials
    refl = mats.reflectivity.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, materials=dataclasses.replace(mats, reflectivity=refl))
    dirs = [[0, 1, 0], [0.3, 1, 0.1]]
    got, stats = trace_dirs(sc, dirs, return_stats=True, **kwargs)
    ref, st_ref = trace_jax(
        rt_jax.load_scene_dict(both_ways_dict()), jnp.zeros((2, 3)),
        jnp.asarray(dirs, jnp.float32), jnp.zeros(2), jax.random.key(0), 1,
        differentiable=True, return_stats=True,
    )
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    for field in ("live", "hits", "spawned", "dropped"):
        np.testing.assert_array_equal(
            getattr(stats, field).numpy(), np.asarray(getattr(st_ref, field)), err_msg=field
        )
    (g,) = torch.autograd.grad(got.sum(), [refl])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_general_path_takes_use_bvh():
    """use_bvh is the general path's own option: it traces the same
    radiance, with a BVH attached or not."""
    scene = both_ways_scene()
    dirs = [[0, 1, 0], [0.3, 1, 0.1]]
    plain = trace_dirs(scene, dirs)
    assert torch.equal(trace_dirs(scene, dirs, use_bvh=True), plain)
    assert torch.equal(trace_dirs(with_bvh(scene), dirs, use_bvh=True), plain)


def test_general_path_needs_draws_or_a_generator():
    _, st = committed("softshadow")
    o, d, tm = tile(st, 1, seed=0)
    with pytest.raises(ValueError, match="area light"):
        trace_wavefront(st, o, d, tm, 2, device="cpu")
    _, st = committed("glossy")
    with pytest.raises(ValueError, match="glossy"):
        trace_wavefront(st, o, d, tm, 1, fused=False, device="cpu")
    with pytest.raises(ValueError, match="return_levels"):
        trace_wavefront(st, o, d, tm, 1, fused=False, return_levels=True, device="cpu",
                        generator=torch.Generator())
