"""The port's intersection layer against the JAX package's.

Three groups:
  (a) the kernel module (kernels/closest_hit.py): the plain versions behind
      `closest_hit_tid`, `closest_hit_tid_n`, `occluded_tid` against the JAX
      functions of the same names with their Pallas kernels in interpret
      mode, as tests/test_intersect.py runs them;
  (b) render/intersect.py: `all_hit_t`, `min_hit_t`, `occluded`,
      `closest_hit` (both `differentiable` values) against the JAX module;
  (c) the hand-computed cases of tests/test_intersect.py, on the port.

Inputs come from a numpy seed; the scene crosses through
scene/convert.py::scene_from_numpy.  Tolerance: ids, validity and
`blocked` equal; floats rtol 2e-5 / atol 2e-6 (two f32 pipelines running
the same formulas; XLA contracts some a*b+c and the frameworks' sqrt
differ in the last bit).  A grazing sphere hit is ill-conditioned: its
discriminant b*b - 4*a*c cancels, and one contracted multiply-add there
moves t by several 1e-5 relative; up to 2 % of the compared values may
therefore sit outside that tolerance, and none outside ten times it.  A lane the caller marked inactive reports a miss
in the port; the JAX kernels leave such a lane of a live block undefined,
so inactive lanes are compared against the miss only.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tracying_tpu_torch as rt
from ray_tracying_tpu.kernels import closest_hit as ch_jax
from ray_tracying_tpu.render import intersect as I_jax
from ray_tracying_tpu.scene.loader import load_scene_dict as load_jax
from ray_tracying_tpu_torch.kernels import closest_hit as ch
from ray_tracying_tpu_torch.render import intersect as I
from ray_tracying_tpu_torch.scene.convert import scene_from_numpy

from test_scene_loader import minimal_camera

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


class interpret:
    """RTT_PALLAS_INTERPRET=1 around a call, as tests/test_intersect.py."""

    def __enter__(self):
        os.environ["RTT_PALLAS_INTERPRET"] = "1"

    def __exit__(self, *exc):
        del os.environ["RTT_PALLAS_INTERPRET"]


def all_kinds_dict():
    """Every kind, rotated and scaled prims, a moving sphere, a plane (the
    scene of tests/test_intersect.py::test_fused_normal_kernel_matches_pass2)."""
    d = minimal_camera()
    d["spheres"] = [
        {"location": [0, 5, 0], "radius": 1.0},
        {"location": [2, 6, 0.5], "rotation": [0.3, 0.2, 0.7],
         "scale": [0.8, 0.5, 1.2], "velocity": [1.0, 0.0, 0.0]},
    ]
    d["cubes"] = [{"translation": [-2, 7, 0], "rotation": [0.1, 0.9, 0.4],
                   "scale": [0.7, 1.1, 0.6]}]
    d["rectangles"] = [{"translation": [0, 9, 0], "rotation": [1.0, 0.2, 0.0],
                        "scale": [6.0, 6.0, 1.0]}]
    d["planes"] = [
        {"corners": [[-9, 12, -9], [9, 12, -9], [9, 12, 9], [-9, 12, 9]]}
    ]
    return d


def blockers_dict():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0}]
    d["cubes"] = [{"translation": [2, 8, 0], "rotation": [0.2, 0.1, 0.4]}]
    d["rectangles"] = [
        {"translation": [0, 12, 0], "rotation": [1.5707963, 0, 0],
         "scale": [30.0, 30.0, 1.0]}
    ]
    return d


def many_spheres_dict():
    d = minimal_camera()
    d["spheres"] = [
        {"location": [x, 5 + 0.3 * x, 0.1 * x], "radius": 0.5}
        for x in range(-3, 4)
    ]
    d["cubes"] = [{"translation": [0, 9, 0], "rotation": [0.1, 0.2, 0.3]}]
    d["planes"] = [
        {"corners": [[-9, 12, -9], [9, 12, -9], [9, 12, 9], [-9, 12, 9]]}
    ]
    return d


SCENES = {
    "all_kinds": all_kinds_dict,
    "blockers": blockers_dict,
    "many_spheres": many_spheres_dict,
}


def both(name):
    sj = load_jax(SCENES[name]())
    return sj, scene_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")


def rays(n, seed, spread=1.5):
    """Seeded rays around the origin, unit directions leaning to +y where
    the geoms are, random times, a random active mask and random shadow
    distances."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    act = rng.random(n) < 0.7
    maxt = rng.uniform(0.5, 20.0, size=n).astype(np.float32)
    return o, d, tm, act, maxt


def tt(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def close(got, ref, rtol=RTOL, atol=ATOL, loose_share=0.0):
    """All values within (rtol, atol); with loose_share, that share of them
    may lie outside it but within ten times it (module docstring)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if loose_share:
        np.testing.assert_allclose(got, ref, rtol=10 * rtol, atol=10 * atol)
        with np.errstate(invalid="ignore"):  # inf - inf of two misses
            off = np.abs(got - ref) > atol + rtol * np.abs(ref)
        assert off.mean() <= loose_share, f"{off.sum()} of {off.size} values off"
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


GRAZING = 0.02


# ------------------------------------------------------------------ (a)
# 97 and 131: widths that are a multiple of nothing the kernels use.
@pytest.mark.parametrize("name,n", [("all_kinds", 97), ("blockers", 64), ("many_spheres", 131)])
@pytest.mark.parametrize("masked", [False, True], ids=["all_live", "act_mask"])
def test_closest_hit_tid_matches_jax_kernel(name, n, masked):
    sj, st = both(name)
    o, d, tm, act, _ = rays(n, seed=3)
    if not masked:
        act = np.ones(n, bool)
    with interpret():
        t_j, id_j = ch_jax.closest_hit_tid(
            sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jnp.asarray(act)
        )
    t_t, id_t = ch.closest_hit_tid(st, *tt(o, d, tm, act))
    assert t_t.shape == (n,) and id_t.dtype == torch.int32
    np.testing.assert_array_equal(id_t.numpy()[act], np.asarray(id_j)[act])
    close(t_t.numpy()[act], np.asarray(t_j)[act], loose_share=GRAZING)
    assert (id_t.numpy()[~act] == -1).all() and np.isinf(t_t.numpy()[~act]).all()
    assert 0 < (id_t.numpy() >= 0).sum() < n
    assert ch.brute_closest.launches == 0  # CPU: no kernel launch


@pytest.mark.parametrize("name,n", [("all_kinds", 97), ("blockers", 64), ("many_spheres", 131)])
@pytest.mark.parametrize("masked", [False, True], ids=["all_live", "act_mask"])
def test_closest_hit_tid_n_matches_jax_kernel(name, n, masked):
    sj, st = both(name)
    o, d, tm, act, _ = rays(n, seed=4)
    if not masked:
        act = np.ones(n, bool)
    with interpret():
        t_j, id_j, n_j = ch_jax.closest_hit_tid_n(
            sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jnp.asarray(act)
        )
    t_t, id_t, n_t = ch.closest_hit_tid_n(st, *tt(o, d, tm, act))
    assert n_t.shape == (n, 3)
    np.testing.assert_array_equal(id_t.numpy()[act], np.asarray(id_j)[act])
    close(t_t.numpy()[act], np.asarray(t_j)[act], loose_share=GRAZING)
    hit = act & (id_t.numpy() >= 0)
    close(n_t.numpy()[hit], np.asarray(n_j)[hit], loose_share=GRAZING)
    close(np.linalg.norm(n_t.numpy()[hit], axis=1), 1.0, atol=1e-5)
    assert not n_t.numpy()[~hit].any()
    assert ch.brute_closest_n.launches == 0


@pytest.mark.parametrize("name,n", [("all_kinds", 97), ("blockers", 64), ("many_spheres", 131)])
@pytest.mark.parametrize("masked", [False, True], ids=["all_live", "act_mask"])
def test_occluded_tid_matches_jax_kernel(name, n, masked):
    sj, st = both(name)
    o, d, _, act, maxt = rays(n, seed=5, spread=2.0)
    if not masked:
        act = np.ones(n, bool)
    with interpret():
        b_j = ch_jax.occluded_tid(
            sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt), jnp.asarray(act)
        )
    b_t = ch.occluded_tid(st, *tt(o, d, maxt, act))
    assert b_t.dtype == torch.bool
    np.testing.assert_array_equal(b_t.numpy()[act], np.asarray(b_j)[act])
    assert not b_t.numpy()[~act].any()
    assert 0 < b_t.numpy().sum() < n
    assert ch.occlusion_any.launches == 0


def test_occluded_tid_carries_time_zero():
    """Shadow rays carry time 0 even in a motion-blur scene: the moving
    sphere blocks where it stands at time 0."""
    _, st = both("all_kinds")
    assert st.has_motion
    o, d, tm, _, maxt = rays(64, seed=6)
    b = ch.occluded_tid(st, *tt(o, d, maxt))
    t0, _ = ch.closest_hit_tid(st, *tt(o, d, np.zeros(64, np.float32)))
    np.testing.assert_array_equal(b.numpy(), (t0 <= torch.from_numpy(maxt)).numpy())


def test_occlusion_plain_counts_tests_to_the_first_blocker():
    _, st = both("blockers")
    o, d, _, act, maxt = rays(64, seed=7, spread=2.0)
    table, ranges = ch.scene_table(st)
    r = ch.pack_rays(*tt(o, d, np.zeros(64, np.float32), act))
    need = {}
    b = ch.occlusion_plain(r, torch.from_numpy(maxt), table, ranges, stats=need)
    g = table.shape[1]
    assert need["lanes"] == 64 and need["live"] == int(act.sum())
    # an unblocked live ray runs all G tests, a blocked one at least one
    n_blocked = int(b.sum())
    assert (need["live"] - n_blocked) * g + n_blocked <= need["tests"] <= need["live"] * g


def test_kernel_wrappers_check_their_arguments():
    _, st = both("blockers")
    table, ranges = ch.scene_table(st)
    r = torch.zeros((8, 16))
    with pytest.raises(TypeError):
        ch.brute_closest(torch.zeros((7, 16)), table, ranges)
    with pytest.raises(TypeError):
        ch.brute_closest_n(r.double(), table, ranges)
    with pytest.raises(ValueError):
        ch.brute_closest(torch.zeros((16, 8)).T, table, ranges)
    with pytest.raises(TypeError):
        ch.occlusion_any(r, torch.zeros(15), table, ranges)
    with pytest.raises(ValueError):
        ch.brute_closest(r, table, ((0, 0, 99),))
    with pytest.raises(ValueError):
        ch.brute_closest(r, table, ((7, 0, 1),))


@pytest.mark.parametrize("fn", ["brute_closest", "brute_closest_n", "occlusion_any"])
def test_cuda_tensor_never_takes_the_plain_version(monkeypatch, fn):
    """A CUDA tensor goes to the launcher (which builds the kernel or
    raises), never to the plain version."""
    _, st = both("blockers")
    table, ranges = ch.scene_table(st)
    called = []
    monkeypatch.setattr(ch, "_launch_closest", lambda *a, **k: called.append(a) or "launched")
    monkeypatch.setattr(ch, "_launch_occlusion", lambda *a, **k: called.append(a) or "launched")
    monkeypatch.setattr(ch, fn.replace("_any", "") + "_plain", lambda *a, **k: pytest.fail("plain"))

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = torch.zeros((8, 8)).as_subclass(FakeCuda)
    args = (r, torch.zeros(8), table, ranges) if fn == "occlusion_any" else (r, table, ranges)
    assert getattr(ch, fn)(*args) == "launched"
    assert len(called) == 1


def test_occlusion_variant_is_for_the_card_and_counts_apart(monkeypatch):
    """The schedule chip_smoke.py measures the package's any-hit against
    (one thread per lane) is reached by name, refuses a CPU tensor and an
    unknown schedule, and counts its launches apart from the wrapper's."""
    _, st = both("blockers")
    table, ranges = ch.scene_table(st)
    with pytest.raises(ValueError, match="card"):
        ch.occlusion_any_variant(torch.zeros((8, 8)), torch.zeros(8), table, ranges)
    called = []
    monkeypatch.setattr(ch, "_launch_occlusion", lambda *a: called.append(a) or "launched")

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = torch.zeros((8, 8)).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="variant"):
        ch.occlusion_any_variant(r, torch.zeros(8), table, ranges, schedule="blocks")
    before = (ch.occlusion_any_variant.launches, ch.occlusion_any.launches)
    assert ch.occlusion_any_variant(r, torch.zeros(8), table, ranges, schedule="lane") == "launched"
    ch.occlusion_any_variant(r, torch.zeros(8), table, ranges)
    ch.occlusion_any(r, torch.zeros(8), table, ranges)
    assert [a[4:] for a in called] == [("lane",), ("warp",), ()]
    assert (ch.occlusion_any_variant.launches, ch.occlusion_any.launches) == \
        (before[0] + 2, before[1] + 1)


def test_brute_variant_is_for_the_card_and_counts_apart(monkeypatch):
    """The schedule chip_smoke.py measures the package's closest hits
    against (one thread per lane) is reached by name, for either kernel,
    refuses a CPU tensor and an unknown schedule, and counts its launches
    apart from the wrappers'."""
    _, st = both("blockers")
    table, ranges = ch.scene_table(st)
    with pytest.raises(ValueError, match="card"):
        ch.brute_closest_variant(torch.zeros((8, 8)), table, ranges)
    called = []
    monkeypatch.setattr(ch, "_launch_closest", lambda *a: called.append(a) or "launched")

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = torch.zeros((8, 8)).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="variant"):
        ch.brute_closest_variant(r, table, ranges, schedule="blocks")
    counts = (ch.brute_closest_variant, ch.brute_closest, ch.brute_closest_n)
    before = [fn.launches for fn in counts]
    assert ch.brute_closest_variant(r, table, ranges, schedule="lane") == "launched"
    ch.brute_closest_variant(r, table, ranges, True, want_n=True, schedule="lane")
    ch.brute_closest_variant(r, table, ranges, want_n=True)
    ch.brute_closest(r, table, ranges)
    ch.brute_closest_n(r, table, ranges, True)
    # (motion, want_n[, schedule]) as each call asked
    assert [a[3:] for a in called] == [(False, False, "lane"), (True, True, "lane"),
                                       (False, True, "warp"), (False, False), (True, True)]
    assert [fn.launches for fn in counts] == [before[0] + 3, before[1] + 1, before[2] + 1]


def test_launcher_refuses_a_table_beyond_shared_memory():
    """More geoms than one block's shared memory holds: refused by name
    before any build, not sent to a slower route."""
    g = ch.BRUTE_MAX_SMEM_BYTES // (4 * 17) + 1
    table = torch.zeros((17, g))
    with pytest.raises(NotImplementedError, match="shared memory"):
        ch._launch_args(torch.zeros((8, 4)), table, ((0, 0, g),))


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_all_hit_t_matches_jax(name):
    sj, st = both(name)
    o, d, tm, _, _ = rays(96, seed=8)
    ref = np.asarray(I_jax.all_hit_t(sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)))
    got = I.all_hit_t(st, *tt(o, d, tm)).numpy()
    assert got.shape == ref.shape == (96, st.n_geoms)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    hit = np.isfinite(ref)
    close(got[hit], ref[hit], loose_share=GRAZING)
    assert hit.any(axis=0).sum() > st.n_geoms // 2


@pytest.mark.parametrize("name", sorted(SCENES))
def test_min_hit_t_and_occluded_match_jax(name):
    """Through the kernels on both sides (JAX in interpret mode), and
    against the port's own dense oracle."""
    sj, st = both(name)
    o, d, tm, act, maxt = rays(96, seed=9, spread=2.0)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    with interpret():
        t_j = np.asarray(I_jax.min_hit_t(sj, jo, jd, jt))
        b_j = np.asarray(I_jax.occluded(sj, jo, jd, jnp.asarray(maxt)))
    t_t = I.min_hit_t(st, *tt(o, d, tm)).numpy()
    np.testing.assert_array_equal(np.isfinite(t_t), np.isfinite(t_j))
    close(t_t[np.isfinite(t_j)], t_j[np.isfinite(t_j)], loose_share=GRAZING)
    b_t = I.occluded(st, *tt(o, d, maxt)).numpy()
    np.testing.assert_array_equal(b_t, b_j)
    dense = I.all_hit_t(st, *tt(o, d, tm)).min(dim=1).values.numpy()
    close(t_t[np.isfinite(dense)], dense[np.isfinite(dense)], loose_share=GRAZING)
    # an inactive ray reports a miss / not blocked
    t_m = I.min_hit_t(st, *tt(o, d, tm, act)).numpy()
    assert np.isinf(t_m[~act]).all()
    np.testing.assert_array_equal(t_m[act], t_t[act])


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("differentiable", [True, False], ids=["pass2", "fused_normal"])
def test_closest_hit_matches_jax(name, differentiable):
    """Every Hit field on valid lanes.  differentiable=True: the (t, id)
    kernel plus pass 2; False: the fused-normal kernel (untextured
    scenes), point = o + t * d."""
    sj, st = both(name)
    o, d, tm, _, _ = rays(256, seed=10)
    with interpret():
        ref = I_jax.closest_hit(
            sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            differentiable=differentiable,
        )
    got = I.closest_hit(st, *tt(o, d, tm), differentiable=differentiable)
    m = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), m)
    assert 30 < m.sum() < 256
    np.testing.assert_array_equal(got.geom_id.numpy(), np.asarray(ref.geom_id))
    assert got.geom_id.dtype == torch.int32
    assert np.isinf(got.t.numpy()[~m]).all()
    close(got.t.numpy()[m], np.asarray(ref.t)[m], loose_share=GRAZING)
    close(got.point.numpy()[m], np.asarray(ref.point)[m], loose_share=GRAZING)
    close(got.normal.numpy()[m], np.asarray(ref.normal)[m], loose_share=GRAZING)
    close(got.uv.numpy()[m], np.asarray(ref.uv)[m], loose_share=GRAZING)
    if differentiable:
        assert got.uv.numpy()[m].any()


def test_closest_hit_paths_agree_inside_the_port():
    """Fused-normal kernel against (t, id) kernel + pass 2 on the scene
    with every kind: the bar of the JAX package's own test."""
    _, st = both("all_kinds")
    o, d, tm, _, _ = rays(96, seed=3)
    fast = I.closest_hit(st, *tt(o, d, tm), differentiable=False)
    slow = I.closest_hit(st, *tt(o, d, tm), differentiable=True)
    assert torch.equal(fast.valid, slow.valid)
    m = fast.valid.numpy()
    assert torch.equal(fast.geom_id, slow.geom_id)
    close(fast.t.numpy()[m], slow.t.numpy()[m], rtol=1e-5, atol=1e-5)
    close(fast.point.numpy()[m], slow.point.numpy()[m], rtol=1e-4, atol=1e-4)
    close(fast.normal.numpy()[m], slow.normal.numpy()[m], rtol=1e-4, atol=1e-4)


def test_use_bvh_is_refused_by_name():
    """Only the fused level refuses use_bvh, by name."""
    from ray_tracying_tpu_torch.kernels import wavefront as wf

    _, st = both("blockers")
    assert "use_bvh" in wf.wave_refusal(st, use_bvh=True)
    without = wf.wave_refusal(st, use_bvh=False)
    assert without is None or "use_bvh" not in without


def test_use_bvh_is_taken_by_the_search():
    """closest_hit and min_hit_t take use_bvh: without a BVH on the scene
    the brute kernels answer, with one the traversal does, and the hits are
    the same."""
    from ray_tracying_tpu_torch.accel.lbvh import with_bvh

    _, st = both("blockers")
    o, d, tm, _, maxt = rays(64, seed=0)
    ref = I.closest_hit(st, *tt(o, d, tm))
    ref_t = I.min_hit_t(st, *tt(o, d, tm))
    for scene in (st, with_bvh(st)):
        hit = I.closest_hit(scene, *tt(o, d, tm), use_bvh=True)
        assert torch.equal(hit.geom_id, ref.geom_id) and torch.equal(hit.t, ref.t)
        assert torch.equal(I.min_hit_t(scene, *tt(o, d, tm), use_bvh=True), ref_t)
    assert int(ref.valid.sum()) > 0


# ------------------------------------------------------------------ (c)
def scene_with(**kwargs):
    d = minimal_camera()
    d.update(kwargs)
    return rt.load_scene_dict(d, device="cpu")


def hit_one(scene, o, d, time=0.0, **kw):
    o = torch.tensor([o], dtype=torch.float32)
    d = torch.tensor([d], dtype=torch.float32)
    return I.closest_hit(scene, o, d, torch.tensor([time], dtype=torch.float32), **kw)


def test_unit_sphere_frontal():
    s = scene_with(spheres=[{"location": [0, 5, 0], "radius": 1.0}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(4.0, abs=1e-4)
    np.testing.assert_allclose(h.point[0].numpy(), [0, 4, 0], atol=1e-4)
    np.testing.assert_allclose(h.normal[0].numpy(), [0, -1, 0], atol=1e-4)


def test_sphere_inside_hits_far_side():
    s = scene_with(spheres=[{"location": [0, 0, 0], "radius": 2.0}])
    h = hit_one(s, [0, 0, 0], [1, 0, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(2.0, abs=1e-4)


def test_sphere_t_min_epsilon():
    """Hits with t <= 0.001 are rejected (Code/shapes.cpp:231)."""
    s = scene_with(spheres=[{"location": [0, 0, 0], "radius": 1.0}])
    h = hit_one(s, [0, 1.0005, 0], [0, 1, 0])
    assert not bool(h.valid[0])


def test_scaled_sphere_euclidean_t():
    """hit.t is the Euclidean distance to the world hit point even for
    non-uniform scale (Code/shapes.cpp:251-253)."""
    s = scene_with(spheres=[{"location": [0, 10, 0], "scale": [3.0, 1.0, 1.0]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert float(h.t[0]) == pytest.approx(9.0, abs=1e-3)
    assert np.linalg.norm(h.normal[0].numpy()) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("differentiable", [True, False])
def test_cube_frontal_face_normal(differentiable):
    s = scene_with(cubes=[{"translation": [0, 3, 0], "rotation": [0, 0, 0]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0], differentiable=differentiable)
    assert float(h.t[0]) == pytest.approx(2.5, abs=1e-4)
    np.testing.assert_allclose(h.normal[0].numpy(), [0, -1, 0], atol=1e-5)


@pytest.mark.parametrize("differentiable", [True, False])
def test_cube_inside_exit_keeps_entry_normal(differentiable):
    """Ray starting inside a cube exits through t_far but the normal comes
    from the entry axis (reference quirk, Code/shapes.cpp:392-402)."""
    s = scene_with(cubes=[{"translation": [0, 0, 0], "rotation": [0, 0, 0]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0], differentiable=differentiable)
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(0.5, abs=1e-5)
    np.testing.assert_allclose(h.normal[0].numpy(), [0, -1, 0], atol=1e-5)


def test_cube_no_t_epsilon():
    """Cube uses t > 0, not the 0.001 epsilon (Code/shapes.cpp:392-393)."""
    s = scene_with(cubes=[{"translation": [0, 0, 0], "rotation": [0, 0, 0]}])
    h = hit_one(s, [0, -0.5005, 0], [0, 1, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(5e-4, abs=2e-4)


def test_rect_bounds_and_uv():
    s = scene_with(
        rectangles=[{"translation": [0, 4, 0], "rotation": [1.5707963, 0, 0],
                     "scale": [2.0, 2.0, 1.0]}]
    )
    h = hit_one(s, [0.5, 0, 0.25], [0, 1, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(4.0, abs=1e-4)
    # u = local_x + 0.5; local x = world x / 2 = 0.25 -> u = 0.75
    assert float(h.uv[0, 0]) == pytest.approx(0.75, abs=1e-5)
    miss = hit_one(s, [2.5, 0, 0], [0, 1, 0])
    assert not bool(miss.valid[0])


@pytest.mark.parametrize("differentiable", [True, False])
def test_plane_quad_parametric_t(differentiable):
    """Plane hit.t is the PARAMETRIC t (Code/shapes.cpp:458,481): an
    unnormalized direction exposes the difference."""
    s = scene_with(
        planes=[{"corners": [[-1, 5, -1], [1, 5, -1], [1, 5, 1], [-1, 5, 1]]}]
    )
    h = hit_one(s, [0, 0, 0], [0, 2.0, 0], differentiable=differentiable)
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(2.5, abs=1e-5)  # 5 / |d|=2
    np.testing.assert_allclose(np.abs(h.normal[0].numpy()), [0, 1, 0], atol=1e-6)


def test_plane_point_in_quad_rejects_outside():
    s = scene_with(
        planes=[{"corners": [[-1, 5, -1], [1, 5, -1], [1, 5, 1], [-1, 5, 1]]}]
    )
    h = hit_one(s, [1.5, 0, 0], [0, 1, 0])
    assert not bool(h.valid[0])


@pytest.mark.parametrize("differentiable", [True, False])
def test_motion_blur_shifts_sphere(differentiable):
    s = scene_with(
        spheres=[{"location": [0, 5, 0], "radius": 0.5, "velocity": [5.0, 0, 0]}]
    )
    # velocity/5 = 1.0/frame.  At time=1 the sphere center is at x=+1.
    kw = dict(differentiable=differentiable)
    h0 = hit_one(s, [0, 0, 0], [0, 1, 0], time=0.0, **kw)
    h1 = hit_one(s, [1.0, 0, 0], [0, 1, 0], time=1.0, **kw)
    miss = hit_one(s, [1.0, 0, 0], [0, 1, 0], time=0.0, **kw)
    assert bool(h0.valid[0]) and bool(h1.valid[0]) and not bool(miss.valid[0])
    # The advected hit point is reported in world space at the ray's time
    # (Code/shapes.cpp:243-248).
    np.testing.assert_allclose(h1.point[0].numpy(), [1.0, 4.5, 0], atol=1e-4)


def test_closest_hit_tie_break_first_geom():
    """Equal-t hits resolve to the first geom in load order
    (Code/acceleration.cpp:112,133)."""
    s = scene_with(spheres=[
        {"location": [0, 5, 0], "radius": 1.0},
        {"location": [0, 5, 0], "radius": 1.0},
    ])
    for differentiable in (True, False):
        h = hit_one(s, [0, 0, 0], [0, 1, 0], differentiable=differentiable)
        assert int(h.geom_id[0]) == 0


def test_empty_scene_misses():
    s = scene_with()
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert not bool(h.valid[0])
    assert np.isinf(float(h.t[0]))
    z = torch.zeros((1, 3))
    assert np.isinf(float(I.min_hit_t(s, z, z, torch.zeros(1))[0]))
    assert not bool(I.occluded(s, z, z, torch.ones(1))[0])
    assert I.all_hit_t(s, z, z, torch.zeros(1)).shape == (1, 0)


def test_min_hit_t_matches_closest_hit():
    s = scene_with(
        spheres=[{"location": [0, 5, 0], "radius": 1.0}],
        cubes=[{"translation": [0, 8, 0], "rotation": [0, 0, 0]}],
    )
    o = torch.zeros((1, 3))
    dd = torch.tensor([[0, 1.0, 0]])
    t = I.min_hit_t(s, o, dd, torch.zeros(1))
    h = I.closest_hit(s, o, dd, torch.zeros(1))
    assert float(t[0]) == pytest.approx(float(h.t[0]), rel=1e-5)


def test_occluded_matches_min_hit_t():
    s = rt.load_scene_dict(blockers_dict(), device="cpu")
    o, d, _, _, maxt = rays(64, seed=0, spread=2.0)
    blocked = I.occluded(s, *tt(o, d, maxt))
    t = I.min_hit_t(s, *tt(o, d, np.zeros(64, np.float32)))
    np.testing.assert_array_equal(blocked.numpy(), (t <= torch.from_numpy(maxt)).numpy())
