"""Differentiable rendering of the port against the JAX package's, on the
CPU: the same scene (carried across with `scene_from_numpy`) and the same
parameters (`theta_from_numpy`) through both.

- Gradients of the fused path (record-mode level + `WaveLevelFn`) and of
  the general path (pass 2 + shading under checkpoint) each equal the JAX
  fused path's (Pallas in interpret mode) at rtol 2e-4, atol 2e-4 * max|g|,
  for five parameter classes and the ray origins (the JAX package's own
  fused-against-general bar, tests/test_diff.py).
- Finite differences on the port (tests/test_diff.py's five paths and its
  bar); gradients finite everywhere; the gradient of a zero albedo on a lit
  surface behind an occluder against finite differences on both paths.
- Tiled against whole-frame gradients; Adam against optax (five steps from
  the same start, and a JAX Adam state carried across mid-fit); fit
  convergence, tiled and not; checkpoint and resume; the routing guard.

Gradients are compared at a tolerance, never bit for bit: on the card the
backward's scatter-adds are atomic and unordered.
"""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ray_tracying_tpu.core.sampling import uniform_in_unit_sphere as sphere_jax
from ray_tracying_tpu.diff import params as P_jax
from ray_tracying_tpu.diff.optimize import fit as fit_jax
from ray_tracying_tpu.diff.render import mse_loss as mse_jax
from ray_tracying_tpu.diff.render import render_linear as render_jax
from ray_tracying_tpu.render.integrator import trace_wavefront as trace_jax
from ray_tracying_tpu_torch.diff import checkpoint as ckpt
from ray_tracying_tpu_torch.diff import params as P
from ray_tracying_tpu_torch.diff.optimize import fit
from ray_tracying_tpu_torch.diff.render import (
    mse_loss,
    mse_loss_and_grad_tiled,
    mse_loss_tiled,
    render_linear,
)
from ray_tracying_tpu_torch.kernels import wavefront as wf
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.render.pipeline import RenderOptions, render_image, tile_rays
from ray_tracying_tpu_torch.scene.convert import scene_from_numpy
from ray_tracying_tpu_torch.scene.loader import load_scene_dict

from test_diff import tiny_scene
from test_scene_loader import minimal_camera
from test_torch_wavefront import interpret

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = RenderOptions(samples_sqrt=1, light_samples=1)
KEY = jax.random.key(0)
G_RTOL = 2e-4


def carried(sj):
    return scene_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")


def theta_np(sj, paths):
    return {k: np.asarray(v) for k, v in P_jax.extract(sj, paths).items()}


def assert_grads_close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    assert np.isfinite(got).all(), err_msg
    np.testing.assert_allclose(
        got, ref, rtol=G_RTOL, atol=G_RTOL * max(1.0, np.abs(ref).max()), err_msg=err_msg
    )


# ------------------------------------------------- fused / general vs JAX
FG_PATHS = (
    "materials.diffuse", "materials.reflectivity", "materials.roughness",
    "lights.intensity", "lights.position",
)


def glossy_two_light_scene():
    """tests/test_diff.py::test_fused_diff_matches_general_grads's scene:
    sphere, cube, rect, two point lights, glossy reflection."""
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 300.0},
        {"location": [4, 2, 3], "color": [1.0, 0.8, 0.6], "intensity": 200.0},
    ]
    d["spheres"] = [
        {"location": [0, 6, 0], "radius": 1.5,
         "material": {"diffuse_color": [0.8, 0.2, 0.2], "reflectivity": 0.4, "roughness": 0.1}},
    ]
    d["cubes"] = [
        {"translation": [2.5, 6, -0.5], "rotation": [0.2, 0.4, 0.1],
         "material": {"diffuse_color": [0.9, 0.8, 0.3], "reflectivity": 0.3, "roughness": 0.1}},
    ]
    d["rectangles"] = [
        {"translation": [0, 6, -2], "rotation": [0, 0, 0], "scale": [14, 14, 1],
         "material": {"diffuse_color": [0.3, 0.5, 0.3], "reflectivity": 0.2, "roughness": 0.0}},
    ]
    from ray_tracying_tpu.scene.loader import load_scene_dict as load_jax

    return load_jax(d)


@pytest.fixture(scope="module")
def fused_general_case():
    """The JAX fused path's gradients (Pallas in interpret mode) and the
    port's on both paths, fed the JAX path's glossy fuzz."""
    sj = glossy_two_light_scene()
    st = carried(sj)
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    dirs[:, 1] = np.abs(dirs[:, 1]) + 0.4
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    key = jax.random.key(3)
    weight = np.linspace(0.5, 1.5, 256 * 3, dtype=np.float32).reshape(256, 3)
    theta = P_jax.extract(sj, FG_PATHS)

    def loss(th, o_):
        out = trace_jax(P_jax.apply(sj, th), o_, jnp.asarray(dirs), jnp.zeros(256), key, 1,
                        differentiable=True)
        return jnp.sum(out * weight)

    with interpret():
        ref, ref_o = jax.grad(loss, argnums=(0, 1))(theta, jnp.zeros((256, 3)))
    # the JAX fused level's fuzz rows (render/integrator.py:355-382); the
    # draws of its 2048-lane block begin with those of 256 lanes
    fuzz = [
        torch.from_numpy(np.array(sphere_jax(
            jax.random.fold_in(jax.random.fold_in(key, depth), 1), (256,)).T))
        for depth in range(11)
    ]
    got = {}
    for fused in (True, False):
        th = P.theta_from_numpy(theta_np(sj, FG_PATHS), "cpu")
        o = torch.zeros((256, 3), requires_grad=True)
        out = trace_wavefront(
            P.apply(st, th), o, torch.from_numpy(dirs), torch.zeros(256), 1,
            differentiable=True, fused=fused, fuzz=fuzz, device="cpu",
        )
        (out * torch.from_numpy(weight)).sum().backward()
        got[fused] = ({k: v.grad.numpy() for k, v in th.items()}, o.grad.numpy())
    return ref, ref_o, got


@pytest.mark.parametrize("path", FG_PATHS + ("origins",))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_fused_and_general_grads_match_jax(fused_general_case, path, fused):
    ref, ref_o, got = fused_general_case
    g, g_o = got[fused]
    if path == "origins":
        assert_grads_close(g_o, ref_o, path)
    else:
        assert np.abs(np.asarray(ref[path])).max() > 0, path
        assert_grads_close(g[path], ref[path], path)


def test_differentiable_trace_takes_the_fused_level(monkeypatch):
    """A scene the gate takes runs every level through WaveLevelFn; one it
    refuses (use_bvh here) takes the general path; both give the inference
    radiance."""
    st = carried(glossy_two_light_scene())
    calls = []
    apply = wf.WaveLevelFn.apply
    monkeypatch.setattr(
        wf.WaveLevelFn, "apply", lambda *a: calls.append(1) or apply(*a)
    )
    o, d, tm = tile_rays(st.camera, 2, 2, 8, 1, generator=torch.Generator().manual_seed(0))
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    ref = trace_wavefront(st, o, d, tm, 1, generator=gen(), device="cpu")
    got = trace_wavefront(st, o, d, tm, 1, generator=gen(), device="cpu", differentiable=True)
    assert len(calls) == 11 and torch.equal(got, ref)
    calls.clear()
    general = trace_wavefront(st, o, d, tm, 1, generator=gen(), device="cpu",
                              differentiable=True, use_bvh=True)
    assert not calls
    np.testing.assert_allclose(general.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------- tiny scene: vs JAX, FD
def loss_at(st, theta, fused=None):
    target = torch.full(st.camera.resolution[::-1] + (3,), 0.25)
    if fused is None:
        return mse_loss(P.apply(st, theta), target, 0, OPTS, device="cpu")
    sc = P.apply(st, theta)
    w, h = sc.camera.resolution
    o, d, tm = tile_rays(sc.camera, 0, h, w, 1, generator=torch.Generator().manual_seed(0))
    img = trace_wavefront(sc, o, d, tm, 1, differentiable=True, fused=fused, device="cpu")
    return torch.mean((img.reshape(h, w, 3) - target) ** 2)


FD_CASES = [
    ("lights.intensity", 1e-1),
    ("materials.diffuse", 1e-3),
    ("materials.k_diffuse", 1e-3),
    ("lights.position", 1e-3),
    ("camera.location", 1e-4),
]


@pytest.mark.parametrize("path,eps", FD_CASES)
def test_grad_matches_finite_difference(path, eps):
    """tests/test_diff.py's check on the port: central differences on the
    first four coordinates, rel 0.15 / abs 2e-4; and the analytic gradient
    against the JAX package's on the same scene and parameters."""
    sj = tiny_scene()
    st = carried(sj)
    th_np = theta_np(sj, [path])
    theta = P.theta_from_numpy(th_np, "cpu")
    (g,) = torch.autograd.grad(loss_at(st, theta), [theta[path]])
    g = g.numpy()
    target = jnp.full(sj.camera.resolution[::-1] + (3,), 0.25)
    ref = jax.grad(
        lambda th: mse_jax(P_jax.apply(sj, th), target, KEY, OPTS)
    )({path: jnp.asarray(th_np[path])})[path]
    assert_grads_close(g, ref, path)
    base = th_np[path].astype(np.float64)
    for i in range(min(base.size, 4)):
        pert = np.zeros(base.size)
        pert[i] = eps
        pert = pert.reshape(base.shape)
        with torch.no_grad():
            lp = float(loss_at(st, {path: torch.tensor(base + pert, dtype=torch.float32)}))
            lm = float(loss_at(st, {path: torch.tensor(base - pert, dtype=torch.float32)}))
        fd = (lp - lm) / (2 * eps)
        assert g.reshape(-1)[i] == pytest.approx(fd, rel=0.15, abs=2e-4), (path, i)


def test_gradients_are_finite_everywhere():
    st = carried(tiny_scene())
    paths = [
        "materials.diffuse", "materials.specular", "materials.roughness",
        "materials.shininess", "materials.reflectivity",
        "lights.position", "lights.intensity", "lights.color",
        "camera.location", "camera.gaze", "camera.focal_length",
        "prims.o2w", "prims.w2o",
    ]
    for fused in (None, False):
        theta = P.extract(st, paths)
        grads = torch.autograd.grad(loss_at(st, theta, fused), list(theta.values()),
                                    allow_unused=True)
        for k, g in zip(theta, grads):
            assert g is None or torch.isfinite(g).all(), (k, fused)
        assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0


def dead_zone_scene():
    """A black floor (diffuse 0, specular 0: every Blinn-Phong product is
    zero) under a point light, half of it in the shadow of a sphere."""
    d = minimal_camera()
    d["cameras"][0]["location"] = [0.0, -4.0, 3.0]
    d["cameras"][0]["gaze_vector"] = [0.0, 0.8, -0.6]
    d["cameras"][0]["up_vector"] = [0.0, 0.6, 0.8]
    d["render"] = {"resolution_x": 16, "resolution_y": 12}
    d["lights"] = [{"location": [0.0, 1.0, 4.0], "color": [1, 1, 1], "intensity": 600.0}]
    d["spheres"] = [
        {"location": [0.6, 1.0, 1.2], "radius": 0.7,
         "material": {"diffuse_color": [0.8, 0.3, 0.2]}},
    ]
    d["rectangles"] = [
        {"translation": [0, 1, 0], "rotation": [0, 0, 0], "scale": [8, 8, 1],
         "material": {"diffuse_color": [0.0, 0.0, 0.0], "specular_color": [0.0, 0.0, 0.0]}},
    ]
    return load_scene_dict(d, device="cpu")


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "general"])
def test_dead_zone_gradient_matches_finite_differences(fused):
    """d loss / d floor albedo at albedo 0, against central differences.
    The lit part of the floor has a non-zero derivative, the shadowed part
    none: the port records the raw geometric visibility.  The JAX package
    does not get this right (its fused kernel records "blocked" for a lane
    whose term is zero, its general path skips the shadow ray there), so
    the check is against finite differences, not against it."""
    st = dead_zone_scene()
    assert wf.wave_refusal(st) is None
    theta = P.extract(st, ["materials.diffuse"])
    (g,) = torch.autograd.grad(loss_at(st, theta, fused), [theta["materials.diffuse"]])
    base = theta["materials.diffuse"].detach().double().numpy()
    floor = 1  # the rect's material row
    for c in range(3):
        pert = np.zeros_like(base)
        pert[floor, c] = 1e-3
        with torch.no_grad():
            lp = float(loss_at(st, {"materials.diffuse": torch.tensor(base + pert, dtype=torch.float32)}, fused))
            lm = float(loss_at(st, {"materials.diffuse": torch.tensor(base - pert, dtype=torch.float32)}, fused))
        fd = (lp - lm) / 2e-3
        assert abs(fd) > 1e-3
        assert float(g[floor, c]) == pytest.approx(fd, rel=0.02), c


def test_render_linear_is_the_inference_image():
    """Record mode changes no pixel: render_linear equals render_image of
    the same seed (one tile), and mse_loss is its MSE."""
    sj = tiny_scene()
    st = carried(sj)
    img = render_linear(st, 0, OPTS, device="cpu")
    ref = render_image(st, OPTS, device="cpu")
    assert torch.equal(img.detach(), torch.from_numpy(ref))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(render_jax(sj, KEY, OPTS)),
                               rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------------- tiled
def test_tiled_grad_matches_whole_frame():
    """6-row tiles (16 = 6 + 6 + 4, the last clamped and masked): loss at
    rtol 1e-5, gradients at rtol 2e-4 / atol 1e-6 (tests/test_diff.py)."""
    st = carried(tiny_scene(res=(24, 16)))
    target = torch.full((16, 24, 3), 0.2)
    paths = ["materials.diffuse", "lights.intensity", "camera.location"]
    theta = P.extract(st, paths)
    l_ref = mse_loss(P.apply(st, theta), target, 0, OPTS, device="cpu")
    g_ref = torch.autograd.grad(l_ref, list(theta.values()))
    opts = RenderOptions(samples_sqrt=1, light_samples=1, max_rays_per_pass=24 * 6)
    l_t, g_t = mse_loss_and_grad_tiled(st, theta, target, 0, opts, device="cpu")
    assert not l_t.requires_grad
    np.testing.assert_allclose(float(l_t), float(l_ref.detach()), rtol=1e-5)
    np.testing.assert_allclose(float(mse_loss_tiled(st, theta, target, 0, opts, device="cpu")),
                               float(l_t), rtol=1e-6)
    for k, b in zip(paths, g_ref):
        np.testing.assert_allclose(g_t[k].numpy(), b.numpy(), rtol=2e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------- fit
def wrong_start(sj):
    wrong = sj.materials.diffuse.at[0].set(jnp.asarray([0.2, 0.7, 0.7]))
    return sj.replace(materials=sj.materials.replace(diffuse=wrong))


def test_fit_matches_jax_adam():
    """Five Adam steps from the same start: the loss history and theta of
    torch.optim.Adam equal optax.adam's at rtol 1e-4."""
    sj_true = tiny_scene()
    target = render_jax(sj_true, KEY, OPTS)
    sj0 = wrong_start(sj_true)
    _, th_j, hist_j = fit_jax(sj0, target, ["materials.diffuse"], steps=5,
                              learning_rate=5e-2, opts=OPTS, key=KEY, resample_noise=False)
    _, th_t, hist_t = fit(carried(sj0), torch.from_numpy(np.array(target)),
                          ["materials.diffuse"], steps=5, learning_rate=5e-2, opts=OPTS,
                          resample_noise=False, device="cpu")
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    np.testing.assert_allclose(th_t["materials.diffuse"].numpy(),
                               np.asarray(th_j["materials.diffuse"]), rtol=1e-4)


def test_adam_state_carries_over_from_jax():
    """JAX Adam for k = 2 steps, its (theta, mu, nu, count) carried into
    torch.optim.Adam, three more steps there: theta equals JAX's after its
    steps 3..5 at rtol 1e-4."""
    sj = wrong_start(tiny_scene())
    target_j = render_jax(tiny_scene(), KEY, OPTS)
    path = "materials.diffuse"
    opt = optax.adam(5e-2)
    th = P_jax.extract(sj, [path])
    state = opt.init(th)
    grad = jax.jit(jax.grad(lambda t: mse_jax(P_jax.apply(sj, t), target_j, KEY, OPTS)))
    for _ in range(2):
        upd, state = opt.update(grad(th), state, th)
        th = optax.apply_updates(th, upd)
    carried_theta = P.theta_from_numpy({path: np.asarray(th[path])}, "cpu")
    adam_state = state[0]
    torch_opt = P.adam_state_from_numpy(
        {path: np.asarray(adam_state.mu[path])}, {path: np.asarray(adam_state.nu[path])},
        int(adam_state.count), carried_theta, lr=5e-2,
    )
    for _ in range(3):
        upd, state = opt.update(grad(th), state, th)
        th = optax.apply_updates(th, upd)
    _, got, _ = fit(carried(sj), torch.from_numpy(np.array(target_j)), [path], steps=3,
                    opts=OPTS, resample_noise=False, device="cpu",
                    theta=carried_theta, optimizer=torch_opt)
    np.testing.assert_allclose(got[path].numpy(), np.asarray(th[path]), rtol=1e-4)


@pytest.mark.parametrize("tiled", [False, True], ids=["whole_frame", "tiled"])
def test_fit_recovers_diffuse(tiled):
    """tests/test_diff.py's inverse-rendering checks: 60 steps bring the
    loss under 5 % of its start and the sphere's albedo to [0.8, 0.3, 0.2]
    at atol 0.07."""
    sj_true = tiny_scene()
    st_true = carried(sj_true)
    target = render_linear(st_true, 0, OPTS, device="cpu").detach()
    opts = RenderOptions(samples_sqrt=1, light_samples=1,
                         max_rays_per_pass=24 * 6 if tiled else 1 << 23)
    _, theta, hist = fit(carried(wrong_start(sj_true)), target, ["materials.diffuse"],
                         steps=60, learning_rate=5e-2, opts=opts, resample_noise=False,
                         tiled=tiled, device="cpu")
    assert hist[-1] < hist[0] * 0.05, hist[::10]
    np.testing.assert_allclose(theta["materials.diffuse"][0].numpy(), [0.8, 0.3, 0.2], atol=0.07)


def test_fit_checkpoint_and_resume(tmp_path):
    """2N steps in one go equal N steps, a checkpoint, a restore and N more;
    the newest `keep` checkpoints are kept."""
    sj_true = tiny_scene()
    target = render_linear(carried(sj_true), 0, OPTS, device="cpu").detach()
    st0 = carried(wrong_start(sj_true))
    common = dict(learning_rate=5e-2, opts=OPTS, resample_noise=False, device="cpu")
    ckdir = str(tmp_path / "ckpt")
    _, _, hist_a = fit(st0, target, ["materials.diffuse"], steps=4,
                       checkpoint_dir=ckdir, checkpoint_every=2, **common)
    assert len(hist_a) == 4
    step, theta_ck, opt_state = ckpt.restore(ckdir, "cpu")
    assert step == 4 and set(theta_ck) == {"materials.diffuse"}
    _, theta_b, hist_b = fit(st0, target, ["materials.diffuse"], steps=8,
                             checkpoint_dir=ckdir, checkpoint_every=2, **common)
    assert len(hist_b) == 4, "resume must skip the steps already run"
    _, theta_c, hist_c = fit(st0, target, ["materials.diffuse"], steps=8, **common)
    assert torch.equal(theta_b["materials.diffuse"], theta_c["materials.diffuse"])
    assert hist_a + hist_b == hist_c
    assert sorted(os.listdir(ckdir)) == [f"step_{s:09d}.pt" for s in (4, 6, 8)]


# -------------------------------------------------------------------- guard
def test_routing_guard_raises_when_reflectivity_crosses_zero():
    st = carried(tiny_scene())
    refl = st.materials.reflectivity
    assert st.has_reflection and float(refl[1]) == 0.0
    P.apply(st, {"materials.reflectivity": refl * 0.5})  # same side of zero
    with pytest.raises(ValueError, match="routing"):
        P.apply(st, {"materials.reflectivity": torch.zeros_like(refl)})
    with pytest.raises(ValueError, match="routing"):
        P.apply(st, {"materials.transparency": torch.full_like(refl, 0.5)})
    with pytest.raises(KeyError):
        P.apply(st, {"render.resolution": refl})


def test_theta_from_numpy_gives_leaves():
    sj = tiny_scene()
    th = P.theta_from_numpy(theta_np(sj, ["lights.position", "camera.location"]), "cpu")
    for k, v in th.items():
        assert v.is_leaf and v.requires_grad and v.dtype == torch.float32
    np.testing.assert_array_equal(th["lights.position"].detach().numpy(),
                                  np.asarray(sj.lights.position))


def test_diff_modules_import_no_jax():
    """The port's differentiable path imports torch and numpy only."""
    pkg = os.path.join(REPO, "ray_tracying_tpu_torch")
    files = [os.path.join(pkg, "diff", f) for f in os.listdir(os.path.join(pkg, "diff"))
             if f.endswith(".py")]
    files.append(os.path.join(pkg, "kernels", "wave_ref.py"))
    bad = re.compile(r"^\s*(import|from)\s+(jax|optax|orbax|ray_tracying_tpu\b(?!_torch))")
    for path in files:
        with open(path) as f:
            for line in f:
                assert not bad.match(line), (path, line)


STRIP_PATHS = ("materials.diffuse", "materials.reflectivity", "materials.transparency",
               "lights.position", "lights.intensity", "camera.location")


@pytest.mark.parametrize("name", ["cornell", "motion", "det_basic"])
def test_fused_and_general_grads_agree_on_the_level_specialisations(name):
    """cornell (legacy planes, one-way glass, a mirror, an area light),
    motion (moving spheres) and det_basic (every kind, glass): gradients of
    a weighted radiance sum down the fused path (record-mode level and the
    rebuild's autograd) and down the general path (pass 2 under
    checkpoint), from the same rays and area-light jitter, agree at G_RTOL
    and are finite.  Before the general path gave a non-refracting lane
    index 1, its camera gradient on cornell was NaN."""
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.scene.loader import load_scene

    if name == "cornell":
        st = models.get("cornell", res=(40, 40), device="cpu")
    else:
        st = load_scene(os.path.join(REPO, "scenes", f"{name}.json"), device="cpu")
    w, h = st.camera.resolution
    rows = 6
    n = rows * w
    gen = torch.Generator().manual_seed(21)
    jitter = [[uniform_in_unit_sphere(gen, (n, 2)) if a else None for a in st.lights.is_area]
              for _ in range(11)]
    weight = torch.rand((n, 3), generator=gen) + 0.5
    paths = [p for p in STRIP_PATHS if p != "materials.transparency" or st.has_refraction]
    grads = {}
    for fused in (True, False):
        theta = P.extract(st, paths)
        sc = P.apply(st, theta)
        o, d, tm = tile_rays(sc.camera, h // 2 - rows // 2, rows, w, 1,
                             generator=torch.Generator().manual_seed(22))
        rad = trace_wavefront(sc, o, d, tm, 2, differentiable=True, fused=fused, device="cpu",
                              light_jitter=jitter if any(st.lights.is_area) else None)
        grads[fused] = torch.autograd.grad((rad * weight).sum(), list(theta.values()))
    for k, a, b in zip(paths, grads[True], grads[False]):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), k
        assert_grads_close(a, b, err_msg=k)
    assert any(float(g.abs().max()) > 0 for g in grads[True])


def test_refract_gradient_is_finite_where_the_discriminant_is_zero():
    """A lane whose normal is zero (a miss) and whose index the general
    path's spawn sets to 1 (it does not refract) has discriminant exactly 0:
    refract's gradient there is finite (a safe sqrt), not NaN (sqrt'(0)
    times the lane's cotangent), and a refracting lane's is unchanged."""
    from ray_tracying_tpu_torch.core.vecmath import refract

    d = torch.tensor([[0.6, 0.0, 0.8], [0.0, 0.0, 1.0]], requires_grad=True)
    n = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t_dir, _ = refract(d, n, torch.tensor([1.0, 1.5]))
    (g,) = torch.autograd.grad(t_dir.sum(), [d])
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g[1].numpy(), [1.5, 1.5, 0.0], rtol=1e-6)
