"""Far, small spheres: where the fused level and the general path part.

The zoo's `sphere_field(n=1500)`, a texture on every third geom, seen from
the zoo's camera: its small spheres sit up to ~400 radii away, where the
sphere quadratic cancels, and the two paths compute the hit point by
different f32 arithmetic (the level keeps the loop's point, the general
path rebuilds it in pass 2).  On a few lanes in a thousand the last-bit
difference moves a texel lookup or a shadow ray's start, and the two
paths' radiance differs by more than rtol 2e-5.

This file holds that split to the JAX package's own: the port's fused path
against JAX's fused path (Pallas in interpret mode) and the port's general
path against JAX's general path agree on every lane at rtol 2e-5 / atol
2e-6, and the lanes where the port's two paths part are the lanes where
JAX's two paths part (at most SPLIT_SHARE of the lanes on one side only).
So the split is a tolerance of the reference, not a fault of the port.

The JAX side runs in a subprocess whose XLA uses no FMA instructions, as
tests/test_torch_wave_features.py explains:

    python tests/test_torch_far_spheres.py <in.npz> <out.npz>
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TEX = os.path.join(REPO, "golden", "Textures")
RTOL, ATOL = 2e-5, 2e-6
N_SPHERES, RES = 1500, (192, 108)
ROWS = (28, 9)  # first image row and row count of the traced band
# Lanes that may split on one package's paths and not on the other's.
SPLIT_SHARE = 1e-3

torch.set_num_threads(1)


def textured_tex_id(m):
    """Texture 0 on every third material and on the last (the floor's)."""
    ids = np.arange(m)
    return np.where((ids % 3 == 0) | (ids == m - 1), 0, -1).astype(np.int32)


def port_case():
    """(port scene, o, d, tm): the band's primary rays at 1 spp."""
    import ray_tracying_tpu_torch as rt
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    st = models.get("sphere_field", n=N_SPHERES, res=RES, device="cpu")
    donor = rt.load_scene(os.path.join(REPO, "scenes", "texture.json"), textures_dir=TEX,
                          device="cpu")
    tex_id = torch.from_numpy(textured_tex_id(st.materials.tex_id.shape[0]))
    st = dataclasses.replace(
        st, tex_atlas=donor.tex_atlas, tex_wh=donor.tex_wh, has_textures=True,
        materials=dataclasses.replace(st.materials, tex_id=tex_id))
    o, d, tm = tile_rays(st.camera, ROWS[0], ROWS[1], RES[0], 1,
                         generator=torch.Generator().manual_seed(0))
    return st, o, d, tm


def write_jax_refs(inp, out):
    """JAX's fused (shrink=(), Pallas interpret) and general radiance of
    the rays in `inp`."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    os.environ["RTT_PALLAS_INTERPRET"] = "1"
    import ray_tracying_tpu as rt_jax
    from ray_tracying_tpu.models import zoo as zoo_jax
    from ray_tracying_tpu.render.integrator import trace_wavefront as trace_jax

    sj = zoo_jax.sphere_field(n=N_SPHERES, res=RES)
    donor = rt_jax.load_scene(os.path.join(REPO, "scenes", "texture.json"), textures_dir=TEX)
    sj = sj.replace(
        tex_atlas=donor.tex_atlas, tex_wh=donor.tex_wh, has_textures=True,
        materials=sj.materials.replace(
            tex_id=jnp.asarray(textured_tex_id(sj.materials.tex_id.shape[0]))))
    rays = np.load(inp)
    o, d, tm = (jnp.asarray(rays[k]) for k in ("o", "d", "tm"))
    key = jax.random.key(0)
    fused = trace_jax(sj, o, d, tm, key, 1, shrink=(), fused=True)
    general = trace_jax(sj, o, d, tm, key, 1, fused=False)
    np.savez(out, fused=np.asarray(fused), general=np.asarray(general))


def split_lanes(a, b):
    return ~np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=1)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(port fused, port general, JAX fused, JAX general) radiance."""
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront

    st, o, d, tm = port_case()
    tmp = tmp_path_factory.mktemp("far_spheres")
    inp, out = str(tmp / "rays.npz"), str(tmp / "jax.npz")
    np.savez(inp, o=o.numpy(), d=d.numpy(), tm=tm.numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    job = subprocess.Popen([sys.executable, os.path.abspath(__file__), inp, out],
                           env=env, cwd=REPO)
    fused = trace_wavefront(st, o, d, tm, 1, fused=True, shrink=(), device="cpu").numpy()
    general = trace_wavefront(st, o, d, tm, 1, fused=False, device="cpu").numpy()
    assert job.wait(timeout=600) == 0
    ref = np.load(out)
    return fused, general, ref["fused"], ref["general"]


def test_each_port_path_matches_its_jax_twin_on_far_spheres(traced):
    """Port fused = JAX fused and port general = JAX general, every lane
    at RTOL/ATOL."""
    fused, general, jax_fused, jax_general = traced
    np.testing.assert_allclose(fused, jax_fused, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(general, jax_general, rtol=RTOL, atol=ATOL)


def test_the_paths_split_where_the_jax_paths_split(traced):
    """The lanes where the port's fused and general radiance part (beyond
    RTOL/ATOL) are the lanes where JAX's part: at most SPLIT_SHARE of the
    lanes on one side only.  The split exists (this band holds some) and
    stays under 2 % of the lanes."""
    fused, general, jax_fused, jax_general = traced
    port_split = split_lanes(fused, general)
    jax_split = split_lanes(jax_fused, jax_general)
    n = fused.shape[0]
    assert port_split.sum() > 0 and jax_split.sum() > 0
    assert port_split.mean() < 0.02
    assert (port_split ^ jax_split).sum() <= SPLIT_SHARE * n, (
        np.nonzero(port_split)[0], np.nonzero(jax_split)[0])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    write_jax_refs(sys.argv[1], sys.argv[2])
