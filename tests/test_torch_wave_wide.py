"""The fused level on tables over what a block's shared memory stages
(1,107-6,144 geoms: the kernel's wide build), against the JAX package,
whose fused level takes any table up to WAVE_MAX_GEOMS = 6,144.

The gate: the port's `wave_refusal(...) is None` exactly where JAX's
`wave_supported` is True, textured and untextured, around both packages'
caps; every table it takes, from 1 geom to 6,144, routed to a window
cull.  One level: `wave_level` on the CPU (the plain version, which is
the wide kernel's plain version too) against `wave_level_call` in
interpret mode on cube_city(n=2048) (2,049 geoms, cubes and a rect) and a
textured sphere_field(n=3000) (3,001 geoms, spherical UV), levels 0 and 1
on the same rays, and the g++ build of the kernel's windowed block
schedule (tests/test_torch_kernel_source.py's `host_blocks`: the table's
rows in Morton windows culled per warp by box) on the same rays against
the same reference; the same for a table a block stages, the flagship's,
through the staged windowed schedule and the staged one.  The whole fused
trace of cube_city against JAX's `trace_wavefront(..., shrink=())`:
radiance and per-level counts; it runs
through `wave_level` and never the general path.  Differentiable mode
takes the same scene fused, with the general path's gradients.

The JAX side runs in a subprocess whose XLA uses no FMA instructions, as
tests/test_torch_wave_features.py explains; the port's side runs
meanwhile.  Tolerance: rtol 2e-5, atol 2e-6, decision rows (act, act_hit)
and counts equal; gradients rtol 2e-4 (tests/test_torch_diff.py).

    python tests/test_torch_wave_wide.py <case>|trace <in.npz> <out.npz>

writes the JAX references (a case's levels, or the trace) of the rays in
<in.npz>."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_kernel_source import host_blocks  # noqa: F401  (a fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TEX = os.path.join(REPO, "golden", "Textures")
RTOL, ATOL = 2e-5, 2e-6
G_RTOL = 2e-4
BLOCK = 2048  # the JAX kernel's block (kernels/wavefront.py::WAVE_BLOCK)
RES = (96, 54)
# (zoo name, n, textured, first row): four rows (384 lanes at 1 spp) where
# reflective geoms send rays on past level 1
CASES = {
    "cube_city": ("cube_city", 2048, False, 14),
    "sphere_field_textured": ("sphere_field", 3000, True, 13),
}
N_ROWS = 4
KEY_TRACE = 21
# A table a block stages: the flagship's (141 geoms: cubes and a rect,
# textured, glossy, two lights) at RES, four rows from this one, its glossy
# fuzz fed to both packages.
FLAGSHIP = ("golden/ASCII/scene.json", 30)

torch.set_num_threads(1)


def textured_tex_id(m):
    """Texture 0 on every third material and on the last (the floor's)."""
    ids = np.arange(m)
    return np.where((ids % 3 == 0) | (ids == m - 1), 0, -1).astype(np.int32)


def port_scene(name, n, textured, res=RES):
    import ray_tracying_tpu_torch as rt
    from ray_tracying_tpu_torch import models

    st = models.get(name, n=n, res=res, device="cpu")
    if not textured:
        return st
    donor = rt.load_scene(os.path.join(REPO, "scenes", "texture.json"), textures_dir=TEX,
                          device="cpu")
    return dataclasses.replace(
        st, tex_atlas=donor.tex_atlas, tex_wh=donor.tex_wh, has_textures=True,
        materials=dataclasses.replace(
            st.materials, tex_id=torch.from_numpy(textured_tex_id(st.materials.tex_id.shape[0]))))


def jax_scene(name, n, textured, res=RES):
    import jax.numpy as jnp

    import ray_tracying_tpu as rt_jax
    from ray_tracying_tpu import models as models_jax

    sj = models_jax.get(name, n=n, res=res)
    if not textured:
        return sj
    donor = rt_jax.load_scene(os.path.join(REPO, "scenes", "texture.json"), textures_dir=TEX)
    return sj.replace(
        tex_atlas=donor.tex_atlas, tex_wh=donor.tex_wh, has_textures=True,
        materials=sj.materials.replace(
            tex_id=jnp.asarray(textured_tex_id(sj.materials.tex_id.shape[0]))))


def port_case(case):
    """(port scene, o, d, tm, bootstrap (13, BLOCK) f32): the case's four
    rows at 1 spp; the bootstrap has a mixed act mask and throughput, then
    dead padding up to the JAX kernel's block."""
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    name, n, textured, y0 = CASES[case]
    st = port_scene(name, n, textured)
    o, d, tm = tile_rays(st.camera, y0, N_ROWS, RES[0], 1,
                         generator=torch.Generator().manual_seed(3))
    r = o.shape[0]
    rng = np.random.default_rng(6)
    boot = np.zeros((13, BLOCK), np.float32)
    boot[0:3, :r] = o.numpy().T
    boot[3:6, :r] = d.numpy().T
    boot[6, :r] = tm.numpy()
    boot[7, :r] = (rng.random(r) < 0.8).astype(np.float32)
    boot[8, :r] = (0.2 + 0.8 * rng.random(r)).astype(np.float32)
    return st, o, d, tm, boot


def flagship_case():
    """(port scene at RES, bootstrap (13, BLOCK) f32 as port_case makes it,
    (3, BLOCK) unit-ball fuzz rows)."""
    import ray_tracying_tpu_torch as rt
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    st = rt.load_scene(os.path.join(REPO, FLAGSHIP[0]), textures_dir=TEX, device="cpu")
    st = dataclasses.replace(st, camera=dataclasses.replace(st.camera, resolution=RES))
    gen = torch.Generator().manual_seed(3)
    o, d, tm = tile_rays(st.camera, FLAGSHIP[1], N_ROWS, RES[0], 1, generator=gen)
    r = o.shape[0]
    rng = np.random.default_rng(6)
    boot = np.zeros((13, BLOCK), np.float32)
    boot[0:3, :r] = o.numpy().T
    boot[3:6, :r] = d.numpy().T
    boot[6, :r] = tm.numpy()
    boot[7, :r] = (rng.random(r) < 0.8).astype(np.float32)
    boot[8, :r] = (0.2 + 0.8 * rng.random(r)).astype(np.float32)
    fuzz = uniform_in_unit_sphere(gen, (BLOCK,), device="cpu").T.contiguous().numpy()
    return st, boot, fuzz


def write_jax_refs(what, inp, out):
    """what = a case of CASES: levels 0 and 1 of wave_level_call (level 1
    fed by JAX's level 0), as the port's 13 rows: a textured sphere scene's
    level leaves the texel to the glue (_wave_tex_modulate), whose
    contribution stands in rows 9..11 here.  what = "flagship": the same of
    the flagship's table, with its fuzz rows.  what = "trace": cube_city's
    whole fused trace."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    os.environ["RTT_PALLAS_INTERPRET"] = "1"
    from ray_tracying_tpu.kernels import wavefront as wf_jax
    from ray_tracying_tpu.render.integrator import _wave_tex_modulate
    from ray_tracying_tpu.render.integrator import trace_wavefront as trace_jax

    data = np.load(inp)
    res = {}
    if what in CASES or what == "flagship":
        if what == "flagship":
            import ray_tracying_tpu as rt_jax

            sj = rt_jax.load_scene(os.path.join(REPO, FLAGSHIP[0]), textures_dir=TEX)
        else:
            sj = jax_scene(*CASES[what][:3])
        fz = jnp.asarray(data[f"{what}_fuzz"]) if f"{what}_fuzz" in data \
            else jnp.zeros((1, BLOCK), jnp.float32)
        table, ranges, lights = wf_jax.wave_tables(sj)
        ktex = wf_jax.tex_kernel_supported(sj)
        glue = sj.has_textures and not ktex
        hr = wf_jax.hit_row(glue, glue and sj.has_spheres)
        uv_kinds = (sj.has_spheres, sj.has_cubes, sj.has_rects, sj.n_planes > 0)
        if ktex:
            tex_m, twh = wf_jax.pack_tex_matrix(sj)
        else:
            tex_m, twh = jnp.zeros((8, 128), jnp.bfloat16), jnp.zeros((2, 1), jnp.float32)
        # one compilation for both levels (interpret mode runs op by op
        # outside jit)
        level = jax.jit(lambda prev: wf_jax.wave_level_call(
            prev, fz, table, lights, tex_m, twh, ranges,
            sj.has_motion, sj.n_lights, sj.has_glossy, sj.has_refraction, 0.0,
            sj.has_textures, uv_kinds, tuple(sj.lights.is_area), 1, ktex, 0))
        # the bootstrap padded to the level's rows, as _trace_wave pads it
        boot = data[f"{what}_boot"]
        prev = jnp.asarray(np.pad(boot, ((0, hr + 1 - boot.shape[0]), (0, 0))))
        for lv in (0, 1):
            o_ = level(prev)
            contrib = _wave_tex_modulate(sj, o_) if glue else o_[9:12]
            res[f"{what}_level{lv}"] = np.asarray(
                jnp.concatenate([o_[:9], contrib, o_[hr : hr + 1]]))
            prev = o_
    if what == "trace":
        sj = jax_scene(*CASES["cube_city"][:3])
        rad, stats = trace_jax(sj, *(jnp.asarray(data[k]) for k in ("o", "d", "tm")),
                               jax.random.key(KEY_TRACE), 1, shrink=(), return_stats=True)
        res["trace_radiance"] = np.asarray(rad)
        res["trace_counts"] = np.stack([np.asarray(stats.live), np.asarray(stats.hits),
                                        np.asarray(stats.spawned)])
    np.savez(out, **res)


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """A getter of the JAX references (a case's levels, or "trace"),
    computed in one subprocess each (no FMA instructions), all started
    before the file's first test; the getter waits for the one asked for,
    so the tests compute their port side meanwhile."""
    tmp = tmp_path_factory.mktemp("wave_wide")
    inp = str(tmp / "rays.npz")
    outs = {what: str(tmp / f"jax_{what}.npz") for what in (*CASES, "flagship", "trace")}
    arrays = {}
    for case in CASES:
        _, o, d, tm, boot = port_case(case)
        arrays[f"{case}_boot"] = boot
        if case == "cube_city":
            arrays.update(o=o.numpy(), d=d.numpy(), tm=tm.numpy())
    _, arrays["flagship_boot"], arrays["flagship_fuzz"] = flagship_case()
    np.savez(inp, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    jobs = {what: subprocess.Popen([sys.executable, os.path.abspath(__file__), what, inp, out],
                                   env=env, cwd=REPO) for what, out in outs.items()}
    refs = {}

    def get(what):
        if what not in refs:
            assert jobs[what].wait(timeout=600) == 0, what
            refs[what] = dict(np.load(outs[what]))
        return refs[what]

    yield get
    for job in jobs.values():
        if job.poll() is None:
            job.kill()
            job.wait()


def live_lanes_only(plain, calls):
    """wave_level_plain restricted to the lanes that enter live, counting
    its calls: the plain version is lane-wise, so this is the same
    function (a lane that enters dead leaves with rows 0..12 zero, and in
    record mode id -1, visibility 0, texel 1), and a deep level whose
    lanes are all dead costs nothing."""
    from ray_tracying_tpu_torch.kernels import wavefront as wf

    def level(out_prev, fuzz, tables, min_tp=0.0, stats=None, record=False):
        calls.append(record)
        live = torch.nonzero(out_prev[7] > 0).squeeze(1)
        rows = wf.OUT_ROWS + (wf.record_rows(tables.n_lights, tables.has_tex) if record else 0)
        out = torch.zeros((rows, out_prev.shape[1]), dtype=torch.float32)
        if record:
            out[wf.OUT_ROWS] = -1.0
            out[wf.OUT_ROWS + 1 + tables.n_lights :] = 1.0
        if len(live):
            out[:, live] = plain(
                out_prev[:, live].contiguous(),
                None if fuzz is None else fuzz[:, live].contiguous(), tables, min_tp,
                record=record)
        return out

    return level


@pytest.mark.parametrize("textured", [False, True], ids=["untextured", "textured"])
def test_gate_equals_the_jax_gate_on_the_geom_count(textured):
    """Around the staged tables' caps (1,106 textured, 1,130 untextured:
    the table, its window records and its permuted rows in a block's shared
    memory), the caps of the staged build before it culled (1,669 and
    1,723), and the JAX package's WAVE_MAX_GEOMS, and at no geoms: the port
    takes a table exactly where `wave_supported` does, names the count
    where it refuses, and the package's build is the wide one ("windows")
    past the staged cap."""
    from ray_tracying_tpu.kernels import wavefront as wf_jax
    from ray_tracying_tpu_torch.kernels import wavefront as wf

    assert wf.WAVE_MAX_GEOMS == wf_jax.WAVE_MAX_GEOMS == 6144
    base = wf.wave_tables(port_scene("sphere_field", 8, textured, res=(8, 6)))
    for n_geoms in (1106, 1107, 1130, 1131, 1669, 1670, 1723, 1724, 2049, 3001, 6144, 6145):
        st = port_scene("sphere_field", n_geoms - 1, textured, res=(8, 6))
        sj = jax_scene("sphere_field", n_geoms - 1, textured, res=(8, 6))
        assert st.n_geoms == sj.n_geoms == n_geoms
        refusal = wf.wave_refusal(st)
        assert (refusal is None) == wf_jax.wave_supported(sj), n_geoms
        assert (refusal is None) == (n_geoms <= 6144), n_geoms
        if refusal is not None:
            assert f"shaded table of {n_geoms} geoms" in refusal
        cap = wf.wave_cap_geoms(31 + int(textured), st.n_lights)
        assert cap == (1106 if textured else 1130)
        sized = dataclasses.replace(base, table=torch.zeros((31 + int(textured), n_geoms)))
        assert wf.package_build(sized) == ("windows" if n_geoms > cap else "staged_windows")
    # no geoms: both refuse (the trace answers an empty scene with the background)
    empty = dataclasses.replace(st, n_prims=0, n_planes=0)
    assert "empty table" in wf.wave_refusal(empty)
    assert not wf_jax.wave_supported(sj.replace(n_prims=0, n_planes=0))


@pytest.mark.parametrize("textured", [False, True], ids=["untextured", "textured"])
def test_every_table_the_gate_takes_is_culled_by_window(textured):
    """From one geom to the gate's 6,144: every table `wave_refusal` takes
    gets its windows from `wave_tables` (built from this very table:
    `check_windows` passes), and the package launches a window-culled build
    for it: the staged windowed build while the table, its window records
    and its permuted rows fit a block's shared memory beside the rest (at
    the most windows a table of that size can have), the wide windowed
    build past that; never the unculled staged build."""
    from ray_tracying_tpu_torch.kernels import wavefront as wf

    n_cols = 31 + int(textured)
    for n_geoms in (1, 2, 33, 141, 1106, 1107, 1130, 1131, 1669, 2049, 6144):
        st = port_scene("sphere_field", n_geoms - 1, textured, res=(8, 6))
        assert st.n_geoms == n_geoms and wf.wave_refusal(st) is None
        tables = wf.wave_tables(st)
        wf.check_windows(tables)
        build = wf.package_build(tables)
        fits = wf.staged_smem_bytes(n_geoms, n_cols, st.n_lights) <= wf.WAVE_MAX_SMEM_BYTES
        assert build == ("staged_windows" if fits else "windows"), n_geoms
        assert fits == (n_geoms <= wf.wave_cap_geoms(n_cols, st.n_lights))
        n_win = sum(-(-(e - s_) // wf.WAVE_WINDOW) for _, s_, e in tables.ranges)
        assert tables.windows.shape == (n_win, wf.WIN_REC)
        assert n_win <= wf.max_windows(n_geoms)
        assert tables.perm_rows.shape == (n_geoms, wf.WIN_COLS)
        assert wf.wave_smem_bytes(n_geoms, n_cols, st.n_lights, n_win, n_geoms) \
            <= wf.staged_smem_bytes(n_geoms, n_cols, st.n_lights)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_level_matches_jax_kernel(jax_refs, host_blocks, case, level):
    """One level of wave_level (the plain version on the CPU) against
    wave_level_call in interpret mode on the same rays (mixed act mask and
    throughput): level 0, and level 1 fed by JAX's level 0 (reflected
    rays).  The table takes the kernel's wide build; the g++ build of its
    windowed block schedule holds to the same reference on the same rays."""
    from test_torch_wavefront import assert_level_close

    from ray_tracying_tpu_torch.kernels import wavefront as wf

    st, _, _, _, boot = port_case(case)
    tables = wf.wave_tables(st)
    assert tables.has_tex == CASES[case][2]
    if level == 0:
        prev = torch.from_numpy(boot)
    else:
        prev = torch.from_numpy(np.ascontiguousarray(jax_refs(case)[f"{case}_level0"][:9]))
        assert int((prev[7] > 0).sum()) > 20
    assert wf.package_build(tables) == "windows" and tables.windows is not None
    got = wf.wave_level(prev, None, tables).numpy()
    ref = jax_refs(case)[f"{case}_level{level}"]
    assert got.shape == ref.shape == (13, BLOCK)
    assert_level_close(got, ref, prev.numpy()[7] > 0)
    assert got[12].sum() > 20
    windowed = host_blocks(prev, None, tables).numpy()
    assert_level_close(windowed, ref, prev.numpy()[7] > 0)


@pytest.mark.parametrize("level", [0, 1])
def test_staged_table_level_matches_jax_kernel(jax_refs, host_blocks, level):
    """A table a block stages (the flagship's: 141 geoms, cubes and a rect,
    textured, glossy) through the package's build, the window cull over the
    staged table, windows and rows: the g++ build of its block schedule
    against wave_level_call in interpret mode on the same rays and fuzz
    (level 0, and level 1 fed by JAX's level 0), and so is the plain
    version and the unculled staged schedule."""
    from test_torch_wavefront import assert_level_close

    from ray_tracying_tpu_torch.kernels import wavefront as wf

    st, boot, fuzz = flagship_case()
    tables = wf.wave_tables(st)
    assert wf.package_build(tables) == "staged_windows" and tables.windows.shape[0] == 6
    if level == 0:
        prev = torch.from_numpy(boot)
    else:
        prev = torch.from_numpy(np.ascontiguousarray(jax_refs("flagship")["flagship_level0"][:9]))
        assert int((prev[7] > 0).sum()) > 20
    fz = torch.from_numpy(fuzz)
    ref = jax_refs("flagship")[f"flagship_level{level}"]
    live = prev.numpy()[7] > 0
    windowed = host_blocks(prev, fz, tables).numpy()
    assert windowed.shape == ref.shape == (13, BLOCK)
    assert_level_close(windowed, ref, live)
    assert windowed[12].sum() > 20
    assert_level_close(host_blocks(prev, fz, tables, build="staged").numpy(), ref, live)
    assert_level_close(wf.wave_level(prev, fz, tables).numpy(), ref, live)


def test_wide_trace_matches_jax_fused_path(jax_refs, monkeypatch):
    """cube_city's whole trace down the fused path (the default routing of
    a 2,049-geom scene: every level through wave_level, never the general
    path) against JAX's fused path (shrink=(), Pallas in interpret mode):
    radiance at RTOL/ATOL, per-level live / hit / spawned counts equal."""
    from ray_tracying_tpu_torch.kernels import wavefront as wf
    from ray_tracying_tpu_torch.render import integrator as G

    st, o, d, tm, _ = port_case("cube_city")
    calls = []
    monkeypatch.setattr(wf, "wave_level_plain", live_lanes_only(wf.wave_level_plain, calls))
    monkeypatch.setattr(G, "_trace_general", lambda *a, **k: pytest.fail("general path"))
    got, stats = G.trace_wavefront(st, o, d, tm, 1, return_stats=True, device="cpu",
                                   shrink=())
    assert calls == [False] * 11
    ref = jax_refs("trace")
    counts = torch.stack([stats.live, stats.hits, stats.spawned]).numpy()
    np.testing.assert_array_equal(counts, ref["trace_counts"])
    assert int(stats.live[2]) > 0, "the rays must reach past level 1"
    np.testing.assert_allclose(got.numpy(), ref["trace_radiance"], rtol=RTOL, atol=ATOL)


def test_wide_table_takes_the_fused_path_differentiable_too(monkeypatch):
    """differentiable=True routes cube_city (2,049 geoms) down the fused
    path as inference does (every level a WaveLevelFn, its forward the
    record-mode level); gradients of a weighted radiance sum match the
    general path's at G_RTOL on a strip, two levels deep."""
    from test_torch_diff import assert_grads_close

    from ray_tracying_tpu_torch.diff import params as P
    from ray_tracying_tpu_torch.kernels import wavefront as wf
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    st = port_scene("cube_city", 2048, False)
    paths = ("materials.diffuse", "materials.reflectivity", "lights.position",
             "lights.intensity", "camera.location")
    rows = 2
    weight = torch.rand((rows * RES[0], 3), generator=torch.Generator().manual_seed(21)) + 0.5
    applied = []
    real_apply = wf.WaveLevelFn.apply
    monkeypatch.setattr(wf.WaveLevelFn, "apply", lambda *a: applied.append(1) or real_apply(*a))
    grads = {}
    for fused in (None, False):
        theta = P.extract(st, paths)
        sc = P.apply(st, theta)
        o, d, tm = tile_rays(sc.camera, 14, rows, RES[0], 1,
                             generator=torch.Generator().manual_seed(22))
        rad = trace_wavefront(sc, o, d, tm, 1, differentiable=True, fused=fused,
                              device="cpu", max_depth=1)
        grads[fused] = torch.autograd.grad((rad * weight).sum(), list(theta.values()))
        if fused is None:
            assert len(applied) == 2
    assert len(applied) == 2  # the general path launches no level
    for k, a, b in zip(paths, grads[None], grads[False]):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), k
        assert_grads_close(a.numpy(), b.numpy(), err_msg=k)
    assert all(float(g.abs().max()) > 0 for g in grads[None])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    write_jax_refs(*sys.argv[1:4])
