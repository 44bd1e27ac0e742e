"""Record mode of the fused level and its backward, against the JAX
package's.

(a) `wave_level_plain(record=True)` against the JAX kernel
    `wave_level_call(record=...)` (Pallas in interpret mode) on two levels of
    bvh_glossy (cubes + rect, two point lights, in-kernel texture, glossy):
    rows 0..12 are those of `record=False`, bit for bit; the recorded winner
    ids agree on >= 99.9 % of live lanes (the two compute t with different
    f32 roundings, so near-ties can fall either way); the texel agrees where
    the ids do, and so does the visibility, except where the JAX kernel
    records "blocked" for a term that is exactly zero (it casts no shadow
    ray there; the port records the raw geometric visibility): on those
    lanes the port's rebuild gives the same rows 9..11 with either record.
(b) `kernels/wave_ref.py::wave_level_ref` against the JAX package's on the
    same recorded inputs: rows 0..12 at rtol 2e-5 / atol 2e-6 (the bar of
    tests/test_torch_wavefront.py), and the VJP with respect to (out_prev,
    table, lights) for a seeded cotangent at rtol 2e-4 / atol 2e-4 * max|g|
    (the JAX package's own fused-against-general gradient bar).
(c) `WaveLevelFn`: forward is the record-mode level, backward the autograd
    of (b); and the rebuild builds no tensor of size (R, G).
(d) core/segment.py: `segment_sum` against an f64 `index_add_`, and
    `gather_columns` under gradcheck.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tracying_tpu.core.sampling import uniform_in_unit_sphere as sphere_jax
from ray_tracying_tpu.kernels import wave_ref as wr_jax
from ray_tracying_tpu.kernels import wavefront as wf_jax
from ray_tracying_tpu_torch.kernels import wave_ref as wr
from ray_tracying_tpu_torch.kernels import wavefront as wf

from test_torch_wavefront import (
    BLOCK,
    boot_tensor,
    carried,
    glossy_rays,
    glossy_scenes,
    interpret,
)
from test_wavefront import cam_rays, wave_scene

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
G_RTOL = 2e-4


def jax_record_level(sj, prev, fuzz):
    """One JAX level in record mode, with the operands _trace_wave packs
    (render/integrator.py:323-336)."""
    table, ranges, lights = wf_jax.wave_tables(sj)
    ktex = wf_jax.tex_kernel_supported(sj)
    if ktex:
        tex_m, twh = wf_jax.pack_tex_matrix(sj)
    else:
        tex_m = jnp.zeros((8, 128), jnp.bfloat16)
        twh = jnp.zeros((2, 1), jnp.float32)
    record = 1 + sj.n_lights + (3 if ktex else 0)
    uv_kinds = (sj.has_spheres, sj.has_cubes, sj.has_rects, sj.n_planes > 0)
    with interpret():
        return np.asarray(
            wf_jax.wave_level_call(
                jnp.asarray(prev), jnp.asarray(fuzz), table, lights, tex_m, twh,
                ranges, sj.has_motion, sj.n_lights, sj.has_glossy,
                sj.has_refraction, 0.0, sj.has_textures, uv_kinds,
                tuple(sj.lights.is_area), 1, ktex, record,
            )
        )


def glossy_case():
    sj, st = glossy_scenes()
    o, d, tm = glossy_rays()
    n = o.shape[0]
    boot = boot_tensor(o.numpy(), d.numpy(), tm.numpy(), np.ones(n, np.float32),
                       np.ones(n, np.float32))
    fuzz = np.array(sphere_jax(jax.random.key(9), (BLOCK,)).T)
    return sj, st, torch.from_numpy(boot), torch.from_numpy(fuzz)


def rebuild(tables, prev, fuzz, rec_out):
    best_id, vis, texel = wf.split_record(rec_out, tables.n_lights, tables.has_tex)
    return wr.wave_level_ref(
        prev, fuzz, tables.table, tables.lights, best_id, vis, texel,
        kinds=[k for k, _, _ in tables.ranges], n_lights=tables.n_lights,
        glossy=tables.glossy, motion=tables.motion, refraction=tables.refraction,
    )


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("level", [0, 1])
def test_record_rows_match_jax_kernel(level):
    sj, st, prev, fuzz = glossy_case()
    tables = wf.wave_tables(st)
    L = tables.n_lights
    assert tables.has_tex and tables.glossy and L == 2
    if level == 1:
        prev = wf.wave_level(prev, fuzz, tables, record=True)
        assert prev[7].sum() > 10
    plain = wf.wave_level_plain(prev, fuzz, tables)
    got = wf.wave_level_plain(prev, fuzz, tables, record=True)
    assert got.shape == (13 + 1 + L + 3, BLOCK)
    assert torch.equal(got[:13], plain)
    ref = jax_record_level(sj, prev.numpy(), fuzz.numpy())
    assert ref.shape == got.shape
    got = got.numpy()
    live = prev.numpy()[7] > 0
    hit = live & (got[12] > 0)
    assert 0 < hit.sum() < live.sum()
    same = got[13] == ref[13]
    assert same[live].mean() >= 0.999
    agree = hit & same
    np.testing.assert_array_equal(got[14 + L :, agree], ref[14 + L :, agree])
    # lanes without a hit: id -1, visibility 0, texel 1, in both
    none = ~hit
    assert (got[13, none] == -1).all() and not got[14 : 14 + L, none].any()
    assert (got[14 + L :, none] == 1).all()
    vj, vp = ref[14 : 14 + L], got[14 : 14 + L]
    assert (vj[:, agree] <= vp[:, agree]).all()
    differ = agree & (vj != vp).any(axis=0)
    assert (vp[:, agree] == 1).any() and (vp[:, agree] == 0).any()
    # where the JAX kernel recorded "blocked" and the port "visible", the
    # light's term is zero: the rebuild gives the same radiance either way
    swapped = torch.from_numpy(got.copy())
    swapped[14 : 14 + L, differ] = torch.from_numpy(vj[:, differ])
    a = rebuild(tables, prev, fuzz, torch.from_numpy(got))
    b = rebuild(tables, prev, fuzz, swapped)
    assert torch.equal(a[9:12], b[9:12])


def test_record_mode_untextured_and_dead_lanes():
    """wave_scene (spheres + cube + rect, untextured, glossy): 1 + L record
    rows, rows 0..12 those of record=False, dead lanes record id -1 and
    visibility 0."""
    st = carried(wave_scene(roughness=0.35))
    tables = wf.wave_tables(st)
    o, d, tm = (np.array(x) for x in cam_rays(n=384, seed=4))
    act = (np.random.default_rng(5).random(384) < 0.7).astype(np.float32)
    prev = torch.from_numpy(boot_tensor(o, d, tm, act, np.ones(384, np.float32)))
    fuzz = torch.from_numpy(np.array(sphere_jax(jax.random.key(2), (BLOCK,)).T))
    got = wf.wave_level(prev, fuzz, tables, record=True)
    assert got.shape == (13 + 1 + 2, BLOCK)
    assert torch.equal(got[:13], wf.wave_level(prev, fuzz, tables))
    dead = prev[7] <= 0
    assert (got[13, dead] == -1).all() and not got[14:, dead].any()
    ids = got[13][got[12] > 0]
    assert set(ids.long().tolist()) <= set(range(st.n_geoms)) and len(set(ids.tolist())) > 2


# ---------------------------------------------------------------- (b)
def jax_rebuild(sj, tables, prev, fuzz, rec_out):
    L = tables.n_lights
    kinds = {k for k, _, _ in tables.ranges}
    rows = rec_out.shape[0]

    def recon(p, t, li):
        return wr_jax.wave_level_ref(
            p, jnp.asarray(fuzz), t, li, jnp.asarray(rec_out[13]),
            jnp.asarray(rec_out[14 : 14 + L]),
            jnp.asarray(rec_out[14 + L : 17 + L]) if tables.has_tex else None,
            motion=False, n_lights=L, glossy=tables.glossy, refraction=False,
            min_tp=0.0, ktex=tables.has_tex,
            kinds_present=tuple(k in kinds for k in range(4)), rows=rows, hr=12,
        )

    return recon


@pytest.mark.parametrize("level", [0, 1])
def test_wave_level_ref_matches_jax(level):
    sj, st, prev, fuzz = glossy_case()
    tables = wf.wave_tables(st)
    if level == 1:
        prev = wf.wave_level(prev, fuzz, tables, record=True)
    out = wf.wave_level(prev, fuzz, tables, record=True)
    recon = jax_rebuild(sj, tables, prev, fuzz, out.numpy())
    args = (jnp.asarray(prev.numpy()), jnp.asarray(tables.table.numpy()),
            jnp.asarray(tables.lights.numpy()))
    ref, vjp = jax.vjp(recon, *args)
    xs = [t.clone().requires_grad_(True) for t in (prev, tables.table, tables.lights)]
    got = rebuild(dataclasses_replace(tables, xs[1], xs[2]), xs[0], fuzz, out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref[:13], rtol=RTOL, atol=ATOL)
    # the rebuild gives the kernel's rows on the lanes that entered live
    live = prev[7] > 0
    np.testing.assert_allclose(
        got.detach()[:, live].numpy(), out[:13, live].numpy(), rtol=RTOL, atol=ATOL
    )
    cot = np.random.default_rng(11).normal(size=out.shape).astype(np.float32)
    cot[13:] = 0.0
    g_ref = vjp(jnp.asarray(cot))
    g_got = torch.autograd.grad(got, xs, torch.from_numpy(cot[:13]))
    for name, a, b in zip(("out_prev", "table", "lights"), g_got, g_ref):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all(), name
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(
            a.numpy(), b, rtol=G_RTOL, atol=G_RTOL * np.abs(b).max(), err_msg=name
        )


def dataclasses_replace(tables, table, lights):
    import dataclasses

    return dataclasses.replace(tables, table=table, lights=lights)


# ---------------------------------------------------------------- (c)
def test_wave_level_fn_is_record_level_and_rebuild_backward():
    sj, st, prev, fuzz = glossy_case()
    tables = wf.wave_tables(st, differentiable=True)
    xs = [t.detach().clone().requires_grad_(True) for t in (prev, tables.table, tables.lights)]
    out = wf.WaveLevelFn.apply(xs[0], fuzz, xs[1], xs[2], tables, 0.0)
    assert torch.equal(out.detach(), wf.wave_level(prev, fuzz, tables, record=True))
    cot = torch.from_numpy(
        np.random.default_rng(3).normal(size=out.shape).astype(np.float32)
    )
    got = torch.autograd.grad(out, xs, cot)
    ys = [t.detach().clone().requires_grad_(True) for t in xs]
    ref = torch.autograd.grad(
        rebuild(dataclasses_replace(tables, ys[1], ys[2]), ys[0], fuzz, out.detach()),
        ys, cot[:13],
    )
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # the table's gradient reaches the scene's materials through the packing
    mats = st.materials
    diffuse = mats.diffuse.clone().requires_grad_(True)
    import dataclasses

    st2 = dataclasses.replace(st, materials=dataclasses.replace(mats, diffuse=diffuse))
    t2 = wf.wave_tables(st2, differentiable=True)
    out2 = wf.WaveLevelFn.apply(prev, fuzz, t2.table, t2.lights, t2, 0.0)
    (g,) = torch.autograd.grad(out2[9:12].sum(), [diffuse])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert not wf.wave_tables(st2).table.requires_grad


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_rebuild_builds_nothing_of_size_rays_by_geoms():
    """Forward and backward of the rebuild: no tensor has both a lane
    dimension and a geom dimension (the winner's record is gathered by
    index, not by a one-hot product)."""
    _, st, prev, fuzz = glossy_case()
    tables = wf.wave_tables(st)
    out = wf.wave_level(prev, fuzz, tables, record=True)
    n_cols, g = tables.table.shape
    r = prev.shape[1]
    assert g not in (r, n_cols, 13, 3, 8, 9, 29) and g > 8
    xs = [t.clone().requires_grad_(True) for t in (prev, tables.table, tables.lights)]
    with _Shapes() as rec:
        got = rebuild(dataclasses_replace(tables, xs[1], xs[2]), xs[0], fuzz, out)
        torch.autograd.grad(got.sum(), xs)
    assert rec.shapes
    assert not [s for s in rec.shapes if r in s and g in s]


# ---------------------------------------------------------------- (d)
@pytest.mark.parametrize("r,g,c", [(1000, 7, 3), (4099, 141, 29)])
def test_segment_sum_equals_index_add(r, g, c):
    """The gather's backward (core/segment.py): the same sums as an
    index_add_, every column hit or not, to f32 rounding."""
    from ray_tracying_tpu_torch.core.segment import segment_sum

    gen = torch.Generator().manual_seed(r)
    vals = torch.randn((c, r), generator=gen)
    idx = torch.randint(0, g, (r,), generator=gen)
    idx[idx == 2] = 3  # a column with no lane
    ref = torch.zeros((c, g), dtype=torch.float64).index_add_(1, idx, vals.double())
    got = segment_sum(vals, idx, g)
    assert got.dtype == torch.float32 and not got[:, 2].any()
    np.testing.assert_allclose(got.numpy(), ref.float().numpy(), rtol=1e-6, atol=1e-6)


def test_gather_columns_gradcheck():
    from ray_tracying_tpu_torch.core.segment import gather_columns

    gen = torch.Generator().manual_seed(0)
    table = torch.randn((4, 6), generator=gen, dtype=torch.float64, requires_grad=True)
    idx = torch.randint(0, 6, (40,), generator=gen)
    assert torch.equal(gather_columns(table, idx), table.index_select(1, idx))
    assert torch.autograd.gradcheck(lambda t: gather_columns(t, idx), (table,))


# ---------------------------------------------------------------- (e)
# The rebuild of the level's specialisations: one-way refraction and a
# legacy plane (det_basic), moving spheres (motion), an area light's
# recorded fraction (softshadow, 4 samples), planes + glass + mirror +
# area light (cornell); level 1 fed by the port's level 0 where rays spawn.
FEATURE_CASES = [("det_basic", 0), ("det_basic", 1), ("motion", 0), ("softshadow", 0),
                 ("cornell", 0), ("cornell", 1)]


def jax_feature_scene(name):
    import os

    import ray_tracying_tpu as rt_jax
    from ray_tracying_tpu.models import zoo as zoo_jax

    from test_torch_wave_features import REPO, TEX

    if name == "cornell":
        return zoo_jax.cornell(res=(48, 48))
    return rt_jax.load_scene(os.path.join(REPO, "scenes", f"{name}.json"), textures_dir=TEX)


@pytest.mark.parametrize("name,level", FEATURE_CASES)
def test_wave_level_ref_matches_jax_on_features(name, level):
    """wave_level_ref against the JAX rebuild on the port's record-mode
    level: rows 0..12 at RTOL/ATOL except on lanes whose spawn the two
    frameworks' roundings (XLA contracts a*b+c here) move by a few 1e-5
    (at most 3 % of the live lanes, within 1e-3); the VJP with respect to
    (out_prev, table, lights) at G_RTOL.  WaveLevelFn's backward is the
    autograd of that rebuild, with the scene's motion and refraction."""
    from test_torch_wave_features import feature_case, jax_fuzz_rows, level_inputs

    st, o, d, tm, nss = feature_case(name)
    sj = jax_feature_scene(name)
    tables = wf.wave_tables(st, light_samples=nss)
    rows = jax_fuzz_rows(sj, nss, jax.random.key(9))
    fuzz = None if rows is None else torch.from_numpy(rows)
    prev = torch.from_numpy(level_inputs(st, o, d, tm))
    if level == 1:
        prev = wf.wave_level(prev, fuzz, tables, record=True)
        assert prev[7].sum() > 5
    out = wf.wave_level(prev, fuzz, tables, record=True)
    if st.has_refraction:
        # The JAX rebuild's VJP is NaN on a lane without a hit in a scene
        # that refracts (its all-zero record has index 0: eta = 1e20, an
        # inf, whose zero cotangent is a NaN); the port's rebuild gives
        # such lanes index 1.  Both are held to each other on the hit lanes.
        hit = out[12] > 0
        prev, out = prev[:, hit].contiguous(), out[:, hit].contiguous()
        fuzz = None if fuzz is None else fuzz[:, hit].contiguous()
        rows = None if rows is None else rows[:, hit.numpy()]
        assert out.shape[1] > 3
    L = tables.n_lights
    kinds = {k for k, _, _ in tables.ranges}

    def recon(p, t, li):
        return wr_jax.wave_level_ref(
            p, jnp.asarray(rows if rows is not None else np.zeros((1, out.shape[1]), np.float32)),
            t, li, jnp.asarray(out[13].numpy()), jnp.asarray(out[14 : 14 + L].numpy()), None,
            motion=st.has_motion, n_lights=L, glossy=tables.glossy,
            refraction=st.has_refraction, min_tp=0.0, ktex=False,
            kinds_present=tuple(k in kinds for k in range(4)), rows=out.shape[0], hr=12,
        )

    args = (jnp.asarray(prev.numpy()), jnp.asarray(tables.table.numpy()),
            jnp.asarray(tables.lights.numpy()))
    ref, vjp = jax.vjp(recon, *args)
    ref = np.asarray(ref)[:13]
    xs = [t.clone().requires_grad_(True) for t in (prev, tables.table, tables.lights)]
    got = rebuild(dataclasses_replace(tables, xs[1], xs[2]), xs[0], fuzz, out)
    live = (prev[7] > 0).numpy()
    g = got.detach().numpy()
    # the rebuild gives the kernel's rows on the lanes that entered live
    np.testing.assert_allclose(g[:, live], out[:13, live].numpy(), rtol=RTOL, atol=ATOL)
    off = live & ~np.isclose(g, ref, rtol=RTOL, atol=ATOL).all(axis=0)
    assert off.sum() <= 0.03 * live.sum(), (int(off.sum()), int(live.sum()))
    np.testing.assert_allclose(g[:, live], ref[:, live], rtol=1e-3, atol=1e-3)
    cot = np.random.default_rng(11).normal(size=out.shape).astype(np.float32)
    cot[13:] = 0.0
    g_ref = vjp(jnp.asarray(cot))
    g_got = torch.autograd.grad(got, xs, torch.from_numpy(cot[:13]))
    for what, a, b in zip(("out_prev", "table", "lights"), g_got, g_ref):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all(), what
        assert np.abs(b).max() > 0, what
        np.testing.assert_allclose(
            a.numpy(), b, rtol=G_RTOL, atol=G_RTOL * np.abs(b).max(), err_msg=what
        )
    # WaveLevelFn: forward the record level, backward the rebuild's autograd
    ys = [t.detach().clone().requires_grad_(True) for t in (prev, tables.table, tables.lights)]
    fn_out = wf.WaveLevelFn.apply(ys[0], fuzz, ys[1], ys[2], tables, 0.0)
    assert torch.equal(fn_out.detach(), out)
    g_fn = torch.autograd.grad(fn_out, ys, torch.from_numpy(cot))
    for a, b in zip(g_fn, g_got):
        assert torch.equal(a, b)
