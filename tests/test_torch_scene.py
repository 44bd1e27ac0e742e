"""The port's scene side against the JAX package: loader, scene carried
across, PPM codec, and the kernels' packed tables.  Everything runs on the
CPU; nothing here is approximate, so every comparison is exact."""

import dataclasses
import glob
import os

import numpy as np
import jax
import pytest
import torch

import ray_tracying_tpu as rt_jax
import ray_tracying_tpu_torch as rt
from ray_tracying_tpu.kernels import geom_table as gt_jax
from ray_tracying_tpu.kernels.closest_hit import OCC_CHUNK
from ray_tracying_tpu_torch.kernels import geom_table as gt
from ray_tracying_tpu_torch.kernels.wavefront import pack_tex_u8, wave_tables
from ray_tracying_tpu_torch.scene.convert import scene_from_numpy

# Small tensors: one thread each is fastest and keeps parallel test
# workers from oversubscribing the host.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
SCENES = sorted(glob.glob(os.path.join(REPO, "scenes", "*.json"))) + [
    os.path.join(REPO, "golden", "ASCII", "scene.json")
]
IDS = [os.path.relpath(p, REPO) for p in SCENES]


def both(path):
    return (
        rt_jax.load_scene(path, textures_dir=TEX),
        rt.load_scene(path, textures_dir=TEX, device="cpu"),
    )


def assert_same_scene(sj, st):
    """Field by field, nested dataclasses included: arrays equal bit for
    bit with the same dtype, static facts equal.  The fields the port
    derives beside the acceleration arrays have no counterpart to hold."""
    from ray_tracying_tpu_torch.scene.convert import _PORT_ONLY

    for f in dataclasses.fields(st):
        if f.name in _PORT_ONLY and not hasattr(sj, f.name):
            continue
        a, b = getattr(sj, f.name), getattr(st, f.name)
        if dataclasses.is_dataclass(b):
            assert_same_scene(a, b)
        elif isinstance(b, torch.Tensor):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, f.name
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name


def test_scene_list_is_complete():
    assert len(SCENES) == 11


@pytest.mark.parametrize("path", SCENES, ids=IDS)
def test_load_scene_matches_jax(path):
    sj, st = both(path)
    assert_same_scene(sj, st)
    assert st.n_geoms == sj.n_geoms


@pytest.mark.parametrize("path", SCENES, ids=IDS)
def test_scene_from_numpy_round_trip(path):
    sj, st = both(path)
    carried = scene_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
    assert_same_scene(sj, carried)
    assert_same_scene(st, carried)


def test_scene_from_numpy_takes_a_dict():
    sj, st = both(SCENES[0])
    tree = jax.tree.map(np.asarray, sj)

    def as_dict(obj):
        return {
            f.name: as_dict(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(obj, f.name)
            for f in dataclasses.fields(obj)
        }

    assert_same_scene(st, scene_from_numpy(as_dict(tree), device="cpu"))


def test_scene_to_moves_every_tensor():
    st = rt.load_scene(SCENES[-1], textures_dir=TEX, device="cpu")
    moved = st.to("meta")
    for f in dataclasses.fields(moved.materials):
        assert getattr(moved.materials, f.name).device.type == "meta"
    assert moved.tex_atlas.device.type == "meta"
    assert moved.camera.location.device.type == "meta"
    assert moved.kind_counts == st.kind_counts
    assert st.camera.location.device.type == "cpu"  # the original is untouched


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        rt.load_scene(SCENES[0], textures_dir=TEX)
    st = rt.load_scene(SCENES[0], textures_dir=TEX, device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        rt.render_to_srgb_u8(st, rt.RenderOptions(samples_sqrt=1))
    with pytest.raises((AssertionError, RuntimeError)):
        rt.render_image(st, rt.RenderOptions(samples_sqrt=1))


def test_ppm_bytes_match_jax_codec(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    a, b = tmp_path / "a.ppm", tmp_path / "b.ppm"
    rt_jax.write_ppm(str(a), img)
    rt.write_ppm(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(rt.read_ppm(str(a)), img)
    tex = os.path.join(TEX, "tex2.ppm")
    np.testing.assert_array_equal(rt.read_ppm(tex), rt_jax.read_ppm(tex))
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.ppm"
        bad.write_text("P6\n1 1\n255\n")
        rt.read_ppm(str(bad))


@pytest.mark.parametrize("path", SCENES, ids=IDS)
def test_tables_match_jax(path):
    """Geometry, kind-sorted, shaded and light tables equal the JAX
    package's bit for bit."""
    sj, st = both(path)
    np.testing.assert_array_equal(
        np.asarray(gt_jax.pack_geom_table(sj)), gt.pack_geom_table(st).numpy()
    )
    tj, rj = gt_jax.pack_geom_table_sorted(sj)
    tt, rtt = gt.pack_geom_table_sorted(st)
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    assert rj == rtt
    np.testing.assert_array_equal(
        np.asarray(gt_jax.pack_light_table(sj)), gt.pack_light_table(st).numpy()
    )
    # Shaded table: the JAX package pads every kind segment to a multiple
    # of 8 rows (ids -2) for its TPU loop unroll; the port drops the
    # padding.  Real rows equal bit for bit, in the same order, and the
    # ranges cover the same kinds with the unpadded counts.
    with_tex = sj.has_textures
    tj, rj = gt_jax.pack_geom_table_shaded(sj, chunk=OCC_CHUNK, with_tex=with_tex)
    tj = np.asarray(tj)
    tt, rtt = gt.pack_geom_table_shaded(st, with_tex=with_tex)
    np.testing.assert_array_equal(tj[tj[:, 16] >= 0], tt.numpy())
    assert [k for k, _, _ in rtt] == [k for k, _, _ in rj]
    assert sum(e - s for _, s, e in rtt) == st.n_geoms
    for (_, s, e), (_, sj_, ej) in zip(rtt, rj):
        assert ej - sj_ == -(-(e - s) // OCC_CHUNK) * OCC_CHUNK
    # the level's operand is that table, transposed
    tables = wave_tables(st)
    np.testing.assert_array_equal(tt.numpy().T, tables.table.numpy())
    assert tables.ranges == rtt


def test_unsorted_hand_built_scene_is_recounted():
    """A scene whose kind_counts do not cover its prims (hand-built) still
    packs kind-sorted, with ranges recounted from the kind column."""
    st = rt.load_scene(
        os.path.join(REPO, "scenes", "det_basic.json"), textures_dir=TEX,
        device="cpu",
    )
    loose = dataclasses.replace(st, kind_counts=(0, 0, 0))
    t0, r0 = gt.pack_geom_table_sorted(st)
    t1, r1 = gt.pack_geom_table_sorted(loose)
    assert r0 == r1
    np.testing.assert_array_equal(t0.numpy(), t1.numpy())


def test_texture_packing_is_exact_u8():
    """The texel table holds round(255 * atlas), which for an atlas read
    from 8-bit PPMs is the file's own bytes, and the true sizes."""
    sj, st = both(os.path.join(REPO, "golden", "ASCII", "scene.json"))
    tex, twh = pack_tex_u8(st)
    src = rt.read_ppm(os.path.join(TEX, "tex2.ppm"))
    assert tex.shape == (1, 128, 128, 4) and tex.dtype == torch.uint8
    np.testing.assert_array_equal(tex[0, :, :, :3].numpy(), src)
    np.testing.assert_array_equal(twh.numpy(), [[128.0], [128.0]])
    # the same integers the JAX package packs into its bf16 texture matrix
    from ray_tracying_tpu.kernels.wavefront import pack_tex_matrix

    m, twh_j = pack_tex_matrix(sj)
    m = np.asarray(m.astype(np.float32)).reshape(3, 128, 1, 128)  # c x t y
    np.testing.assert_array_equal(
        m.transpose(2, 3, 1, 0)[0], tex[0, :, :, :3].numpy().astype(np.float32)
    )
    np.testing.assert_array_equal(np.asarray(twh_j), twh.numpy())
