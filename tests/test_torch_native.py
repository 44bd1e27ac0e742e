"""The port's native builders (native/src/*.cpp, g++ at first use) against
their plain versions and the JAX package: the LBVH arrays bit for bit
against the numpy `build_lbvh` and the JAX package's build, the PPM codec
byte for byte against the Python codec; `with_bvh` builds with the native
LBVH; importing the port builds nothing; a failed build raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tracying_tpu.accel import lbvh as lbvh_jax
from ray_tracying_tpu_torch import models, native
from ray_tracying_tpu_torch.accel import lbvh
from ray_tracying_tpu_torch.io import ppm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def random_aabbs(g, seed, grid=None):
    """(g, 6) boxes from a seed; grid: snap the centres to a coarse grid, so
    that many Morton codes tie and the stable order decides."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-50.0, 50.0, (g, 3))
    if grid:
        c = np.round(c / grid) * grid
    h = rng.uniform(0.01, 2.0, (g, 3))
    return np.concatenate([c - h, c + h], axis=1).astype(np.float32)


def assert_bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def assert_same_tree(got, ref):
    for x, y in zip(got, ref):
        assert_bits_equal(x, y)


@pytest.mark.parametrize("g, seed, grid", [(1, 0, None), (4, 1, None), (5, 2, None),
                                           (97, 3, None), (1000, 4, None), (3001, 5, 10.0),
                                           (257, 6, 1e9)])
def test_native_lbvh_equals_numpy_and_jax_on_random_boxes(g, seed, grid):
    """Random boxes (a few, a leaf's worth, thousands; centres snapped to a
    grid so that Morton codes tie; every centre equal): the native build
    equals build_lbvh and the JAX package's numpy build bit for bit."""
    aabbs = random_aabbs(g, seed, grid)
    got = native.lbvh_build(aabbs, lbvh.LEAF_SIZE)
    assert_same_tree(got, lbvh.build_lbvh(aabbs))
    assert_same_tree(got, lbvh_jax.build_lbvh(aabbs))


def test_native_lbvh_of_no_geoms_is_build_lbvhs():
    assert_same_tree(native.lbvh_build(np.zeros((0, 6), np.float32), 4),
                     lbvh.build_lbvh(np.zeros((0, 6), np.float32)))


@pytest.mark.parametrize("name, kw", [("sphere_field", dict(n=3000)),
                                      ("cube_city", dict(n=512))])
def test_with_bvh_builds_the_native_tree_of_zoo_scenes(name, kw, monkeypatch):
    """The zoo's procedural scenes: with_bvh attaches the native tree, which
    equals build_lbvh's and the JAX package's with_bvh arrays bit for bit."""
    from ray_tracying_tpu.models import zoo as zoo_jax

    st = models.get(name, device="cpu", **kw)
    calls = []
    build = native.lbvh_build
    monkeypatch.setattr(native, "lbvh_build", lambda *a: calls.append(1) or build(*a))
    sc = lbvh.with_bvh(st)
    assert calls == [1]
    boxes, topo, order = lbvh.build_lbvh(lbvh.geom_aabbs(st))
    assert_bits_equal(sc.bvh_nodes_box.numpy(), boxes)
    assert_bits_equal(sc.bvh_nodes_topo.numpy(), topo)
    sj = lbvh_jax.with_bvh(getattr(zoo_jax, name)(**kw))
    assert_bits_equal(sc.bvh_nodes_box.numpy(), np.asarray(sj.bvh_nodes_box))
    assert_bits_equal(sc.bvh_nodes_topo.numpy(), np.asarray(sj.bvh_nodes_topo))
    assert_bits_equal(sc.bvh_geoms.numpy(), np.asarray(sj.bvh_geoms))


def ppm_images():
    rng = np.random.default_rng(8)
    yield rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    yield np.zeros((1, 1, 3), np.uint8)
    yield np.full((3, 64, 3), 255, np.uint8)
    yield rng.integers(0, 256, (33, 17, 3), dtype=np.uint8)


def test_ppm_write_then_read_equals_the_python_codec(tmp_path):
    """write_ppm (native) gives the Python codec's bytes, and read_ppm
    (native) reads back what each wrote."""
    for k, img in enumerate(ppm_images()):
        a, b = str(tmp_path / f"n{k}.ppm"), str(tmp_path / f"p{k}.ppm")
        ppm.write_ppm(a, img)
        ppm.write_ppm_plain(b, img)
        assert open(a, "rb").read() == open(b, "rb").read()
        for path in (a, b):
            np.testing.assert_array_equal(ppm.read_ppm(path), img)
            np.testing.assert_array_equal(ppm.read_ppm_plain(path), img)


def test_ppm_reads_goldens_and_textures_like_the_python_codec():
    for rel in ("golden/Output/bvh_det_s1.ppm", "golden/Output/det_basic_s1.ppm"):
        path = os.path.join(REPO, rel)
        assert_bits_equal(ppm.read_ppm(path), ppm.read_ppm_plain(path))
    tex = os.path.join(REPO, "golden", "Textures")
    for name in sorted(os.listdir(tex))[:3]:
        if name.endswith(".ppm"):
            path = os.path.join(tex, name)
            assert_bits_equal(ppm.read_ppm(path), ppm.read_ppm_plain(path))


PPM_ODD_FILES = {
    "comment_and_over_range": b"P3\n# a comment\n2 1\n255\n0 300 7  1 2 # tail\n3\n",
    "negative_and_signed": b"P3\n2 1\n255\n-5 +7 -0  -300 12 +255\n",
    "surplus_values": b"P3\n1 1\n255\n1 2 3 4 5 junk 6.5\n",
    "long_leading_comment": b"# " + b"x" * 9000 + b"\nP3 # magic\n#\n 2\t1\r\n255\x0b1 2 3\x0c4#5\n5 6\n",
    "comment_glued_to_tokens": b"P3#m\n1#w\n1\n255#v\n9#a\n8\n7#b",
    "underscores": b"P3\n1 1\n2_55\n1_0 2_0_0 0_0\n",
    "no_pixels": b"P3\n0 4\n",
    "extreme_int64": b"P3\n1 1\n255\n-9223372036854775808 9223372036854775807 1\n",
}

PPM_BAD_FILES = {
    "p6": (b"P6\n1 1\n255\n\x00\x00\x00", ValueError),
    "magic_not_alone": (b"P34 1 1 255 0 0 0\n", ValueError),
    "truncated": (b"P3\n2 2\n255\n1 2 3\n", ValueError),
    "float_value": (b"P3\n1 1\n255\n1 2.5 3\n", ValueError),
    "letters_in_value": (b"P3\n1 1\n255\n1 2x 3\n", ValueError),
    "bad_underscore": (b"P3\n1 1\n255\n1 2__0 3\n", ValueError),
    "negative_width": (b"P3\n-1 -1\n255\n1 2 3\n", ValueError),
    "past_int64": (b"P3\n1 1\n255\n1 9223372036854775808 3\n", OverflowError),
}


@pytest.mark.parametrize("name", sorted(PPM_ODD_FILES))
def test_ppm_odd_files_read_as_the_python_codec_reads_them(tmp_path, name):
    """Comments anywhere, signs, over-range and surplus values, Python's
    int() grammar: the native reader gives the Python codec's array."""
    path = tmp_path / f"{name}.ppm"
    path.write_bytes(PPM_ODD_FILES[name])
    assert_bits_equal(ppm.read_ppm(str(path)), ppm.read_ppm_plain(str(path)))


@pytest.mark.parametrize("name", sorted(PPM_BAD_FILES))
def test_ppm_bad_files_raise_as_the_python_codec_does(tmp_path, name):
    data, error = PPM_BAD_FILES[name]
    path = tmp_path / f"{name}.ppm"
    path.write_bytes(data)
    with pytest.raises(error):
        ppm.read_ppm_plain(str(path))
    with pytest.raises(error):
        ppm.read_ppm(str(path))


def test_ppm_comments_clamping_and_errors(tmp_path):
    """A comment and an over-range value read as the Python codec reads
    them; a non-P3 file, a truncated one and a missing one raise."""
    path = tmp_path / "c.ppm"
    path.write_bytes(PPM_ODD_FILES["comment_and_over_range"])
    assert_bits_equal(ppm.read_ppm(str(path)), ppm.read_ppm_plain(str(path)))
    (tmp_path / "p6.ppm").write_bytes(PPM_BAD_FILES["p6"][0])
    with pytest.raises(ValueError):
        ppm.read_ppm(str(tmp_path / "p6.ppm"))
    (tmp_path / "short.ppm").write_bytes(PPM_BAD_FILES["truncated"][0])
    with pytest.raises(ValueError):
        ppm.read_ppm(str(tmp_path / "short.ppm"))
    with pytest.raises(FileNotFoundError):
        ppm.read_ppm(str(tmp_path / "missing.ppm"))
    with pytest.raises(TypeError):
        ppm.write_ppm(str(tmp_path / "f.ppm"), np.zeros((2, 2, 3), np.float32))


def test_importing_the_port_builds_nothing():
    """A fresh interpreter imports the package, its native builders and its
    CLI without compiling anything."""
    code = (
        "import ray_tracying_tpu_torch, ray_tracying_tpu_torch.cli\n"
        "from ray_tracying_tpu_torch import native\n"
        "from ray_tracying_tpu_torch.accel import lbvh\n"
        "from ray_tracying_tpu_torch.io import ppm\n"
        "assert native._lib is None and not native.last_build\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: the first use raises with the reason; nothing is
    handed back."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no-such-compiler-here"):
        native.lbvh_build(random_aabbs(8, 0), 4)
    assert native._lib is None and not os.listdir(tmp_path)


def test_a_rebuild_is_keyed_by_the_sources(monkeypatch, tmp_path):
    """The library's name carries the hash of the sources and flags: the
    same sources reuse it, other flags build another."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    a = native.build()
    assert native.last_build["compiled"]
    assert native.build() == a and not native.last_build["compiled"]
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DRTT_KEY_CHECK",))
    assert native.build() != a
