"""The port's render pipeline on the CPU: the bvh_det frame against the
reference renderer's golden and against the JAX package's image, the
deterministic goldens of the scenes that take the general path, every
committed scene through the pipeline's own routing, the output encoding
against JAX, and guards on what the port may import."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tracying_tpu as rt_jax
import ray_tracying_tpu_torch as rt
from ray_tracying_tpu.render.pipeline import linear_to_srgb_u8 as to_u8_jax
from ray_tracying_tpu_torch.render.pipeline import linear_to_srgb_u8

# Small tensors: one thread each is fastest and keeps parallel test
# workers from oversubscribing the host.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
GOLD = os.path.join(REPO, "golden", "Output")


@pytest.fixture(scope="module")
def bvh_det_image():
    """bvh_det, 320x180 at 1 spp, through the port's render_to_srgb_u8 on
    the CPU, in two tiles (the tile loop and the ragged last tile)."""
    scene = rt.load_scene(
        os.path.join(REPO, "scenes", "bvh_det.json"), textures_dir=TEX,
        device="cpu",
    )
    opts = rt.RenderOptions(samples_sqrt=1, max_rays_per_pass=320 * 100)
    return rt.render_to_srgb_u8(scene, opts, device="cpu")


def test_bvh_det_matches_golden(bvh_det_image):
    """The deterministic contract of tests/test_parity_golden.py: max
    diff <= 1 uint8 step (float reassociation only), < 1 % of values off."""
    gold = rt.read_ppm(os.path.join(GOLD, "bvh_det_s1.ppm"))
    assert bvh_det_image.shape == gold.shape == (180, 320, 3)
    assert bvh_det_image.dtype == np.uint8
    diff = np.abs(bvh_det_image.astype(int) - gold.astype(int))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, "too many off-by-one pixels"


def test_bvh_det_matches_jax_image(bvh_det_image):
    """Against the JAX package's own render of the same scene, under the
    same contract (two float pipelines, one quantization step apart at
    most)."""
    sj = rt_jax.load_scene(
        os.path.join(REPO, "scenes", "bvh_det.json"), textures_dir=TEX
    )
    ref = rt_jax.render_to_srgb_u8(
        sj, rt_jax.RenderOptions(samples_sqrt=1), key=jax.random.key(0)
    )
    diff = np.abs(bvh_det_image.astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("name", ["det_basic", "det_mirrors", "det_twoway", "texture"])
def test_deterministic_goldens_through_the_routing(name):
    """1 spp against the reference renderer's golden under the
    deterministic contract (max diff <= 1 uint8 step, < 1 % of values
    off).  det_mirrors, det_basic (a plane, glass) and texture (a textured
    sphere) take the fused level; det_twoway (mirror + glass on one
    material) takes the general path."""
    scene = rt.load_scene(
        os.path.join(REPO, "scenes", f"{name}.json"), textures_dir=TEX, device="cpu"
    )
    img = rt.render_to_srgb_u8(scene, rt.RenderOptions(samples_sqrt=1), device="cpu")
    gold = rt.read_ppm(os.path.join(GOLD, f"{name}_s1.ppm"))
    assert img.shape == gold.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(int) - gold.astype(int))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, "too many off-by-one pixels"


@pytest.mark.parametrize("name,path", [
    ("det_basic", "fused"), ("det_mirrors", "fused"), ("det_twoway", "general"),
    ("dof", "fused"), ("glossy", "fused"), ("motion", "fused"),
    ("softshadow", "fused"), ("texture", "fused"),
    ("bvh_det", "fused"), ("bvh_glossy", "fused"), ("flagship", "fused"),
])
def test_every_committed_scene_renders(name, path):
    """All ten scenes/*.json and the flagship through render_to_srgb_u8 on
    the CPU, by the path the routing picks (frames cut to 48 pixels wide:
    this is about routing, not the image)."""
    from ray_tracying_tpu_torch.kernels.wavefront import wave_refusal

    file = (
        os.path.join(REPO, "golden", "ASCII", "scene.json") if name == "flagship"
        else os.path.join(REPO, "scenes", f"{name}.json")
    )
    scene = rt.load_scene(file, textures_dir=TEX, device="cpu")
    w, h = scene.camera.resolution
    small = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, resolution=(48, 48 * h // w))
    )
    assert (wave_refusal(small, light_samples=2) is None) == (path == "fused")
    img, stats = rt.render_image(
        small, rt.RenderOptions(samples_sqrt=2, light_samples=2, stats=True),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    assert img.shape == (48 * h // w, 48, 3)
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() > img.min()
    assert stats["total_dropped"] == 0
    assert stats["levels"][0]["live"] == img.shape[0] * 48 * 4


def test_render_image_and_stats_on_a_small_frame():
    """render_image returns linear f32 whose quantization is
    render_to_srgb_u8's image; stats mode sums the per-level counters over
    tiles and drops nothing."""
    scene = rt.load_scene(
        os.path.join(REPO, "scenes", "det_mirrors.json"), textures_dir=TEX,
        device="cpu",
    )
    cam = scene.camera

    small = dataclasses.replace(
        scene, camera=dataclasses.replace(cam, resolution=(32, 18))
    )
    opts = rt.RenderOptions(samples_sqrt=1, max_rays_per_pass=32 * 10, stats=True)
    lin, stats = rt.render_image(small, opts, device="cpu")
    assert lin.shape == (18, 32, 3) and lin.dtype == np.float32
    assert np.isfinite(lin).all() and lin.min() >= 0
    u8 = rt.render_to_srgb_u8(
        small, rt.RenderOptions(samples_sqrt=1, max_rays_per_pass=32 * 10),
        device="cpu",
    )
    np.testing.assert_array_equal(
        u8, linear_to_srgb_u8(torch.from_numpy(lin)).numpy()
    )
    levels = stats["levels"]
    assert len(levels) == 11 and levels[0]["live"] == 32 * 18
    assert stats["total_dropped"] == 0
    assert levels[1]["live"] > 0
    for a, b in zip(levels, levels[1:]):
        assert b["live"] == a["spawned"] <= a["hits"]


def test_linear_to_srgb_u8_matches_jax():
    """Seeded values including negatives, values > 1 and exact 0 and 1.
    Both sides compute pow(max(x, 0), 1/1.1) in f32 and truncate
    clamp01 * 255.999; the two pow implementations may differ in the last
    bit, which can move a value sitting on a quantization boundary by one
    step: at most 1 apart, fewer than 1 in 10,000 values."""
    rng = np.random.default_rng(0)
    x = np.concatenate(
        [
            rng.uniform(-0.5, 1.5, 200_000),
            rng.uniform(0.0, 0.02, 20_000),
            [0.0, 1.0, -1.0, 2.0, 1e-30, 0.999999],
        ]
    ).astype(np.float32)
    ref = np.asarray(to_u8_jax(jnp.asarray(x)))
    got = linear_to_srgb_u8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-4
    assert got[x <= 0].max() == 0 and got[x >= 1].min() == 255


def _port_files():
    files = sorted(
        glob.glob(os.path.join(REPO, "ray_tracying_tpu_torch", "**", "*.py"), recursive=True)
    )
    assert len(files) > 20
    return files + [os.path.join(REPO, "chip_smoke.py")]


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Walks every module of the port and chip_smoke.py: no import of
    jax, flax or ray_tracying_tpu (the _torch package is its own)."""
    for path in _port_files():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "ray_tracying_tpu"), (
                f"{os.path.relpath(path, REPO)} imports {mod}"
            )


def test_port_imports_without_triton_jax_or_cuda():
    """A fresh interpreter in which triton, jax and flax cannot be
    imported still imports the whole package, every module of it, and
    builds nothing at import."""
    mods = [
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files()[:-1]
    ]
    code = (
        "import sys\n"
        "for m in ('triton', 'jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch, os\n"
        "import ray_tracying_tpu_torch as rt\n"
        "from ray_tracying_tpu_torch.kernels import _build\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert _build._lib is None and not _build.last_build\n"
        "assert 'jax' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print('ok', len(rt.__all__))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 16"


def test_public_names_match_the_jax_package():
    assert sorted(rt.__all__) == sorted(rt_jax.__all__)
    for name in rt.__all__:
        assert hasattr(rt, name)


def test_build_needs_nvcc_and_says_so(monkeypatch):
    """Without nvcc the build step raises with a message; it never hands
    back a library it did not build."""
    from ray_tracying_tpu_torch.kernels import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    real_exists = os.path.exists
    monkeypatch.setattr(
        _build.os.path, "exists",
        lambda p: False if str(p).endswith("nvcc") else real_exists(p),
    )
    monkeypatch.setattr(_build, "BUILD_DIR", os.path.join(REPO, "no_such_dir"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert not os.path.exists(os.path.join(REPO, "no_such_dir"))


# ---------------------------------------------------------------------------
# The acceleration path through the pipeline
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch, names):
    """Count the calls render/intersect.py makes to each named kernel
    entry, leaving them in place."""
    from ray_tracying_tpu_torch.render import intersect as I

    seen = {n: 0 for n in names}
    for n in names:
        real = getattr(I, n)

        def counted(*a, _n=n, _f=real, **k):
            seen[_n] += 1
            return _f(*a, **k)

        monkeypatch.setattr(I, n, counted)
    return seen


ACCEL_ENTRIES = (
    "closest_hit_tid", "closest_hit_tid_n", "occluded_tid", "closest_hit_tid_bvh",
    "closest_hit_tid_n_bvh", "closest_hit_tid_chunks", "closest_hit_tid_n_chunks",
    "occluded_tid_chunks",
)


@pytest.mark.parametrize("name,kwargs", [
    ("cube_city", {"n": 24}), ("sphere_field", {"n": 40}),
])
def test_accelerated_renders_are_byte_equal_and_match_jax(monkeypatch, name, kwargs):
    """A small zoo scene at 1 spp on the CPU, down the general path (the
    fused gate's geom cap set below the scene): brute kernels, then
    use_bvh (the traversal for closest hits, the brute any-hit for shadow
    rays), then with the cap set below the scene (chunk kernels for
    everything).  The three images are byte-equal, the reference's contract
    for -bvh, and within the deterministic contract of the JAX package's
    render of the same scene."""
    from ray_tracying_tpu import models as models_jax
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.accel import lbvh
    from ray_tracying_tpu_torch.kernels import closest_hit as ch
    from ray_tracying_tpu_torch.kernels import wavefront as wf
    from ray_tracying_tpu_torch.render import pipeline

    scene = models.get(name, res=(64, 36), device="cpu", **kwargs)
    monkeypatch.setattr(wf, "WAVE_MAX_GEOMS", 8)
    assert "shaded table" in wf.wave_refusal(scene)
    seen = _count_calls(monkeypatch, ACCEL_ENTRIES)
    opts = rt.RenderOptions(samples_sqrt=1)

    brute = rt.render_to_srgb_u8(scene, opts, device="cpu")
    assert seen["closest_hit_tid_n"] == 11 and seen["occluded_tid"] == 22
    assert sum(seen.values()) == 33

    for k in seen:
        seen[k] = 0
    bvh = rt.render_to_srgb_u8(scene, rt.RenderOptions(samples_sqrt=1, use_bvh=True), device="cpu")
    assert seen["closest_hit_tid_n_bvh"] == 11 and seen["occluded_tid"] == 22
    assert sum(seen.values()) == 33

    for k in seen:
        seen[k] = 0
    monkeypatch.setattr(ch, "BRUTE_SMEM_MAX_GEOMS", 8)
    monkeypatch.setattr(lbvh, "CHUNK", 4)
    n_chunks = []
    real_with_chunks = pipeline.with_chunks

    def recording(s):
        out = real_with_chunks(s)
        n_chunks.append(out.chunk_boxes.shape[0])
        return out

    monkeypatch.setattr(pipeline, "with_chunks", recording)
    chunks = rt.render_to_srgb_u8(scene, rt.RenderOptions(samples_sqrt=1, use_bvh=True), device="cpu")
    assert seen["closest_hit_tid_n_chunks"] == 11 and seen["occluded_tid_chunks"] == 22
    assert sum(seen.values()) == 33
    # CHUNK is read when the chunks are built: several chunks of 4, so the
    # cull and the ragged last chunk are on this frame's path
    assert n_chunks == [-(-scene.n_geoms // 4)] and n_chunks[0] > 1

    assert np.array_equal(brute, bvh) and np.array_equal(brute, chunks)
    assert brute.shape == (36, 64, 3) and brute.min() < brute.max()

    sj = models_jax.get(name, res=(64, 36), **kwargs)
    ref = np.asarray(rt_jax.render_to_srgb_u8(
        sj, rt_jax.RenderOptions(samples_sqrt=1), key=jax.random.key(0)))
    diff = np.abs(brute.astype(int) - ref.astype(int))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


def test_oversize_fused_scene_takes_the_general_path(monkeypatch):
    """A fused-eligible scene whose shaded table passes a block's shared
    memory still takes the fused level (its wide build, the same image);
    one over the gate's geom cap (WAVE_MAX_GEOMS, the JAX package's) is
    refused by name and rendered down the general path; forcing the fused
    path then raises."""
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.kernels import wavefront as wf
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    scene = models.get("cube_city", n=24, res=(48, 27), device="cpu")
    assert wf.wave_refusal(scene) is None
    opts = rt.RenderOptions(samples_sqrt=1)
    levels = []
    real = wf.wave_level_plain  # what wave_level runs for a CPU tensor
    monkeypatch.setattr(wf, "wave_level_plain", lambda *a, **k: levels.append(1) or real(*a, **k))
    fused = rt.render_to_srgb_u8(scene, opts, device="cpu")
    assert len(levels) == 11
    with monkeypatch.context() as m:
        small = wf.staged_smem_bytes(scene.n_geoms, 31, scene.n_lights) - 4
        m.setattr(wf, "WAVE_MAX_SMEM_BYTES", small)
        assert wf.package_build(wf.wave_tables(scene)) == "windows"
        assert wf.wave_refusal(scene) is None
        assert np.array_equal(rt.render_to_srgb_u8(scene, opts, device="cpu"), fused)
        assert len(levels) == 22
    monkeypatch.setattr(wf, "WAVE_MAX_GEOMS", scene.n_geoms - 1)
    assert "shaded table of 25 geoms" in wf.wave_refusal(scene)
    seen = _count_calls(monkeypatch, ACCEL_ENTRIES)
    general = rt.render_to_srgb_u8(scene, opts, device="cpu")
    assert seen["closest_hit_tid_n"] == 11 and seen["occluded_tid"] == 22 and len(levels) == 22
    diff = np.abs(fused.astype(int) - general.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    o, d, tm = tile_rays(scene.camera, 0, 2, 48, 1)
    with pytest.raises(NotImplementedError, match="shaded table"):
        trace_wavefront(scene, o, d, tm, fused=True, device="cpu")
