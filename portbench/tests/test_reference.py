"""The plain reference against the program's CPU path on small crops of
each configuration's scene.  At one centred sample a pixel and without
glossy fuzz a frame draws nothing at random, so the two renders are held
to the reference renderer's deterministic contract (at most one uint8
step apart); the flagship's fuzz is switched off for it.  The statistical
comparison of noisy frames is exercised by test_faults."""

import copy

import numpy as np
import pytest
import torch

from yardstick import manifest

REF = manifest.module("reference", "whitted")
FRAMES = manifest.module("loops", "frames")
BENCH = manifest.benchmark()


def _crop(name, w, h):
    cfg = manifest.config(BENCH, name)
    data = FRAMES.scene_dict(cfg)
    data["render"] = {"resolution_x": w, "resolution_y": h}
    tex = manifest.config_path(cfg["textures"]) if cfg.get("textures") else None
    return data, tex


def _both(data, tex, use_bvh=False):
    import ray_tracying_tpu_torch as rt

    scene = rt.load_scene_dict(copy.deepcopy(data), textures_dir=tex, device="cpu")
    prog = rt.render_to_srgb_u8(scene, rt.RenderOptions(samples_sqrt=1, use_bvh=use_bvh), device="cpu")
    sc = REF.RefScene(data, tex, "cpu")
    w, h = sc.resolution
    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ref = REF.render_pixels(sc, x.reshape(-1), y.reshape(-1), 1, 1, torch.Generator())[0]
    return prog.astype(np.int64), ref.reshape(h, w, 3).numpy().astype(np.int64)


def _deterministic_contract(prog, ref):
    diff = np.abs(prog - ref)
    assert diff.max() <= 1, (diff.max(), np.argwhere(diff > 1)[:5])
    assert (diff > 0).mean() < 0.01


def _flagship_without_fuzz(w, h):
    data, tex = _crop("flagship", w, h)
    for c in data["cubes"] + data["rectangles"]:
        c["material"]["roughness"] = 0.0
    return data, tex


@pytest.mark.parametrize("use_bvh", [False, True], ids=["fused", "general_bvh"])
def test_flagship_crop_without_fuzz(use_bvh):
    """The fused level, and with use_bvh the general path and its BVH."""
    _deterministic_contract(*_both(*_flagship_without_fuzz(48, 27), use_bvh=use_bvh))


def test_reference_refuses_what_it_does_not_render():
    data, tex = _crop("flagship", 8, 6)
    data["lights"][0]["radius"] = 0.5
    with pytest.raises(NotImplementedError):
        REF.RefScene(data, tex, "cpu")


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, 3.0 + 2.0 ** -20])
    assert REF._tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, 3.0]
