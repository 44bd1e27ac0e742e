"""The general path at its live width (render/integrator.py, "Live width"):
every level after the first runs over the lanes that carry a ray.  Each case
traces once with `shrink=()` (every level at full width) and once with the
default schedule, and the two must agree to the bit: radiance `torch.equal`,
TraceStats equal, draws from one generator seed included (in-slot and
compacted queues, glossy fuzz, area-light jitter); a queue whose lanes all
die ends the loop; each level's `rtt.level` span carries the width it ran;
gradients of the differentiable path agree."""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ray_tracying_tpu_torch as rt
from ray_tracying_tpu_torch import models, spans
from ray_tracying_tpu_torch.accel.lbvh import with_bvh
from ray_tracying_tpu_torch.diff import params as P
from ray_tracying_tpu_torch.render import pipeline
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.render.pipeline import tile_rays

from test_scene_loader import minimal_camera

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")


def committed(name):
    return rt.load_scene(os.path.join(REPO, "scenes", f"{name}.json"), textures_dir=TEX,
                         device="cpu")


def flagship(w, h):
    scene = rt.load_scene(os.path.join(REPO, "golden", "ASCII", "scene.json"),
                          textures_dir=TEX, device="cpu")
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, resolution=(w, h)))


def rays(st, rows, seed, samples_sqrt=1):
    w, h = st.camera.resolution
    return tile_rays(st.camera, h // 2 - rows // 2, rows, w, samples_sqrt,
                     generator=torch.Generator().manual_seed(seed))


def both(st, o, d, tm, seed=None, **kw):
    """(full width, live width) traces of the same rays, each with
    TraceStats, each drawing from a generator seeded by `seed` if given,
    which both leave in the same state (a frame's next tile draws on)."""
    out, states = [], []
    for shrink in ((), "auto"):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        out.append(trace_wavefront(st, o, d, tm, generator=gen, fused=False, shrink=shrink,
                                   return_stats=True, device="cpu", **kw))
        states.append(None if gen is None else gen.get_state())
    assert seed is None or torch.equal(*states)
    return out


def assert_same(a, b):
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def levels_run(run, profiled=True):
    """run()'s result and the `lanes` of its `rtt.level` spans, recorded
    under a CPU profiler; profiled=False: with the recorder's flag forced
    on, which records the same spans without the profiler's cost a CPU
    operation."""
    spans.clear()
    with pytest.MonkeyPatch.context() as mp:
        if not profiled:
            mp.setattr(spans, "_recording", lambda: True)
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
            out = run()
    lanes = [r["counts"]["lanes"] for r in spans.records() if r["name"] == "rtt.level"]
    spans.clear()
    return out, lanes


CASES = {
    # in-slot, the LBVH traversal (the reference's -bvh), textured
    "bvh_det_use_bvh": lambda: (with_bvh(committed("bvh_det")), 2, dict(use_bvh=True), None),
    # the compacted two-way queue
    "det_twoway": lambda: (committed("det_twoway"), 4, {}, None),
    # glossy fuzz from one seed, in-slot
    "flagship_glossy": lambda: (flagship(24, 12), 12, {}, 5),
    # area-light jitter (2 samples) and glossy-free one-way glass and mirror
    "cornell_area": lambda: (models.get("cornell", res=(40, 40), device="cpu"), 6,
                             dict(light_samples=2), 7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_live_width_gives_the_full_width_bytes(case):
    """Equal bytes and counters; the live-width trace's rtt.level spans
    carry the queue's width at level 0, then each level's live count, and
    stop where no lane is live."""
    st, rows, kw, seed = CASES[case]()
    o, d, tm = rays(st, rows, seed=3)
    (full, live), lanes = levels_run(lambda: both(st, o, d, tm, seed=seed, **kw), profiled=False)
    assert_same(full, live)
    counts = full[1].live.tolist()
    width = o.shape[0] * (2 if st.has_two_way else 1)
    # The case reaches a level where some lanes are dead and some live.
    assert 0 < counts[1] < width
    assert lanes == [width] * 11 + [width] + [n for n in counts[1:] if n]


def test_frame_of_several_tiles_is_the_same_bytes(monkeypatch):
    """A glossy use_bvh frame in three tiles through the pipeline, its
    draws from one seed: the same bytes at live width as at full width, the
    later tiles' camera and fuzz draws included."""
    st = flagship(16, 12)
    opts = rt.RenderOptions(samples_sqrt=1, use_bvh=True, max_rays_per_pass=16 * 4)
    imgs = []
    for shrink in ((), "auto"):
        monkeypatch.setattr(pipeline, "tile_shrink", lambda n, spp, shrink=shrink: shrink)
        imgs.append(rt.render_to_srgb_u8(st, opts, torch.Generator().manual_seed(12),
                                         device="cpu"))
    assert np.array_equal(*imgs)


def test_two_way_queue_overflows_as_at_full_width():
    """A material that both reflects and refracts, at queue_mult 1: the
    compacted queue overflows, and the drops are those of the full width."""
    d = minimal_camera()
    d["rectangles"] = [
        {"translation": [0, y, 0], "rotation": [1.5707963, 0, 0], "scale": [40, 40, 1],
         "material": {"reflectivity": 0.5, "transparency": 0.5,
                      "refractive_index": 1.0, "roughness": 0.0}}
        for y in (5.0, 7.0)
    ]
    st = rt.load_scene_dict(d, device="cpu")
    dirs = torch.tensor([[0.0, 1.0, 0.0]] * 8)
    full, live = both(st, torch.zeros_like(dirs), dirs, torch.zeros(8), queue_mult=1)
    assert_same(full, live)
    assert int(full[1].dropped.sum()) > 0


def test_forced_compaction_narrows_to_the_prefix():
    """compact='always' on a one-way scene: the compacted discipline, its
    narrowed levels slices of the queue."""
    st = committed("det_mirrors")
    o, d, tm = rays(st, 4, seed=6)
    full, live = both(st, o, d, tm, compact="always")
    assert_same(full, live)


def test_queue_that_dies_ends_the_loop():
    """A perfect mirror facing the background: every ray dies at level 1.
    The live-width trace stops after it (two spans), and the rows of the
    levels it did not run are zero, as at full width."""
    d = minimal_camera()
    d["rectangles"] = [{"translation": [0, 5.0, 0], "rotation": [1.5707963, 0, 0],
                        "scale": [4, 4, 1],
                        "material": {"reflectivity": 1.0, "roughness": 0.0}}]
    st = rt.load_scene_dict(d, device="cpu")
    dirs = torch.tensor([[0.0, 1.0, 0.0], [0.1, 1.0, 0.0], [1.0, 0.0, 0.0]])
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    o, tm = torch.zeros_like(dirs), torch.zeros(3)
    (full, live), lanes = levels_run(lambda: both(st, o, dirs, tm), profiled=False)
    assert_same(full, live)
    assert full[1].live.tolist() == [3, 2] + [0] * 9
    assert lanes == [3] * 11 + [3, 2]
    np.testing.assert_allclose(live[0].numpy(), 0.1, atol=1e-6)


def test_level_spans_carry_the_width_each_level_ran():
    """Under torch.profiler each rtt.level's `lanes` is the level's live
    count on the pipeline's default trace: the whole tile at level 0, then
    exactly its live lanes."""
    st = committed("det_mirrors")
    o, d, tm = rays(st, 4, seed=8)
    out, lanes = levels_run(lambda: trace_wavefront(st, o, d, tm, fused=False, return_stats=True,
                                                    device="cpu"))
    live = out[1].live.tolist()
    ran = [n for n in live if n]
    assert lanes == ran and lanes[0] == o.shape[0] > lanes[1] > 0
    assert all(n == 0 for n in live[len(ran):])


def test_differentiable_general_path_at_live_width():
    """The differentiable general path narrows between its checkpointed
    levels: the radiance is the full width's bit for bit, and the gradients
    agree at rtol 1e-5."""
    st = models.get("cornell", res=(24, 24), device="cpu")
    paths = ["materials.diffuse", "materials.reflectivity", "lights.position", "camera.location"]
    w, h = st.camera.resolution
    weight = torch.rand((4 * w, 3), generator=torch.Generator().manual_seed(9)) + 0.5
    rads, grads = [], []
    for shrink in ((), "auto"):
        theta = P.extract(st, paths)
        sc = P.apply(st, theta)
        o, d, tm = tile_rays(sc.camera, h // 2 - 2, 4, w, 1,
                             generator=torch.Generator().manual_seed(10))
        rad = trace_wavefront(sc, o, d, tm, 2, generator=torch.Generator().manual_seed(11),
                              differentiable=True, fused=False, shrink=shrink, device="cpu")
        rads.append(rad.detach())
        grads.append(torch.autograd.grad((rad * weight).sum(), list(theta.values())))
    assert torch.equal(rads[0], rads[1])
    for k, a, b in zip(paths, *grads):
        assert torch.isfinite(b).all(), k
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(a.abs().max())), err_msg=k)
    assert any(float(g.abs().max()) > 0 for g in grads[0])
