"""Faults planted under the timed path, for the checks that `correct`
catches them (tests/test_faults.py on the CPU, calibrate.py --fault on the
card).  Each takes pytest's `monkeypatch` or anything with its `setattr`.
The benchmark's own runs never load this module.

Frames: half of each pixel's samples left out, the mean taken over the
rest; the first frame returned again for every later one; a quarter of a
frame's rows altered where the bytes are made.  Fit steps: a step that
leaves its parameters unchanged; half of the image left out of the loss,
the mean taken over the rest; the loss altered where it is made."""

from __future__ import annotations

import torch


def half_samples(mp):
    import ray_tracying_tpu_torch.render.pipeline as PL

    def tile(scene, y0, rows, width, opts, generator, tables=None, differentiable=False):
        spp = opts.samples_sqrt ** 2
        o, d, times = PL.tile_rays(scene.camera, y0, rows, width, opts.samples_sqrt, generator=generator)
        colors, aux = PL.trace_wavefront(scene, o, d, times, opts.light_samples, opts.queue_mult,
                                         generator=generator, use_bvh=opts.use_bvh,
                                         return_dropped=True, device=scene.device, tables=tables)
        return colors.reshape(rows, width, spp, 3)[:, :, : spp // 2].mean(dim=2), aux

    mp.setattr(PL, "_render_tile", tile)


def frame_again(mp):
    import ray_tracying_tpu_torch as rt

    first = {}
    real = rt.render_to_srgb_u8

    def again(*a, **k):
        img = real(*a, **k)
        return first.setdefault("img", img)

    mp.setattr(rt, "render_to_srgb_u8", again)


def bytes_altered(mp):
    import ray_tracying_tpu_torch.render.pipeline as PL

    real = PL.linear_to_srgb_u8

    def altered(linear):
        out = real(linear)
        out[::4] = 255 - out[::4]
        return out

    mp.setattr(PL, "linear_to_srgb_u8", altered)


def unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_image(mp):
    import ray_tracying_tpu_torch.diff.optimize as O
    from ray_tracying_tpu_torch.diff.render import render_linear

    def half(scene, target, seed=0, opts=None, device=None):
        img = render_linear(scene, seed, opts, device)
        h = img.shape[0] // 2
        return torch.mean((img[:h] - target.to(img.device)[:h]) ** 2)

    mp.setattr(O, "mse_loss", half)


def loss_altered(mp):
    import ray_tracying_tpu_torch.diff.optimize as O

    real = O.mse_loss
    mp.setattr(O, "mse_loss", lambda *a, **k: real(*a, **k) * 1.5)


FRAMES = (half_samples, frame_again, bytes_altered)
FIT = (unchanged, half_image, loss_altered)


class Patches:
    """setattr that remembers, for use outside pytest."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []
