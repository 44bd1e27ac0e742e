"""The frames loop: a closed loop of frames of one scene through the
program's entry `render_to_srgb_u8`, one frame in flight, each timed by the
host clock around the call (which returns the frame's bytes to the host).

Parameters come from the traffic mix's file:
  options      RenderOptions fields laid over the configuration's;
  pan_degrees, pan_period
               the camera pans about the world's vertical axis by
               pan_degrees * sin(2 pi i / pan_period) at frame i, so that
               consecutive frames differ (a frame returned twice is wrong)
               and every seed renders the same views in the same order;
               the window ends on a whole number of pan periods;
  names        {a metric's name here: the name its cells report it under}
               (a mix whose cells keep a bound of their own);
  warmup       frames rendered in set-up (every view the window renders is
               one of pan_period views of one shape);
  trace        {"skip": frames before the traced ones (past the first, the
               untraced pace), "units": frames traced for the device
               metrics} (one more is traced with the host's operations,
               yardstick.profile);
  check        {"frames": frames compared after the window,
                "pixels": pixels compared a frame,
                "copies": reference renders a pixel}.
Frame i draws from a generator seeded by (seed, "frame", i).  The
comparison's limits sit in the configuration's file, under
check.frames.limits."""

from __future__ import annotations

import copy
import dataclasses
import math
import time
import traceback
import warnings

import numpy as np
import torch

from yardstick import compare, manifest, seeds
from yardstick.window import closed_loop


def scene_dict(cfg: dict) -> dict:
    """The configuration's scene.json dict."""
    return copy.deepcopy(cfg["scene"])


def pan_views(data: dict, degrees: float, period: int) -> list:
    """(gaze, up) float32 vectors of each view: the scene camera's,
    turned about the world z axis."""
    cam = data["cameras"][0]
    out = []
    for k in range(period):
        a = math.radians(degrees * math.sin(2.0 * math.pi * k / period))
        rot = np.array([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0], [0, 0, 1.0]])
        out.append(tuple((rot @ np.asarray(cam[key], np.float64)).astype(np.float32)
                         for key in ("gaze_vector", "up_vector")))
    return out


def view_dict(data: dict, view) -> dict:
    """The scene dict seen from one view."""
    d = dict(data)
    cam = dict(data["cameras"][0])
    cam["gaze_vector"], cam["up_vector"] = [float(x) for x in view[0]], [float(x) for x in view[1]]
    d["cameras"] = [cam]
    return d


class Session:
    """One cell's program, set up and warmed; `window` runs the frames."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import ray_tracying_tpu_torch as rt

        t = time.perf_counter()
        self.rt, self.cfg, self.traffic, self.seed = rt, cfg, traffic, seed
        self.device = torch.device(device)
        self.data = scene_dict(cfg)
        self.textures = manifest.config_path(cfg["textures"]) if cfg.get("textures") else None
        base = rt.load_scene_dict(self.data, textures_dir=self.textures, device=self.device)
        self.views = pan_views(self.data, traffic["pan_degrees"], traffic["pan_period"])
        self.scenes = [
            dataclasses.replace(base, camera=dataclasses.replace(
                base.camera, gaze=torch.tensor(g, device=self.device),
                up=torch.tensor(u, device=self.device)))
            for g, u in self.views]
        self.opts = rt.RenderOptions(**{**cfg["options"], **traffic.get("options", {})})
        n = self.opts.samples_sqrt
        self.spp = n * n if n > 1 else 1
        self.width, self.height = base.camera.resolution
        self.rays_per_unit = self.width * self.height * self.spp
        self.facts = dict(n_geoms=base.n_geoms, n_lights=base.n_lights,
                          glossy=base.has_glossy, motion=base.has_motion)
        chk = traffic["check"]
        px, py = compare.sample_pixels(self.width, self.height, chk["pixels"],
                                       np.random.default_rng(seeds.derive(seed, "pixels")))
        self.px, self.py = px, py
        self.kept = {}
        self.phases = {"load": time.perf_counter() - t}
        t = time.perf_counter()
        for i in range(traffic["warmup"]):
            self._frame(i, "warmup")
        self.phases["warmup"] = time.perf_counter() - t

    def _frame(self, i: int, key: str):
        """Frame i -> (bytes at the sampled pixels or None, failure or None)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, key, i))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                img = self.rt.render_to_srgb_u8(self.scenes[i % len(self.scenes)], self.opts, gen,
                                                device=self.device)
            except Exception as e:  # a frame that raises is a failed frame
                return None, f"frame {i} raised {e!r}\n{traceback.format_exc(limit=-3)}"
        dropped = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
        if dropped:
            return None, f"frame {i}: {dropped[0]}"
        return np.ascontiguousarray(img[self.py, self.px]), None

    def window(self, seconds: float, tracer=None) -> dict:
        def unit(i):
            pix, err = self._frame(i, "frame")
            if not err:
                self.kept[i] = pix
            return err

        w = closed_loop(unit, seconds, tracer, period=self.traffic["pan_period"])
        self.traced = w["traced"]
        return w

    def end_to_end(self, w: dict) -> dict:
        from yardstick import stats

        done = w["attempted"] - w["failed"]
        names = self.traffic.get("names", {})
        return {names.get(k, k): v for k, v in (
            ("rays_per_s", stats.rate(done * self.rays_per_unit, w["window_s"])),
            ("frame_p95_ms", stats.percentile(w["times"], 95) * 1e3))}

    def counters(self) -> list:
        """Per traced frame, the levels' live and hit counts, read by
        render_with_stats on the same view and seed (outside the trace)."""
        out = []
        for i in self.traced:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seeds.derive(self.seed, "frame", i))
            _, st = self.rt.render_with_stats(self.scenes[i % len(self.scenes)], self.opts, gen,
                                              device=self.device)
            out.append(st["levels"])
        return out

    def release(self):
        """Free the program's state before the reference runs."""
        self.scenes = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, reference, tf32_program: bool = False) -> list:
        """Compare frames drawn from the seed with the reference ->
        [(name, value, limit)].  tf32_program: the reference's TF32 control
        stands in for the program's bytes (the control reading)."""
        chk = self.traffic["check"]
        limits = self.cfg["check"]["frames"]["limits"]
        done = sorted(self.kept)
        if not done:  # no frame to compare: the largest error a byte can have
            return [("excess_err", 255.0, limits["excess_err"])]
        rng = np.random.default_rng(seeds.derive(self.seed, "check"))
        picks = sorted(rng.choice(done, size=min(chk["frames"], len(done)), replace=False).tolist())
        px = torch.as_tensor(self.px, device=self.device)
        py = torch.as_tensor(self.py, device=self.device)
        worst = -np.inf
        for i in picks:
            data = view_dict(self.data, self.views[i % len(self.views)])
            sc = reference.RefScene(data, self.textures, self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seeds.derive(self.seed, "reference", i))
            copies = reference.render_pixels(sc, px, py, self.opts.samples_sqrt, chk["copies"], gen)
            if tf32_program:
                prog = reference.render_pixels(sc, px, py, self.opts.samples_sqrt, 1, gen, tf32=True)[0]
            else:
                prog = torch.as_tensor(self.kept[i], device=self.device)
            worst = max(worst, compare.excess_error(prog, copies))
        return [("excess_err", worst, limits["excess_err"])]
