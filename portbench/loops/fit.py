"""The fit loop: scene parameters fitted to a target image, one Adam step
a call of the program's entry `fit(..., steps=1, theta=, optimizer=)`, each
call carrying the same parameters and optimizer on; each step renders the
whole frame once (record-mode forward, the level's backward).

Parameters come from the traffic mix's file:
  options      RenderOptions of the fit's render (fit's defaults: 1 spp);
  params       the parameter paths fitted;
  lr           Adam's learning rate (b1 0.9, b2 0.999, eps 1e-8);
  target       {path: factor}: the target is the reference's render of the
               configuration's scene with each of these parameters scaled;
  first_steps  steps taken in set-up through the same call, whose losses,
               first gradient and parameter change the check compares;
  trace        {"skip": steps before the traced ones (past the first, the
               untraced pace), "units": steps traced for the device
               metrics} (one more is traced with the host's operations,
               yardstick.profile).
Step k renders with the seed (seed, "step", k).  The limits sit in the
configuration's file, under check.fit.limits."""

from __future__ import annotations

import math
import time
import traceback
import warnings

import torch

from yardstick import manifest, seeds
from yardstick.window import closed_loop
from loops.frames import scene_dict


def _scaled(data: dict, factors: dict) -> dict:
    """The scene dict with material parameters scaled (materials.<key>)."""
    keys = {"materials.diffuse": "diffuse_color"}
    out = dict(data)
    for kind in ("spheres", "cubes", "rectangles"):
        items = []
        for p in data.get(kind, []) or []:
            p = dict(p)
            m = dict(p.get("material") or {})
            for path, f in factors.items():
                k = keys[path]
                m[k] = [x * f for x in m.get(k, (0.8, 0.8, 0.8))]
            p["material"] = m
            items.append(p)
        if items:
            out[kind] = items
    return out


def leaf_gaps(prog: dict, ref: dict, skip=()) -> float:
    """Worst leaf's |norm(program) - norm(reference)| over the larger of
    that leaf's reference norm and the median leaf's."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med, 1e-30)
               for k in ref if k not in skip)


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import ray_tracying_tpu_torch as rt
        from ray_tracying_tpu_torch.diff import params as P

        t = time.perf_counter()
        self.rt, self.cfg, self.traffic, self.seed = rt, cfg, traffic, seed
        self.device = torch.device(device)
        self.data = scene_dict(cfg)
        self.textures = manifest.config_path(cfg["textures"]) if cfg.get("textures") else None
        self.reference = manifest.module("reference", cfg["reference"])
        self.opts = rt.RenderOptions(**traffic["options"])
        n = self.opts.samples_sqrt
        self.spp = n * n if n > 1 else 1
        self.scene = rt.load_scene_dict(self.data, textures_dir=self.textures, device=self.device)
        w, h = self.scene.camera.resolution
        self.rays_per_unit = w * h * self.spp
        self.facts = dict(n_geoms=self.scene.n_geoms, n_lights=self.scene.n_lights,
                          glossy=self.scene.has_glossy, motion=self.scene.has_motion)
        self.phases = {"load": time.perf_counter() - t}
        t = time.perf_counter()
        # the target: the reference's render of the scaled scene.  Its
        # seconds are the reference's ("reference", taken out of setup_s)
        # and its memory peak is not the program's
        ref = self.reference.RefScene(_scaled(self.data, traffic["target"]), self.textures, self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(seed, "target"))
        self.target = self.reference.render_linear(ref, n, gen)
        del ref
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.phases["reference"] = time.perf_counter() - t
        t = time.perf_counter()

        self.paths = traffic["params"]
        self.theta = P.extract(self.scene, self.paths)
        self.optimizer = torch.optim.Adam(list(self.theta.values()), lr=traffic["lr"],
                                          betas=(0.9, 0.999), eps=1e-8)
        self.first = {"theta0": {k: v.detach().clone() for k, v in self.theta.items()}, "loss": []}
        self.failures = []
        for k in range(traffic["first_steps"]):
            loss, err = self._step(k)
            self.first["loss"].append(loss)
            if err:
                self.failures.append(err)
            if k == 0:  # Adam's first moment after one step is 0.1 g
                self.first["grad"] = {
                    p: self.optimizer.state.get(t, {}).get("exp_avg", torch.zeros_like(t)).detach() / 0.1
                    for p, t in self.theta.items()}
        self.first["change"] = {k: v.detach() - self.first["theta0"][k] for k, v in self.theta.items()}
        self.next_step = traffic["first_steps"]
        self.phases["first_steps"] = time.perf_counter() - t

    def _step(self, k: int):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                _, _, hist = self.rt.fit(
                    self.scene, self.target, self.paths, steps=1, learning_rate=self.traffic["lr"],
                    opts=self.opts, seed=seeds.derive(self.seed, "step", k), device=self.device,
                    optimizer=self.optimizer, theta=self.theta)
            except Exception as e:  # a step that raises is a failed step
                return math.nan, f"step {k} raised {e!r}\n{traceback.format_exc(limit=-3)}"
        dropped = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
        if dropped:
            return hist[0], f"step {k}: {dropped[0]}"
        if not math.isfinite(hist[0]):
            return hist[0], f"step {k}: loss {hist[0]}"
        return hist[0], None

    def window(self, seconds: float, tracer=None) -> dict:
        w = closed_loop(lambda i: self._step(self.next_step + i)[1], seconds, tracer)
        w["failures"] = (self.failures + w["failures"])[:5]
        w["failed"] += len(self.failures)
        return w

    def end_to_end(self, w: dict) -> dict:
        from yardstick import stats

        return {"fit_rays_per_s": stats.rate((w["attempted"] - w["failed"]) * self.rays_per_unit,
                                             w["window_s"])}

    def counters(self) -> list:
        return []

    def release(self):
        self.scene = self.theta = self.optimizer = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def reference_steps(self, tf32: bool = False) -> dict:
        """The reference's first steps: losses, first gradient, change."""
        R = self.reference
        sc = R.RefScene(self.data, self.textures, self.device)
        theta = R.leaves(sc, self.paths)
        theta0 = {k: v.detach().clone() for k, v in theta.items()}
        adam = R.Adam(theta, self.traffic["lr"])
        out = {"loss": []}
        for k in range(self.traffic["first_steps"]):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seeds.derive(self.seed, "reference", k))
            out["loss"].append(R.mse_backward(sc, self.target, self.opts.samples_sqrt, gen, tf32))
            if k == 0:
                out["grad"] = {p: t.grad.detach().clone() for p, t in theta.items()}
            adam.step()
        out["change"] = {k: v.detach() - theta0[k] for k, v in theta.items()}
        return out

    def readings(self, prog: dict, ref: dict) -> dict:
        """The numbers compared.  Leaves whose reference gradient is under a
        thousandth of the median leaf's move by round-off alone and are left
        out of the change."""
        g = {k: float(v.norm()) for k, v in ref["grad"].items()}
        med = sorted(g.values())[len(g) // 2]
        still = {k for k, v in g.items() if v < 1e-3 * med}
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
            "grad_gap": leaf_gaps(prog["grad"], ref["grad"]),
            "change_gap": leaf_gaps(prog["change"], ref["change"], skip=still),
        }

    def check(self, reference=None, tf32_program: bool = False) -> list:
        limits = self.cfg["check"]["fit"]["limits"]
        ref = self.reference_steps()
        prog = self.reference_steps(tf32=True) if tf32_program else self.first
        r = self.readings(prog, ref)
        return [(k, r[k], limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")]
