"""Optimizable-parameter plumbing for inverse rendering.

A parameter set is a flat dict mapping dotted paths into the Scene
dataclasses (e.g. "materials.diffuse", "lights.intensity",
"camera.location") to tensors.  `extract` pulls the current values (as
fresh leaves that require grad), `apply` returns a new Scene with them
swapped in through `dataclasses.replace`; the Scene is frozen, so this is
pure.

`theta_from_numpy` and `adam_state_from_numpy` carry a fit across from the
JAX package: its parameter dict and its Adam state, as numpy arrays.

Port of the JAX package's diff/params.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from ray_tracying_tpu_torch.scene.types import Scene

# Paths that make sense to optimize (guards against typos).
SUPPORTED_PREFIXES = ("materials.", "lights.", "camera.", "prims.", "planes.", "tex_atlas")


def extract(scene: Scene, paths: Iterable[str]) -> Dict[str, torch.Tensor]:
    """{path: a copy of the scene's tensor there, a leaf that requires
    grad}."""
    out = {}
    for path in paths:
        node = scene
        for part in path.split("."):
            node = getattr(node, part)
        out[path] = node.detach().clone().requires_grad_(True)
    return out


def apply(scene: Scene, params: Mapping[str, torch.Tensor]) -> Scene:
    """Return a Scene with the given tensors swapped in.

    The integrator's queue discipline is chosen from the scene's static
    routing flags (has_reflection / has_refraction / has_two_way, fixed at
    load time from reflectivity / transparency > 0).  An update must not
    change that classification: optimizing reflectivity above 0 on a
    transparent material would leave the one-continuation-per-ray route in
    place and drop the reflection branch and its gradients.  Every call
    that sets reflectivity or transparency checks it (one host read) and
    raises.  Likewise has_glossy is static: a roughness that starts at 0
    stays non-glossy (keep it above 0 to fit it)."""
    by_top: Dict[str, Dict[str, torch.Tensor]] = {}
    direct: Dict[str, torch.Tensor] = {}
    for path, val in params.items():
        if not path.startswith(SUPPORTED_PREFIXES):
            raise KeyError(f"unsupported parameter path: {path}")
        if "." in path:
            top, rest = path.split(".", 1)
            by_top.setdefault(top, {})[rest] = val
        else:
            direct[path] = val
    updates = dict(direct)
    for top, subs in by_top.items():
        updates[top] = dataclasses.replace(getattr(scene, top), **subs)
    new_scene = dataclasses.replace(scene, **updates)

    mats = by_top.get("materials", {})
    if "reflectivity" in mats or "transparency" in mats:
        refl = new_scene.materials.reflectivity.detach()
        trans = new_scene.materials.transparency.detach()
        flags = tuple(
            bool(x)
            for x in torch.stack(
                [(refl > 0).any(), (trans > 0).any(), ((refl > 0) & (trans > 0)).any()]
            ).tolist()
        )
        old = (scene.has_reflection, scene.has_refraction, scene.has_two_way)
        if flags != old:
            raise ValueError(
                "parameter update changes the scene's static ray-routing "
                f"classification {old} -> {flags} (reflection/refraction/"
                "two-way); reload the scene or keep reflectivity/transparency "
                "on the same side of zero (see diff.params.apply docstring)"
            )
    return new_scene


def theta_from_numpy(theta_np: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (its values turned into numpy
    arrays) as the port's: f32 leaves that require grad, on `device` (None =
    "cuda")."""
    dev = torch.device("cuda" if device is None else device)
    return {
        path: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev).requires_grad_(True)
        for path, v in theta_np.items()
    }


def adam_state_from_numpy(
    mu: Mapping[str, np.ndarray],
    nu: Mapping[str, np.ndarray],
    count: int,
    theta: Mapping[str, torch.Tensor],
    lr: float = 5e-2,
) -> torch.optim.Adam:
    """A torch.optim.Adam over theta's tensors whose state is an optax
    ScaleByAdamState given as numpy arrays (mu and nu keyed like theta,
    count = steps taken), so that a fit carries on where the JAX package
    left it (diff/optimize.fit(theta=..., optimizer=...)).  optax's mu / nu /
    count are torch.optim.Adam's exp_avg / exp_avg_sq / step: both update
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2 and step by
    lr * m_hat / (sqrt(v_hat) + eps), b1 0.9, b2 0.999, eps 1e-8."""
    optimizer = torch.optim.Adam(list(theta.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for path, p in theta.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(np.array(mu[path], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[path], dtype=np.float32)).to(p.device),
        }
    return optimizer
