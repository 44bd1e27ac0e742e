"""Scene model zoo: the bundled reference scenes plus procedural
generators for scale benchmarking.

The reference ships exactly one scene (ASCII/scene.json — the 140-cube
BVH stress scene, SURVEY.md §2 row 16) and a set of demo .blend files
whose exports are reproduced as hand-authored JSON in scenes/ (see
tools/make_test_scenes.py).  This module is the programmatic registry for
all of them, plus procedural scenes that scale to thousands of primitives
beyond what the brute-force kernels hold in shared memory.  The
generators draw from the same numpy seeds as the JAX package's, so both
packages build the same scenes.

Every function takes `device`: None = "cuda" (raises without a card);
"cpu" keeps the scene on the host.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np

from ray_tracying_tpu_torch.scene.loader import load_scene, load_scene_dict
from ray_tracying_tpu_torch.scene.types import Scene

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SCENES_DIR = os.path.join(_REPO, "scenes")
_GOLDEN_ASCII = os.path.join(_REPO, "golden", "ASCII")

#: Demo scenes authored in the reference's scene.json schema, one per
#: reference feature demo (.MISSING_LARGE_BLOBS:3-14 lists the originals).
DEMO_SCENES = (
    "det_basic",      # all four primitive kinds, reflection + refraction
    "det_mirrors",    # facing mirrors: exercises the depth-11 recursion cap
    "softshadow",     # spherical area light (radius > 0)
    "dof",            # thin-lens aperture + focus distance
    "motion",         # sphere velocity motion blur
    "glossy",         # reflective + rough floor (glossy fuzz)
    "texture",        # nearest-neighbor texture sampling with v flip
)


def demo(name: str, device=None) -> Scene:
    """Load a named demo scene (see DEMO_SCENES)."""
    if name not in DEMO_SCENES:
        raise KeyError(f"unknown demo scene {name!r}; have {DEMO_SCENES}")
    for base in (_SCENES_DIR, _GOLDEN_ASCII):
        path = os.path.join(base, f"{name}.json")
        if os.path.exists(path):
            return load_scene(
                path, textures_dir=os.path.join(_REPO, "golden", "Textures"),
                device=device,
            )
    raise FileNotFoundError(
        f"{name}.json not found; run tools/make_test_scenes.py"
    )


def bvh_stress(device=None) -> Scene:
    """The reference's bundled 140-cube stress scene (ASCII/scene.json):
    1920x1080, 2 point lights, reflective textured cubes on a floor."""
    return load_scene(os.path.join(_GOLDEN_ASCII, "scene.json"), device=device)


def _base_dict(res=(320, 180), loc=(0.0, -14.0, 6.0)) -> Dict:
    gaze = np.array([0.0, 1.0, -0.35])
    gaze = gaze / np.linalg.norm(gaze)
    up = np.array([0.0, 0.35, 1.0])
    up = up / np.linalg.norm(up)
    return {
        "cameras": [
            {
                "location": list(loc),
                "gaze_vector": gaze.tolist(),
                "up_vector": up.tolist(),
                "focal_length": 24.0,
                "sensor_width": 36.0,
                "sensor_height": 24.0,
            }
        ],
        "render": {"resolution_x": res[0], "resolution_y": res[1]},
        "lights": [
            {"location": [6.0, -8.0, 12.0], "intensity": 2500.0,
             "color": [1.0, 1.0, 1.0], "radius": 0.0},
            {"location": [-8.0, -2.0, 9.0], "intensity": 1500.0,
             "color": [1.0, 0.95, 0.9], "radius": 0.0},
        ],
    }


def sphere_field(
    n: int = 4096,
    seed: int = 0,
    reflective_fraction: float = 0.3,
    res=(320, 180),
    device=None,
) -> Scene:
    """Procedural scale-stress scene: n random spheres above a floor.

    This is the regime the acceleration kernels exist for: a brute-force
    kernel is O(rays * n), a traversal or a chunk cull prunes most of n."""
    rng = np.random.default_rng(seed)
    d = _base_dict(res=res)
    side = max(4.0, math.sqrt(n) * 0.55)
    pos = rng.uniform([-side, 0.0, 0.0], [side, 2.0 * side, side * 0.25], (n, 3))
    radii = rng.uniform(0.12, 0.4, n)
    refl = rng.uniform(0.0, 1.0, n) < reflective_fraction
    colors = rng.uniform(0.15, 0.95, (n, 3))
    d["spheres"] = [
        {
            "location": pos[i].tolist(),
            "radius": float(radii[i]),
            "material": {
                "diffuse_color": colors[i].tolist(),
                "reflectivity": 0.35 if refl[i] else 0.0,
                "roughness": 0.0,
            },
        }
        for i in range(n)
    ]
    d["rectangles"] = [
        {
            "translation": [0.0, side, -0.2],
            "rotation": [0.0, 0.0, 0.0],
            "scale": [6.0 * side, 6.0 * side, 1.0],
            "material": {"diffuse_color": [0.65, 0.65, 0.68]},
        }
    ]
    return load_scene_dict(d, device=device)


def cube_city(
    n: int = 2048,
    seed: int = 0,
    res=(320, 180),
    device=None,
) -> Scene:
    """Procedural grid of rotated boxes ("city blocks") — cube-heavy
    analog of sphere_field for the slab-test kernel path."""
    rng = np.random.default_rng(seed)
    d = _base_dict(res=res)
    cols = int(math.ceil(math.sqrt(n)))
    spacing = 1.6
    cubes: List[Dict] = []
    for i in range(n):
        gx, gy = i % cols, i // cols
        x = (gx - cols / 2) * spacing + rng.uniform(-0.3, 0.3)
        y = gy * spacing + 2.0
        h = float(rng.uniform(0.4, 2.5))
        cubes.append(
            {
                "translation": [x, y, h / 2 - 0.2],
                "rotation": [0.0, 0.0, float(rng.uniform(0, math.pi / 2))],
                "scale": [0.5, 0.5, h / 2],
                "material": {
                    "diffuse_color": rng.uniform(0.2, 0.9, 3).tolist(),
                    "reflectivity": float(rng.uniform(0.0, 1.0) < 0.2) * 0.3,
                },
            }
        )
    d["cubes"] = cubes
    d["rectangles"] = [
        {
            "translation": [0.0, cols * spacing / 2, -0.2],
            "rotation": [0.0, 0.0, 0.0],
            "scale": [8.0 * cols, 8.0 * cols, 1.0],
            "material": {"diffuse_color": [0.6, 0.6, 0.62]},
        }
    ]
    return load_scene_dict(d, device=device)


def cornell(res=(256, 256), device=None) -> Scene:
    """Cornell-style box from legacy planes + a mirror and a glass sphere:
    one scene touching every integrator branch (local, reflect, refract)."""
    d = {
        "cameras": [
            {
                "location": [0.0, -3.6, 1.0],
                "gaze_vector": [0.0, 1.0, 0.0],
                "up_vector": [0.0, 0.0, 1.0],
                "focal_length": 28.0,
                "sensor_width": 36.0,
                "sensor_height": 36.0,
            }
        ],
        "render": {"resolution_x": res[0], "resolution_y": res[1]},
        "lights": [
            {"location": [0.0, 0.0, 1.9], "intensity": 380.0,
             "color": [1.0, 1.0, 1.0], "radius": 0.25},
        ],
        "planes": [
            # floor / ceiling / back / left (red) / right (green)
            {"corners": [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
             "material": {"diffuse_color": [0.75, 0.75, 0.75]}},
            {"corners": [[-1, -1, 2], [-1, 1, 2], [1, 1, 2], [1, -1, 2]],
             "material": {"diffuse_color": [0.75, 0.75, 0.75]}},
            {"corners": [[-1, 1, 0], [1, 1, 0], [1, 1, 2], [-1, 1, 2]],
             "material": {"diffuse_color": [0.75, 0.75, 0.75]}},
            {"corners": [[-1, -1, 0], [-1, 1, 0], [-1, 1, 2], [-1, -1, 2]],
             "material": {"diffuse_color": [0.75, 0.15, 0.15]}},
            {"corners": [[1, -1, 0], [1, -1, 2], [1, 1, 2], [1, 1, 0]],
             "material": {"diffuse_color": [0.15, 0.65, 0.15]}},
        ],
        "spheres": [
            {"location": [-0.45, 0.35, 0.4], "radius": 0.4,
             "material": {"diffuse_color": [0.9, 0.9, 0.9],
                          "reflectivity": 0.85, "roughness": 0.0}},
            {"location": [0.45, -0.2, 0.35], "radius": 0.35,
             "material": {"diffuse_color": [0.95, 0.95, 0.95],
                          "transparency": 0.9, "refractive_index": 1.5}},
        ],
    }
    return load_scene_dict(d, device=device)


REGISTRY = {
    "bvh_stress": bvh_stress,
    "cornell": cornell,
    "sphere_field": sphere_field,
    "cube_city": cube_city,
    **{
        name: (lambda name=name, device=None: demo(name, device))
        for name in DEMO_SCENES
    },
}


def get(name: str, **kwargs) -> Scene:
    """Look up a scene model by name (procedural ones accept kwargs; all
    accept `device`)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown scene model {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
