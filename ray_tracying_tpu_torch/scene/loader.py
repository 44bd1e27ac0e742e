"""scene.json -> Scene of tensors.

Accepts the exact schema of the reference loader, including its quirks
(all cited to the reference sources, Code/...):

  - spheres: "scale" array wins over "radius" scalar (Code/json_loader.cpp:194-204)
  - sphere "velocity" divided by 5 on load (Code/json_loader.cpp:221-223)
  - cubes: scale may be an array, a scalar, or missing (-> 1)
    (Code/json_loader.cpp:250-263); translation+rotation required else the
    entry is skipped (:241-244)
  - material defaults differ depending on whether a "material" block exists
    at all (class defaults, Code/material.hpp:52-70) or exists with missing
    keys (loader .value() defaults, Code/json_loader.cpp:45-69)
  - shininess = 5 / clamp(roughness, 0.001, 1)^2 (Code/json_loader.cpp:56-61)
  - texture filename: last 3 chars replaced by "ppm", loaded from the
    textures dir; load failure fails soft to plain diffuse
    (Code/json_loader.cpp:72-88)
  - lights with non-positive intensity skipped (Code/json_loader.cpp:138-141)
  - malformed entries warn-and-skip, never abort (:230-232 etc.)
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.core.transforms import build_trs
from ray_tracying_tpu_torch.io.ppm import read_ppm
from ray_tracying_tpu_torch.scene.types import (
    KIND_CUBE,
    KIND_RECT,
    KIND_SPHERE,
    Camera,
    Lights,
    Materials,
    Planes,
    Primitives,
    Scene,
)


def _t(a) -> torch.Tensor:
    """numpy (host) -> tensor on the CPU; load_scene_dict moves the
    finished scene to its device in one step."""
    return torch.from_numpy(np.array(a))


def _warn(msg: str) -> None:
    print(f"Warning: {msg}", file=sys.stderr)


def _vec3(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float32)
    if a.shape != (3,):
        raise ValueError(f"expected 3-vector, got shape {a.shape}")
    return a


class _MaterialAccum:
    """Columnar material accumulator + texture registry."""

    FIELDS = (
        "diffuse", "specular", "k_ambient", "k_diffuse", "k_specular",
        "shininess", "roughness", "reflectivity", "transparency", "ior",
        "tex_id",
    )

    def __init__(self, textures_dir: Optional[str]):
        self.rows = {f: [] for f in self.FIELDS}
        self.textures_dir = textures_dir
        self._tex_cache: dict[str, int] = {}
        self.tex_images: list[np.ndarray] = []

    def _load_texture(self, filename: str) -> int:
        """Return atlas index or -1.  Mirrors the reference's extension
        rewrite (chop last 3 chars, append 'ppm') and fail-soft."""
        if not filename or self.textures_dir is None:
            return -1
        changed = filename[:-3] + "ppm" if len(filename) >= 3 else filename
        path = os.path.join(self.textures_dir, changed)
        if changed in self._tex_cache:
            return self._tex_cache[changed]
        try:
            img = read_ppm(path)  # (H, W, 3) uint8
        except (OSError, ValueError):
            _warn(f"Failed to load texture file: {path}")
            self._tex_cache[changed] = -1
            return -1
        idx = len(self.tex_images)
        self.tex_images.append(img.astype(np.float32) / 255.0)
        self._tex_cache[changed] = idx
        return idx

    def add(self, mat_json: Optional[dict]) -> None:
        r = self.rows
        if mat_json is None:
            # No "material" block: pure class defaults (Code/material.hpp).
            d = C.MAT_DEFAULTS_NO_BLOCK
            r["diffuse"].append(np.asarray(d["diffuse_color"], np.float32))
            r["specular"].append(np.asarray(d["specular_color"], np.float32))
            r["k_ambient"].append(d["k_ambient"])
            r["k_diffuse"].append(d["k_diffuse"])
            r["k_specular"].append(d["k_specular"])
            r["shininess"].append(d["shininess"])
            r["roughness"].append(d["roughness"])
            r["reflectivity"].append(d["reflectivity"])
            r["transparency"].append(d["transparency"])
            r["ior"].append(d["refractive_index"])
            r["tex_id"].append(-1)
            return
        try:
            dflt = C.MAT_DEFAULTS_IN_BLOCK
            diffuse = _vec3(mat_json.get("diffuse_color", (0.8, 0.8, 0.8)))
            specular = _vec3(mat_json.get("specular_color", (1.0, 1.0, 1.0)))
            rough_for_shin = float(
                mat_json.get("roughness", dflt["roughness_for_shininess"])
            )
            rc = float(
                np.clip(max(C.SHININESS_R_MIN, rough_for_shin),
                        C.SHININESS_R_MIN, C.SHININESS_R_MAX)
            )
            shininess = C.SHININESS_NUM / (rc * rc)
            tex_id = -1
            tf = mat_json.get("texture_file", "")
            if tf:
                tex_id = self._load_texture(str(tf))
            r["diffuse"].append(diffuse)
            r["specular"].append(specular)
            r["k_ambient"].append(float(mat_json.get("k_ambient", dflt["k_ambient"])))
            r["k_diffuse"].append(float(mat_json.get("k_diffuse", dflt["k_diffuse"])))
            r["k_specular"].append(float(mat_json.get("k_specular", dflt["k_specular"])))
            r["shininess"].append(shininess)
            r["roughness"].append(float(mat_json.get("roughness", dflt["roughness"])))
            r["reflectivity"].append(float(mat_json.get("reflectivity", dflt["reflectivity"])))
            r["transparency"].append(float(mat_json.get("transparency", dflt["transparency"])))
            r["ior"].append(float(mat_json.get("refractive_index", dflt["refractive_index"])))
            r["tex_id"].append(tex_id)
        except (TypeError, ValueError, KeyError) as e:
            # Parse error inside the block -> full class-default material
            # (Code/json_loader.cpp:90-94).
            _warn(f"Error parsing material data: {e}")
            # Pop any partial row, then add defaults.
            n = min(len(v) for v in r.values())
            for f in self.FIELDS:
                del r[f][n:]
            self.add(None)


def _parse_camera(data: dict) -> Camera:
    """cameras[0] + render block (Code/camera.cpp:14-58); parse failure
    yields the zeroed default camera (Code/camera.cpp:240-252)."""
    try:
        cam = data["cameras"][0]
        render = data["render"]
        return Camera(
            location=_t(_vec3(cam["location"])),
            gaze=_t(_vec3(cam["gaze_vector"])),
            up=_t(_vec3(cam["up_vector"])),
            focal_length=_t(np.float32(cam["focal_length"])),
            aperture=_t(np.float32(cam.get("aperture", C.CAMERA_APERTURE_DEFAULT))),
            focus_dist=_t(np.float32(cam.get("focus_dist", C.CAMERA_FOCUS_DIST_DEFAULT))),
            sensor_wh=_t(
                np.array([cam["sensor_width"], cam["sensor_height"]], np.float32)
            ),
            resolution=(int(render["resolution_x"]), int(render["resolution_y"])),
        )
    except (KeyError, IndexError, TypeError, ValueError) as e:
        _warn(f"Camera configuration failed to load ({e}). Using default values.")
        z3 = _t(np.zeros(3, np.float32))
        return Camera(
            location=z3, gaze=z3, up=z3,
            focal_length=_t(np.float32(0.0)), aperture=_t(np.float32(0.0)),
            focus_dist=_t(np.float32(0.0)), sensor_wh=_t(np.zeros(2, np.float32)),
            resolution=(0, 0),
        )


def _parse_lights(data: dict) -> Lights:
    pos, col, inten, rad = [], [], [], []
    for lj in data.get("lights", []) or []:
        if not isinstance(lj, dict):
            _warn("Skipping non-object entry in 'lights' array.")
            continue
        try:
            if not all(k in lj for k in ("location", "color", "intensity")):
                _warn("Skipping invalid light definition.")
                continue
            intensity = float(lj["intensity"])
            if intensity <= 0:
                _warn("Skipping light with non-positive intensity.")
                continue
            pos.append(_vec3(lj["location"]))
            col.append(_vec3(lj["color"]))
            inten.append(intensity)
            rad.append(float(lj.get("radius", C.LIGHT_RADIUS_DEFAULT)))
        except (TypeError, ValueError) as e:
            _warn(f"Error parsing light entry: {e}")
    n = len(pos)
    return Lights(
        position=_t(np.array(pos, np.float32).reshape(n, 3)),
        color=_t(np.array(col, np.float32).reshape(n, 3)),
        intensity=_t(np.array(inten, np.float32)),
        radius=_t(np.array(rad, np.float32)),
        is_area=tuple(r > 0.0 for r in rad),
    )


def load_scene_dict(
    data: dict, textures_dir: Optional[str] = None, device=None
) -> Scene:
    """Build a Scene from an already-parsed scene dict.  Parsing is numpy
    on the host; the tensors land on `device` (None = "cuda", which raises
    without a card; pass "cpu" to stay on the host)."""
    mats = _MaterialAccum(textures_dir)

    kinds: list[int] = []
    trs: list[tuple] = []          # (translation, rotation, scale)
    velocities: list[np.ndarray] = []
    plane_corners: list[np.ndarray] = []

    # Load order = material-table order = closest-hit tie-break order; must
    # match the reference: spheres, cubes, rectangles, planes
    # (Code/json_loader.cpp:180,237,282,304).
    for sj in data.get("spheres", []) or []:
        if not isinstance(sj, dict):
            continue
        try:
            translation = _vec3(sj["location"])
            rotation = _vec3(sj.get("rotation", (0.0, 0.0, 0.0)))
            if isinstance(sj.get("scale"), (list, tuple)):
                scale = _vec3(sj["scale"])
            elif "radius" in sj:
                rr = float(sj["radius"])
                scale = np.array([rr, rr, rr], np.float32)
            else:
                scale = np.ones(3, np.float32)
            vel = _vec3(sj.get("velocity", (0.0, 0.0, 0.0))) * np.float32(C.VELOCITY_SCALE)
            kinds.append(KIND_SPHERE)
            trs.append((translation, rotation, scale))
            velocities.append(vel)
            mats.add(sj.get("material"))
        except (TypeError, ValueError, KeyError) as e:
            _warn(f"Error parsing sphere: {e}")

    for cj in data.get("cubes", []) or []:
        if not isinstance(cj, dict):
            continue
        try:
            if "translation" not in cj or "rotation" not in cj:
                _warn("Skipping invalid cube definition.")
                continue
            translation = _vec3(cj["translation"])
            rotation = _vec3(cj["rotation"])
            sc = cj.get("scale", 1.0)
            if isinstance(sc, (list, tuple)):
                scale = _vec3(sc)
            else:
                scale = np.full(3, float(sc), np.float32)
            kinds.append(KIND_CUBE)
            trs.append((translation, rotation, scale))
            velocities.append(np.zeros(3, np.float32))
            mats.add(cj.get("material"))
        except (TypeError, ValueError, KeyError) as e:
            _warn(f"Error parsing cube entry: {e}")

    for rj in data.get("rectangles", []) or []:
        if not isinstance(rj, dict):
            continue
        try:
            translation = _vec3(rj["translation"])
            rotation = _vec3(rj["rotation"])
            scale = _vec3(rj["scale"])
            kinds.append(KIND_RECT)
            trs.append((translation, rotation, scale))
            velocities.append(np.zeros(3, np.float32))
            mats.add(rj.get("material"))
        except (TypeError, ValueError, KeyError) as e:
            _warn(f"Error parsing rectangle: {e}")

    for pj in data.get("planes", []) or []:
        if not isinstance(pj, dict):
            continue
        try:
            corners = pj.get("corners")
            if not isinstance(corners, list) or len(corners) != 4:
                _warn("Skipping invalid plane definition.")
                continue
            plane_corners.append(np.array([_vec3(c) for c in corners], np.float32))
            mats.add(pj.get("material"))
        except (TypeError, ValueError, KeyError) as e:
            _warn(f"Error parsing plane entry: {e}")

    n_prims, n_planes = len(kinds), len(plane_corners)
    if n_prims + n_planes == 0:
        _warn("No valid shapes were loaded.")

    if n_prims:
        t = np.stack([x[0] for x in trs])
        r = np.stack([x[1] for x in trs])
        s = np.stack([x[2] for x in trs])
        o2w, w2o = build_trs(t, r, s)
        vel = np.stack(velocities)
    else:
        o2w = w2o = np.zeros((0, 3, 4), np.float32)
        vel = np.zeros((0, 3), np.float32)

    prims = Primitives(
        kind=_t(np.array(kinds, np.int32)),
        o2w=_t(o2w),
        w2o=_t(w2o),
        velocity=_t(vel),
    )
    planes = Planes(
        corners=_t(
            np.stack(plane_corners) if n_planes else np.zeros((0, 4, 3), np.float32)
        )
    )

    rows = mats.rows
    materials = Materials(
        diffuse=_t(np.array(rows["diffuse"], np.float32).reshape(-1, 3)),
        specular=_t(np.array(rows["specular"], np.float32).reshape(-1, 3)),
        k_ambient=_t(np.array(rows["k_ambient"], np.float32)),
        k_diffuse=_t(np.array(rows["k_diffuse"], np.float32)),
        k_specular=_t(np.array(rows["k_specular"], np.float32)),
        shininess=_t(np.array(rows["shininess"], np.float32)),
        roughness=_t(np.array(rows["roughness"], np.float32)),
        reflectivity=_t(np.array(rows["reflectivity"], np.float32)),
        transparency=_t(np.array(rows["transparency"], np.float32)),
        ior=_t(np.array(rows["ior"], np.float32)),
        tex_id=_t(np.array(rows["tex_id"], np.int32)),
    )

    tex_atlas = tex_wh = None
    has_textures = len(mats.tex_images) > 0
    if has_textures:
        max_h = max(im.shape[0] for im in mats.tex_images)
        max_w = max(im.shape[1] for im in mats.tex_images)
        atlas = np.zeros((len(mats.tex_images), max_h, max_w, 3), np.float32)
        wh = np.zeros((len(mats.tex_images), 2), np.int32)
        for i, im in enumerate(mats.tex_images):
            atlas[i, : im.shape[0], : im.shape[1]] = im
            wh[i] = (im.shape[1], im.shape[0])
        tex_atlas, tex_wh = _t(atlas), _t(wh)

    refl = np.array(rows["reflectivity"], np.float32)
    trans = np.array(rows["transparency"], np.float32)
    rough = np.array(rows["roughness"], np.float32)
    scene = Scene(
        camera=_parse_camera(data),
        lights=_parse_lights(data),
        prims=prims,
        planes=planes,
        materials=materials,
        tex_atlas=tex_atlas,
        tex_wh=tex_wh,
        n_prims=n_prims,
        n_planes=n_planes,
        n_lights=len(_json_lights(data)),
        has_refraction=bool((trans > 0).any()),
        has_reflection=bool((refl > 0).any()),
        has_two_way=bool(((refl > 0) & (trans > 0)).any()),
        has_glossy=bool(((refl > 0) & (rough > 0)).any()),
        has_motion=bool((np.abs(vel) > 0).any()),
        has_textures=has_textures,
        has_spheres=KIND_SPHERE in kinds,
        has_cubes=KIND_CUBE in kinds,
        has_rects=KIND_RECT in kinds,
        kind_counts=(
            kinds.count(KIND_SPHERE),
            kinds.count(KIND_CUBE),
            kinds.count(KIND_RECT),
        ),
    )
    return scene.to(torch.device("cuda" if device is None else device))


def _json_lights(data: dict) -> list:
    """Count lights the way the loader will actually accept them."""
    out = []
    for lj in data.get("lights", []) or []:
        if (
            isinstance(lj, dict)
            and all(k in lj for k in ("location", "color", "intensity"))
        ):
            try:
                if float(lj["intensity"]) > 0:
                    out.append(lj)
            except (TypeError, ValueError):
                pass
    return out


def load_scene(
    path: str, textures_dir: Optional[str] = None, device=None
) -> Scene:
    """Load a scene.json file.

    Unlike the reference — which re-opens and re-parses the same file three
    times for camera, lights, and shapes (Code/raytracer.cpp:401,410-411) —
    we parse once.

    textures_dir defaults to <scene_dir>/../Textures, matching the
    reference's hardcoded relative layout (Code/json_loader.cpp:80).
    device: None = "cuda" (raises without a card); "cpu" stays on the host.
    """
    with open(path) as f:
        data = json.load(f)
    if textures_dir is None:
        textures_dir = os.path.join(os.path.dirname(os.path.abspath(path)), "..", "Textures")
    return load_scene_dict(data, textures_dir=textures_dir, device=device)
