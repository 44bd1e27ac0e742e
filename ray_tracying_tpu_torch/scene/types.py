"""Scene representation: frozen struct-of-arrays dataclasses of tensors.

The reference keeps an AoS vector of polymorphic Shapes* with virtual
intersect() (Code/shapes.hpp:59-139).  Here one unified table holds all
*transformed* primitives (sphere/cube/rect share the same object-space
transform machinery, Code/shapes.cpp:92-139), a separate corner table
holds the legacy Plane (Code/shapes.cpp:438-503), and a flat material
table is indexed by primitive id.

Tensor fields live on one device; `Scene.to(device)` moves them all.  The
remaining fields are static Python facts about the scene (kinds present,
whether anything reflects, texture presence) that pick code paths without
a device round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Primitive kind codes for the unified transformed-primitive table.
KIND_SPHERE = 0  # unit sphere, |p|=1         (Code/shapes.cpp:200-262)
KIND_CUBE = 1    # unit cube, [-0.5,0.5]^3    (Code/shapes.cpp:355-423)
KIND_RECT = 2    # unit square on z=0         (Code/shapes.cpp:299-333)


def _moved(obj, device):
    """Copy of a dataclass with every tensor field (nested dataclasses
    included) moved to `device`; static fields pass through."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _moved(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class Materials:
    """Per-primitive material table, length = n_prims + n_planes.

    Matches Material fields (Code/material.hpp:47-77); tex_id is -1 when the
    primitive has no texture (texture atlas lives in Scene.tex_*)."""

    diffuse: torch.Tensor        # (M, 3)
    specular: torch.Tensor       # (M, 3)
    k_ambient: torch.Tensor      # (M,)
    k_diffuse: torch.Tensor      # (M,)
    k_specular: torch.Tensor     # (M,)
    shininess: torch.Tensor      # (M,)
    roughness: torch.Tensor      # (M,)
    reflectivity: torch.Tensor   # (M,)
    transparency: torch.Tensor   # (M,)
    ior: torch.Tensor            # (M,)
    tex_id: torch.Tensor         # (M,) int32, -1 = none


@dataclasses.dataclass(frozen=True)
class Primitives:
    """Unified transformed primitives (spheres, cubes, rectangles)."""

    kind: torch.Tensor      # (P,) int32 in {KIND_SPHERE, KIND_CUBE, KIND_RECT}
    o2w: torch.Tensor       # (P, 3, 4) object->world affine
    w2o: torch.Tensor       # (P, 3, 4) world->object affine (analytic inverse)
    velocity: torch.Tensor  # (P, 3) motion-blur velocity; zero for non-spheres


@dataclasses.dataclass(frozen=True)
class Planes:
    """Legacy explicit-corner quads (Code/shapes.cpp:438-503)."""

    corners: torch.Tensor  # (Q, 4, 3)


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point / spherical-area lights (Code/light.hpp:5-14)."""

    position: torch.Tensor   # (L, 3)
    color: torch.Tensor      # (L, 3)
    intensity: torch.Tensor  # (L,)
    radius: torch.Tensor     # (L,)
    # Static: per-light "is an area light" flags frozen at load time
    # (radius-0 lights get exactly 1 shadow sample, Code/raytracer.cpp:207).
    is_area: Tuple[bool, ...] = ()


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole / thin-lens camera (Code/camera.{hpp,cpp})."""

    location: torch.Tensor      # (3,)
    gaze: torch.Tensor          # (3,)
    up: torch.Tensor            # (3,)
    focal_length: torch.Tensor  # () mm
    aperture: torch.Tensor      # () lens diameter; <=0 degrades to pinhole
    focus_dist: torch.Tensor    # ()
    sensor_wh: torch.Tensor     # (2,) mm
    # Render resolution is static: it shapes every downstream tensor.
    resolution: Tuple[int, int] = (0, 0)


@dataclasses.dataclass(frozen=True)
class Scene:
    camera: Camera
    lights: Lights
    prims: Primitives
    planes: Planes
    materials: Materials
    # Texture atlas: all loaded textures padded to a common (H, W); absent
    # textures fail-soft to the plain diffuse color exactly like the
    # reference (Code/json_loader.cpp:83-86).
    tex_atlas: Optional[torch.Tensor] = None   # (T, H, W, 3) float32 in [0,1]
    tex_wh: Optional[torch.Tensor] = None      # (T, 2) int32 true (w, h)

    # Optional acceleration structures (accel/lbvh.py): the LBVH's flat
    # node arrays with its Morton-ordered geom table, and the Morton-ordered
    # chunk table with one AABB per chunk for scenes whose table does not
    # fit a block's shared memory.  The boxes are exact; `*_graze` is the
    # slack the f32 box test gives each of them (accel/lbvh.py::node_graze,
    # chunk_graze), kept beside them so that no launch recomputes it.
    bvh_nodes_box: Optional[torch.Tensor] = None   # (M, 6) f32 [min | max]
    bvh_nodes_topo: Optional[torch.Tensor] = None  # (M, 4) int32 [left, right, first, count]
    bvh_geoms: Optional[torch.Tensor] = None       # (G, 17) f32, Morton order
    chunk_geoms: Optional[torch.Tensor] = None     # (NC * chunk, 17) f32, Morton order
    chunk_boxes: Optional[torch.Tensor] = None     # (NC, 6) f32
    bvh_nodes_graze: Optional[torch.Tensor] = None  # (M,) f32
    chunk_graze: Optional[torch.Tensor] = None      # (NC,) f32
    # The traversal kernel's packed copy of the tree (accel/lbvh.py::
    # pack_bvh): per inner node both children's boxes, slacks and
    # references; the Morton-ordered table as 64-byte rows.
    bvh_inner: Optional[torch.Tensor] = None        # (inner nodes, 16) f32
    bvh_rows: Optional[torch.Tensor] = None         # (G, 16) f32

    # --- static facts ---
    n_prims: int = 0
    n_planes: int = 0
    n_lights: int = 0
    has_refraction: bool = False
    has_reflection: bool = False
    # True iff SOME single material both reflects AND refracts — the only
    # case with branching factor 2 (Code/raytracer.cpp:308-344 runs both
    # branches for one hit).
    has_two_way: bool = False
    has_glossy: bool = False
    has_motion: bool = False
    has_textures: bool = False
    has_spheres: bool = False
    has_cubes: bool = False
    has_rects: bool = False
    # Static (n_spheres, n_cubes, n_rects): the kernels run one
    # kind-specialized loop per range of a kind-sorted geom table.
    kind_counts: Tuple[int, int, int] = (0, 0, 0)

    @property
    def n_geoms(self) -> int:
        """Total primitive count (transformed prims + planes)."""
        return self.n_prims + self.n_planes

    @property
    def device(self) -> torch.device:
        return self.camera.location.device

    def to(self, device) -> "Scene":
        """The same scene with every tensor on `device`."""
        return _moved(self, device)
