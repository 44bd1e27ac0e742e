"""Batched ray/scene intersection: the replacement for the reference's
per-shape virtual dispatch (Code/shapes.cpp) and BVH recursion
(Code/acceleration.cpp).

Design: two-pass closest hit over SoA primitive tables.

  Pass 1: the winner search.  `closest_hit`, `min_hit_t` and `occluded` run
  it through the kernels of kernels/closest_hit.py, kernels/bvh_traverse.py
  and kernels/chunk_stream.py (a CUDA kernel for tensors on the card, its
  plain version for tensors on the CPU), which never build anything of
  size rays x geoms.  `all_hit_t` is
  the dense (rays x geoms) oracle of the same distances, in load order, for
  small inputs and tests.  Distances use the reference's Euclidean-distance
  semantics (Code/shapes.cpp:251-253 etc.): for affine TRS transforms the
  world hit point is exactly origin + t_loc * dir, so euclidean_t == t_loc
  * |dir|, and all traced rays have unit |dir|.  Legacy planes use the
  parametric t (Code/shapes.cpp:458,481) — faithfully mixed semantics.

  Pass 2 (`closest_hit`): per-ray attribute reconstruction for the winner
  only (point, normal, uv) — O(R) instead of O(R*G).  Per-ray records are
  plain indexed row loads, `table[idx]`.

Three arithmetics for one test are kept apart on purpose: `all_hit_t`
divides twice for the sphere (Code/shapes.cpp:219-232 as written), the
kernels take one reciprocal and two multiplies, and pass 2 recomputes t as
the Euclidean distance of the rebuilt point.  Winner ids agree except on
exact ties between kinds (kind-sorted table against load order).

Which kernel searches (the same routing on the card and on the CPU):

  - a scene of more than `BRUTE_SMEM_MAX_GEOMS` geoms (its table does not
    fit a block's shared memory) that carries chunks
    (accel.lbvh.with_chunks) takes the chunk-culled sweeps, for closest
    hits and for shadow rays alike; without chunks it takes the chunked
    brute kernel;
  - `use_bvh=True` on a scene under the cap that carries a BVH
    (accel.lbvh.with_bvh) takes the traversal kernel for closest hits (the
    reference's `-bvh`); its shadow rays stay with the brute any-hit
    kernel: occlusion needs existence, not the closest hit;
  - everything else takes the brute-force kernels, which mirror `-bvh` off
    (intersect_linear, Code/acceleration.cpp:124-139).

All of them report the same hit set, so the image does not depend on the
route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.core.transforms import (
    apply_normal,
    apply_point,
    apply_vector,
)
from ray_tracying_tpu_torch.core.vecmath import cross, dot, safe_arcsin, safe_sqrt
from ray_tracying_tpu_torch.kernels import closest_hit as _CH
from ray_tracying_tpu_torch.kernels.bvh_traverse import (
    closest_hit_tid_bvh,
    closest_hit_tid_n_bvh,
)
from ray_tracying_tpu_torch.kernels.chunk_stream import (
    closest_hit_tid_chunks,
    closest_hit_tid_n_chunks,
    occluded_tid_chunks,
)
from ray_tracying_tpu_torch.kernels.closest_hit import (
    closest_hit_tid,
    closest_hit_tid_n,
    occluded_tid,
)
from ray_tracying_tpu_torch.scene.types import KIND_CUBE, KIND_SPHERE, Scene

_INF = float("inf")


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays (all fields shape (R, ...))."""

    valid: torch.Tensor    # (R,) bool
    geom_id: torch.Tensor  # (R,) int32 into the global geom/material table
    t: torch.Tensor        # (R,) reference-semantics hit distance
    point: torch.Tensor    # (R, 3) world intersection point
    normal: torch.Tensor   # (R, 3) world unit normal
    uv: torch.Tensor       # (R, 2)


def _is_big(scene: Scene) -> bool:
    """More geoms than the brute kernels hold in shared memory.  The cap is
    read at call time."""
    return scene.n_geoms > _CH.BRUTE_SMEM_MAX_GEOMS


def _closest_tid(scene: Scene, o, d, time, active, use_bvh, sort_rays=False):
    """Pass 1, (t, id): the chunk sweep, the BVH traversal or a brute
    kernel (module docstring)."""
    if _is_big(scene) and scene.chunk_geoms is not None:
        return closest_hit_tid_chunks(scene, o, d, time, active, sort_rays)
    if use_bvh and scene.bvh_geoms is not None and not _is_big(scene):
        return closest_hit_tid_bvh(scene, o, d, time, active, sort_rays)
    return closest_hit_tid(scene, o, d, time, active)


# ---------------------------------------------------------------------------
# Object-space primitive tests (t only).  o, d: (..., 3) object-space ray.
# Each returns t_loc with +inf for miss.
# ---------------------------------------------------------------------------

def _sphere_t(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Unit-sphere quadratic with the 0.001 t-min and near-then-far root
    choice (Code/shapes.cpp:219-232)."""
    a = dot(d, d)
    b = 2.0 * dot(o, d)
    c = dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    sq = safe_sqrt(disc)
    # a == 0 only for degenerate (masked-out) rays; guard the division so
    # NaNs never enter the min reduction.
    a_safe = torch.where(a > 0.0, a, 1.0)
    t1 = (-b - sq) / (2.0 * a_safe)
    t2 = (-b + sq) / (2.0 * a_safe)
    t = torch.where(t1 > C.EPS_T_MIN, t1, torch.where(t2 > C.EPS_T_MIN, t2, _INF))
    return torch.where((disc >= 0.0) & (a > 0.0), t, _INF)


def _cube_slabs(o: torch.Tensor, d: torch.Tensor):
    """Shared slab computation for the unit cube [-0.5, 0.5]^3
    (Code/shapes.cpp:361-392).  Returns (t_near, t_far, entry_t_per_axis,
    entry_sign_per_axis, miss)."""
    parallel = torch.abs(d) < C.EPS_PARALLEL
    outside_parallel = parallel & ((o < -0.5) | (o > 0.5))
    d_safe = torch.where(parallel, 1.0, d)
    t1 = (-0.5 - o) / d_safe
    t2 = (0.5 - o) / d_safe
    t_entry = torch.minimum(t1, t2)
    t_exit = torch.maximum(t1, t2)
    # hit_sign: -1 when the min-plane is entered first (t1 < t2), else +1
    # (Code/shapes.cpp:385).
    entry_sign = torch.where(t1 < t2, -1.0, 1.0)
    # Parallel axes never win the entry max nor tighten the exit min.
    t_entry = torch.where(parallel, -_INF, t_entry)
    t_exit = torch.where(parallel, _INF, t_exit)
    t_near = torch.amax(t_entry, dim=-1)
    t_far = torch.amin(t_exit, dim=-1)
    miss = torch.any(outside_parallel, dim=-1) | (t_near > t_far) | (t_far < 0.0)
    return t_near, t_far, t_entry, entry_sign, miss


def _cube_t(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """NOTE: the cube uses t > 0, NOT the 0.001 epsilon
    (Code/shapes.cpp:392-393)."""
    t_near, t_far, _, _, miss = _cube_slabs(o, d)
    t = torch.where(t_near > 0.0, t_near, t_far)
    return torch.where(miss | (t < 0.0), _INF, t)


def _rect_t(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Unit square on z=0, [-0.5, 0.5]^2 (Code/shapes.cpp:305-315)."""
    dz = d[..., 2]
    parallel = torch.abs(dz) < C.EPS_PARALLEL
    t = -o[..., 2] / torch.where(parallel, 1.0, dz)
    hx = o[..., 0] + t * d[..., 0]
    hy = o[..., 1] + t * d[..., 1]
    ok = (
        ~parallel
        & (t >= C.EPS_T_MIN)  # reference: t < 0.001 -> miss
        & (hx >= -0.5) & (hx <= 0.5) & (hy >= -0.5) & (hy <= 0.5)
    )
    return torch.where(ok, t, _INF)


def _plane_geometry(corners: torch.Tensor):
    """corners: (..., 4, 3) -> (unit_normal, degenerate_mask)."""
    e1 = corners[..., 1, :] - corners[..., 0, :]
    e2 = corners[..., 2, :] - corners[..., 0, :]
    n = cross(e1, e2)
    ln = torch.sqrt(dot(n, n))
    degenerate = ln < C.EPS_PARALLEL
    n = n / torch.where(degenerate, 1.0, ln)[..., None]
    return n, degenerate


def _point_in_tri(p, a, b, c, n):
    """Edge-sign test with the reference's -1e-6 tolerance
    (Code/shapes.cpp:24-40)."""
    s1 = dot(cross(b - a, p - a), n) >= C.EPS_PLANE_EDGE
    s2 = dot(cross(c - b, p - b), n) >= C.EPS_PLANE_EDGE
    s3 = dot(cross(a - c, p - c), n) >= C.EPS_PLANE_EDGE
    return s1 & s2 & s3


def _plane_t(corners: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Legacy quad: parametric t, two-triangle containment
    (Code/shapes.cpp:444-483).  corners broadcast against o/d."""
    n, degenerate = _plane_geometry(corners)
    denom = dot(n, d)
    parallel = torch.abs(denom) < C.EPS_PARALLEL
    t = dot(corners[..., 0, :] - o, n) / torch.where(parallel, 1.0, denom)
    p = o + t[..., None] * d
    c0, c1, c2, c3 = (corners[..., i, :] for i in range(4))
    inside = _point_in_tri(p, c1, c3, c2, n) | _point_in_tri(p, c0, c1, c2, n)
    ok = ~degenerate & ~parallel & (t >= 0.0) & inside
    return torch.where(ok, t, _INF)


# ---------------------------------------------------------------------------
# Pass 1, dense: the (rays x geoms) oracle
# ---------------------------------------------------------------------------

def _prims_object_rays(scene: Scene, o, d, time):
    """Transform rays into every transformed-prim's object space.

    o, d: (R, 3); time: (R,).  Returns o_loc, d_loc: (R, P, 3).
    Motion blur shifts the ray origin by -velocity * time before the
    transform (Code/shapes.cpp:201-215); velocity is zero for non-spheres.
    """
    o_shift = o[:, None, :] - scene.prims.velocity[None, :, :] * time[:, None, None]
    w2o = scene.prims.w2o[None]  # (1, P, 3, 4)
    # Explicit multiply-adds, never matmul (see core/transforms.py).
    o_loc = (
        w2o[..., :, 0] * o_shift[..., 0:1]
        + w2o[..., :, 1] * o_shift[..., 1:2]
        + w2o[..., :, 2] * o_shift[..., 2:3]
        + w2o[..., :, 3]
    )
    dr = d[:, None, :]
    d_loc = (
        w2o[..., :, 0] * dr[..., 0:1]
        + w2o[..., :, 1] * dr[..., 1:2]
        + w2o[..., :, 2] * dr[..., 2:3]
    )
    return o_loc, d_loc


def all_hit_t(scene: Scene, o, d, time) -> torch.Tensor:
    """(R, G) matrix of reference-semantics hit distances, +inf = miss.
    Dense: for small inputs and tests only.

    Geom order is sphere/cube/rect table then planes, matching the
    reference's load order so that argmin tie-breaks agree with
    min_element / intersect_linear first-wins (Code/acceleration.cpp:112,133).
    """
    parts = []
    if scene.n_prims:
        o_loc, d_loc = _prims_object_rays(scene, o, d, time)
        kind = scene.prims.kind[None, :]
        t_s = _sphere_t(o_loc, d_loc)
        t_c = _cube_t(o_loc, d_loc)
        t_r = _rect_t(o_loc, d_loc)
        t_loc = torch.where(
            kind == KIND_SPHERE, t_s, torch.where(kind == KIND_CUBE, t_c, t_r)
        )
        # Euclidean world distance == t_loc * |d| (see module docstring).
        d_norm = torch.sqrt(dot(d, d))[:, None]
        parts.append(t_loc * d_norm)
    if scene.n_planes:
        t_p = _plane_t(
            scene.planes.corners[None, :, :, :], o[:, None, :], d[:, None, :]
        )
        parts.append(t_p)
    if not parts:
        return torch.full((o.shape[0], 0), _INF, dtype=torch.float32, device=o.device)
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# Pass 1 through the kernels
# ---------------------------------------------------------------------------

def min_hit_t(
    scene: Scene, o, d, time, active=None, use_bvh=False, sort_rays=False
) -> torch.Tensor:
    """Closest hit distance per ray, +inf on miss.

    active: optional (R,) bool mask; inactive rays report a miss and cost
    the kernel no test.  use_bvh selects the LBVH traversal kernel (the
    same hit set; needs accel.lbvh.with_bvh).  sort_rays: sort an
    incoherent wavefront for coherence before the accelerated kernels
    (kernels/ray_sort.py); the same results."""
    if scene.n_geoms == 0:
        return torch.full(o.shape[:1], _INF, dtype=torch.float32, device=o.device)
    t, _ = _closest_tid(scene, o, d, time, active, use_bvh, sort_rays)
    return t


def occluded(scene: Scene, o, d, maxt, active=None, use_bvh=False) -> torch.Tensor:
    """(R,) bool: some geom blocks the ray at distance <= maxt.

    The complement of the reference's shadow visibility test
    `shadow_hit.t > light_dist` (Code/raytracer.cpp:233-235) — existence
    of ANY blocker, which lets the kernel leave its loop at each ray's
    first blocker instead of completing the closest-hit min.  Shadow rays
    carry time = 0 (Ray default, Code/shapes.hpp:28).  Under the cap always
    the brute any-hit kernel, even with use_bvh: occlusion needs
    existence, not the closest hit.  Over it, the chunk-culled any-hit
    sweep; a big scene without chunks falls to the closest-hit distance."""
    if scene.n_geoms == 0:
        return torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    if not _is_big(scene):
        return occluded_tid(scene, o, d, maxt, active)
    if scene.chunk_geoms is not None:
        return occluded_tid_chunks(scene, o, d, maxt, active)
    t = min_hit_t(scene, o, d, torch.zeros_like(maxt), active, use_bvh)
    return t <= maxt


# ---------------------------------------------------------------------------
# Pass 2: attribute reconstruction for the winning geom
# ---------------------------------------------------------------------------

_PI = float(np.float32(3.1415926535))


def _prim_attributes(scene: Scene, pid, o, d, time):
    """Reconstruct hit attributes for transformed prims.  pid: (R,) int64
    clipped to the valid range; returns per-field (R, ...) plus the
    recomputed t (callers rely on the pass-1 winner for validity)."""
    w2o = scene.prims.w2o[pid]
    o2w = scene.prims.o2w[pid]
    vel = scene.prims.velocity[pid]
    kind = scene.prims.kind[pid]

    o_shift = o - vel * time[:, None]
    o_loc = apply_point(w2o, o_shift)
    d_loc = apply_vector(w2o, d)

    # --- sphere ---
    t_sph = _sphere_t(o_loc, d_loc)
    t_sph = torch.where(torch.isfinite(t_sph), t_sph, 0.0)  # grad-safe miss
    p_sph = o_loc + t_sph[..., None] * d_loc
    n_sph = p_sph
    u_sph = 0.5 + torch.atan2(p_sph[..., 2], p_sph[..., 0]) / (2.0 * _PI)
    v_sph = 0.5 - safe_arcsin(torch.clamp(p_sph[..., 1], -1.0, 1.0)) / _PI

    # --- cube ---
    t_near, t_far, t_entry, entry_sign, miss = _cube_slabs(o_loc, d_loc)
    t_cub = torch.where(t_near > 0.0, t_near, t_far)
    t_cub = torch.where(miss | (t_cub < 0.0) | ~torch.isfinite(t_cub), 0.0, t_cub)
    p_cub = o_loc + t_cub[..., None] * d_loc
    # Normal comes from the ENTRY face even when the exit t is used
    # (the reference never updates hit_axis for t_far, Code/shapes.cpp:392-402).
    axis = torch.argmax(t_entry, dim=-1)  # first of equal maxima
    sign = torch.where(
        axis == 0,
        entry_sign[..., 0],
        torch.where(axis == 1, entry_sign[..., 1], entry_sign[..., 2]),
    )
    zero = torch.zeros_like(sign)
    n_cub = torch.stack(
        [
            torch.where(axis == 0, sign, zero),
            torch.where(axis == 1, sign, zero),
            torch.where(axis == 2, sign, zero),
        ],
        dim=-1,
    )
    uc = p_cub[..., 0] + 0.5
    vc = p_cub[..., 1] + 0.5
    wc = p_cub[..., 2] + 0.5
    pos = sign > 0.0
    u_cub = torch.where(
        axis == 0, torch.where(pos, wc, 1.0 - wc),
        torch.where(axis == 1, uc, torch.where(pos, uc, 1.0 - uc)),
    )
    v_cub = torch.where(
        axis == 0, vc, torch.where(axis == 1, torch.where(pos, wc, 1.0 - wc), vc)
    )

    # --- rect ---
    t_rec = _rect_t(o_loc, d_loc)
    t_rec = torch.where(torch.isfinite(t_rec), t_rec, 0.0)  # grad-safe miss
    p_rec = o_loc + t_rec[..., None] * d_loc
    p_rec = torch.stack([p_rec[..., 0], p_rec[..., 1], zero], dim=-1)
    n_rec = torch.stack([zero, zero, torch.ones_like(zero)], dim=-1)
    u_rec = p_rec[..., 0] + 0.5
    v_rec = p_rec[..., 1] + 0.5

    is_s = kind == KIND_SPHERE
    is_c = kind == KIND_CUBE
    p_loc = torch.where(is_s[..., None], p_sph, torch.where(is_c[..., None], p_cub, p_rec))
    n_loc = torch.where(is_s[..., None], n_sph, torch.where(is_c[..., None], n_cub, n_rec))
    u = torch.where(is_s, u_sph, torch.where(is_c, u_cub, u_rec))
    v = torch.where(is_s, v_sph, torch.where(is_c, v_cub, v_rec))

    # World point: transformed at time 0 then advected (Code/shapes.cpp:243-248).
    point = apply_point(o2w, p_loc) + vel * time[:, None]
    normal = apply_normal(w2o, n_loc)
    # Reference recomputes t as the Euclidean distance from the true origin
    # (Code/shapes.cpp:251-253).  safe_sqrt: masked slots can have point==o.
    t = safe_sqrt(dot(point - o, point - o))
    return point, normal, u, v, t


def _plane_attributes(scene: Scene, qid, o, d):
    """Legacy plane attribute reconstruction (Code/shapes.cpp:444-482)."""
    corners = scene.planes.corners[qid]  # (R, 4, 3)
    n, _ = _plane_geometry(corners)
    denom = dot(n, d)
    safe = torch.where(torch.abs(denom) < C.EPS_PARALLEL, 1.0, denom)
    t = dot(corners[:, 0, :] - o, n) / safe
    p = o + t[..., None] * d
    vec_u = corners[:, 1, :] - corners[:, 0, :]
    vec_v = corners[:, 3, :] - corners[:, 0, :]
    hv = p - corners[:, 0, :]
    u = torch.clamp(dot(hv, vec_u) / torch.clamp(dot(vec_u, vec_u), min=1e-20), 0.0, 1.0)
    v = torch.clamp(dot(hv, vec_v) / torch.clamp(dot(vec_v, vec_v), min=1e-20), 0.0, 1.0)
    return p, n, u, v, t


def closest_hit(
    scene: Scene, o, d, time, active=None, use_bvh=False, differentiable=True
) -> Hit:
    """Full closest-hit: pass-1 winner search then pass-2 attribute rebuild.

    Pass 1 is a (t, id) kernel (module docstring); pass 2 is plain tensor
    code (gradients can flow to scene parameters with the hit id held
    fixed).

    differentiable=False selects a fused-normal kernel when the scene
    allows it (no textures -> no uv needed; under the cap, or over it with
    chunks): the hit normal is accumulated inside the
    kernel loop, the point is o + t*d (exact for affine TRS prims incl.
    motion advection), and pass 2 is skipped entirely.  Hit attributes
    then carry no gradients — inference only."""
    r = o.shape[0]
    dev = o.device
    if scene.n_geoms == 0:
        f32 = dict(dtype=torch.float32, device=dev)
        return Hit(
            valid=torch.zeros(r, dtype=torch.bool, device=dev),
            geom_id=torch.full((r,), -1, dtype=torch.int32, device=dev),
            t=torch.full((r,), _INF, **f32),
            point=torch.zeros((r, 3), **f32),
            normal=torch.zeros((r, 3), **f32),
            uv=torch.zeros((r, 2), **f32),
        )
    big = _is_big(scene)
    if (
        not differentiable
        and not scene.has_textures
        and (not big or scene.chunk_geoms is not None)
    ):
        # Fused-attribute path: normal from the kernel, point from
        # o + t*d, no pass 2.  Every route carries the normal with the same
        # arithmetic, so the image does not depend on the route (the JAX
        # package sends use_bvh through pass 2 here, whose normals differ
        # in the last bit).
        if big:
            t_min, gid, normal = closest_hit_tid_n_chunks(scene, o, d, time, active)
        elif use_bvh and scene.bvh_geoms is not None:
            t_min, gid, normal = closest_hit_tid_n_bvh(scene, o, d, time, active)
        else:
            t_min, gid, normal = closest_hit_tid_n(scene, o, d, time, active)
        valid = torch.isfinite(t_min)
        t_fin = torch.where(valid, t_min, 0.0)
        return Hit(
            valid=valid,
            geom_id=gid,
            t=t_min,
            point=o + t_fin[:, None] * d,
            normal=normal,
            uv=torch.zeros((r, 2), dtype=torch.float32, device=dev),
        )
    t_min, gid = _closest_tid(scene, o, d, time, active, use_bvh)
    valid = torch.isfinite(t_min)
    gid = torch.clamp(gid, min=0).to(torch.int64)

    if scene.n_prims and scene.n_planes:
        pid = torch.clamp(gid, 0, scene.n_prims - 1)
        qid = torch.clamp(gid - scene.n_prims, 0, scene.n_planes - 1)
        p1, n1, u1, v1, t1 = _prim_attributes(scene, pid, o, d, time)
        p2, n2, u2, v2, t2 = _plane_attributes(scene, qid, o, d)
        is_plane = gid >= scene.n_prims
        point = torch.where(is_plane[:, None], p2, p1)
        normal = torch.where(is_plane[:, None], n2, n1)
        u = torch.where(is_plane, u2, u1)
        v = torch.where(is_plane, v2, v1)
        t = torch.where(is_plane, t2, t1)
    elif scene.n_prims:
        pid = torch.clamp(gid, 0, scene.n_prims - 1)
        point, normal, u, v, t = _prim_attributes(scene, pid, o, d, time)
    else:
        qid = torch.clamp(gid, 0, scene.n_planes - 1)
        point, normal, u, v, t = _plane_attributes(scene, qid, o, d)

    return Hit(
        valid=valid,
        geom_id=torch.where(valid, gid, -1).to(torch.int32),
        t=torch.where(valid, t, _INF),
        point=point,
        normal=normal,
        uv=torch.stack([u, v], dim=-1),
    )
