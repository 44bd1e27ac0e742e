"""Chunk-culled streaming kernels: closest hit, closest hit with the
winner's normal, and shadow any-hit for scenes whose geom table does not
fit a block's shared memory (more than `BRUTE_SMEM_MAX_GEOMS` geoms).

The structure is a ONE-LEVEL BVH over Morton-ordered geom chunks
(accel/lbvh.py::build_chunks): the table sorted by centroid Morton code,
cut into chunks of `chunk` rows, each with a conservative AABB (motion
extent included) and the slack its box test gets (`graze`, (NC,):
accel/lbvh.py::chunk_graze).  Rows are of mixed kinds, the kind read from
column 15.

The three kernels (csrc/chunk_stream.cu over csrc/sweep.cuh) replace
`_closest_kernel`, `_closest_n_kernel` and `_occlusion_kernel` of the JAX
package's kernels/chunk_stream.py.  What bounds them on an H100:
operations — the geom tests of the chunks a ray cannot rule out, about 80
f32 operations each, against 8 rows of 4 bytes read and 1 to 5 written a
ray.  Design: one thread per ray with its (best t, row[, normal]) in
registers across the whole sweep; each thread slab-tests the chunk's AABB
against its own ray and its own bound (best t so far, or the shadow ray's
max t) and runs the chunk's rows only if it can be hit — the cull is per
thread; the block stages a chunk in shared memory only if one of its
threads wants it — the staging is culled per block; the any-hit thread
stops at its first blocker.  The table is read as it lies in the scene,
row-major (rows, 17): a chunk is one contiguous copy.

The cull only removes provable misses, so every kernel equals the plain
sweep of the whole table in row order (`mixed_closest_plain`), which is
what the `_plain` versions here are: no cull, strict <, lowest row wins a
tie.  With `stats` they also count what a per-ray cull cannot avoid.

For CUDA tensors the wrappers launch the kernel (built at first use by
kernels/_build.py) or raise; only CPU tensors take the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tracying_tpu_torch.kernels.closest_hit import (
    RayBlock,
    check_rays,
    check_rows_table,
    geom_t,
    launch_sweep,
    mixed_closest_plain,
    mixed_rows,
    pack_rays,
)
from ray_tracying_tpu_torch.kernels.ray_sort import sorted_closest_hit
from ray_tracying_tpu_torch.scene.types import Scene

_INF = float("inf")


# Slack of the box test (csrc/geom.cuh::kBoxSlack): a box is grown by 32 ulp
# of the largest coordinate involved, and by its own `graze` times the
# squared distance to its farthest corner (the sphere test's cancellation at
# a distance), so that a cull never removes a hit the geom tests themselves
# would report.
BOX_SLACK = 4e-6


def box_hit(rb: RayBlock, box, bound, graze: Optional[float]) -> torch.Tensor:
    """(R,) bool: can the ray hit the AABB `box` (6 floats, min | max),
    grown by the slack, at a Euclidean distance <= bound?  The reference
    slab test (Code/shapes.cpp:55-72), compared as t_near * |d| <= bound;
    the twin of csrc/geom.cuh::box_hit.  graze: the box's own slack factor
    (a float taken from the f32 `graze` tensor); None tests the exact box,
    without any slack, which is what the counts of needed tests use."""
    if graze is None:
        pad = 0.0
    else:
        far = [
            torch.abs(0.5 * (box[k] + box[k + 3]) - oo) + 0.5 * (box[k + 3] - box[k])
            for k, oo in enumerate((rb.ox, rb.oy, rb.oz))
        ]
        mo = torch.maximum(torch.maximum(torch.abs(rb.ox), torch.abs(rb.oy)), torch.abs(rb.oz))
        pad = BOX_SLACK * (mo + far[0] + far[1] + far[2]) + graze * (
            far[0] * far[0] + far[1] * far[1] + far[2] * far[2]
        )
    t_near = torch.full_like(rb.ox, -_INF)
    t_far = torch.full_like(rb.ox, _INF)
    miss = torch.zeros_like(rb.ox, dtype=torch.bool)
    for axis, (oo, dd) in enumerate(((rb.ox, rb.dx), (rb.oy, rb.dy), (rb.oz, rb.dz))):
        mn, mx = box[axis] - pad, box[axis + 3] + pad
        par = torch.abs(dd) < 1e-6
        d_safe = torch.where(par, 1.0, dd)
        s1 = (mn - oo) / d_safe
        s2 = (mx - oo) / d_safe
        ent = torch.where(par, -_INF, torch.minimum(s1, s2))
        ext = torch.where(par, _INF, torch.maximum(s1, s2))
        miss = miss | (par & ((oo < mn) | (oo > mx)))
        t_near = torch.maximum(t_near, ent)
        t_far = torch.minimum(t_far, ext)
    hit = ~miss & (t_near <= t_far) & (t_far >= 0.0)
    return hit & (t_near * rb.dnorm <= bound)


def _check(rays, boxes, graze, table, g, maxt=None):
    check_rays(rays, maxt, boxes=boxes, graze=graze, table=table)
    check_rows_table(table, g)
    if boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 6:
        raise TypeError("boxes must be an (NC, 6) float32 tensor")
    nc = boxes.shape[0]
    if graze.dtype != torch.float32 or graze.shape != (nc,):
        raise TypeError("graze must be an (NC,) float32 tensor beside the boxes")
    if nc == 0 or table.shape[0] % nc:
        raise ValueError(
            f"a table of {table.shape[0]} rows is not {nc} chunks of equal size"
        )
    chunk = table.shape[0] // nc
    if -(-g // chunk) != nc:
        raise ValueError(f"{g} geoms do not fill {nc} chunks of {chunk}")
    return chunk


def _closest_stats(stats, rays, boxes, table, g, chunk, t):
    """What a per-ray cull cannot avoid, given the final t: every live ray
    tests every chunk's box, and runs the rows of each chunk whose exact
    box it can hit no farther than its closest hit."""
    rb = RayBlock(rays)
    live = rays[7] > 0.0
    tests = 0
    for c, box in enumerate(boxes.tolist()):
        need = live & box_hit(rb, box, t, None)
        tests += int(need.sum()) * (min(chunk, g - c * chunk))
    n_live = int(live.sum())
    stats.update(lanes=rays.shape[1], live=n_live, tests=tests,
                 box_tests=n_live * boxes.shape[0])


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the oracles of the kernels and the path of CPU
# tensors.
# ---------------------------------------------------------------------------

def chunk_closest_plain(rays, boxes, graze, table, g: int, motion: bool = False,
                        stats: Optional[dict] = None):
    """(t, id) of the closest hit over the first g rows of the chunk table;
    see `mixed_closest_plain`.  The plain versions sweep every row: they
    take the boxes and their slacks only to check and to count."""
    chunk = _check(rays, boxes, graze, table, g)
    t, pid = mixed_closest_plain(rays, table, g, motion)
    if stats is not None:
        _closest_stats(stats, rays, boxes, table, g, chunk, t)
    return t, pid


def chunk_closest_n_plain(rays, boxes, graze, table, g: int, motion: bool = False,
                          stats: Optional[dict] = None):
    """(t, id, unit normal (3, R)): the winner's normal is normalized once
    after the last row; lanes without a winner carry a zero normal."""
    chunk = _check(rays, boxes, graze, table, g)
    t, pid, n = mixed_closest_plain(rays, table, g, motion, want_n=True)
    if stats is not None:
        _closest_stats(stats, rays, boxes, table, g, chunk, t)
    return t, pid, n


def chunk_occlusion_plain(rays, maxt, boxes, graze, table, g: int,
                          stats: Optional[dict] = None):
    """Shadow any-hit: blocked (R,) bool, true iff some geom hits the ray
    at t <= maxt.  Shadow rays carry time 0: no origin is shifted.  A lane
    with act <= 0 reports False.

    stats: optional dict that receives what this call's data needed under a
    per-ray cull in row order: for each chunk whose exact box an open lane
    can hit within maxt, the geom tests up to and including its first
    blocker."""
    chunk = _check(rays, boxes, graze, table, g, maxt)
    rb = RayBlock(rays)
    live = rays[7] > 0.0
    blocked = ~live
    n_tests = n_box = 0
    want = None
    box_list = boxes.tolist() if stats is not None else None
    for i, (row, kind, _) in enumerate(mixed_rows(table, g)):
        if stats is not None:
            if i % chunk == 0:
                n_box += int((~blocked).sum())
                want = ~blocked & box_hit(rb, box_list[i // chunk], maxt, None)
            n_tests += int((want & ~blocked).sum())
        blocked = blocked | (geom_t(row, rb, kind) <= maxt)
    if stats is not None:
        stats.update(lanes=rays.shape[1], live=int(live.sum()), tests=n_tests,
                     box_tests=n_box)
    return blocked & live


# ---------------------------------------------------------------------------
# Wrappers.  A CUDA tensor goes through the hand-written kernel or raises;
# only a CPU tensor takes the plain version.  `.launches` counts kernel
# launches.
# ---------------------------------------------------------------------------

def chunk_closest(rays, boxes, graze, table, g: int, motion: bool = False):
    """(t, id) of the closest hit; see `chunk_closest_plain`."""
    if not rays.is_cuda:
        return chunk_closest_plain(rays, boxes, graze, table, g, motion)
    chunk = _check(rays, boxes, graze, table, g)
    out = launch_sweep("chunk_closest", rays, None, boxes, graze, table, g, chunk, motion)
    chunk_closest.launches += 1
    return out


def chunk_closest_n(rays, boxes, graze, table, g: int, motion: bool = False):
    """(t, id, unit normal (3, R)); see `chunk_closest_n_plain`."""
    if not rays.is_cuda:
        return chunk_closest_n_plain(rays, boxes, graze, table, g, motion)
    chunk = _check(rays, boxes, graze, table, g)
    out = launch_sweep("chunk_closest_n", rays, None, boxes, graze, table, g, chunk, motion)
    chunk_closest_n.launches += 1
    return out


def chunk_occlusion(rays, maxt, boxes, graze, table, g: int):
    """blocked (R,) bool; see `chunk_occlusion_plain`."""
    if not rays.is_cuda:
        return chunk_occlusion_plain(rays, maxt, boxes, graze, table, g)
    chunk = _check(rays, boxes, graze, table, g, maxt)
    out = launch_sweep("chunk_occlusion", rays, maxt, boxes, graze, table, g, chunk, False)
    chunk_occlusion.launches += 1
    return out


chunk_closest.launches = 0
chunk_closest_n.launches = 0
chunk_occlusion.launches = 0


def _operands(scene: Scene):
    if scene.chunk_geoms is None or scene.chunk_graze is None:
        raise ValueError("the scene carries no chunks: call accel.lbvh.with_chunks first")
    return (scene.chunk_boxes.detach().contiguous(), scene.chunk_graze,
            scene.chunk_geoms.detach().contiguous(), scene.n_geoms)


def closest_hit_tid_chunks(scene: Scene, o, d, time, active=None, sort_rays=False):
    """Chunk-culled closest hit for a scene beyond shared memory:
    (t, geom_id).  Requires accel.lbvh.with_chunks(scene).

    sort_rays: sort the wavefront for coherence first
    (kernels/ray_sort.py), so that the blocks of an incoherent wavefront
    stage as few chunks as those of a camera tile; the results are slot
    for slot the same."""
    boxes, graze, table, g = _operands(scene)
    if sort_rays:
        return sorted_closest_hit(
            closest_hit_tid_chunks, scene, o, d, time, active,
            boxes[:, :3].amin(dim=0), boxes[:, 3:].amax(dim=0),
        )
    return chunk_closest(pack_rays(o, d, time, active), boxes, graze, table, g,
                         scene.has_motion)


def closest_hit_tid_n_chunks(scene: Scene, o, d, time, active=None):
    """Chunk-culled closest hit with fused world normals (inference path):
    (t, geom_id, normal (R, 3))."""
    boxes, graze, table, g = _operands(scene)
    t, pid, n = chunk_closest_n(pack_rays(o, d, time, active), boxes, graze, table,
                                g, scene.has_motion)
    return t, pid, n.T


def occluded_tid_chunks(scene: Scene, o, d, maxt, active=None):
    """Chunk-culled any-hit shadow test for a scene beyond shared memory."""
    boxes, graze, table, g = _operands(scene)
    rays = pack_rays(o, d, torch.zeros_like(maxt), active)
    return chunk_occlusion(rays, maxt.detach().contiguous(), boxes, graze, table, g)
