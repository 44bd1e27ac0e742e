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
operations — the box tests and the geom tests of the chunks a ray cannot
rule out, about 80 f32 operations a geom test, against 8 rows of 4 bytes
read and 1 to 5 written a ray; bytes where few lanes are live.

The three wrappers launch the warp schedule
(sweep.cuh::sweep_warp_kernel): one cooperative launch of persistent
blocks lists the live lanes (act > 0; dead lanes get their outputs in that
scan) and deals them to warps 32 at a time; the boxes are staged once a
block; a warp runs a chunk when one of its lanes wants it (the cull per
warp, no block barrier), its rows arriving through a ring of bulk copies of
its own; the closest hits visit the chunks nearest first by the warp's
least entry distance and merge by (t, row), `chunk_closest_n` computes the
winner's normal once; the any-hit lane stops at its first blocker and the
warp once no lane is open.  `chunk_sweep_variant` reaches, by name, the
one-thread-per-lane schedule they replaced (sweep.cuh::sweep_kernel: each
thread culls a chunk against its own bound, and the block stages a chunk in
shared memory when one of its threads wants it), for the measurement that
compares them; the package never calls it.  The ring needs a chunk of whole
16-byte copies (a multiple of 4 rows under 32, of 32 rows above) and a
16-byte aligned table: the warp schedule refuses other operands.  The table
is read as it lies in the scene, row-major (rows, 17): a chunk is one
contiguous block.

The cull only removes provable misses, so every kernel equals the plain
sweep of the whole table in row order (`mixed_closest_plain`), which is
what the `_plain` versions here are: no cull, strict <, lowest row wins a
tie.  With `stats` they also count what a per-ray cull cannot avoid.

For CUDA tensors the wrappers launch the kernel (built at first use by
kernels/_build.py) or raise; only CPU tensors take the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tracying_tpu_torch.kernels import _build, _coop
from ray_tracying_tpu_torch.kernels.closest_hit import (
    BRUTE_THREADS,
    RayBlock,
    _raise_on,
    check_rays,
    check_rows_table,
    geom_t,
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
    out = _launch("chunk_closest", rays, None, boxes, graze, table, g, chunk, motion)
    chunk_closest.launches += 1
    return out


def chunk_closest_n(rays, boxes, graze, table, g: int, motion: bool = False):
    """(t, id, unit normal (3, R)); see `chunk_closest_n_plain`."""
    if not rays.is_cuda:
        return chunk_closest_n_plain(rays, boxes, graze, table, g, motion)
    chunk = _check(rays, boxes, graze, table, g)
    out = _launch("chunk_closest_n", rays, None, boxes, graze, table, g, chunk, motion)
    chunk_closest_n.launches += 1
    return out


def chunk_occlusion(rays, maxt, boxes, graze, table, g: int):
    """blocked (R,) bool; see `chunk_occlusion_plain`."""
    if not rays.is_cuda:
        return chunk_occlusion_plain(rays, maxt, boxes, graze, table, g)
    chunk = _check(rays, boxes, graze, table, g, maxt)
    out = _launch("chunk_occlusion", rays, maxt, boxes, graze, table, g, chunk, False)
    chunk_occlusion.launches += 1
    return out


# The warp kernel's mode of each wrapper (csrc/sweep.cuh::kSweepClosest, ...).
_SWEEP_MODES = {"chunk_closest": 0, "chunk_closest_n": 1, "chunk_occlusion": 2}


def _launch(name, rays, maxt, boxes, graze, table, g, chunk, motion, schedule="warp",
            work=None):
    """Launch `name` (chunk_closest or chunk_closest_n, or chunk_occlusion
    when maxt is given) on the current stream: the warp schedule or,
    schedule="lane", the one-thread-per-lane sweep.  work: an
    int64 (3,) tensor to count into (lane geom tests, lane box tests, warp
    lane slots; csrc/sweep.cuh::SweepWork), or None.  Returns the outputs;
    the caller counts the launch."""
    lib = _build.load()
    r = rays.shape[1]
    dev = rays.device
    if maxt is not None:
        outs = [torch.empty((r,), dtype=torch.bool, device=dev)]
        head = [rays.data_ptr(), maxt.data_ptr()]
        tail = [r, g, chunk]
    else:
        outs = [torch.empty((r,), dtype=torch.float32, device=dev),
                torch.empty((r,), dtype=torch.int32, device=dev)]
        if name == "chunk_closest_n":
            outs.append(torch.empty((3, r), dtype=torch.float32, device=dev))
        head = [rays.data_ptr()]
        tail = [r, g, chunk, int(bool(motion))]
    args = head + [boxes.data_ptr(), graze.data_ptr(), table.data_ptr()]
    args += [x.data_ptr() for x in outs] + tail
    work_ptr = None if work is None else work.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if schedule == "lane":
            err = getattr(lib, f"{name}_lane_launch")(*args, work_ptr, BRUTE_THREADS, stream)
        else:
            ctr = _coop.work_counters(dev, stream)
            # the launch's list of live lanes (scratch, no initial value)
            live = torch.empty(r, dtype=torch.int32, device=dev)
            err = getattr(lib, f"{name}_launch")(
                *args, work_ptr, ctr.data_ptr(), live.data_ptr(), stream)
    _raise_on(err, lib, name)
    return outs[0] if maxt is not None else tuple(outs)


def chunk_sweep_variant(name, rays, maxt, boxes, graze, table, g: int, motion: bool = False,
                        schedule: str = "warp", work=None):
    """`name` ("chunk_closest" or "chunk_closest_n" with maxt None, or
    "chunk_occlusion" with maxt) by the package's warp schedule or,
    schedule="lane", the one-thread-per-lane sweep it replaced; work counts
    what the launch ran (see `_launch`).  Only for measuring the package's
    kernel against the schedule it replaced (chip_smoke.py); CUDA tensors
    only.  Its launches count in `chunk_sweep_variant.launches`, apart from
    the package's."""
    if not rays.is_cuda:
        raise ValueError("chunk_sweep_variant runs on the card only")
    if schedule not in ("warp", "lane") or name not in _SWEEP_MODES \
            or (maxt is None) != (name != "chunk_occlusion"):
        raise ValueError(f"no variant {schedule!r} of {name!r} with these operands")
    chunk = _check(rays, boxes, graze, table, g, maxt)
    out = _launch(name, rays, maxt, boxes, graze, table, g, chunk, motion, schedule, work)
    chunk_sweep_variant.launches += 1
    return out


def chunk_sweep_plan(name: str, g: int, chunk: int, device=None) -> dict:
    """What the warp schedule of `name` launches with for a table of g rows
    in chunks of `chunk` on the current card: shared memory bytes of a
    block, resident blocks per SM, SMs, threads per block, boxes staged in
    shared memory."""
    lib = _build.load()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = lib.chunk_sweep_plan(_SWEEP_MODES[name], g, chunk, out)
    _raise_on(err, lib, f"{name} plan")
    keys = ("smem_bytes", "blocks_per_sm", "sms", "threads", "boxes_staged")
    return dict(zip(keys, list(out)))


chunk_closest.launches = 0
chunk_closest_n.launches = 0
chunk_occlusion.launches = 0
chunk_sweep_variant.launches = 0


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
