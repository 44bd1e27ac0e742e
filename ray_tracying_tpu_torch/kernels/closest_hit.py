"""Brute-force closest hit, closest hit with fused normals, and shadow
any-hit over the packed geom table: the per-geom intersection math, the
plain PyTorch versions of the three kernels, and their wrappers.

`geom_t` tests ONE geom-table row against a whole block of rays held as
(R,) tensors; `geom_step` / `geom_step_n` fold it into a running closest
hit with the reference's strict-< first-wins tie-break
(Code/acceleration.cpp:112,133).  Nothing of size (rays x geoms) ever
exists: callers loop over table rows.  The CUDA twins of these functions
live in csrc/geom.cuh and keep the same order of operations, so that the
kernels can be held against this module bit for bit.

Distances are the reference's Euclidean semantics: t_loc * |d| for the
transformed prims, parametric t for legacy planes.  Misses are true +inf.
Tables are always kind-sorted, so the kind code of a loop range is the
whole static spec of its rows.

The three kernels (csrc/closest_hit.cu) replace `_brute_kernel`,
`_brute_n_kernel` and `_occlusion_kernel` of the JAX package's
kernels/closest_hit.py.  What bounds them on an H100: operations.  A live
lane runs G tests of about 80 f32 operations each against 8 rows of 4
bytes read and 2 to 5 written.  Each is one cooperative launch of
persistent blocks of 1,024 threads, one an SM: each block stages the table
once as row-major rows that a test reads as 16-byte broadcasts (a closest
hit's rows of 64 bytes, columns 0-14 and the id; a shadow test's of 48,
columns 0-11: `brute_closest_plan`, `occlusion_any_plan`); a scan writes
the dead lanes' outputs and lists the live ones; warps take 32 listed
lanes at a time, and a short list's few lanes a warp have their rows split
over helper lanes.  A closest hit's loop carries (t, row) only, and helpers
merge by (t, row); the winner's normal is its geom test run once more.  An
any-hit lane leaves its loop at its first blocker.  The one-thread-per-lane
kernels they replaced (the (17, G) table staged by every block of 256 rays)
stay reachable by name (`brute_closest_variant`, `occlusion_any_variant`)
for the measurement that compares the two.

A fourth kernel, `brute_closest_chunked` (csrc/closest_hit.cu over
csrc/sweep.cuh), replaces `_brute_chunked_kernel`: the same closest hit for
a table that does not fit a block's shared memory.  The table stays in load
order, rows of mixed kinds (the kind is read from column 15).  It is the
chunk sweeps' warp schedule without boxes: the scan and live-lane list,
warps of 32 listed lanes that keep their (best t, row) in registers and
take the table `GEOM_CHUNK` rows at a time, in row order, through a ring of
bulk copies of their own, a short task's rows split over helper lanes.
Bound: operations, as above.  The one-thread-per-lane sweep it replaced
(each block stages every chunk for its 256 lanes, dead ones too) stays
reachable by name (`brute_closest_chunked_variant`).

`brute_closest`, `brute_closest_n`, `occlusion_any` and
`brute_closest_chunked` take the packed operands: for CUDA tensors they
launch the kernel (built at first use by kernels/_build.py) or raise; only
CPU tensors go through the `_plain` versions.  `closest_hit_tid`,
`closest_hit_tid_n` and `occluded_tid` pack a scene and a ray batch and
call them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.kernels import _build, _coop
from ray_tracying_tpu_torch.kernels.geom_table import (
    GEOM_COLS,
    KIND_PLANE,
    pack_geom_table,
    pack_geom_table_sorted,
)
from ray_tracying_tpu_torch.scene.types import Scene

_INF = float("inf")

KIND_SPHERE, KIND_CUBE, KIND_RECT = 0, 1, 2

# Threads per block of the one-thread-per-lane kernels (the chunked brute,
# and the replaced schedules that `*_variant` reaches); one thread per ray.
BRUTE_THREADS = 256
# The routing's cap: the (17, G) table of the replaced schedules fits the
# 227 KB of dynamic shared memory a block can have on sm_90 up to 3,418
# geoms, and so does the warp kernels' staged table (64 bytes a geom).  A
# larger scene takes the chunked kernels (`brute_closest_chunked` here, or
# the culled sweeps of kernels/chunk_stream.py when the scene carries
# chunks).
BRUTE_MAX_SMEM_BYTES = 232448
BRUTE_SMEM_MAX_GEOMS = BRUTE_MAX_SMEM_BYTES // (4 * GEOM_COLS)
# Rows of one chunk of the chunked brute kernel: a warp's unit of work (its
# ring brings them 32 rows a copy); the one-thread-per-lane sweep stages a
# chunk in 34 KB of a block's shared memory.
GEOM_CHUNK = 512
MAX_RANGES = 4


class RayBlock:
    """The ray block's registers, read from rows 0..6 of a (rows, R) queue
    tensor: origin, direction, time, and |d|."""

    __slots__ = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "dnorm")

    def __init__(self, q: torch.Tensor):
        self.ox, self.oy, self.oz = q[0], q[1], q[2]
        self.dx, self.dy, self.dz = q[3], q[4], q[5]
        self.tm = q[6]
        self.dnorm = torch.sqrt(
            self.dx * self.dx + self.dy * self.dy + self.dz * self.dz
        )


def _plane_t(c, rb: RayBlock, want_normal: bool):
    """Legacy quad, parametric t (Code/shapes.cpp:444-483); the 12 matrix
    slots hold the 4 corners.  What depends on the row alone (edges, unit
    normal) is f32 scalar arithmetic, done in np.float32 as the kernel does
    it in registers."""
    cf = np.asarray(c[:12], dtype=np.float32)
    ax, ay, az, bx, by, bz, cx, cy, cz, ex, ey, ez = cf
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    n2 = nx * nx + ny * ny + nz * nz
    ln = np.sqrt(n2) if n2 > 0.0 else np.float32(0.0)
    degen = bool(ln < np.float32(C.EPS_PARALLEL))
    ln_safe = np.float32(1.0) if degen else ln
    nx, ny, nz = float(nx / ln_safe), float(ny / ln_safe), float(nz / ln_safe)
    ax, ay, az, bx, by, bz, cx, cy, cz, ex, ey, ez = (float(v) for v in cf)

    inf = torch.full_like(rb.ox, _INF)
    denom = rb.dx * nx + rb.dy * ny + rb.dz * nz
    par = torch.abs(denom) < C.EPS_PARALLEL
    t = ((ax - rb.ox) * nx + (ay - rb.oy) * ny + (az - rb.oz) * nz) / torch.where(
        par, 1.0, denom
    )
    px = rb.ox + t * rb.dx
    py = rb.oy + t * rb.dy
    pz = rb.oz + t * rb.dz

    def edge(x0, y0, z0, x1, y1, z1):
        ux, uy, uz = (float(np.float32(x1) - np.float32(x0)),
                      float(np.float32(y1) - np.float32(y0)),
                      float(np.float32(z1) - np.float32(z0)))
        wx, wy, wz = px - x0, py - y0, pz - z0
        cxv = wz * uy - wy * uz
        cyv = wx * uz - wz * ux
        czv = wy * ux - wx * uy
        return (cxv * nx + cyv * ny + czv * nz) >= C.EPS_PLANE_EDGE

    in_t1 = (
        edge(bx, by, bz, ex, ey, ez)
        & edge(ex, ey, ez, cx, cy, cz)
        & edge(cx, cy, cz, bx, by, bz)
    )
    in_t2 = (
        edge(ax, ay, az, bx, by, bz)
        & edge(bx, by, bz, cx, cy, cz)
        & edge(cx, cy, cz, ax, ay, az)
    )
    if degen:
        ok = torch.zeros_like(par)
    else:
        ok = ~par & (t >= 0.0) & (in_t1 | in_t2)
    t_geom = torch.where(ok, t, inf)
    if not want_normal:
        return t_geom
    # The plane normal is already in world space (Code/shapes.cpp:454).
    return t_geom, (
        torch.full_like(rb.ox, nx),
        torch.full_like(rb.ox, ny),
        torch.full_like(rb.ox, nz),
    )


def geom_t(c, rb: RayBlock, kind: int, want_normal: bool = False,
           motion: bool = False, miss_t: float = _INF):
    """Hit distance of one geom-table row against the ray block.

    c: the row's 17 columns as Python floats (each exactly an f32 value):
    the world->object 3x4 (or a plane's corners), the velocity, kind and
    id.  kind: the static kind code of the row's range.  motion: shift the
    origin by -velocity * time first (Code/shapes.cpp:201-210); callers
    set it for sphere ranges of a scene with motion blur, since only
    spheres carry velocity (Code/json_loader.cpp:215-223).  Returns t (R,)
    with +inf for a miss — plus, when want_normal, the UNnormalized
    world-space hit normal (3 tensors; reference semantics: sphere = local
    point, cube = entry face even when the exit t is used
    (Code/shapes.cpp:392-402), rect = +z, plane = face normal; world
    mapping is the inverse-transpose w2o^T (Code/shapes.cpp:178-187), with
    normalization deferred to the caller).

    c may also hold (R,) tensors, one value per lane (the columns of each
    lane's own winner, kernels/wave_ref.py).  miss_t: the distance reported
    for a miss, +inf as the kernels report it; a differentiable caller
    passes a large finite value, since an inf primal turns the zero
    cotangent of a masked lane into NaN (0 * inf)."""
    if kind == KIND_PLANE:
        return _plane_t(c, rb, want_normal)
    ox, oy, oz = rb.ox, rb.oy, rb.oz
    if motion:
        ox = ox - rb.tm * c[12]
        oy = oy - rb.tm * c[13]
        oz = oz - rb.tm * c[14]
    # World -> object (explicit multiply-adds, left to right).
    olx = ox * c[0] + oy * c[1] + oz * c[2] + c[3]
    oly = ox * c[4] + oy * c[5] + oz * c[6] + c[7]
    olz = ox * c[8] + oy * c[9] + oz * c[10] + c[11]
    dlx = rb.dx * c[0] + rb.dy * c[1] + rb.dz * c[2]
    dly = rb.dx * c[4] + rb.dy * c[5] + rb.dz * c[6]
    dlz = rb.dx * c[8] + rb.dy * c[9] + rb.dz * c[10]
    inf = torch.full_like(rb.ox, miss_t)

    if kind == KIND_SPHERE:
        # (Code/shapes.cpp:219-232)
        a = dlx * dlx + dly * dly + dlz * dlz
        b = (olx * dlx + oly * dly + olz * dlz) * 2.0
        cc = olx * olx + oly * oly + olz * olz - 1.0
        disc = b * b - a * 4.0 * cc
        pos = disc > 0.0
        sq = torch.where(
            pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0
        )
        a_safe = torch.where(a > 0.0, a, 1.0)
        inv_2a = 1.0 / (a_safe * 2.0)
        t1 = (-b - sq) * inv_2a
        t2 = (-b + sq) * inv_2a
        t_loc = torch.where(
            t1 > C.EPS_T_MIN, t1, torch.where(t2 > C.EPS_T_MIN, t2, inf)
        )
        t_loc = torch.where((disc >= 0.0) & (a > 0.0), t_loc, inf)
        t_geom = t_loc * rb.dnorm
        if want_normal:
            # n_loc = local hit point (unit sphere, Code/shapes.cpp:241)
            tl = torch.where(t_loc < miss_t, t_loc, 0.0)
            nlx = olx + tl * dlx
            nly = oly + tl * dly
            nlz = olz + tl * dlz
    elif kind == KIND_CUBE:
        # Slab test with t > 0, no 1e-3 epsilon (Code/shapes.cpp:361-393).
        t_near = torch.full_like(ox, -miss_t)
        t_far = inf
        miss = torch.zeros_like(ox, dtype=torch.bool)
        ents = []
        sgns = []
        for oo, ddc in ((olx, dlx), (oly, dly), (olz, dlz)):
            par = torch.abs(ddc) < C.EPS_PARALLEL
            inv_d = 1.0 / torch.where(par, 1.0, ddc)
            s1 = (-0.5 - oo) * inv_d
            s2 = (0.5 - oo) * inv_d
            ent = torch.where(par, -miss_t, torch.minimum(s1, s2))
            ext = torch.where(par, miss_t, torch.maximum(s1, s2))
            miss = miss | (par & ((oo < -0.5) | (oo > 0.5)))
            t_near = torch.maximum(t_near, ent)
            t_far = torch.minimum(t_far, ext)
            if want_normal:
                ents.append(ent)
                sgns.append(torch.where(s1 < s2, -1.0, 1.0))
        miss = miss | (t_near > t_far) | (t_far < 0.0)
        t_cub = torch.where(t_near > 0.0, t_near, t_far)
        t_cub = torch.where(miss | (t_cub < 0.0), inf, t_cub)
        t_geom = t_cub * rb.dnorm
        if want_normal:
            # Entry face: the axis whose slab entry won the max, first
            # wins on ties (strict >), like the reference's sequential
            # update.
            win1 = ents[1] > ents[0]
            axv = torch.where(win1, ents[1], ents[0])
            win2 = ents[2] > axv
            nlx = torch.where(win1 | win2, 0.0, sgns[0])
            nly = torch.where(win2, 0.0, torch.where(win1, sgns[1], 0.0))
            nlz = torch.where(win2, sgns[2], 0.0)
    elif kind == KIND_RECT:
        # (Code/shapes.cpp:305-315)
        par_z = torch.abs(dlz) < C.EPS_PARALLEL
        t_r = -olz / torch.where(par_z, 1.0, dlz)
        hx = olx + t_r * dlx
        hy = oly + t_r * dly
        ok_r = (
            ~par_z
            & (t_r >= C.EPS_T_MIN)
            & (hx >= -0.5) & (hx <= 0.5) & (hy >= -0.5) & (hy <= 0.5)
        )
        t_geom = torch.where(ok_r, t_r, inf) * rb.dnorm
        if want_normal:
            # n_loc = +z (Code/shapes.cpp:320)
            nlx = torch.zeros_like(ox)
            nly = nlx
            nlz = torch.ones_like(ox)
    else:
        raise ValueError(f"unknown geom kind {kind}")

    if not want_normal:
        return t_geom
    # World normal via inverse-transpose: n_w = w2o^T n_loc.
    nwx = nlx * c[0] + nly * c[4] + nlz * c[8]
    nwy = nlx * c[1] + nly * c[5] + nlz * c[9]
    nwz = nlx * c[2] + nly * c[6] + nlz * c[10]
    return t_geom, (nwx, nwy, nwz)


def geom_step(gid: int, carry, c, rb: RayBlock, kind: int, motion=False):
    """Test one table row (columns c, geom id gid) and update the running
    (best_t, best_id) with the strict-< first-wins tie-break."""
    best_t, best_id = carry
    t_geom = geom_t(c, rb, kind, motion=motion)
    better = t_geom < best_t
    return torch.where(better, t_geom, best_t), torch.where(better, gid, best_id)


def geom_step_n(g: int, carry, c, rb: RayBlock, kind: int, motion=False):
    """geom_step that also carries the winner's unnormalized world normal;
    g is what the caller wants recorded for the winner (its table row or
    its geom id)."""
    best_t, best_row, bnx, bny, bnz = carry
    t_geom, (nwx, nwy, nwz) = geom_t(c, rb, kind, want_normal=True, motion=motion)
    better = t_geom < best_t
    best_t = torch.where(better, t_geom, best_t)
    best_row = torch.where(better, g, best_row)
    bnx = torch.where(better, nwx, bnx)
    bny = torch.where(better, nwy, bny)
    bnz = torch.where(better, nwz, bnz)
    return best_t, best_row, bnx, bny, bnz


# ---------------------------------------------------------------------------
# Operands
# ---------------------------------------------------------------------------

def pack_rays(o, d, time, active=None) -> torch.Tensor:
    """(R, 3) x 2 + (R,) [+ (R,) bool] -> the (8, R) ray tensor of the
    kernels: rows ox oy oz dx dy dz time act.  One concatenation; R is not
    padded to anything."""
    r = o.shape[0]
    if active is None:
        act_row = torch.ones((1, r), dtype=torch.float32, device=o.device)
    else:
        act_row = active.to(torch.float32)[None, :]
    return torch.cat([o.T, d.T, time[None, :], act_row], dim=0).detach().contiguous()


def scene_table(scene: Scene):
    """((17, G) kind-sorted table, transposed and contiguous, ranges)."""
    table, ranges = pack_geom_table_sorted(scene)
    return table.T.detach().contiguous(), ranges


def check_rays(rays, maxt=None, **tables):
    """Raise on what no kernel takes: rays that are not a contiguous
    (8, R) f32 tensor, a `maxt` that is not (R,) f32 beside them, or a
    named table that is not contiguous on the rays' device."""
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 8:
        raise TypeError("rays must be an (8, R) float32 tensor")
    if not rays.is_contiguous():
        raise ValueError("rays must be contiguous (row-major)")
    for name, tab in tables.items():
        if not tab.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
        if tab.device != rays.device:
            raise ValueError(f"{name} must be on the rays' device")
    if maxt is not None:
        if maxt.dtype != torch.float32 or maxt.shape != (rays.shape[1],):
            raise TypeError("maxt must be an (R,) float32 tensor")
        if not maxt.is_contiguous() or maxt.device != rays.device:
            raise ValueError("maxt must be contiguous, on the rays' device")


def check_rows_table(table, g=None):
    """A row-major (rows, 17) f32 geom table with at least `g` rows."""
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != GEOM_COLS:
        raise TypeError(f"table must be a (G, {GEOM_COLS}) float32 tensor")
    if g is not None and not 0 < g <= table.shape[0]:
        raise ValueError(f"{g} geoms in a table of {table.shape[0]} rows")


def _check_args(rays, table, ranges, maxt=None):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != GEOM_COLS:
        raise TypeError(f"table must be a ({GEOM_COLS}, G) float32 tensor")
    check_rays(rays, maxt, table=table)
    if not 0 < len(ranges) <= MAX_RANGES:
        raise ValueError(f"between 1 and {MAX_RANGES} kind ranges")
    for kind, start, end in ranges:
        if kind not in (KIND_SPHERE, KIND_CUBE, KIND_RECT, KIND_PLANE):
            raise ValueError(f"unknown geom kind {kind}")
        if not 0 <= start <= end <= table.shape[1]:
            raise ValueError("a kind range leaves the table")


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the oracles of the kernels and the path of CPU
# tensors.  Python loops over the table rows of each range on (R,) tensors.
# ---------------------------------------------------------------------------

def brute_closest_plain(rays, table, ranges, motion: bool = False):
    """Closest hit over the kind-sorted table: (t (R,) f32 with +inf for a
    miss, id (R,) int32 with -1 for a miss).  Rows in table order, strict
    <, so the first of equal hits wins.  A lane with act <= 0 reports a
    miss."""
    _check_args(rays, table, ranges)
    r = rays.shape[1]
    rows = table.T.tolist()
    rb = RayBlock(rays)
    best = (
        torch.full((r,), _INF, dtype=torch.float32, device=rays.device),
        torch.full((r,), -1, dtype=torch.int32, device=rays.device),
    )
    for kind, start, end in ranges:
        mo = motion and kind == KIND_SPHERE
        for g in range(start, end):
            best = geom_step(int(round(rows[g][16])), best, rows[g], rb, kind, mo)
    best_t, best_id = best
    live = rays[7] > 0.0
    return (
        torch.where(live, best_t, _INF),
        torch.where(live, best_id, -1),
    )


def brute_closest_n_plain(rays, table, ranges, motion: bool = False):
    """Closest hit plus the winner's unit world normal: (t, id, n (3, R)).
    The normal is normalized once after the loop (Code/shapes.cpp:186);
    lanes without a winner, and dead lanes, carry a zero normal."""
    _check_args(rays, table, ranges)
    r = rays.shape[1]
    rows = table.T.tolist()
    rb = RayBlock(rays)
    zero = torch.zeros(r, dtype=torch.float32, device=rays.device)
    best = (
        torch.full((r,), _INF, dtype=torch.float32, device=rays.device),
        torch.full((r,), -1, dtype=torch.int32, device=rays.device),
        zero, zero, zero,
    )
    for kind, start, end in ranges:
        mo = motion and kind == KIND_SPHERE
        for g in range(start, end):
            best = geom_step_n(int(round(rows[g][16])), best, rows[g], rb, kind, mo)
    best_t, best_id, bnx, bny, bnz = best
    ln = torch.sqrt(bnx * bnx + bny * bny + bnz * bnz)
    ln = torch.where(ln > 0.0, ln, 1.0)
    n = torch.stack([bnx / ln, bny / ln, bnz / ln], dim=0)
    live = rays[7] > 0.0
    return (
        torch.where(live, best_t, _INF),
        torch.where(live, best_id, -1),
        torch.where(live[None, :], n, 0.0),
    )


def occlusion_plain(rays, maxt, table, ranges, stats: Optional[dict] = None):
    """Shadow any-hit: blocked (R,) bool, true iff some geom hits the ray
    at t <= maxt (the complement of the reference's visibility test,
    Code/raytracer.cpp:233-235).  Shadow rays carry time 0, so no origin
    is shifted.  A lane with act <= 0 reports False.

    stats: optional dict that receives what this call's data needed: live
    lanes, and the geom tests counted up to and including each ray's first
    blocker (what a loop with early exit runs)."""
    _check_args(rays, table, ranges, maxt)
    rows = table.T.tolist()
    rb = RayBlock(rays)
    live = rays[7] > 0.0
    # Dead lanes start "blocked" so that the count below leaves them out.
    blocked = ~live
    n_tests = 0
    for kind, start, end in ranges:
        for g in range(start, end):
            if stats is not None:
                n_tests += int((~blocked).sum())
            blocked = blocked | (geom_t(rows[g], rb, kind) <= maxt)
    if stats is not None:
        stats.update(lanes=rays.shape[1], live=int(live.sum()), tests=n_tests)
    return blocked & live


def mixed_rows(table, g: int):
    """The first g rows of a row-major (rows, 17) table as Python floats,
    each with its kind code (column 15) and geom id (column 16)."""
    rows = table[:g].tolist()
    return [(row, int(round(row[15])), int(round(row[16]))) for row in rows]


def mixed_closest_plain(rays, table, g: int, motion: bool = False,
                        want_n: bool = False):
    """Closest hit over the first g rows of a row-major (rows, 17) table
    whose rows are of mixed kinds, in any order: (t, id) or, with want_n,
    (t, id, unit normal (3, R)).  Rows are swept in table order with a
    strict <, so of equal hits the lowest row wins: the result every
    chunked, culled or traversed kernel over the same table must equal,
    whatever order it visits the rows in.  Only spheres carry velocity, so
    `motion` shifts the origin for sphere rows alone."""
    check_rays(rays, table=table)
    check_rows_table(table, g)
    r = rays.shape[1]
    rb = RayBlock(rays)
    zero = torch.zeros(r, dtype=torch.float32, device=rays.device)
    best = (
        torch.full((r,), _INF, dtype=torch.float32, device=rays.device),
        torch.full((r,), -1, dtype=torch.int32, device=rays.device),
    )
    if want_n:
        best += (zero, zero, zero)
    step = geom_step_n if want_n else geom_step
    for row, kind, gid in mixed_rows(table, g):
        best = step(gid, best, row, rb, kind, motion and kind == KIND_SPHERE)
    live = rays[7] > 0.0
    t = torch.where(live, best[0], _INF)
    pid = torch.where(live, best[1], -1)
    if not want_n:
        return t, pid
    bnx, bny, bnz = best[2:]
    ln = torch.sqrt(bnx * bnx + bny * bny + bnz * bnz)
    ln = torch.where(ln > 0.0, ln, 1.0)
    n = torch.stack([bnx / ln, bny / ln, bnz / ln], dim=0)
    return t, pid, torch.where(live[None, :], n, 0.0)


def brute_closest_chunked_plain(rays, table, motion: bool = False):
    """Closest hit over a load-order (G, 17) table of any size: (t, id);
    see `mixed_closest_plain`."""
    return mixed_closest_plain(rays, table, table.shape[0], motion)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------

def _launch_args(rays, table, ranges):
    g = table.shape[1]
    if g > BRUTE_SMEM_MAX_GEOMS:
        raise NotImplementedError(
            f"a geom table of {g} geoms does not fit the {BRUTE_MAX_SMEM_BYTES} "
            f"bytes of shared memory a block has ({BRUTE_SMEM_MAX_GEOMS} geoms): "
            "a scene of that size takes brute_closest_chunked or the chunk "
            "kernels of kernels/chunk_stream.py"
        )
    flat = [x for rng in ranges for x in rng]
    flat += [0] * (3 * MAX_RANGES - len(flat))
    return g, (ctypes.c_int * (3 * MAX_RANGES))(*flat)


def _raise_on(err: int, lib, name: str):
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.wave_error_string(err).decode()})"
        )


def _launch_brute(name, args, rays, schedule):
    """`name`_launch(*args, ctr, live, stream), the package's cooperative
    kernel, or with schedule="lane" `name`_lane_launch(*args, threads,
    stream), the one-thread-per-lane kernel it replaced, on the current
    stream; raises if it did not launch."""
    lib = _build.load()
    dev = rays.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if schedule == "lane":
            err = getattr(lib, f"{name}_lane_launch")(*args, BRUTE_THREADS, stream)
        else:
            ctr = _coop.work_counters(dev, stream)
            # the launch's list of live lanes (scratch, no initial value)
            live = torch.empty(rays.shape[1], dtype=torch.int32, device=dev)
            err = getattr(lib, f"{name}_launch")(*args, ctr.data_ptr(), live.data_ptr(), stream)
    _raise_on(err, lib, name)


def _launch_closest(rays, table, ranges, motion, want_n, schedule="warp"):
    """Launch a closest hit by `schedule` (see `_launch_brute`).  Returns
    (t, id[, n]); the caller counts the launch."""
    g, c_ranges = _launch_args(rays, table, ranges)
    r = rays.shape[1]
    dev = rays.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    pid = torch.empty((r,), dtype=torch.int32, device=dev)
    n = torch.empty((3, r), dtype=torch.float32, device=dev) if want_n else None
    outs = (t, pid, n) if want_n else (t, pid)
    args = [rays.data_ptr(), table.data_ptr(), *(x.data_ptr() for x in outs),
            r, g, c_ranges, len(ranges), int(bool(motion))]
    _launch_brute("brute_closest_n" if want_n else "brute_closest", args, rays, schedule)
    return outs


def _launch_occlusion(rays, maxt, table, ranges, schedule="warp"):
    """Launch the any-hit by `schedule` (see `_launch_brute`).  Returns
    blocked; the caller counts the launch."""
    g, c_ranges = _launch_args(rays, table, ranges)
    blocked = torch.empty((rays.shape[1],), dtype=torch.bool, device=rays.device)
    args = [rays.data_ptr(), maxt.data_ptr(), table.data_ptr(), blocked.data_ptr(),
            rays.shape[1], g, c_ranges, len(ranges)]
    _launch_brute("occlusion_any", args, rays, schedule)
    return blocked


def _plan(name, *args, device=None) -> dict:
    """`name`_plan(*args, out) on the current card: shared memory bytes of
    a block, resident blocks per SM, SMs, threads per block."""
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = getattr(lib, f"{name}_plan")(*args, out)
    _raise_on(err, lib, f"{name} plan")
    return dict(zip(("smem_bytes", "blocks_per_sm", "sms", "threads"), list(out)))


# ---------------------------------------------------------------------------
# Wrappers.  A CUDA tensor goes through the hand-written kernel or raises;
# only a CPU tensor takes the plain version.  `.launches` counts kernel
# launches.
# ---------------------------------------------------------------------------

def brute_closest(rays, table, ranges, motion: bool = False):
    """(t, id) of the closest hit; see `brute_closest_plain`."""
    if not rays.is_cuda:
        return brute_closest_plain(rays, table, ranges, motion)
    _check_args(rays, table, ranges)
    out = _launch_closest(rays, table, ranges, motion, False)
    brute_closest.launches += 1
    return out


def brute_closest_n(rays, table, ranges, motion: bool = False):
    """(t, id, unit normal (3, R)); see `brute_closest_n_plain`."""
    if not rays.is_cuda:
        return brute_closest_n_plain(rays, table, ranges, motion)
    _check_args(rays, table, ranges)
    out = _launch_closest(rays, table, ranges, motion, True)
    brute_closest_n.launches += 1
    return out


def brute_closest_variant(rays, table, ranges, motion: bool = False, want_n: bool = False,
                          schedule: str = "warp"):
    """`brute_closest` (or, want_n, `brute_closest_n`) by the package's
    kernel or by the one-thread-per-lane kernel it replaced
    (schedule="lane").  Only for measuring the one against the other
    (chip_smoke.py); CUDA tensors only.  Its launches count in
    `brute_closest_variant.launches`, apart from the package's."""
    if not rays.is_cuda:
        raise ValueError("brute_closest_variant runs on the card only")
    if schedule not in ("warp", "lane"):
        raise ValueError(f"no variant {schedule!r} of brute_closest")
    _check_args(rays, table, ranges)
    out = _launch_closest(rays, table, ranges, motion, want_n, schedule)
    brute_closest_variant.launches += 1
    return out


def brute_closest_plan(g: int, want_n: bool = False, device=None) -> dict:
    """What `brute_closest` (want_n: `brute_closest_n`) launches with for a
    table of g geoms on the current card: shared memory bytes of a block,
    resident blocks per SM, SMs, threads per block."""
    return _plan("brute_closest", g, int(bool(want_n)), device=device)


def occlusion_any(rays, maxt, table, ranges):
    """blocked (R,) bool; see `occlusion_plain`."""
    if not rays.is_cuda:
        return occlusion_plain(rays, maxt, table, ranges)
    _check_args(rays, table, ranges, maxt)
    out = _launch_occlusion(rays, maxt, table, ranges)
    occlusion_any.launches += 1
    return out


def occlusion_any_variant(rays, maxt, table, ranges, schedule: str = "warp"):
    """`occlusion_any` by the package's kernel or by the one-thread-per-lane
    kernel it replaced (schedule="lane").  Only for measuring the one against
    the other (chip_smoke.py); CUDA tensors only.  Its launches count in
    `occlusion_any_variant.launches`, apart from the package's."""
    if not rays.is_cuda:
        raise ValueError("occlusion_any_variant runs on the card only")
    if schedule not in ("warp", "lane"):
        raise ValueError(f"no variant {schedule!r} of occlusion_any")
    _check_args(rays, table, ranges, maxt)
    out = _launch_occlusion(rays, maxt, table, ranges, schedule)
    occlusion_any_variant.launches += 1
    return out


def occlusion_any_plan(g: int, device=None) -> dict:
    """What `occlusion_any` launches with for a table of g geoms; see
    `brute_closest_plan`."""
    return _plan("occlusion_any", g, device=device)


def brute_closest_chunked(rays, table, motion: bool = False):
    """(t, id) of the closest hit over a load-order (G, 17) table that
    need not fit shared memory; see `brute_closest_chunked_plain`."""
    if not rays.is_cuda:
        return brute_closest_chunked_plain(rays, table, motion)
    check_rays(rays, table=table)
    check_rows_table(table, table.shape[0])
    out = launch_sweep("brute_closest_chunked", rays, table, table.shape[0], GEOM_CHUNK, motion)
    brute_closest_chunked.launches += 1
    return out


def brute_closest_chunked_variant(rays, table, motion: bool = False, schedule: str = "warp"):
    """`brute_closest_chunked` by the package's warp schedule or by the
    one-thread-per-lane sweep it replaced (schedule="lane").  Only for
    measuring the one against the other (chip_smoke.py); CUDA tensors only.
    Its launches count in `brute_closest_chunked_variant.launches`, apart
    from the package's."""
    if not rays.is_cuda:
        raise ValueError("brute_closest_chunked_variant runs on the card only")
    if schedule not in ("warp", "lane"):
        raise ValueError(f"no variant {schedule!r} of brute_closest_chunked")
    check_rays(rays, table=table)
    check_rows_table(table, table.shape[0])
    out = launch_sweep("brute_closest_chunked", rays, table, table.shape[0], GEOM_CHUNK, motion,
                       schedule)
    brute_closest_chunked_variant.launches += 1
    return out


def brute_closest_chunked_plan(g: int, chunk: int = GEOM_CHUNK, device=None) -> dict:
    """What `brute_closest_chunked` launches with for g rows in chunks of
    `chunk` on the current card; see `brute_closest_plan`."""
    return _plan("brute_closest_chunked", g, chunk, device=device)


def launch_sweep(name, rays, table, g, chunk, motion, schedule="warp"):
    """Launch the chunk sweep of csrc/sweep.cuh without boxes on the
    current stream (brute_closest_chunked), by `schedule` (see
    `_launch_brute`).  Returns (t, id); the caller counts the launch."""
    if not 0 < chunk <= BRUTE_SMEM_MAX_GEOMS:
        raise ValueError(
            f"a chunk of {chunk} geoms does not fit a block's shared memory "
            f"({BRUTE_SMEM_MAX_GEOMS} geoms)"
        )
    r = rays.shape[1]
    dev = rays.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    pid = torch.empty((r,), dtype=torch.int32, device=dev)
    args = [rays.data_ptr(), table.data_ptr(), t.data_ptr(), pid.data_ptr(), r, g, chunk,
            int(bool(motion))]
    _launch_brute(name, args, rays, schedule)
    return t, pid


brute_closest.launches = 0
brute_closest_n.launches = 0
brute_closest_variant.launches = 0
occlusion_any.launches = 0
occlusion_any_variant.launches = 0
brute_closest_chunked.launches = 0
brute_closest_chunked_variant.launches = 0


def closest_hit_tid(scene: Scene, o, d, time, active=None):
    """Brute-force closest hit: (t_min, geom_id) for a ray batch.

    o, d: (R, 3); time: (R,).  active: optional (R,) bool; inactive rays
    report a miss and cost no test.  Returns t (R,) with +inf for a miss
    and id (R,) int32 (the reference's load-order geom id) with -1."""
    rays = pack_rays(o, d, time, active)
    if scene.n_geoms > BRUTE_SMEM_MAX_GEOMS:
        # The table does not fit shared memory: stream it in chunks, rows
        # in load order and of mixed kinds.
        table = pack_geom_table(scene).detach().contiguous()
        return brute_closest_chunked(rays, table, scene.has_motion)
    table, ranges = scene_table(scene)
    return brute_closest(rays, table, ranges, scene.has_motion)


def closest_hit_tid_n(scene: Scene, o, d, time, active=None):
    """Closest hit with fused world normals: (t, geom_id, normal (R, 3)).
    Inference path: no gradient flows."""
    table, ranges = scene_table(scene)
    t, pid, n = brute_closest_n(
        pack_rays(o, d, time, active), table, ranges, scene.has_motion
    )
    return t, pid, n.T


def occluded_tid(scene: Scene, o, d, maxt, active=None):
    """(R,) bool: some geom blocks the ray at a distance <= maxt.

    Shadow rays carry time = 0 (Ray default, Code/shapes.hpp:28): no
    origin is shifted even in a motion-blur scene."""
    table, ranges = scene_table(scene)
    rays = pack_rays(o, d, torch.zeros_like(maxt), active)
    return occlusion_any(rays, maxt.detach().contiguous(), table, ranges)
