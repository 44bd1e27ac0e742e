"""Per-geom intersection math shared by the kernels: the plain PyTorch
version of the device functions.

`geom_t` tests ONE geom-table row against a whole block of rays held as
(R,) tensors; `geom_step_n` folds it into a running closest hit with the
reference's strict-< first-wins tie-break (Code/acceleration.cpp:112,133).
Nothing of size (rays x geoms) ever exists: callers loop over table rows.
The CUDA twins of these functions live in csrc/geom.cuh and keep the same
order of operations, so that the kernels can be held against this module.

Distances are the reference's Euclidean semantics: t_loc * |d| for the
transformed prims.  Misses are true +inf.  Spheres, cubes and rects are
covered; legacy planes and the motion-blur origin shift are not (the
kernel gate refuses such scenes).  Tables are always kind-sorted, so the
kind code of a loop range is the whole static spec of its rows.
"""

from __future__ import annotations

import torch

from ray_tracying_tpu_torch.core import constants as C

_INF = float("inf")

KIND_SPHERE, KIND_CUBE, KIND_RECT = 0, 1, 2


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


def geom_t(c, rb: RayBlock, kind: int, want_normal: bool = False):
    """Hit distance of one geom-table row against the ray block.

    c: the row's first 12+ columns as Python floats (each exactly an f32
    value) — the world->object 3x4.  kind: the static kind code of the
    row's range.  Returns t (R,) with +inf for a miss — plus, when
    want_normal, the UNnormalized world-space hit normal (3 tensors;
    reference semantics: sphere = local point, cube = entry face even when
    the exit t is used (Code/shapes.cpp:392-402), rect = +z; world mapping
    is the inverse-transpose w2o^T (Code/shapes.cpp:178-187), with
    normalization deferred to the caller)."""
    ox, oy, oz = rb.ox, rb.oy, rb.oz
    # World -> object (explicit multiply-adds, left to right).
    olx = ox * c[0] + oy * c[1] + oz * c[2] + c[3]
    oly = ox * c[4] + oy * c[5] + oz * c[6] + c[7]
    olz = ox * c[8] + oy * c[9] + oz * c[10] + c[11]
    dlx = rb.dx * c[0] + rb.dy * c[1] + rb.dz * c[2]
    dly = rb.dx * c[4] + rb.dy * c[5] + rb.dz * c[6]
    dlz = rb.dx * c[8] + rb.dy * c[9] + rb.dz * c[10]
    inf = torch.full_like(ox, _INF)

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
            tl = torch.where(t_loc < _INF, t_loc, 0.0)
            nlx = olx + tl * dlx
            nly = oly + tl * dly
            nlz = olz + tl * dlz
    elif kind == KIND_CUBE:
        # Slab test with t > 0, no 1e-3 epsilon (Code/shapes.cpp:361-393).
        t_near = torch.full_like(ox, -_INF)
        t_far = inf
        miss = torch.zeros_like(ox, dtype=torch.bool)
        ents = []
        sgns = []
        for oo, ddc in ((olx, dlx), (oly, dly), (olz, dlz)):
            par = torch.abs(ddc) < C.EPS_PARALLEL
            inv_d = 1.0 / torch.where(par, 1.0, ddc)
            s1 = (-0.5 - oo) * inv_d
            s2 = (0.5 - oo) * inv_d
            ent = torch.where(par, -_INF, torch.minimum(s1, s2))
            ext = torch.where(par, _INF, torch.maximum(s1, s2))
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
        raise NotImplementedError(f"geom kind {kind} (legacy planes)")

    if not want_normal:
        return t_geom
    # World normal via inverse-transpose: n_w = w2o^T n_loc.
    nwx = nlx * c[0] + nly * c[4] + nlz * c[8]
    nwy = nlx * c[1] + nly * c[5] + nlz * c[9]
    nwz = nlx * c[2] + nly * c[6] + nlz * c[10]
    return t_geom, (nwx, nwy, nwz)


def geom_step_n(g: int, carry, c, rb: RayBlock, kind: int):
    """Test table row g (columns c) and update the running closest hit
    (best_t, best_row, unnormalized world normal) with the strict-<
    first-wins tie-break."""
    best_t, best_row, bnx, bny, bnz = carry
    t_geom, (nwx, nwy, nwz) = geom_t(c, rb, kind, want_normal=True)
    better = t_geom < best_t
    best_t = torch.where(better, t_geom, best_t)
    best_row = torch.where(better, g, best_row)
    bnx = torch.where(better, nwx, bnx)
    bny = torch.where(better, nwy, bny)
    bnz = torch.where(better, nwz, bnz)
    return best_t, best_row, bnx, bny, bnz
