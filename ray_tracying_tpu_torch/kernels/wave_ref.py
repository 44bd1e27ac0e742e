"""Differentiable tensor-code reconstruction of one fused bounce level.

The fused level kernel (kernels/wavefront.py, csrc/wavefront.cu) is fast
but opaque to autograd.  `WaveLevelFn` therefore runs the kernel forward in
record mode, which appends the level's discrete decisions (the winner's
geom id, each light's raw visibility, the texel), and its backward rebuilds
the level as this function of (queue, fuzz, table, lights) GIVEN those
decisions, and differentiates the rebuild:

  - hit SELECTION (which geom wins) and shadow visibility are recorded and
    held fixed: they are piecewise constant in every parameter (the
    "closest-hit re-use" scope, the same contract as the general path,
    whose winner search is a kernel and whose pass 2 is tensor code);
  - the winner's hit distance and normal are RECOMPUTED from the winner's
    table row by the same per-kind math the kernels use
    (kernels/closest_hit.py::geom_t), so camera and geometry gradients keep
    their dt/d(origin) terms;
  - shading, attenuation, throughput weights and the continuation spawn
    (glossy fuzz included: the same fuzz rows the kernel consumed; one-way
    refraction) are the reference's formulas, as in `wave_level_plain`;
    an area light's recorded visibility is the fraction of its samples.

The winner's record is gathered by INDEX (core/segment.py::
gather_columns, an `index_select` on the table's columns), never through a
(R, G) one-hot product; its backward sums each geom's lanes' cotangents
without atomics, the same bits on every run.  Rows of the queue and of the winner's record are
taken apart with `unbind`, whose backward stacks the row gradients once
(a select per row would allocate a zero tensor of the whole operand for
each).  Cost: one O(R * L) elementwise pass, no shadow-ray loops
(visibility is recorded).

Scope: what the fused level takes (`wave_refusal`): every geom kind
(legacy planes by their corners), moving spheres (the winner's origin
shifted by -velocity * time), point and area lights, glossy reflection,
one-way refraction, textures (the texel is recorded).

Port of the JAX package's kernels/wave_ref.py::wave_level_ref.
Reconstructs Code/raytracer.cpp:280-351, differentiated with respect to
materials, lights, and ray/camera parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.core.segment import gather_columns
from ray_tracying_tpu_torch.kernels.closest_hit import geom_t
from ray_tracying_tpu_torch.kernels.geom_table import GEOM_COLS, KIND_PLANE

_TINY = 1e-20
# A FINITE miss distance: an inf primal turns the zero cotangent of a
# masked lane into NaN (0 * inf) in the backward of a product.
_MISS_T = 1e30
# Columns of a winner the rebuild reads: the geometry (0..16) and the
# material block up to reflectivity (17..28), or up to the index (30) when
# the scene refracts.
_N_NEED = GEOM_COLS + 12
_N_NEED_REFR = GEOM_COLS + 14


def safe_sqrt(x2: torch.Tensor) -> torch.Tensor:
    """sqrt with a finite gradient at 0 (dead lanes hold zeros; sqrt'(0) =
    inf times a zero cotangent would poison the backward with NaN).  Values
    equal torch.sqrt(max(x2, 0))."""
    pos = x2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x2, 1.0)), 0.0)


class _Rays:
    """The ray attributes geom_t reads, from rows 0..6 of a queue (a
    sequence of (R,) tensors), with a safe |d|."""

    __slots__ = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "dnorm")

    def __init__(self, q):
        self.ox, self.oy, self.oz = q[0], q[1], q[2]
        self.dx, self.dy, self.dz = q[3], q[4], q[5]
        self.tm = q[6]
        self.dnorm = safe_sqrt(self.dx * self.dx + self.dy * self.dy + self.dz * self.dz)


def plane_t_lanes(c, rb: _Rays, miss_t: float):
    """The legacy plane's parametric t (Code/shapes.cpp:444-483) and its
    unit face normal, for per-lane corners: c[0..11] are (R,) tensors, each
    lane's own winner (kernels/closest_hit.py::_plane_t takes one row's
    scalars).  Differentiable in the corners and the ray; a miss is
    `miss_t`."""
    ax, ay, az, bx, by, bz, cx, cy, cz, ex, ey, ez = c[:12]
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    ln = safe_sqrt(nx * nx + ny * ny + nz * nz)
    degen = ln < C.EPS_PARALLEL
    ln_safe = torch.where(degen, 1.0, ln)
    nx, ny, nz = nx / ln_safe, ny / ln_safe, nz / ln_safe
    denom = rb.dx * nx + rb.dy * ny + rb.dz * nz
    par = torch.abs(denom) < C.EPS_PARALLEL
    t = ((ax - rb.ox) * nx + (ay - rb.oy) * ny + (az - rb.oz) * nz) / torch.where(
        par, 1.0, denom
    )
    px = rb.ox + t * rb.dx
    py = rb.oy + t * rb.dy
    pz = rb.oz + t * rb.dz

    def edge(x0, y0, z0, x1, y1, z1):
        ux, uy, uz = x1 - x0, y1 - y0, z1 - z0
        wx, wy, wz = px - x0, py - y0, pz - z0
        return ((wz * uy - wy * uz) * nx + (wx * uz - wz * ux) * ny
                + (wy * ux - wx * uy) * nz) >= C.EPS_PLANE_EDGE

    in_t1 = edge(bx, by, bz, ex, ey, ez) & edge(ex, ey, ez, cx, cy, cz) & edge(cx, cy, cz, bx, by, bz)
    in_t2 = edge(ax, ay, az, bx, by, bz) & edge(bx, by, bz, cx, cy, cz) & edge(cx, cy, cz, ax, ay, az)
    ok = (~degen & ~par & (t >= 0.0) & (in_t1 | in_t2)).detach()
    return torch.where(ok, t, miss_t), (nx, ny, nz)


def winner_rows(table: torch.Tensor, best_id: torch.Tensor) -> torch.Tensor:
    """(R,) int64 table row of each lane's recorded winner id; -1 for none.
    The ids of a packed table (column 16) are a permutation of 0..G-1, so
    the inverse permutation needs no host read."""
    ids = torch.round(table[16].detach()).to(torch.int64)
    g = ids.shape[0]
    row_of = torch.empty_like(ids)
    row_of[ids] = torch.arange(g, device=table.device)
    bid = best_id.detach().to(torch.int64)
    return torch.where(bid >= 0, row_of[torch.clamp(bid, min=0)], -1)


def wave_level_ref(
    out_prev: torch.Tensor,
    fuzz: Optional[torch.Tensor],
    table: torch.Tensor,
    lights: torch.Tensor,
    best_id: torch.Tensor,
    vis: torch.Tensor,
    texel: Optional[torch.Tensor],
    *,
    kinds: Sequence[int],
    n_lights: int,
    glossy: bool,
    min_tp: float = 0.0,
    motion: bool = False,
    refraction: bool = False,
) -> torch.Tensor:
    """Rebuild rows 0..12 of a level's output from its recorded decisions.

    out_prev: (rows >= 9, R) the level's input (queue in rows 0..8).
    fuzz: the fuzz rows the kernel consumed (glossy rows 0..2 first), or
    None.  table: (n_cols, G) shaded table as the kernel got it
    (transposed).  lights: (8, L) light table.  best_id: (R,) recorded
    winner geom id (-1 none); vis: (L, R) recorded visibility (an area
    light's the fraction of its samples); texel: (3, R) recorded texel
    (textured scenes) or None.  All three are held fixed.  kinds: the geom
    kinds of the table's ranges.  motion: the winner's origin is shifted by
    -velocity * time (only spheres carry velocity).  refraction: the
    material block carries transparency and index, and a transparent
    winner spawns the refracted ray.  Returns (13, R)."""
    q = out_prev[:9].unbind(0)
    rb = _Rays(q)
    act = q[7].detach() > 0.0
    tp = q[8]
    zero = torch.zeros_like(tp)
    best_id = best_id.detach()
    vis = vis.detach()
    won = best_id >= 0.0
    hit_f = won & act

    # --- the winner's record, gathered by index; no winner -> all zero.
    rows = winner_rows(table, best_id)
    win = gather_columns(table[:_N_NEED_REFR if refraction else _N_NEED],
                         torch.clamp(rows, min=0))
    win = torch.where((rows >= 0)[None, :], win, 0.0).unbind(0)
    dr, dg, db, sr, sg, sb, ka, kd, ks, shin, rough, refl = win[GEOM_COLS:_N_NEED]
    trans, ior = win[_N_NEED:] if refraction else (zero, zero)

    # --- the winner's distance and unnormalized normal by its kind's test
    # (a moving winner's origin at the ray's time; velocity is zero but
    # for spheres, so every transformed kind takes the shift).
    kind = win[15].detach()
    best_t = torch.full_like(tp, _MISS_T)
    bnx = bny = bnz = zero
    for k in kinds:
        if k == KIND_PLANE:
            t_k, (nx_k, ny_k, nz_k) = plane_t_lanes(win, rb, _MISS_T)
        else:
            t_k, (nx_k, ny_k, nz_k) = geom_t(win, rb, k, want_normal=True, motion=motion,
                                             miss_t=_MISS_T)
        sel = kind == float(k)
        best_t = torch.where(sel, t_k, best_t)
        bnx = torch.where(sel, nx_k, bnx)
        bny = torch.where(sel, ny_k, bny)
        bnz = torch.where(sel, nz_k, bnz)
    ln = safe_sqrt(bnx * bnx + bny * bny + bnz * bnz)
    inv_n = 1.0 / torch.clamp(ln, min=_TINY)
    nx, ny, nz = bnx * inv_n, bny * inv_n, bnz * inv_n

    t_fin = torch.where(hit_f & (best_t < 1e29), best_t, zero)
    px = rb.ox + t_fin * rb.dx
    py = rb.oy + t_fin * rb.dy
    pz = rb.oz + t_fin * rb.dz
    vx, vy, vz = -rb.dx, -rb.dy, -rb.dz

    w_miss = torch.where(act & ~won, tp, zero)
    w_local = torch.where(hit_f, tp * torch.clamp(1.0 - refl - trans, min=0.0), zero)
    amb = ka * w_local
    d_r, d_g, d_b = dr * amb, dg * amb, db * amb
    s_r = w_miss * C.BACKGROUND_RGB[0]
    s_g = w_miss * C.BACKGROUND_RGB[1]
    s_b = w_miss * C.BACKGROUND_RGB[2]

    # --- Blinn-Phong from the light center (Code/raytracer.cpp:244-262),
    # visibility recorded.
    for li in range(n_lights):
        lpx, lpy, lpz = lights[0, li], lights[1, li], lights[2, li]
        lr, lg, lb = lights[3, li], lights[4, li], lights[5, li]
        lvx, lvy, lvz = lpx - px, lpy - py, lpz - pz
        d2 = lvx * lvx + lvy * lvy + lvz * lvz
        dist = torch.sqrt(torch.clamp(d2, min=_TINY))
        inv_d = 1.0 / torch.clamp(dist, min=_TINY)
        lcx, lcy, lcz = lvx * inv_d, lvy * inv_d, lvz * inv_d
        ndotl = torch.clamp(nx * lcx + ny * lcy + nz * lcz, min=0.0)
        hx, hy, hz = lcx + vx, lcy + vy, lcz + vz
        inv_h = 1.0 / torch.clamp(safe_sqrt(hx * hx + hy * hy + hz * hz), min=_TINY)
        ndoth = torch.clamp(nx * hx * inv_h + ny * hy * inv_h + nz * hz * inv_h, min=0.0)
        spec_i = torch.where(
            ndoth > 0.0, torch.exp(shin * torch.log(torch.clamp(ndoth, min=1e-12))), zero
        )
        atten = C.ATTEN_NUM * lights[6, li] / (
            C.ATTEN_C0 + C.ATTEN_C1 * dist + C.ATTEN_C2 * d2
        )
        scale = atten * w_local
        dif = kd * ndotl * scale * vis[li]
        spc = ks * spec_i * scale * vis[li]
        d_r = d_r + lr * dr * dif
        d_g = d_g + lg * dg * dif
        d_b = d_b + lb * db * dif
        s_r = s_r + lr * sr * spc
        s_g = s_g + lg * sg * spc
        s_b = s_b + lb * sb * spc

    if texel is not None:
        tex = texel.detach()
        c_r, c_g, c_b = d_r * tex[0] + s_r, d_g * tex[1] + s_g, d_b * tex[2] + s_b
    else:
        c_r, c_g, c_b = d_r + s_r, d_g + s_g, d_b + s_b

    # --- reflection continuation (Code/raytracer.cpp:307-333), the fuzz
    # rows the kernel consumed.
    sox = px + nx * C.EPS_NORMAL_OFFSET
    soy = py + ny * C.EPS_NORMAL_OFFSET
    soz = pz + nz * C.EPS_NORMAL_OFFSET
    ddn = rb.dx * nx + rb.dy * ny + rb.dz * nz
    rdx = rb.dx - 2.0 * ddn * nx
    rdy = rb.dy - 2.0 * ddn * ny
    rdz = rb.dz - 2.0 * ddn * nz
    if glossy:
        gx = rdx + rough * fuzz[0]
        gy = rdy + rough * fuzz[1]
        gz = rdz + rough * fuzz[2]
        inv_g = 1.0 / torch.clamp(safe_sqrt(gx * gx + gy * gy + gz * gz), min=_TINY)
        gx, gy, gz = gx * inv_g, gy * inv_g, gz * inv_g
        below = (gx * nx + gy * ny + gz * nz).detach() < 0.0
        isg = rough.detach() > 0.0
        rdx = torch.where(isg, torch.where(below, zero, gx), rdx)
        rdy = torch.where(isg, torch.where(below, zero, gy), rdy)
        rdz = torch.where(isg, torch.where(below, zero, gz), rdz)
    rd2 = (rdx * rdx + rdy * rdy + rdz * rdz).detach()
    tp2 = tp * refl
    ok = hit_f & (refl.detach() > 0.0) & (rd2 > C.EPS_GLOSSY_DIR2)
    cox, coy, coz = sox, soy, soz
    if refraction:
        # one-way refraction (Code/raytracer.cpp:118-150), as the kernel;
        # lanes that do not refract take index 1, so that their masked-out
        # arithmetic stays finite (an index of 0 would give eta = 1e20 and
        # an inf, whose zero cotangent is a NaN)
        use_refr = trans.detach() > 0.0
        ior = torch.where(use_refr, ior, 1.0)
        exiting = ddn.detach() > 0.0
        eta = torch.where(exiting, ior, 1.0) / torch.where(
            exiting, 1.0, torch.clamp(ior, min=_TINY)
        )
        nsg = torch.where(exiting, -1.0, 1.0)
        nex, ney, nez = nsg * nx, nsg * ny, nsg * nz
        cos_abs = torch.abs(ddn)
        disc = 1.0 - eta * eta * (1.0 - cos_abs * cos_abs)
        kk = eta * cos_abs - safe_sqrt(disc)
        tx = eta * rb.dx + kk * nex
        ty = eta * rb.dy + kk * ney
        tz = eta * rb.dz + kk * nez
        tn2 = tx * tx + ty * ty + tz * tz
        inv_t = 1.0 / torch.sqrt(torch.where(tn2 > 0.0, tn2, 1.0))
        live_t = (disc.detach() >= 0.0) & (tn2.detach() > C.EPS_REFRACT_DIR2)
        ok = torch.where(use_refr, hit_f & live_t, ok)
        tp2 = tp * torch.where(use_refr, trans, refl)
        cox = torch.where(use_refr, px - nex * C.EPS_NORMAL_OFFSET, cox)
        coy = torch.where(use_refr, py - ney * C.EPS_NORMAL_OFFSET, coy)
        coz = torch.where(use_refr, pz - nez * C.EPS_NORMAL_OFFSET, coz)
        rdx = torch.where(use_refr, torch.where(live_t, tx * inv_t, zero), rdx)
        rdy = torch.where(use_refr, torch.where(live_t, ty * inv_t, zero), rdy)
        rdz = torch.where(use_refr, torch.where(live_t, tz * inv_t, zero), rdz)
    if min_tp > 0.0:
        ok = ok & (tp2.detach() > min_tp)

    return torch.stack(
        [
            cox, coy, coz, rdx, rdy, rdz,
            zero,
            torch.where(ok, 1.0, 0.0),
            torch.where(ok, tp2, zero),
            c_r, c_g, c_b,
            torch.where(hit_f, 1.0, 0.0),
        ]
    )

